"""The data slice as a whole: the port's loaders feed the port's
``validate`` and training step, the JAX package's loaders feed its own,
on the PASCAL fixture tree of ``tests/fixtures_mtl.py``.

The toy model of tests/test_end_to_end.py:33-41 (64 px, depths
[2, 2, 2, 2], embed 24, window 4) on numpy weights bridged into the port
(``ckpt.convert.from_jax_variables``). The JAX transforms run with their
native backend switched on, so both loaders give the same batches bit for
bit (held here first; the train split's normals within 1e-5, below) and
the comparison is the one of the eval and train tests, at their bounds.
"""

import os
import sys
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlora_tpu.config import load_config
from mtlora_tpu.data import loader as jloader
from mtlora_tpu.data import transforms as jtransforms
from mtlora_tpu.data.native import native as jnative
from mtlora_tpu.models.mtl import build_mtl_model as jax_build
from mtlora_tpu.models.mtl import eval_model_for as jax_eval_model_for
from mtlora_tpu.train import optim as joptim
from mtlora_tpu.train.loop import validate as jax_validate
from mtlora_tpu.train.step import TrainState, make_eval_step, make_train_step
from mtlora_tpu_torch import config as port_config
from mtlora_tpu_torch.ckpt.convert import from_jax_variables
from mtlora_tpu_torch.data.loader import build_loader, data_node
from mtlora_tpu_torch.models.mtl import build_mtl_model
from mtlora_tpu_torch.train import optim
from mtlora_tpu_torch.train.loop import validate
from mtlora_tpu_torch.train.step import train_step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures_mtl import make_pascal_fixture  # noqa: E402

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG = os.path.join(ROOT, "configs/mtlora/tiny_448/"
                   "mtlora_tiny_448_r64_scale4_pertask.yaml")
TASKS = ["semseg", "normals", "sal", "human_parts"]
TOY = ["MODEL.SWIN.DEPTHS", "[2, 2, 2, 2]",
       "MODEL.SWIN.EMBED_DIM", "24",
       "MODEL.SWIN.NUM_HEADS", "[2, 2, 2, 2]",
       "MODEL.SWIN.WINDOW_SIZE", "4"]
# the training step's parity settings (tests/test_torch_port_train.py):
# no dropout or drop-path, the LR from the first update, Adam's eps 1e-6
PARITY = ["MODEL.MTLORA.DROPOUT", "[0.0, 0.0, 0.0, 0.0]",
          "MODEL.DROP_PATH_RATE", "0.0",
          "TRAIN.BASE_LR", "0.0256",
          "TRAIN.WARMUP_EPOCHS", "0",
          "TRAIN.OPTIMIZER.EPS", "1e-6",
          "AMP_ENABLE", "False",
          "TPU.USE_PALLAS_LN", "False",
          "TPU.USE_PALLAS_ADAPTER", "False"]
# the bounds of tests/test_torch_port_eval.py:test_validate_matches_jax
VALIDATE_LOSS_REL = 1e-5
VALIDATE_SCORE_ABS = 1e-3


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX transforms with their native backend switched on."""
    assert jnative.available()
    monkeypatch.setattr(jtransforms, "_USE_NATIVE", True)
    monkeypatch.setattr(jtransforms, "_native", jnative, raising=False)
    monkeypatch.setattr(jtransforms, "_NATIVE_INTERP", {
        cv2.INTER_NEAREST: 0, cv2.INTER_LINEAR: 1, cv2.INTER_CUBIC: 2})


@pytest.fixture(scope="module")
def pascal(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pascal_mt"))
    make_pascal_fixture(root)
    return root


def numpy_variables(model, x, seed):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if name == "mean":
            return rng.uniform(-0.05, 0.05, s.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.9, 1.1, s.shape).astype(np.float32)
        return rng.uniform(-0.08, 0.08, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def models(cfg):
    """The JAX model (kernels off on the CPU) and the port on the same
    numpy weights."""
    jmodel = jax_build(cfg)
    x = np.zeros((2, 64, 64, 3), np.float32)
    variables = numpy_variables(jmodel, x, seed=0)
    port = build_mtl_model(port_config.from_config(cfg), device="cpu")
    port.load_state_dict(from_jax_variables(variables, TASKS), strict=True)
    return jmodel, variables, port


def loaders(root, cfg):
    """(port, JAX) ``build_loader`` results on the tree, from the same
    config; the port's builds its batches in this process."""
    port = build_loader(data_node("PASCALContext", root, TASKS,
                                  cfg.DATA.IMG_SIZE, cfg.DATA.BATCH_SIZE,
                                  int(cfg.SEED), num_workers=0),
                        device="cpu")
    return port, jloader.build_loader(cfg)


def same_batches(port_loader, jax_loader, normals_atol=0.0):
    """Epoch 0 of both loaders: (port batches, JAX batches), equal bit
    for bit but for the normals, within ``normals_atol``."""
    got = list(port_loader.iter_epoch(0))
    want = list(jax_loader.iter_epoch(0))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["meta"] == w["meta"]
        for k, v in w.items():
            if k != "meta":
                np.testing.assert_allclose(
                    g[k].numpy(), v, rtol=0,
                    atol=normals_atol if k == "normals" else 0, err_msg=k)
    return got, want


def test_validate_over_pascal_loader_matches_jax(pascal, jax_native):
    """The port's ``validate`` (the fp32 eval clone of the adapter route,
    ``TPU.EVAL_DTYPE``'s default) over the port's padded PASCAL val loader
    against the JAX ``validate`` over the JAX loader: the val split's 2
    images in one batch of 3 with one pad row, the same batches bit for
    bit; per-task eval losses within 1e-5 relative and every score within
    1e-3."""
    cfg = load_config(CFG, tasks=TASKS, db_name="PASCALContext",
                      img_size=64, opts=TOY,
                      **{"DATA.DATA_PATH": pascal, "DATA.BATCH_SIZE": 3,
                         "DATA.NUM_WORKERS": 1})
    jmodel, variables, port = models(cfg)
    assert port.cfg.use_pallas_adapter
    (_, _, _, port_val, _), (_, _, _, jax_val, _) = loaders(pascal, cfg)
    batches, _ = same_batches(port_val, jax_val)
    assert [b["_valid"].tolist() for b in batches] == [[1.0, 1.0, 0.0]]
    logs = []
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    ref_scores = jax_validate(
        cfg, state, jax.jit(make_eval_step(jax_eval_model_for(jmodel, cfg))),
        jax_val, log_fn=logs.append)
    scores, losses = validate(port, port_val.iter_epoch(0), TASKS,
                              cfg.DATA.DBNAME, port_config.eval_dtype(cfg))
    for t in TASKS:
        want = logs[-1][f"val/loss_{t}"]
        assert losses[t] == pytest.approx(want, rel=VALIDATE_LOSS_REL), t
        assert set(scores[t]) == set(ref_scores[t]), t
        for k, v in ref_scores[t].items():
            np.testing.assert_allclose(np.asarray(scores[t][k], np.float64),
                                       np.asarray(v, np.float64), rtol=1e-6,
                                       atol=VALIDATE_SCORE_ABS,
                                       err_msg=f"{t} {k}")


def test_train_step_on_loader_batch_matches_jax(pascal, jax_native):
    """One port ``train_step`` on the port train loader's first batch
    against ``make_train_step`` on the JAX loader's (the same batch bit for
    bit but for the normals of image 2, within 1e-5: flip, scale and
    rotate, resize through the native ops), from the same weights at the parity settings of tests/test_torch_port_train.py:
    the loss, each task's loss and the pre-clip grad norm within 1e-4
    relative, as there."""
    cfg = load_config(CFG, tasks=TASKS, db_name="PASCALContext",
                      img_size=64, opts=TOY + PARITY,
                      **{"DATA.DATA_PATH": pascal, "DATA.BATCH_SIZE": 2,
                         "DATA.NUM_WORKERS": 1})
    jmodel, variables, port = models(cfg)
    (_, _, port_train, _, _), (_, _, jax_train, _, _) = loaders(pascal, cfg)
    # image 2 of the train split has its label maps at half size, and the
    # JAX dataset resizes them with cv2 (in float64) in any case: its
    # cubic-resized normals differ from the port's by float32 round-off
    (batch, *_), (jbatch, *_) = same_batches(port_train, jax_train, 1e-5)
    keys = ("image", *TASKS)
    tx = joptim.build_optimizer(cfg, variables["params"], n_iter_per_epoch=10)
    state = TrainState.create(params=variables["params"], tx=tx,
                              batch_stats=variables["batch_stats"],
                              rng=jax.random.PRNGKey(0))
    _, want = jax.jit(make_train_step(jmodel, tx, TASKS))(
        state, {k: jnp.asarray(jbatch[k]) for k in keys})
    tcfg = optim.train_from_config(cfg)
    got = train_step(port, optim.build_optimizer(port, tcfg),
                     optim.build_schedule(tcfg, 10),
                     {k: batch[k] for k in keys}, None,
                     clip_grad=tcfg.clip_grad)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   err_msg=k)
