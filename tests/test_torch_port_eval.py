"""The port's eval path vs the JAX package: each meter, ``get_output``,
``calculate_multi_task_performance``, ``eval_model_for`` and ``validate``
as a whole, and the config keys of the eval path (``TPU.USE_PALLAS``,
``TPU.EVAL_DTYPE``).

Inputs are made with numpy from seeds. The JAX side runs on the CPU, where
``build_mtl_model`` turns its Pallas kernels off (``mtl.py:284-293``);
the port's kernel wrappers take their plain versions on CPU tensors. The
whole-model tests use the toy shape of tests/test_end_to_end.py:33-41
(64 px, depths [2, 2, 2, 2], embed 24, window 4) on the flagship YAML's
adapter route, with AMP on so that the fp32 clone differs from the model.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlora_tpu.config import load_config
from mtlora_tpu.evaluation import meters as jmeters
from mtlora_tpu.models.mtl import build_mtl_model as jax_build
from mtlora_tpu.models.mtl import eval_model_for as jax_eval_model_for
from mtlora_tpu.train.loop import _score_logs as jax_score_logs
from mtlora_tpu.train.loop import validate as jax_validate
from mtlora_tpu.train.step import make_eval_step
from mtlora_tpu_torch import config as port_config
from mtlora_tpu_torch.ckpt.convert import from_jax_variables
from mtlora_tpu_torch.evaluation import meters
from mtlora_tpu_torch.models.mtl import (
    MultiTaskSwin,
    build_mtl_model,
    eval_model_for,
)
from mtlora_tpu_torch.models.heads import HighResolutionHead
from mtlora_tpu_torch.models.swin import WindowAttention
from mtlora_tpu_torch.train.loop import _score_logs, throughput, validate
from mtlora_tpu_torch.train.optim import (
    TrainConfig,
    build_optimizer,
    build_schedule,
)
from mtlora_tpu_torch.train.step import synthetic_eval_batches, train_step
from mtlora_tpu_torch.utils.logger import AverageMeter

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG = os.path.join(ROOT, "configs/mtlora/tiny_448/"
                   "mtlora_tiny_448_r64_scale4_pertask.yaml")
TASKS = ["semseg", "normals", "sal", "human_parts"]
TOY = ["MODEL.SWIN.DEPTHS", "[2, 2, 2, 2]",
       "MODEL.SWIN.EMBED_DIM", "24",
       "MODEL.SWIN.NUM_HEADS", "[2, 2, 2, 2]",
       "MODEL.SWIN.WINDOW_SIZE", "4"]
# fp32 sums of the meters (angles, per-image ratios, squared errors) taken
# in another order by XLA and by torch, and their elementwise functions
# (acos, atan2, log, sigmoid) a few ulps apart
SUM_REL = 1e-6
SUM_KEYS = ("v1_sum", "v2_sum", "jac_sum", "prec_sum", "rec_sum", "sq",
            "log_sq", "loss")


# ---------------------------------------------------------------------------
# Meters
# ---------------------------------------------------------------------------

def meter_inputs(task, rng, B=3, S=16, n_classes=21):
    """(pred, gt) in the meters' input space (``get_output`` results and
    labels), with a band of ignored pixels where the task has one."""
    if task in ("semseg", "human_parts"):
        pred = rng.randint(0, n_classes, (B, S, S)).astype(np.int32)
        gt = rng.randint(0, n_classes, (B, S, S, 1)).astype(np.float32)
        gt[:, :2] = 255.0
    elif task == "normals":
        pred = rng.uniform(0, 255, (B, S, S, 3)).astype(np.float32)
        gt = rng.randn(B, S, S, 3).astype(np.float32)
        gt /= np.linalg.norm(gt, axis=-1, keepdims=True)
        gt[:, :2, :4] = 255.0
    elif task in ("sal", "edge"):
        pred = rng.uniform(0, 255, (B, S, S)).astype(np.float32)
        gt = (rng.rand(B, S, S, 1) > 0.6).astype(np.float32)
        if task == "sal":
            gt[:, :1] = 255.0
    else:   # depth
        pred = rng.uniform(0.1, 10.0, (B, S, S)).astype(np.float32)
        gt = rng.uniform(0.5, 10.0, (B, S, S, 1)).astype(np.float32)
        gt[:, :2] = 255.0
    return pred, gt


METER_CASES = [("semseg", "PASCALContext"), ("semseg", "NYUD"),
               ("human_parts", "PASCALContext"), ("normals", None),
               ("sal", None), ("depth", None), ("edge", None)]


def _check_states(port_state, jax_state, what):
    assert set(port_state) == set(jax_state), what
    for k, v in port_state.items():
        a = v.numpy().astype(np.float64)
        b = np.asarray(jax_state[k], np.float64)
        assert v.dtype == torch.float32 and a.shape == b.shape, (what, k)
        if k in SUM_KEYS:
            np.testing.assert_allclose(a, b, rtol=SUM_REL, atol=0,
                                       err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")


def _check_scores(port, ref, what, atol=1e-6):
    assert set(port) == set(ref), what
    for k, v in port.items():
        np.testing.assert_allclose(np.asarray(v, np.float64),
                                   np.asarray(ref[k], np.float64),
                                   rtol=1e-6, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["weight-None", "zeroed-rows"])
@pytest.mark.parametrize("task,db", METER_CASES,
                         ids=[f"{t}-{d}" if d else t for t, d in METER_CASES])
def test_meter_matches_jax(task, db, weighted):
    """Two updates of each meter on the same predictions and labels,
    without a row weight and with the middle row zeroed: states with
    counts equal and fp32 sums within 1e-6 relative, and ``compute``
    within 1e-6."""
    args = (task,) + ((db,) if db else ())
    pm = meters.get_single_task_meter(*args)
    jm = jmeters.get_single_task_meter(*args)
    n = getattr(pm, "n_classes", 21)
    rng = np.random.RandomState(7)
    ps, js = pm.init(), jm.init()
    w = np.array([1.0, 0.0, 1.0], np.float32) if weighted else None
    for _ in range(2):
        pred, gt = meter_inputs(task, rng, n_classes=n)
        ps = pm.update(ps, torch.from_numpy(pred), torch.from_numpy(gt),
                       None if w is None else torch.from_numpy(w))
        js = jm.update(js, jnp.asarray(pred), jnp.asarray(gt),
                       None if w is None else jnp.asarray(w))
    _check_states(ps, js, task)
    _check_scores(pm.compute(ps), jm.compute(js), task)


@pytest.mark.parametrize("task,n", [("semseg", 21), ("human_parts", 7),
                                    ("normals", 3), ("sal", 1), ("edge", 1),
                                    ("depth", 1)])
def test_get_output_matches_jax(task, n):
    """NHWC logits -> meter inputs: argmax equal, the rest within 1e-6."""
    x = np.random.RandomState(3).randn(2, 8, 8, n).astype(np.float32) * 3
    got = meters.get_output(torch.from_numpy(x), task).numpy()
    want = np.asarray(jmeters.get_output(jnp.asarray(x), task))
    assert got.shape == want.shape
    if task in ("semseg", "human_parts"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_performance_meter_and_multi_task_performance_match_jax():
    """The multi-task wrapper on raw logits (with a row weight) and the
    MTL delta against single-task baselines, against the JAX functions."""
    rng = np.random.RandomState(5)
    tasks = ["semseg", "normals", "sal", "human_parts", "depth"]
    outs = {"semseg": 21, "normals": 3, "sal": 1, "human_parts": 7,
            "depth": 1}
    pm = meters.PerformanceMeter(tasks)
    jm = jmeters.PerformanceMeter(tasks)
    w = np.array([1.0, 1.0, 0.0], np.float32)
    preds = {t: rng.randn(3, 16, 16, n).astype(np.float32)
             for t, n in outs.items()}
    targets = {t: meter_inputs(t, rng, n_classes=outs[t])[1] for t in tasks}
    pm.update({t: torch.from_numpy(v) for t, v in preds.items()},
              {t: torch.from_numpy(v) for t, v in targets.items()},
              weight=torch.from_numpy(w))
    jm.states = jm.update_jit(jm.states, preds, targets, jnp.asarray(w))
    sp, sj = pm.get_score(verbose=False), jm.get_score(verbose=False)
    for t in tasks:
        _check_scores(sp[t], sj[t], t)
    single = {t: {"mIoU": 0.5, "mean": 30.0, "rmse": 2.0} for t in tasks}
    assert (meters.calculate_multi_task_performance(sp, single)
            == pytest.approx(jmeters.calculate_multi_task_performance(
                sj, single), rel=1e-6))
    assert _score_logs(sp, 3) == pytest.approx(jax_score_logs(sj, 3),
                                               rel=1e-6)


def test_average_meter_matches_jax():
    from mtlora_tpu.utils.logger import AverageMeter as JAverage
    a, b = AverageMeter(), JAverage()
    for v, n in ((1.5, 2), (3.0, 1), (0.25, 4)):
        a.update(v, n)
        b.update(v, n)
    assert (a.val, a.sum, a.count, a.avg) == (b.val, b.sum, b.count, b.avg)


# ---------------------------------------------------------------------------
# The toy model on both sides
# ---------------------------------------------------------------------------

def numpy_variables(model, x, seed):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if name == "mean":
            return rng.uniform(-0.05, 0.05, s.shape).astype(np.float32)
        return rng.uniform(-0.08, 0.08, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def toy():
    """The JAX model (kernels off on the CPU) and the port (the adapter
    route, bf16 compute) on the same numpy weights."""
    cfg = load_config(CFG, tasks=TASKS, img_size=64, opts=TOY)
    jmodel = jax_build(cfg)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    variables = numpy_variables(jmodel, x, seed=0)
    pcfg = port_config.from_config(cfg)
    assert pcfg.use_pallas_adapter and pcfg.compute_dtype == "bfloat16"
    port = build_mtl_model(pcfg, device="cpu")
    port.load_state_dict(from_jax_variables(variables, TASKS), strict=True)
    return cfg, jmodel, variables, port, x


def test_eval_clone_logits_match_jax_clone(toy):
    """``eval_model_for`` (fp32, every kernel off) against the JAX clone on
    the same weights: all four tasks' logits within 1e-4."""
    cfg, jmodel, variables, port, x = toy
    jclone = jax_eval_model_for(jmodel, cfg)
    ref = jax.jit(lambda v, x: jclone.apply(v, x, deterministic=True))(
        variables, x)
    clone = eval_model_for(port, port_config.eval_dtype(cfg))
    with torch.inference_mode():
        out = clone(torch.from_numpy(x))
    for t in TASKS:
        assert out[t].dtype == torch.float32
        np.testing.assert_allclose(out[t].numpy(), np.asarray(ref[t]),
                                   atol=1e-4, rtol=1e-4, err_msg=t)


def test_eval_clone_keeps_route_and_mode(toy):
    """The clone runs every kernel off in fp32 and is eval; the model keeps
    its route (kernels on, bf16) and its mode, and the clone's tensors are
    the model's own; ``"bfloat16"`` returns the model itself."""
    *_, port, _ = toy
    port.train()
    try:
        clone = eval_model_for(port, "float32")
        assert port.training and not clone.training
    finally:
        port.eval()
    assert port.cfg.use_pallas and port.cfg.use_pallas_adapter
    assert not (clone.cfg.use_pallas or clone.cfg.use_pallas_ln
                or clone.cfg.use_pallas_adapter)
    assert clone.cfg.compute_dtype == "float32"
    for model, on in ((port, True), (clone, False)):
        kernels = [m.kernel for m in model.modules()
                   if isinstance(m, (WindowAttention, HighResolutionHead))]
        assert kernels and all(k is on for k in kernels)
    for (n1, a), (n2, b) in zip(port.named_parameters(),
                                clone.named_parameters()):
        assert n1 == n2 and a is b
    for (n1, a), (n2, b) in zip(port.named_buffers(), clone.named_buffers()):
        assert n1 == n2 and a is b
    assert eval_model_for(port, "bfloat16") is port


def test_eval_clone_sees_weights_after_train_step(toy):
    """A clone made before a training step computes with the weights and
    BatchNorm statistics after it: its logits equal those of a fresh
    kernel-off model loaded with the trained state."""
    *_, port, x = toy
    model = build_mtl_model(port.cfg, device="cpu")
    model.load_state_dict(port.state_dict())
    clone = eval_model_for(model, "float32")
    tcfg = TrainConfig(batch_size=2, warmup_epochs=0)
    batch = synthetic_eval_batches(1, 2, 64, 3, "cpu", valid_last=2)[0]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    train_step(model, build_optimizer(model, tcfg), build_schedule(tcfg, 10),
               batch, torch.Generator().manual_seed(0))
    moved = [k for k, v in model.state_dict().items()
             if not torch.equal(v, before[k])]
    assert any("running_mean" in k for k in moved)
    assert any("lora_shared_A" in k for k in moved)
    fresh = build_mtl_model(clone.cfg, device="cpu")
    fresh.load_state_dict(model.state_dict())
    with torch.inference_mode():
        a, b = clone(torch.from_numpy(x)), fresh(torch.from_numpy(x))
    for t in TASKS:
        assert torch.equal(a[t], b[t]), t


# ---------------------------------------------------------------------------
# validate as a whole
# ---------------------------------------------------------------------------

class Loader:
    """The JAX loop's loader interface over a fixed list of batches."""

    def __init__(self, batches):
        self.batches = batches

    def iter_epoch(self, epoch):
        return iter(self.batches)


# the fp32 clones of the two packages differ by fp32 round-off (logits
# within 1e-4, above): the loss averages to 1e-5 relative, and a score
# moves only where an argmax or a threshold test flips (one pixel of the
# 9,216 valid ones is 1e-4 of a class IoU here): 1e-3 absolute
VALIDATE_LOSS_REL = 1e-5
VALIDATE_SCORE_ABS = 1e-3


def test_validate_matches_jax(toy):
    """``validate`` on the fp32 clone against ``mtlora_tpu.train.loop.
    validate`` with ``make_eval_step(eval_model_for(model, config))``: 3
    batches of 3, the last padded (its last row ``_valid`` 0 and
    ignore-filled), score dicts within 1e-3 absolute and per-task loss
    averages within 1e-5 relative."""
    cfg, jmodel, variables, port, _ = toy
    batches = synthetic_eval_batches(3, 3, 64, 11, "cpu", valid_last=2)
    assert "_valid" in batches[-1] and "_valid" not in batches[0]
    assert bool((batches[-1]["semseg"][2] == 255).all())
    logs = []
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    ref_scores = jax_validate(
        cfg, state, jax.jit(make_eval_step(jax_eval_model_for(jmodel, cfg))),
        Loader([{k: v.numpy() for k, v in b.items()} for b in batches]),
        log_fn=logs.append)
    ref_loss = {t: logs[-1][f"val/loss_{t}"] for t in TASKS}
    port_logs = []
    scores, losses = validate(port, batches, TASKS, cfg.DATA.DBNAME,
                              port_config.eval_dtype(cfg),
                              log_fn=port_logs.append)
    assert set(losses) == set(TASKS)
    for t in TASKS:
        assert losses[t] == pytest.approx(ref_loss[t], rel=VALIDATE_LOSS_REL)
        _check_scores(scores[t], ref_scores[t], t, atol=VALIDATE_SCORE_ABS)
    assert set(port_logs[-1]) == set(logs[-1])


def test_validate_step_series_and_padding(toy):
    """The per-batch series (``WANDB_STEP_VAL``) logs every batch's losses;
    a padded row changes nothing: the batch with its extra row zeroed
    scores as the batch without that row."""
    *_, port, _ = toy
    full = synthetic_eval_batches(1, 3, 64, 5, "cpu", valid_last=2)
    cut = {k: v[:2] for k, v in full[0].items() if k != "_valid"}
    logs = []
    s_pad, l_pad = validate(port, full, TASKS, eval_dtype="bfloat16",
                            log_fn=logs.append, step_val=True)
    s_cut, l_cut = validate(port, [cut], TASKS, eval_dtype="bfloat16")
    assert [set(d) >= {"val/val_loss", "val/tasks/sal/loss"}
            for d in logs[:-1]] == [True]
    for t in TASKS:
        assert l_pad[t] == pytest.approx(l_cut[t], rel=1e-5)
        _check_scores(s_pad[t], s_cut[t], t, atol=1e-6)


def test_throughput_names_and_measures_both_paths(toy, monkeypatch):
    """``throughput`` times through ``serve.throughput`` (CUDA events) and
    keys each rate by the forward measured: on the fp32 eval path the
    clone ("fp32, kernels off") and the model's own path ("bf16 +
    kernels") in one run, on the bf16 path the model alone; the model's
    mode is restored."""
    from mtlora_tpu_torch import serve
    *_, port, x = toy
    seen = []

    def fake(model, images, iters, warmup=2):
        seen.append((model, iters, warmup))
        model.eval()
        return 10.0 * len(seen)

    monkeypatch.setattr(serve, "throughput", fake)
    port.train()
    try:
        rates = throughput(port, torch.from_numpy(x), "float32", iters=4)
        assert port.training
    finally:
        port.eval()
    assert rates == {"fp32, kernels off": 10.0, "bf16 + kernels": 20.0}
    assert seen[0][0] is not port and seen[1][0] is port
    assert seen[0][1:] == (4, 2)
    assert throughput(port, torch.from_numpy(x), "bfloat16") == {
        "bf16 + kernels": 30.0}


# ---------------------------------------------------------------------------
# Config keys
# ---------------------------------------------------------------------------

def test_use_pallas_false_builds_the_kernel_off_config(monkeypatch):
    """``TPU.USE_PALLAS False`` no longer raises: it gates every kernel
    switch off (the JAX package's ``_pallas_available``), MTLORA_ATTN_DENSE
    and TPU.USE_PALLAS_LORA_GEMM included, and the model built from it
    runs kernels 1 and 7 as plain versions; a config that asks for a
    kernel with ``use_pallas`` off is refused."""
    monkeypatch.setenv("MTLORA_ATTN_DENSE", "1")
    cfg = load_config(CFG, tasks=TASKS, opts=["TPU.USE_PALLAS", "False",
                                              "TPU.USE_PALLAS_LORA_GEMM",
                                              "True"])
    pcfg = port_config.from_config(cfg)
    assert pcfg == dataclasses.replace(
        port_config.tiny_448_r64_pertask(use_pallas_ln=False),
        use_pallas=False)
    with torch.device("meta"):
        model = MultiTaskSwin(pcfg)
    assert not any(m.kernel for m in model.modules()
                   if isinstance(m, (WindowAttention, HighResolutionHead)))
    with pytest.raises(ValueError, match="every kernel off"):
        dataclasses.replace(pcfg, use_pallas_ln=True)


@pytest.mark.parametrize("opts,want", [([], "float32"),
                                       (["TPU.EVAL_DTYPE", "bfloat16"],
                                        "bfloat16"),
                                       (["TPU.EVAL_DTYPE", "float32"],
                                        "float32")],
                         ids=["default", "bfloat16", "float32"])
def test_eval_dtype_key(opts, want):
    """``TPU.EVAL_DTYPE`` as the JAX package reads it: ``bfloat16`` keeps
    the model (``eval_model_for`` returns it), anything else the fp32
    clone."""
    cfg = load_config(CFG, tasks=TASKS, opts=opts)
    assert port_config.eval_dtype(cfg) == want

    class Stub:          # the JAX model's clone, not built here
        def clone(self, **kw):
            return kw

    stub = Stub()
    assert (jax_eval_model_for(stub, cfg) is stub) == (want == "bfloat16")
