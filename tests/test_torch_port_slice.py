"""The whole slice: MultiTaskSwin forward vs the JAX package, the
flagship preset vs the YAML config, the weight bridge through the
reference torch keys, and the port's import hygiene.

The JAX model is ``build_mtl_model(cfg).clone(use_pallas=True)`` with the
config's ``TPU.USE_PALLAS_LN`` and ``TPU.USE_PALLAS_ADAPTER``
(``build_mtl_model`` turns both off on a CPU host): the adapter off and
``TPU.USE_PALLAS_LN`` off (LayerNorm outside the GEMMs) or on (kernels 2,
3 and 4); on the CPU its kernels run in interpret mode.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mtlora_tpu.ckpt.torch_convert import (
    convert_torch_state_dict,
    merge_converted,
)
from mtlora_tpu.config import load_config
from mtlora_tpu.models.mtl import build_mtl_model as jax_build
from mtlora_tpu_torch import config as port_config
from mtlora_tpu_torch.ckpt.convert import (
    from_jax_variables,
    to_reference_state_dict,
)
from mtlora_tpu_torch.models.mtl import build_mtl_model

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG = os.path.join(ROOT, "configs/mtlora/tiny_448/"
                   "mtlora_tiny_448_r64_scale4_pertask.yaml")
TASKS = ["semseg", "normals", "sal", "human_parts"]
SLICE_FLAGS = ["TPU.USE_PALLAS_LN", "False",
               "TPU.USE_PALLAS_ADAPTER", "False"]
LN_FLAGS = ["TPU.USE_PALLAS_ADAPTER", "False"]
# the toy shape of tests/test_end_to_end.py:33-41; stage 2 (4x4 tokens)
# and stage 3 (2x2) clamp the window
TOY = ["MODEL.SWIN.DEPTHS", "[2, 2, 2, 2]",
       "MODEL.SWIN.EMBED_DIM", "24",
       "MODEL.SWIN.NUM_HEADS", "[2, 2, 2, 2]",
       "MODEL.SWIN.WINDOW_SIZE", "4",
       "AMP_ENABLE", "False"]


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


def make_toy(flags):
    """The JAX model and the port on the same numpy weights, and an input
    batch, at the toy shape with the given route flags."""
    cfg = load_config(CFG, tasks=TASKS, img_size=64, opts=TOY + flags)
    jmodel = jax_build(cfg).clone(
        use_pallas=True, use_pallas_ln=bool(cfg.TPU.USE_PALLAS_LN),
        use_pallas_adapter=bool(cfg.TPU.USE_PALLAS_ADAPTER))
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    variables = numpy_variables(jmodel, x, seed=0)
    port = build_mtl_model(port_config.from_config(cfg), device="cpu")
    port.load_state_dict(from_jax_variables(variables, TASKS), strict=True)
    return cfg, jmodel, variables, port, x


@pytest.fixture(scope="module")
def toy():
    return make_toy(SLICE_FLAGS)


@pytest.fixture(scope="module")
def toy_ln():
    return make_toy(LN_FLAGS)


def test_multitask_forward_matches_jax(toy):
    """(e) all four tasks' fp32 logits, atol = rtol = 1e-4."""
    _check_forward(toy)


def test_multitask_forward_ln_route_matches_jax(toy_ln):
    """The same on the TPU.USE_PALLAS_LN route: the port's kernels 2, 3, 4
    (plain versions on the CPU) against the interpret-mode Pallas kernels
    (the JAX merges at 8 -> 4 and 4 -> 2 take its kernel-2 fallback)."""
    assert toy_ln[3].cfg.use_pallas_ln
    assert toy_ln[1].use_pallas_ln and not toy_ln[1].use_pallas_adapter
    _check_forward(toy_ln)


def _check_forward(toy):
    _, jmodel, variables, port, x = toy
    ref = jax.jit(jmodel.apply)(variables, x)
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    assert set(out) == set(TASKS)
    for task in TASKS:
        assert out[task].shape == ref[task].shape, task
        np.testing.assert_allclose(out[task].numpy(), np.asarray(ref[task]),
                                   atol=1e-4, rtol=1e-4, err_msg=task)


def test_reference_key_bridge_round_trip(toy, capsys):
    """Port weights under the reference torch keys go through the JAX
    package's converter with no unmapped key and give back the JAX
    variables exactly."""
    _, _, variables, port, _ = toy
    sd = to_reference_state_dict(port)
    assert "backbone.layers.0.blocks.0.attn.qkv.linear.weight" in sd
    assert "decoders.semseg.last_layer.0.weight" in sd
    assert "backbone.layers.0.blocks.1.attn.proj.lora_tasks_A.sal" in sd
    converted = convert_torch_state_dict(sd, TASKS, verbose=True)
    assert "unmapped" not in capsys.readouterr().out
    zeros = jax.tree.map(np.zeros_like, variables)
    merged = merge_converted(zeros, converted, strict=True, verbose=False)
    flat_a = jax.tree_util.tree_leaves_with_path(merged)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf),
                                      np.asarray(flat_b[path]),
                                      err_msg=jax.tree_util.keystr(path))


def test_flagship_preset_equals_yaml_config():
    """(f) the literal preset cannot drift from the YAML it stands for:
    the LN-outside route, ``TPU.USE_PALLAS_LN False``."""
    cfg = load_config(CFG, tasks=TASKS, opts=SLICE_FLAGS)
    assert (port_config.from_config(cfg)
            == port_config.tiny_448_r64_pertask(use_pallas_ln=False))


def test_flagship_ln_preset_equals_yaml_config():
    """The YAML with only ``TPU.USE_PALLAS_ADAPTER`` off is the preset's LN
    route (the default preset is the adapter route,
    tests/test_torch_port_adapter.py)."""
    cfg = load_config(CFG, tasks=TASKS, opts=LN_FLAGS)
    pcfg = port_config.from_config(cfg)
    assert pcfg.use_pallas_ln and not pcfg.use_pallas_adapter
    assert pcfg == port_config.tiny_448_r64_pertask(use_pallas_adapter=False)
    assert pcfg == port_config.tiny_448_r64_pertask(use_pallas_ln=True,
                                                    use_pallas_adapter=False)


@pytest.mark.parametrize("flag,ln,extra", [
    ("TPU.USE_PALLAS_ADAPTER", "True", ["MODEL.MTLORA.PROJ_ENABLED",
                                        "False"]),
    ("TPU.USE_PALLAS_ADAPTER", "False", []),
], ids=["TPU.USE_PALLAS_ADAPTER-ln", "TPU.USE_PALLAS_ADAPTER"])
def test_unported_kernel_flags_raise(flag, ln, extra):
    """The routes not ported raise: the adapter kernels with the LN route
    off, and with it on but without proj task adapters (fc1's task
    projection from the shared LN output). The adapter route itself (LN
    on, proj on) no longer raises, nor the LoRA GEMM kernel
    (:func:`test_lora_gemm_flag_at_224_equals_preset`)."""
    opts = ["TPU.USE_PALLAS_ADAPTER", "False", "TPU.USE_PALLAS_LN", ln,
            flag, "True"] + extra
    cfg = load_config(CFG, tasks=TASKS, opts=opts)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_config.from_config(cfg)


@pytest.mark.parametrize("opts,item", [
    (["MODEL.TYPE", "swinv2"], "Queue 1, item 10"),
    (["TRAIN.USE_CHECKPOINT", "True"], "Queue 1, item 10"),
    (["TPU.REMAT", "True"], "Queue 1, item 10"),
    (["MODEL.MTLORA.FC1_ENABLED", "False"], "Queue 1, item 9"),
    (["MODEL.MTLORA.R_PER_TASK.shared", "[8]"], "Queue 1, item 9"),
    (["MODEL.MTLORA.R_PER_TASK.shared", "[24]"], "Queue 1, item 9"),
    (["MODEL.MTLORA.R_PER_TASK.shared", "[128]", "TPU.USE_PALLAS_ADAPTER",
      "False"], "Queue 1, item 9"),
    (["MODEL.MTLORA.R_PER_TASK.semseg", "[8]"], "Queue 1, item 9"),
    ("tasks", "Queue 1, item 9"),
], ids=["MODEL.TYPE", "TRAIN.USE_CHECKPOINT", "TPU.REMAT",
        "TPU.USE_PALLAS_LN-fc1-off", "shared-rank-8", "shared-rank-24",
        "shared-rank-128-ln-route", "task-rank-8-adapter-route",
        "five-tasks-adapter-route"])
def test_config_keys_the_port_does_not_run_raise(opts, item):
    """Keys the JAX package acts on and the port does not run raise and
    name their ROADMAP item: a model type
    the reference does not build, rematerialization by either key, the
    LN route with an adapter off (kernel 2's other modes), a shared rank
    that kernels 2, 2b, 2-tail and 2b-tail do not take on the LN routes
    (a multiple of 16 up to 64), and on the adapter route a per-task
    rank other than 4 or more than 4 tasks (kernels 5, 5b, 6 and 6b)."""
    if opts == "tasks":
        cfg = load_config(CFG, tasks=TASKS + ["edge"], opts=[])
        assert len(cfg.TASKS) == 5 and cfg.TPU.USE_PALLAS_ADAPTER
    else:
        cfg = load_config(CFG, tasks=TASKS, opts=opts)
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md, {item}\\)"):
        port_config.from_config(cfg)


def test_lora_gemm_flag_at_224_equals_preset(monkeypatch):
    """``TPU.USE_PALLAS_LORA_GEMM`` is read, not refused: the YAML at the
    JAX package's default size, 224, with the flag on is the preset with
    ``use_pallas_lora_gemm`` at 224 (``MTLORA_ATTN_DENSE`` unset)."""
    import dataclasses
    monkeypatch.delenv("MTLORA_ATTN_DENSE", raising=False)
    cfg = load_config(CFG, tasks=TASKS, img_size=224,
                      opts=["TPU.USE_PALLAS_LORA_GEMM", "True"])
    pcfg = port_config.from_config(cfg)
    assert pcfg.use_pallas_lora_gemm and not pcfg.attn_dense
    assert pcfg == dataclasses.replace(
        port_config.tiny_448_r64_pertask(use_pallas_lora_gemm=True),
        img_size=224)


HYGIENE = r"""
import importlib, pkgutil, sys
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "flax", "yaml", "cv2", "PIL"):
        del sys.modules[name]
for name in ("jax", "jaxlib", "flax", "yaml", "cv2", "PIL"):
    sys.modules[name] = None
import torch
torch.set_num_threads(2)
import mtlora_tpu_torch
for m in pkgutil.walk_packages(mtlora_tpu_torch.__path__,
                               "mtlora_tpu_torch."):
    importlib.import_module(m.name)
from mtlora_tpu_torch.config import ModelConfig, StageLoRA
from mtlora_tpu_torch.serve import predict, random_model, synthetic_images
st = StageLoRA(8, (4, 4), 4.0, (4.0, 4.0))
cfg = ModelConfig(tasks=("semseg", "sal"), num_outputs=(21, 1), img_size=64,
                  stages=(st,) * 4, embed_dim=24, depths=(2, 2, 2, 2),
                  num_heads=(2, 2, 2, 2), window_size=4,
                  compute_dtype="float32")
model = random_model(cfg, 0, "cpu")
out = predict(model, synthetic_images(1, 64, 0))
assert out["semseg"].shape == (1, 64, 64, 21)
assert all(bool(torch.isfinite(v).all()) for v in out.values())
from mtlora_tpu_torch.train.optim import (TrainConfig, build_optimizer,
                                          build_schedule)
from mtlora_tpu_torch.train.step import synthetic_batch, train_step
tcfg = TrainConfig(batch_size=2)
batch = synthetic_batch(2, 64, 0, "cpu")
metrics = train_step(model, build_optimizer(model, tcfg),
                     build_schedule(tcfg, 10), batch,
                     torch.Generator().manual_seed(0))
assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics
import dataclasses
from mtlora_tpu_torch.ops import counters
cfg_ln = dataclasses.replace(cfg, use_pallas_ln=True)
model = random_model(cfg_ln, 0, "cpu")
out = predict(model, synthetic_images(1, 64, 0))
assert all(bool(torch.isfinite(v).all()) for v in out.values())
metrics = train_step(model, build_optimizer(model, tcfg),
                     build_schedule(tcfg, 10), batch,
                     torch.Generator().manual_seed(0))
assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics
cfg_ad = dataclasses.replace(cfg, use_pallas_ln=True, use_pallas_adapter=True)
model = random_model(cfg_ad, 0, "cpu")
out = predict(model, synthetic_images(1, 64, 0))
assert all(bool(torch.isfinite(v).all()) for v in out.values())
metrics = train_step(model, build_optimizer(model, tcfg),
                     build_schedule(tcfg, 10), batch,
                     torch.Generator().manual_seed(0))
assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics
for flags in (dict(use_pallas_lora_gemm=True),
              dict(use_pallas_lora_gemm=True, use_pallas_ln=True,
                   use_pallas_adapter=True)):
    model = random_model(dataclasses.replace(cfg, **flags), 0, "cpu")
    out = predict(model, synthetic_images(1, 64, 0))
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    metrics = train_step(model, build_optimizer(model, tcfg),
                         build_schedule(tcfg, 10), batch,
                         torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics
from mtlora_tpu_torch.ops.adapter_mlp import FWD_PROBES, adapter_mid_probe
from mtlora_tpu_torch.ops.quad_attn import quad_attention
from mtlora_tpu_torch.ops.window_attn import (PROBE_MODES,
                                               window_attention_probe)
from mtlora_tpu_torch.tools import adapter_variants, attn_probe
g = torch.Generator().manual_seed(0)
qkv = torch.randn(2, 49, 3 * 64, generator=g)
for mode in PROBE_MODES:
    out = window_attention_probe(qkv, 2, torch.zeros(2, 49, 49), None, 0.2,
                                 mode)
    assert out.shape == (2, 49, 64) and bool(torch.isfinite(out).all())
for name, (_, _, kind) in FWD_PROBES.items():
    shape = (4, 64, 4) if kind in ("vpu1", "vpu12") else (4, 4, 64)
    out = adapter_mid_probe(torch.randn(*shape, generator=g),
                            torch.randn(64, 64, generator=g),
                            torch.randn(4, 4, 64, generator=g),
                            torch.randn(4, 4, 64, generator=g), (1.0,) * 4,
                            name)
    assert out.shape == shape and bool(torch.isfinite(out).all())
out = quad_attention(torch.randn(1, 2, 392, 128, generator=g),
                     torch.randn(1, 2, 2, 98, 128, generator=g),
                     torch.zeros(2, 392, 98))
assert out.shape == (1, 392, 64)
for tool in (attn_probe, adapter_variants):   # the entry points need a card
    try:
        tool.main([])
    except SystemExit as e:
        assert e.code not in (0, None), e.code
    else:
        raise AssertionError(f"{tool.__name__} ran without a CUDA device")
from mtlora_tpu_torch.evaluation.meters import PerformanceMeter
from mtlora_tpu_torch.train.loop import validate
from mtlora_tpu_torch.train.step import synthetic_eval_batches
from mtlora_tpu_torch import serve
for dtype in ("float32", "bfloat16"):
    batches = synthetic_eval_batches(2, 2, 64, 0, "cpu")
    scores, losses = validate(model, batches, cfg.tasks, "PASCALContext",
                              dtype)
    assert set(scores) == set(losses) == set(cfg.tasks), scores
    assert all(v == v for v in losses.values()), losses
assert isinstance(PerformanceMeter(cfg.tasks).meters["sal"].init(), dict)
try:
    serve.main(["--validate", "1"])
except SystemExit as e:
    assert e.code not in (0, None), e.code
else:
    raise AssertionError("serve --validate ran without a CUDA device")
from mtlora_tpu_torch.data.loader import DataLoader
from mtlora_tpu_torch.data.pascal import read_image
from mtlora_tpu_torch.data.synthetic import SyntheticMTL
from mtlora_tpu_torch.data.task_config import get_tasks_config
from mtlora_tpu_torch.data.transforms import get_transformations
from mtlora_tpu_torch.train import __main__ as train_main
tc, _ = get_tasks_config("PASCALContext", list(cfg.tasks), 32)
ds = SyntheticMTL(cfg.tasks, 32, length=4,
                  transform=get_transformations("PASCALContext", tc)[0])
batches = list(DataLoader(ds, 2, num_workers=2).iter_epoch(0))
assert [tuple(b["image"].shape) for b in batches] == [(2, 32, 32, 3)] * 2
assert batches[0]["sal"].shape == (2, 32, 32, 1)
try:
    read_image("no-such-image.jpg")
except ImportError as e:
    assert "PIL" in str(e), e
else:
    raise AssertionError("read_image ran without PIL")
import tempfile
from mtlora_tpu_torch.ckpt.checkpoint import (load_checkpoint,
                                              save_checkpoint)
from mtlora_tpu_torch.models.init import init_weights_
init_weights_(model, torch.Generator().manual_seed(0))
with tempfile.TemporaryDirectory() as tmp:
    opt = build_optimizer(model, tcfg)
    path = save_checkpoint(tmp, 0, model, opt, torch.Generator())
    assert load_checkpoint(path, model, opt)["epoch"] == 0
for main, args in ((train_main.main, ["--synthetic-data"]),
                   (train_main.main, ["--pretrained", "x.pth"]),
                   (train_main.main, ["--resume", "x.pth"]),
                   (serve.main, ["--resume", "x.pth"]),
                   (serve.main, ["--validate", "1", "--pascal", "."])):
    try:
        main(args)
    except SystemExit as e:
        assert e.code not in (0, None), e.code
    else:
        raise AssertionError(f"{args} ran without a CUDA device")
from mtlora_tpu_torch.main import cli
cli_args = ["--cfg", "configs/mtlora/tiny_448/"
            "mtlora_tiny_448_r64_scale4_pertask.yaml",
            "--tasks", "semseg,sal", "--synthetic-data", "--batch-size", "4",
            "--eval", "--disable_wandb", "--opts", "DATA.IMG_SIZE", "64",
            "MODEL.SWIN.DEPTHS", "[2, 2, 2, 2]", "MODEL.SWIN.EMBED_DIM", "24",
            "MODEL.SWIN.NUM_HEADS", "[2, 2, 2, 2]",
            "MODEL.SWIN.WINDOW_SIZE", "4", "AMP_ENABLE", "False",
            "DATA.NUM_WORKERS", "0"]
with tempfile.TemporaryDirectory() as tmp:
    result = cli(["--device", "cpu", "--output", tmp] + cli_args)
    assert set(result["scores"]) == {"semseg", "sal"}, result
    try:
        cli(["--output", tmp] + cli_args)
    except SystemExit as e:
        assert e.code not in (0, None), e.code
    else:
        raise AssertionError("the CLI ran without a CUDA device")
assert not any(counters.read().values())   # the CPU route counts nothing
assert not any(k.split(".")[0] == "mtlora_tpu" for k in sys.modules)
print("HYGIENE-OK")
"""


def test_port_imports_no_jax_flax_yaml_cv2():
    """Every port module imports, the probe entry points of
    ``mtlora_tpu_torch.tools`` among them, and a toy forward and a toy
    training step run on the three routes (LN outside the GEMMs; kernels
    2, 3, 4; and the adapter route, kernels 2 to 6), and with kernel 8 on
    the first and the last; the probes' plain versions run, and each
    probe entry point exits non-zero without a CUDA device; the eval path
    (``evaluation.meters``, ``train.loop.validate`` on both eval dtypes)
    runs and ``serve --validate`` exits non-zero without a CUDA device;
    the data pipeline (``mtlora_tpu_torch.data``) runs the synthetic set
    through the train transforms and a 2-worker loader, the PASCAL reader
    raises an error naming PIL, and ``train --synthetic-data`` and ``serve
    --validate --pascal`` exit non-zero without a CUDA device; the init
    (``models.init``) and a checkpoint's save and load (``ckpt``) run, and
    ``train --pretrained``, ``train --resume`` and ``serve --resume`` exit
    non-zero without a CUDA device; the CLI (``mtlora_tpu_torch.main``)
    reads the flagship YAML and scores a toy model with ``--device cpu
    --eval``, and exits non-zero without ``--device cpu``; all with jax,
    flax, yaml, cv2 and PIL made unimportable."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.run([sys.executable, "-c", HYGIENE], env=env,
                          cwd=os.path.abspath(ROOT), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "HYGIENE-OK" in proc.stdout
