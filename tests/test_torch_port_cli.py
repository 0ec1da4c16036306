"""The port's CLI, ``python -m mtlora_tpu_torch --device cpu``, against the
JAX package's ``python main.py``, both started from one reference-layout
``.pth`` with ``--resume``.

The toy size of tests/test_cli_multiprocess.py:27-41 (64 px, depths
[2, 2, 2, 2], embed 24, window 4, fp32), the synthetic sets of
``main.py:163-189`` at batch 8 (8 training steps, 2 validation batches),
no loader workers, a host read every step (``PRINT_FREQ 1``), dropout
and drop-path off, AdamW's eps at 1e-6 (as in
tests/test_torch_port_train.py) and the LR from the first update. The
JAX CLI runs its transforms with the native image ops
(``MTLORA_NATIVE_IMAGE_OPS=1``), so both see the same batches
(tests/test_torch_port_data_slice.py), and its model on the CPU path
without Pallas kernels; the port's runs the YAML's adapter route through
the kernels' plain versions. The reference ``.pth`` holds the JAX init
(``model.init`` at seed 0) in the reference layout
(``ckpt/convert.py:to_reference_state_dict``). The four CLI runs start
together, two of them the JAX package's.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlora_tpu.config import load_config
from mtlora_tpu.models.mtl import build_mtl_model as jax_build
from mtlora_tpu_torch import config as port_config
from mtlora_tpu_torch.ckpt.convert import (
    from_jax_variables,
    to_reference_state_dict,
)
from mtlora_tpu_torch.main import cli
from mtlora_tpu_torch.models.mtl import build_mtl_model
from mtlora_tpu_torch.utils import yaml_subset

torch.set_num_threads(2)
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CFG = os.path.join(ROOT, "configs/mtlora/tiny_448/"
                   "mtlora_tiny_448_r64_scale4_pertask.yaml")
NAME = "mtlora_tiny_448_r64_scale4_pertask"
TASKS = "semseg,normals,sal,human_parts"
OPTS = ["DATA.IMG_SIZE", "64", "MODEL.SWIN.DEPTHS", "[2, 2, 2, 2]",
        "MODEL.SWIN.EMBED_DIM", "24", "MODEL.SWIN.NUM_HEADS", "[2, 2, 2, 2]",
        "MODEL.SWIN.WINDOW_SIZE", "4", "AMP_ENABLE", "False",
        "DATA.NUM_WORKERS", "0", "PRINT_FREQ", "1",
        "MODEL.MTLORA.DROPOUT", "[0.0, 0.0, 0.0, 0.0]",
        "MODEL.DROP_PATH_RATE", "0.0", "TRAIN.OPTIMIZER.EPS", "1e-6",
        "TRAIN.WARMUP_EPOCHS", "0", "TRAIN.BASE_LR", "0.0256"]
# every eval score, from the same weights: both evaluate in fp32, and a
# score moves only where a pixel's argmax or threshold test flips
EVAL_REL = 1e-4
# after one epoch (8 AdamW updates at lr 4e-4 from the same weights) the
# two runs' weights part by round-off amplified through Adam
# (tests/test_torch_port_train.py bounds the per-update change at lr per
# element; the step losses agree to 2e-4 here): the epoch loss within
# 1e-3 relative; each score within 1e-2 absolute (IoUs and F-scores as
# fractions, the normals' mean and RMS angle in degrees; measured 5.3e-4),
# but the normals' shares of pixels within 11.25, 22.5 and 30 degrees, in
# percent, within 0.25 (160 of the 65,536 pixels; measured 0.11): after 8
# updates the normals head is near random (mean angle 90 degrees), so
# those few-percent shares count pixels that a small rotation of the
# predicted vectors moves across the thresholds
TRAIN_LOSS_REL = 1e-3
TRAIN_SCORE_ABS = 1e-2
TRAIN_SHARE_ABS = 0.25


def _args(out, pth, mode):
    return ["--cfg", CFG, "--tasks", TASKS, "--synthetic-data",
            "--batch-size", "8", "--disable_wandb", "--output", out,
            "--resume", pth, *mode, "--opts", *OPTS]


def _reference_pth(path):
    """The JAX init of the toy model as a reference-layout ``.pth``."""
    cfg = load_config(CFG, tasks=TASKS.split(","), img_size=64,
                      opts=OPTS[2:])
    variables = jax.jit(jax_build(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3), jnp.float32))
    model = build_mtl_model(port_config.from_config(cfg), device="cpu")
    model.load_state_dict(
        from_jax_variables(jax.device_get(variables), cfg.TASKS),
        strict=True)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          to_reference_state_dict(model).items()}}, path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four runs, started together: {(cli, mode): output dir}."""
    root = tmp_path_factory.mktemp("cli")
    pth = str(root / "ref.pth")
    _reference_pth(pth)
    base = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    # one JAX device: main.py scales the LR by its mesh's devices, as the
    # port by its processes (tests/conftest.py sets 8 for the JAX tests)
    flags = " ".join(f for f in os.environ.get("XLA_FLAGS", "").split()
                     if "xla_force_host_platform_device_count" not in f)
    envs = {"jax": dict(base, JAX_PLATFORMS="cpu", MTLORA_PLATFORM="cpu",
                        MTLORA_NATIVE_IMAGE_OPS="1",
                        XLA_FLAGS=flags
                        + " --xla_force_host_platform_device_count=1"),
            "port": base}
    cmds = {"jax": [sys.executable, os.path.join(ROOT, "main.py")],
            "port": [sys.executable, "-m", "mtlora_tpu_torch", "--device",
                     "cpu"]}
    modes = {"eval": ["--eval"], "train": ["--epochs", "1"]}
    procs, outs = {}, {}
    for who in cmds:
        for mode, flags in modes.items():
            out = str(root / f"{who}_{mode}")
            outs[who, mode] = os.path.join(out, NAME, "default")
            # the JAX training run is the longest: the others yield to it
            nice = (["nice", "-n", "10"] if shutil.which("nice")
                    and (who, mode) != ("jax", "train") else [])
            procs[who, mode] = subprocess.Popen(
                [*nice, *cmds[who], *_args(out, pth, flags)],
                env=envs[who], cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
    for key, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, (key, stdout[-2000:], stderr[-3000:])
    outs["pth"] = pth
    return outs


def _scores(out):
    with open(os.path.join(out, "val_scores_r0.json")) as f:
        scores = json.load(f)
    return {f"{t}/{k}": float(v) for t, res in scores.items()
            for k, v in res.items() if isinstance(v, (int, float))}


def _step_losses(out):
    """(step loss, running mean) of each ``Train:`` log line."""
    with open(os.path.join(out, "log_rank0.txt")) as f:
        return [(float(a), float(b)) for a, b in re.findall(
            r"Train: .* loss ([-\d.]+) \(([-\d.]+)\)", f.read())]


def test_eval_matches_main_py(runs):
    """``--eval`` from the same weights: every score within 1e-4
    relative of ``main.py``'s."""
    got, want = _scores(runs["port", "eval"]), _scores(runs["jax", "eval"])
    assert set(got) == set(want) and len(got) >= 10
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=EVAL_REL,
                                   atol=1e-12, err_msg=k)


def test_one_epoch_matches_main_py(runs):
    """``--epochs 1``: the same 8 steps logged; the epoch loss (the mean
    of every step's, both logged at PRINT_FREQ 1 to 4 decimals) within
    1e-3 relative, and each step's; the final validate's scores within
    the bounds above."""
    got, want = (_step_losses(runs["port", "train"]),
                 _step_losses(runs["jax", "train"]))
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got[-1][1], want[-1][1], rtol=TRAIN_LOSS_REL)
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=TRAIN_LOSS_REL)
    gs, ws = _scores(runs["port", "train"]), _scores(runs["jax", "train"])
    assert set(gs) == set(ws)
    for k in ws:
        share = k in ("normals/11.25", "normals/22.5", "normals/30")
        np.testing.assert_allclose(
            gs[k], ws[k], rtol=0, err_msg=k,
            atol=TRAIN_SHARE_ABS if share else TRAIN_SCORE_ABS)
    # the training moved the scores
    assert gs != _scores(runs["port", "eval"])


def test_epoch_average_is_the_mean_of_its_steps(runs):
    """The epoch line's loss, summed on the device over every step, is the
    mean of the 8 steps' logged losses (to their 4 decimals)."""
    with open(os.path.join(runs["port", "train"], "log_rank0.txt")) as f:
        epoch = float(re.search(r"averages over 8 steps: loss ([-\d.]+)",
                                f.read()).group(1))
    steps = [a for a, _ in _step_losses(runs["port", "train"])]
    assert abs(epoch - np.mean(steps)) <= 5e-5 + 1e-6 * abs(epoch)


def test_run_files_as_main_py(runs):
    """The run's files under ``OUTPUT/<MODEL.NAME>/<TAG>``: the same
    ``config.json`` as ``main.py`` writes, a log, the scores, one
    checkpoint (``SAVE_FREQ``: epoch 0 is the last), and ``config.yaml``,
    which the port's reader reads back equal to the run's config."""
    out, jout = runs["port", "train"], runs["jax", "train"]
    with open(os.path.join(out, "config.json")) as f:
        got = json.load(f)
    with open(os.path.join(jout, "config.json")) as f:
        want = json.load(f)
    assert got.pop("OUTPUT") == out and want.pop("OUTPUT") == jout
    assert got == want
    got["OUTPUT"] = out
    assert sorted(os.listdir(out)) == [
        "ckpt_epoch_0.pth", "config.json", "config.yaml", "log_rank0.txt",
        "val_scores_r0.json"]
    dumped = yaml_subset.load(os.path.join(out, "config.yaml"))
    assert dumped == json.loads(json.dumps(got))


def test_eval_of_the_checkpoint_repeats_the_final_scores(runs, tmp_path):
    """``--eval --resume ckpt_epoch_0.pth`` in this process: the scores of
    the training run's final validate, exactly (the same weights and
    statistics, the same fp32 clone, on the CPU)."""
    ckpt = os.path.join(runs["port", "train"], "ckpt_epoch_0.pth")
    argv = ["--device", "cpu", *_args(str(tmp_path), ckpt, ["--eval"])]
    result = cli(argv)
    assert result["start_epoch"] == 1
    got = {f"{t}/{k}": float(v) for t, res in result["scores"].items()
           for k, v in res.items() if isinstance(v, (int, float))}
    assert got == _scores(runs["port", "train"])


def test_throughput_reports_both_eval_paths(tmp_path):
    """``--throughput`` in this process times the eval forward of both
    eval paths on the first val batch (the host clock on the CPU), as
    ``main.py:265-282`` does, and writes no scores."""
    argv = ["--device", "cpu", "--throughput",
            *_args(str(tmp_path), "", [])]
    argv.remove("--resume")
    argv.remove("")
    result = cli(argv)
    assert set(result["throughput"]) == {"fp32, kernels off",
                                         "fp32 + kernels"}
    assert all(r > 0 for r in result["throughput"].values())
    assert "scores" not in result


def test_without_a_card_exits_nonzero(tmp_path):
    argv = _args(str(tmp_path), "x.pth", ["--eval"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        cli(argv)
    assert e.value.code not in (0, None)


@pytest.mark.parametrize("argv,what", [
    (["--cfg", os.path.join(ROOT, "configs/swin/"
                             "swin_tiny_patch4_window7_448.yaml"),
      "--device", "cpu"], "classification mode"),
    (["--cfg", CFG, "--device", "cpu", "--tasks", TASKS, "--eval",
      "--merged"], "--merged"),
    (["--cfg", CFG, "--device", "cpu", "--tasks", TASKS,
      "--use-checkpoint"], "TRAIN.USE_CHECKPOINT"),
])
def test_refusals_name_their_item(argv, what, tmp_path):
    """What the port does not run is refused before anything starts, with
    the ROADMAP item that ports it."""
    with pytest.raises(NotImplementedError, match=re.escape(what)
                       + r".*ROADMAP\.md, Queue 1, item (9|10)"):
        cli([*argv, "--output", str(tmp_path)])
    assert not os.listdir(tmp_path)
