"""The port's CLI in two processes (gloo, ``--device cpu``) against one
process at the same global batch, the analogue of
tests/test_cli_multiprocess.py:133-173.

The toy model of tests/test_torch_port_cli.py (64 px, depths
[2, 2, 2, 2], embed 24, window 4, fp32, the YAML's adapter route through
the kernels' plain versions) at global batch 8: each rank loads 4 rows of
every batch. Both runs start from one ``.pth`` of the port's init.

  - ``--eval`` over 13 validation samples (the second global batch padded:
    rank 0 scores 4 real rows of it, rank 1 one): both ranks' scores equal
    the single process's within 1e-6 relative; the meters' sums are summed
    over the ranks, so the two ranks' are the same numbers.
  - ``--epochs 1`` (8 SGD updates, dropout and drop-path off): the two
    ranks' trainables are identical bit for bit (the CLI checks it before
    it saves, and fails otherwise); each step's loss and grad norm and
    rank 0's checkpoint agree with the single process's. The first step's
    grad norm is the check of the global gradient's scale (an average
    where a sum belongs halves it, which Adam's normalised step and the
    clip would hide in the weights). SGD, clipped at every step, keeps
    the weights' change linear in the clipped gradient, so a clip taken
    per rank before the sum shows in the weights. The LR scales by batch
    * world / 512, so the single process runs at twice the base and
    minimum LRs.
"""

import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mtlora_tpu_torch.ckpt.convert import to_reference_state_dict
from mtlora_tpu_torch.config import load_config
from mtlora_tpu_torch.config import from_config
from mtlora_tpu_torch.serve import initial_model

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
        "MODEL.DROP_PATH_RATE", "0.0", "TRAIN.OPTIMIZER.NAME", "sgd",
        "TRAIN.WARMUP_EPOCHS", "0"]
BASE_LR = 0.01          # 3.125e-4 at batch 8 and world 2
LR_OPTS = {1: ["TRAIN.BASE_LR", str(2 * BASE_LR), "TRAIN.MIN_LR", "1e-5"],
           2: ["TRAIN.BASE_LR", str(BASE_LR), "TRAIN.MIN_LR", "5e-6"]}
SCORE_REL = 1e-6
CHANGE_REL = 2e-2
NORMALS_CHANGE_REL = 0.1


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start_pth(path):
    cfg = load_config(CFG, tasks=TASKS.split(","), img_size=64,
                      opts=OPTS[2:])
    model = initial_model(from_config(cfg), 0, "cpu")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          to_reference_state_dict(model).items()}}, path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One and two processes, --eval and --epochs 1, all started together:
    {(mode, world): output dir}."""
    root = tmp_path_factory.mktemp("ddp")
    pth = str(root / "start.pth")
    _start_pth(pth)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs, outs = [], {}
    for mode, flags, extra_env in (
            ("eval", ["--eval"], {"MTLORA_SYNTH_VAL_LEN": "13"}),
            ("train", ["--epochs", "1"], {})):
        for world in (1, 2):
            out = str(root / f"{mode}_{world}")
            outs[mode, world] = os.path.join(out, NAME, "default")
            coord = f"127.0.0.1:{_free_port()}"
            for rank in range(world):
                dist = (["--coordinator", coord, "--num-processes", "2",
                         "--process-id", str(rank)] if world > 1 else [])
                cmd = [sys.executable, "-m", "mtlora_tpu_torch",
                       "--device", "cpu", "--cfg", CFG, "--tasks", TASKS,
                       "--synthetic-data", "--batch-size", "8",
                       "--disable_wandb", "--output", out, "--resume", pth,
                       *flags, *dist, "--opts", *OPTS, *LR_OPTS[world]]
                procs.append(((mode, world, rank), subprocess.Popen(
                    cmd, env=dict(env, **extra_env), cwd=ROOT,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
    for key, p in procs:
        try:
            stdout, stderr = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
        assert p.returncode == 0, (key, stdout[-2000:], stderr[-3000:])
    return outs


def _scores(out, rank=0):
    with open(os.path.join(out, f"val_scores_r{rank}.json")) as f:
        scores = json.load(f)
    return {f"{t}/{k}": float(v) for t, res in scores.items()
            for k, v in res.items() if isinstance(v, (int, float))}


def test_eval_two_processes_match_one(runs):
    """Ragged val set (13 samples, global batch 8): both ranks' scores
    equal, and equal to the single process's within 1e-6 relative."""
    ref = _scores(runs["eval", 1])
    s0, s1 = _scores(runs["eval", 2], 0), _scores(runs["eval", 2], 1)
    assert len(ref) >= 10 and set(s0) == set(s1) == set(ref)
    assert s0 == s1
    for k in ref:
        np.testing.assert_allclose(s0[k], ref[k], rtol=SCORE_REL,
                                   atol=1e-12, err_msg=k)


def test_train_ranks_identical(runs):
    """Each rank logged the replica check (bit-identical trainables before
    the save), wrote its log and scores; rank 0 alone wrote the
    checkpoint; both ranks' scores are the same numbers."""
    out = runs["train", 2]
    for rank in (0, 1):
        with open(os.path.join(out, f"log_rank{rank}.txt")) as f:
            assert ("epoch 0: the 2 ranks' trainable parameters are "
                    "identical") in f.read()
    assert _scores(out, 0) == _scores(out, 1)
    assert sorted(f for f in os.listdir(out) if f.endswith(".pth")) == [
        "ckpt_epoch_0.pth"]


def _trainables(out):
    ckpt = torch.load(os.path.join(out, "ckpt_epoch_0.pth"),
                      map_location="cpu", weights_only=True)
    return ckpt, {k: v.float().numpy() for k, v in ckpt["model"].items()}


def _logged(out):
    """Each step's loss and grad norm, and the epoch's means, from rank
    0's log."""
    with open(os.path.join(out, "log_rank0.txt")) as f:
        text = f.read()
    steps = [(float(loss), float(norm)) for loss, norm in re.findall(
        r"\[\d+/8\] eta \S+ lr \S+ loss ([-\d.]+) \(\S+\) "
        r"grad_norm ([-\d.]+)", text)]
    m = re.search(r"averages over 8 steps: loss ([-\d.e]+) "
                  r"grad_norm ([-\d.e+]+)", text)
    return steps, (float(m.group(1)), float(m.group(2)))


def test_train_two_processes_match_one(runs):
    """8 SGD updates at LR 3.125e-4, clipped at 5 (every step's norm is
    above it), from one start:

      - the first step's grad norm within 1e-4 relative (both runs see the
        same weights and rows, so only the order of summation differs; an
        average where a sum belongs halves it). Later steps' within 1e-2
        (measured 2.4e-3): the heads' BN variance, E[h^2] - mu^2 as the
        JAX package takes it, turns the order of summation into gradient
        noise that the steps carry on;
      - every step's loss and the epoch's mean loss within 1e-4 relative;
      - every trainable's change within CHANGE_REL of its largest change
        in the single run, or 4 fp32 ulps of its largest weight (the
        rounding of a change read as a difference of weights); the normals
        task's tensors within NORMALS_CHANGE_REL (measured 3.3e-2, its
        adapters: the ill-conditioned loss of
        tests/test_torch_port_train.py), the others within CHANGE_REL
        (measured 5.2e-3). A clip taken per rank, before the sum, would
        change every step by up to 2x;
      - frozen weights bit-unchanged in both; the optimizer at the same
        update and LR."""
    n = 8
    start = torch.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(runs["train", 1]))), "start.pth"),
        map_location="cpu", weights_only=True)["model"]
    c1, w1 = _trainables(runs["train", 1])
    c2, w2 = _trainables(runs["train", 2])
    assert [g["updates"] for g in c1["optimizer"]["param_groups"]] == \
        [g["updates"] for g in c2["optimizer"]["param_groups"]] == [n, n]
    np.testing.assert_allclose(
        [g["lr"] for g in c1["optimizer"]["param_groups"]],
        [g["lr"] for g in c2["optimizer"]["param_groups"]], rtol=1e-12)
    (steps1, (loss1, _)), (steps2, (loss2, _)) = (
        _logged(runs["train", w]) for w in (1, 2))
    assert len(steps1) == len(steps2) == n
    (l1, g1), (l2, g2) = np.array(steps1).T, np.array(steps2).T
    assert (g1 > 5).all()
    np.testing.assert_allclose(g2[0], g1[0], rtol=1e-4)
    np.testing.assert_allclose(g2, g1, rtol=1e-2)
    np.testing.assert_allclose(l2, l1, rtol=1e-4)
    np.testing.assert_allclose(loss2, loss1, rtol=1e-4)
    moved = 0
    for k, s in start.items():
        s = s.float().numpy()
        d1, d2 = w1[k] - s, w2[k] - s
        if not d1.any():
            assert not d2.any(), k
            continue
        moved += 1
        rel = NORMALS_CHANGE_REL if ".normals" in k else CHANGE_REL
        ulps = 4 * 2.0 ** -23 * np.abs(s).max()
        err = np.abs(d2 - d1).max()
        assert err <= max(rel * np.abs(d1).max(), ulps), (
            k, err / np.abs(d1).max())
    assert moved > 0
