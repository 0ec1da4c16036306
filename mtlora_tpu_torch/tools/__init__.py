"""Probe entry points of the port, run on the card:

    python -m mtlora_tpu_torch.tools.attn_probe
    python -m mtlora_tpu_torch.tools.adapter_variants

Counterparts of the JAX package's TPU probes ``tools/attn_probe.py``,
``tools/attn_variants.py`` and ``tools/adapter_variants.py``: each times
variants of a kernel with a part switched, on seeded random tensors at the
flagship's stage shapes, and prints one JSON line per variant. Shared
here: the card's name and power limit, and the timing of a kernel.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def median_ms(fn, reps: int = 20, rounds: int = 3, warmup: int = 3) -> float:
    """ms per call: CUDA events around ``reps`` calls back to back (so the
    host enqueues ahead of the card), the median of ``rounds``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def timed(fields: dict, kernel, plain, reps: int, rounds: int, card: str,
          counter) -> dict:
    """One variant's JSON line, printed and returned: ``fields``, kernel
    and plain ms (one warm-up call each), the kernel's launches in the run
    (``counter()`` before and after) and the card."""
    before = counter()
    t_k = median_ms(kernel, reps, rounds, warmup=1)
    launches = counter() - before
    t_p = median_ms(plain, reps, rounds, warmup=1)
    rec = {**fields, "kernel_ms": t_k, "plain_ms": t_p, "launches": launches,
           "card": card}
    print(json.dumps(rec), flush=True)
    return rec


def require_cuda(name: str):
    if not torch.cuda.is_available():
        raise SystemExit(f"{name}: no CUDA device")


def run_in_trees(script: Path, root: Path, against, args=()) -> None:
    """``python script --worker NAME *args`` in a process of its own per
    tree, with that tree's package on the path, in the order this checkout
    (``root``, named "this"), each of ``against`` (the root of another
    checkout, named by its directory), this checkout again; exits on a
    worker's failure."""
    trees = [(Path(d).name, Path(d).resolve()) for d in against]
    for name, tree in [("this", root), *trees, ("this", root)]:
        proc = subprocess.run(
            [sys.executable, str(script), "--worker", name, *args], cwd=tree,
            env=dict(os.environ, PYTHONPATH=str(tree)))
        if proc.returncode != 0:
            raise SystemExit(f"{name}: exit code {proc.returncode}")
