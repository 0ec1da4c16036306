"""Kernel 7b's device time, kernel by kernel, on the card.

    python -m mtlora_tpu_torch.tools.head_bwd_split [--against DIR ...]

At the batch-32 step's head shape (x [32 * 56 * 56, 270], hidden 1080) for
each task width n in {21, 3, 1, 7}, operands drawn as ``chip_smoke.py``
draws them: the ms per call of ``ops/head.py:head_mlp_bwd`` (CUDA events,
the median of 3 rounds of 10 calls) and the device ms per call of every
kernel it launches (a ``torch.profiler`` trace of 5 calls); one JSON line
per tree and width, with the card. Each ``--against`` (the root of another
checkout, such as the parent commit unpacked with ``git archive``) runs
the same in a process of its own, which imports that tree's package, in
the order this, others, this.

This file imports only torch and the standard library at the top.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
WIDTHS = (21, 3, 1, 7)
CALLS = 5


def worker(tree: str):
    import torch
    from mtlora_tpu_torch.ops import _build, head
    from mtlora_tpu_torch.tools import card_line, median_ms

    _build.library()
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    M, C = 32 * 56 * 56, 270
    O = 4 * C
    x = torch.randn(M, C, generator=gen, device="cuda").to(torch.bfloat16)
    ek = ((torch.rand(O, C, generator=gen, device="cuda") * 2 - 1)
          * C ** -0.5).to(torch.bfloat16).t()
    eb = 0.02 * torch.randn(1, O, generator=gen, device="cuda")
    mul = 0.5 + torch.rand(1, O, generator=gen, device="cuda")
    add = 0.1 * torch.randn(1, O, generator=gen, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for n in WIDTHS:
        pk = ((torch.rand(n, O, generator=gen, device="cuda") * 2 - 1)
              * O ** -0.5).to(torch.bfloat16).t()
        pb = 0.02 * torch.randn(1, n, generator=gen, device="cuda")
        gy = (torch.randn(M, n, generator=gen, device="cuda")
              * M ** -0.5).to(torch.bfloat16)
        args = (x, ek, eb, mul, add, pk, pb, gy)
        ms = median_ms(lambda: head.head_mlp_bwd(*args), reps=10)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(CALLS):
                head.head_mlp_bwd(*args)
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.events():
            if str(e.device_type).endswith("CUDA"):
                kernels[e.name] = (kernels.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3 / CALLS)
        print(json.dumps({"tree": tree, "n": n, "M": M, "ms": ms,
                          "kernel_ms": kernels, "card": card}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[],
                    help="root of another checkout (repeatable)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        worker(a.worker)
        return
    import torch
    from mtlora_tpu_torch.tools import run_in_trees
    if not torch.cuda.is_available():
        raise SystemExit("head_bwd_split: no CUDA device")
    run_in_trees(Path(__file__).resolve(), ROOT, a.against)


if __name__ == "__main__":
    main()
