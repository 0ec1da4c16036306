"""Kernels 2b (the LN + LoRA backward) and 3b (the patch merge's
backward): their device time, kernel by kernel, on the card, at the
stage-tail fc1 sites, the qkv sites or the three patch merges.

    python -m mtlora_tpu_torch.tools.tail_bwd_split [--sites tail|qkv|merge]
        [--against DIR ...]

At the four sites of the batch-32 step (x [32 * 112^2 / 4^s, 96 * 2^s],
rank 64, scale 4, dropout 0.05): ``--sites tail`` (the default) the fc1
sites of the stage-tail mode, O = 4C, with the cotangents of y, p and
dropout(y), through ``ops/ln_lora.py:ln_lora_tail_bwd``; ``--sites qkv``
the qkv sites of y-only mode, O = 3C, through ``ln_lora_bwd``; ``--sites
merge`` the three patch merges of the shared stream (x [32, (112 /
2^s)^2, 96 * 2^s] gathered 2x2 to [M, K = 4C] -> O = 2C, s = 0, 1, 2)
through ``merge_ln_bwd``. Operands drawn as ``chip_smoke.py`` draws them:
the ms per call (CUDA events, the median of 3 rounds of 10 calls) and the
device ms per call of every kernel it launches (the row kernel, the
weight-gradient passes, the sums; a ``torch.profiler`` trace of 5 calls);
one JSON line per tree and stage (merge), with the card. Each
``--against`` (the root of another checkout, such as the parent commit
unpacked with ``git archive``) runs the same in a process of its own,
which imports that tree's package, in the order this, others, this.

This file imports only torch and the standard library at the top.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CALLS = 5


def worker(tree: str, sites: str):
    import torch
    from mtlora_tpu_torch.ops import _build, ln_lora
    from mtlora_tpu_torch.tools import card_line, median_ms

    _build.library()
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def uniform(shape, bound):
        return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1)
                * bound).to(torch.bfloat16)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    tail = sites == "tail"
    for s in range(3 if sites == "merge" else 4):
        C = 96 * 2 ** s
        if sites == "merge":
            res = 112 // 2 ** s
            K, O = 4 * C, 2 * C
            x = torch.randn(32, res * res, C, generator=gen,
                            device="cuda").to(torch.bfloat16)
            gamma = (0.9 + 0.2 * torch.rand(K, generator=gen, device="cuda"))
            beta = 0.02 * torch.randn(K, generator=gen, device="cuda")
            gy = torch.randn(32, res * res // 4, O, generator=gen,
                             device="cuda").to(torch.bfloat16)
            args = (x, gamma.to(torch.bfloat16), beta.to(torch.bfloat16),
                    uniform((O, K), K ** -0.5), res, res, gy)
            fn, M = ln_lora.merge_ln_bwd, 32 * (res // 2) ** 2
        else:
            M, O, r = 32 * (112 // 2 ** s) ** 2, (4 if tail else 3) * C, 64
            x = torch.randn(M, C, generator=gen,
                            device="cuda").to(torch.bfloat16)
            gamma = (0.9 + 0.2 * torch.rand(C, generator=gen, device="cuda"))
            beta = 0.02 * torch.randn(C, generator=gen, device="cuda")
            wt, bias = uniform((O, C), C ** -0.5), uniform((O,), 0.02)
            at, bt = uniform((r, C), C ** -0.5), uniform((O, r), r ** -0.5)
            seed = torch.randint(0, 2 ** 31 - 1, (2,), generator=gen,
                                 device="cuda", dtype=torch.int32)
            cots = [torch.randn(M, O, generator=gen, device="cuda")
                    .to(torch.bfloat16) for _ in range(3 if tail else 1)]
            args = (x, gamma.to(torch.bfloat16), beta.to(torch.bfloat16), wt,
                    bias, at, bt, seed, 4.0, 0.05, *cots) + (
                        (True,) if tail else ())
            fn = ln_lora.ln_lora_tail_bwd if tail else ln_lora.ln_lora_bwd
        ms = median_ms(lambda: fn(*args), reps=10)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(CALLS):
                fn(*args)
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.events():
            if str(e.device_type).endswith("CUDA"):
                kernels[e.name] = (kernels.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3 / CALLS)
        print(json.dumps({"tree": tree, "sites": sites, "stage": s, "M": M,
                          "C": C, "O": O, "ms": ms, "kernel_ms": kernels,
                          "card": card}), flush=True)
        del x, args


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sites", choices=("tail", "qkv", "merge"),
                    default="tail")
    ap.add_argument("--against", action="append", default=[],
                    help="root of another checkout (repeatable)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        worker(a.worker, a.sites)
        return
    import torch
    from mtlora_tpu_torch.tools import run_in_trees
    if not torch.cuda.is_available():
        raise SystemExit("tail_bwd_split: no CUDA device")
    run_in_trees(Path(__file__).resolve(), ROOT, a.against,
                 ("--sites", a.sites))


if __name__ == "__main__":
    main()
