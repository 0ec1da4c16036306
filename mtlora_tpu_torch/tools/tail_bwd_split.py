"""Kernels 2b (the LN + LoRA backward), 3b (the patch merge's backward)
and 6b (the per-task merge's backward): their device time, kernel by
kernel, on the card, at the stage-tail fc1 sites, the qkv sites, the
three patch merges or the three task merges.

    python -m mtlora_tpu_torch.tools.tail_bwd_split
        [--sites tail|qkv|merge|task_merge] [--against DIR ...]

At the four sites of the batch-32 step (x [32 * 112^2 / 4^s, 96 * 2^s],
rank 64, scale 4, dropout 0.05): ``--sites tail`` (the default) the fc1
sites of the stage-tail mode, O = 4C, with the cotangents of y, p and
dropout(y), through ``ops/ln_lora.py:ln_lora_tail_bwd``; ``--sites qkv``
the qkv sites of y-only mode, O = 3C, through ``ln_lora_bwd``; ``--sites
merge`` the three patch merges of the shared stream (x [32, (112 /
2^s)^2, 96 * 2^s] gathered 2x2 to [M, K = 4C] -> O = 2C, s = 0, 1, 2)
through ``merge_ln_bwd``; ``--sites task_merge`` the three merges of the
adapter route's factored task streams (T 4, r1 = r2 = 4, base, pre, p2
[32, (112 / 2^s)^2, 96 * 2^s] -> O = 2C, the drop-path coefficients of
the merging block and the stage's task scales), then the coverage shapes
of ``chip_smoke.py:TASK_MERGE_COVERAGE``, through
``ops/task_merge.py:task_merge_bwd``. Operands drawn as ``chip_smoke.py``
draws them:
the ms per call (CUDA events, the median of 3 rounds of 10 calls) and the
device ms per call of every kernel it launches (the row kernel, the
weight-gradient passes, the sums, the wrapper's own copies; a
``torch.profiler`` trace of 5 calls), the same by part (row kernel,
``wgrad``, sums, PyTorch's) and their sum; one JSON line per tree and
stage (merge), with the card. Each
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
# the parts of a backward by a substring of their kernels' names; the
# rest is PyTorch's (the wrappers' operands and copies)
PARTS = (("rows", "_bwd_rows"), ("combine", "_bwd_combine"),
         ("dmid", "_bwd_dmid"), ("wgrad", "wgrad_kernel"),
         ("sums", "sum_groups_kernel"), ("sums", "sum_firsts_kernel"))


def split_of(kernels: dict) -> dict:
    """Device ms by part (:data:`PARTS`, else "torch")."""
    out = {}
    for name, ms in kernels.items():
        part = next((p for p, key in PARTS if key in name), "torch")
        out[part] = out.get(part, 0.0) + ms
    return out


def worker(tree: str, sites: str):
    import torch
    from mtlora_tpu_torch.ops import _build, ln_lora, task_merge
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
    stages = list(range(3 if "merge" in sites else 4))
    if sites == "task_merge":
        stages += [label for label, *_ in TASK_MERGE_COVERAGE]
    for s in stages:
        C = 96 * 2 ** s if isinstance(s, int) else None
        if sites == "task_merge":
            args, M, C = _task_merge_operands(gen, uniform, s)
            fn = task_merge.task_merge_bwd
        elif sites == "merge":
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
                          "C": C, "O": 2 * C if "merge" in sites else O,
                          "ms": ms, "kernel_ms": kernels,
                          "split": split_of(kernels),
                          "device_ms": sum(kernels.values()),
                          "card": card}), flush=True)
        del args


# 6b's coverage shapes after the three merges, as chip_smoke.py's
# TASK_MERGE_COVERAGE: (label, T, batch, res, C) at drop-path rate 0.1 and
# scales 4
TASK_MERGE_COVERAGE = (("path B 14->7", 4, 32, 14, 384),
                       ("swin-b 28->14", 4, 32, 28, 512),
                       ("ragged 28->14", 4, 2, 28, 384),
                       ("T 6 28->14", 6, 32, 28, 384))


def _task_merge_operands(gen, uniform, s):
    """Kernel 6b's operands at merge s of the batch-32 step, drawn as
    ``chip_smoke.py:check_task_merge`` draws them, or at the coverage
    shape labelled s: (args with gy, merged rows of every task, C)."""
    import torch
    from mtlora_tpu_torch.config import tiny_448_r64_pertask
    from mtlora_tpu_torch.models.lora import droppath_coef

    cfg = tiny_448_r64_pertask()
    gcpu = torch.Generator().manual_seed(0)
    if isinstance(s, int):
        res, C, T, B = 112 // 2 ** s, 96 * 2 ** s, len(cfg.tasks), 32
        rate = 0.2 * (sum(cfg.depths[:s + 1]) - 1) / (sum(cfg.depths) - 1)
        sc = cfg.stages[s].task_scales
    else:
        T, B, res, C = next(c[1:] for c in TASK_MERGE_COVERAGE if c[0] == s)
        rate, sc = 0.1, (4.0,) * T
    r, L, K, O = 4, res * res, 4 * C, 2 * C
    base, pre, p2 = (torch.randn(B, L, C, generator=gen, device="cuda")
                     .to(torch.bfloat16) for _ in range(3))
    mid1T, mid2T = ((0.5 * torch.randn(T, r, B * L, generator=gen,
                                       device="cuda")).to(torch.bfloat16)
                    for _ in range(2))
    b1, b2 = (uniform((T, r, C), 0.1) for _ in range(2))
    c1, c2 = (droppath_coef(rate, T, B, gcpu, "cpu").cuda()
              for _ in range(2))
    gamma = (0.9 + 0.2 * torch.rand(K, generator=gen, device="cuda"))
    beta = 0.02 * torch.randn(K, generator=gen, device="cuda")
    gy = torch.randn(T, B, L // 4, O, generator=gen,
                     device="cuda").to(torch.bfloat16)
    args = (base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, sc, sc,
            gamma.to(torch.bfloat16), beta.to(torch.bfloat16),
            uniform((O, K), K ** -0.5), res, res, gy)
    return args, T * B * L // 4, C


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sites", choices=("tail", "qkv", "merge", "task_merge"),
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
