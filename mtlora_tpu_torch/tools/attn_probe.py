"""Window-attention probes on the card: kernel 1's body with a part
switched, and the quad-operand attention kernel.

    python -m mtlora_tpu_torch.tools.attn_probe [--stages s0 s1 s2 s3]
        [--reps 20] [--rounds 3] [--seed 0]

Counterpart of the JAX package's ``tools/attn_probe.py`` (``run`` :64,
modes ``full``, ``nosmax``, ``nodots``; its ``noconcat`` computes kernel
1's function) and ``tools/attn_variants.py`` (``kern_dots_only``,
``kern_softmax_only`` through ``run_variant`` :500, and ``kern_quad_pre``
through ``run_quad_pre`` :464; its other variants compute kernel 1's or
1c's function). Batch 32 at the Swin-T 448 stage shapes, window 7: the
first three modes with and without the shift mask, the other two without;
the probes' inputs (qkv ``0.5 N(0, 1)``, bias ``0.1 N(0, 1)``), drawn
from a seeded generator on the card. Each probe runs per 49-token window
(not on the TPU's pack-2 pairs); quad_pre takes one 392-row block per 8
windows. One JSON line per variant: kernel and plain ms (CUDA events, the
median of ``--rounds`` rounds of ``--reps`` launches), the launches of the
run, the card's name and power limit.
"""

from __future__ import annotations

import argparse

import torch

from mtlora_tpu_torch.ops.attention import shift_attention_mask
from mtlora_tpu_torch.ops.quad_attn import (
    quad_attention,
    quad_attention_plain,
)
from mtlora_tpu_torch.ops.window_attn import (
    PROBE_MODES,
    UNMASKED_MODES,
    window_attention_probe,
    window_attention_probe_plain,
)
from mtlora_tpu_torch.tools import card_line, require_cuda, timed

# (H, W, C, nH) of the four stages at 448 (tools/attn_probe.py:111-116)
STAGES = {"s0": (112, 112, 96, 3), "s1": (56, 56, 192, 6),
          "s2": (28, 28, 384, 12), "s3": (14, 14, 768, 24)}
BATCH = 32
WS = 7
N = WS * WS
CELL = 8      # windows per quad_pre block: 392 rows


def stage_inputs(stage: str, gen: torch.Generator, batch: int = BATCH):
    """qkv ``[batch nW, 49, 3C]`` bf16, bias ``[nH, 49, 49]`` and the shift
    mask ``[nW, 49, 49]`` (fp32), nH and the scale of a stage."""
    H, W, C, nH = STAGES[stage]
    nw = (H // WS) * (W // WS)
    qkv = (0.5 * torch.randn(batch * nw, N, 3 * C, generator=gen,
                             device="cuda")).to(torch.bfloat16)
    bias = 0.1 * torch.randn(nH, N, N, generator=gen, device="cuda")
    mask = torch.from_numpy(shift_attention_mask(H, W, WS, WS // 2)).cuda()
    return qkv, bias, mask, nH, (C // nH) ** -0.5


def quad_inputs(stage: str, gen: torch.Generator, batch: int = BATCH):
    """qb ``[nq, nH, 392, 128]``, kb ``[nq, nH, 2, 98, 128]`` (bf16) and
    bias ``[nH, 392, 98]`` (fp32), nq = batch nW / 8, as run_quad_pre
    draws them (``0.5 N(0, 1)``, ``0.1 N(0, 1)``)."""
    H, W, _, nH = STAGES[stage]
    nq = batch * (H // WS) * (W // WS) // CELL
    qb = (0.5 * torch.randn(nq, nH, CELL * N, 128, generator=gen,
                            device="cuda")).to(torch.bfloat16)
    kb = (0.5 * torch.randn(nq, nH, 2, 2 * N, 128, generator=gen,
                            device="cuda")).to(torch.bfloat16)
    bias = 0.1 * torch.randn(nH, CELL * N, 2 * N, generator=gen,
                             device="cuda")
    return qb, kb, bias


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", nargs="+", default=list(STAGES),
                    choices=list(STAGES))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    require_cuda("attn_probe")
    card, reps, rounds = card_line(), args.reps, args.rounds
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    records = []
    for stage in args.stages:
        qkv, bias, mask, nH, scale = stage_inputs(stage, gen)
        for mode in PROBE_MODES:
            for m in ((None,) if mode in UNMASKED_MODES else (None, mask)):
                call = (qkv, nH, bias, m, scale, mode)
                records.append(timed(
                    {"probe": "attn_probe", "variant": mode, "stage": stage,
                     "shifted": m is not None},
                    lambda call=call: window_attention_probe(*call),
                    lambda call=call: window_attention_probe_plain(*call),
                    reps, rounds, card,
                    lambda mode=mode: window_attention_probe.launches[mode]))
        del qkv, bias, mask
        qb, kb, qbias = quad_inputs(stage, gen)
        records.append(timed(
            {"probe": "attn_probe", "variant": "quad_pre", "stage": stage},
            lambda: quad_attention(qb, kb, qbias),
            lambda: quad_attention_plain(qb, kb, qbias), reps, rounds, card,
            lambda: quad_attention.launches))
        del qb, kb, qbias
    return records


if __name__ == "__main__":
    main()
