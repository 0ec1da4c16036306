"""Adapter MLP-tail probes on the card: kernels 5 and 5b with a part
switched.

    python -m mtlora_tpu_torch.tools.adapter_variants [fwd|bwd|all]
        [--tokens 401408] [--reps 20] [--rounds 3] [--seed 0]

Counterpart of the JAX package's ``tools/adapter_variants.py`` at its
stage-0 shape (T = 4, r = 4, M = 32 * 12544, H4 = 384, bf16; ``--tokens``
cuts M): the forward variants ``base`` (exact erf), ``tanh`` (kernel 5's
own form), ``sig`` (the sigmoid form), ``noact``, ``nodot1`` (no rank
expansion) and the ``[T, M, r]`` layout variants ``vpu1sig``,
``vpu12sig``, ``vpu1noac`` (its ``nodot2``, which JAX refuses at this
shape, has no counterpart); the backward with the erf (``base``), tanh
(kernel 5b) and sigmoid (``sig``) forms. Inputs as
the probe draws them (mid1 and g ``0.3 N(0, 1)``, p1 ``0.7 N(0, 1)``, B1
and A2 ``0.3 N(0, 1)``, every scale 2), from a seeded generator on the
card. One JSON line per variant: kernel and plain ms (CUDA events, the
median of ``--rounds`` rounds of ``--reps`` launches), the launches of the
run, the card's name and power limit; then the largest gap between the
tanh form and the exact erf on [-6, 6] (host float64).
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from mtlora_tpu_torch.ops.adapter_mlp import (
    BWD_PROBES,
    FWD_PROBES,
    RANK,
    adapter_mid_bwd_probe,
    adapter_mid_bwd_probe_plain,
    adapter_mid_probe,
    adapter_mid_probe_plain,
)
from mtlora_tpu_torch.ops.ln_lora import GELU_C, GELU_D
from mtlora_tpu_torch.tools import card_line, require_cuda, timed

TASKS = 4
TOKENS = 32 * 12544
H4 = 384
SCALES = (2.0,) * TASKS


def inputs(gen: torch.Generator, M: int = TOKENS):
    """mid1T ``[T, r, M]``, p1 ``[M, H4]``, b1 and a2T ``[T, r, H4]``, g
    ``[T, r, M]`` (bf16) on the card."""
    def draw(std, *shape):
        return (std * torch.randn(*shape, generator=gen, device="cuda")).to(
            torch.bfloat16)
    return (draw(0.3, TASKS, RANK, M), draw(0.7, M, H4),
            draw(0.3, TASKS, RANK, H4), draw(0.3, TASKS, RANK, H4),
            draw(0.3, TASKS, RANK, M))


def tanh_form_gap() -> float:
    """max |tanh form - exact erf GELU| on 20001 points of [-6, 6]."""
    z = torch.linspace(-6, 6, 20001, dtype=torch.float64)
    exact = z * 0.5 * (1 + torch.erf(z / math.sqrt(2)))
    tanh = 0.5 * z * (1 + torch.tanh(GELU_C * (z + GELU_D * z ** 3)))
    return float((tanh - exact).abs().max())


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all",
                    choices=("fwd", "bwd", "all"))
    ap.add_argument("--tokens", type=int, default=TOKENS)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    require_cuda("adapter_variants")
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    M = args.tokens
    mid1T, p1, b1, a2T, g = inputs(gen, M)
    mid1N = mid1T.transpose(1, 2).contiguous()
    records = []

    def fields(variant):
        return {"probe": "adapter_variants", "variant": variant, "stage": "s0",
                "T": TASKS, "r": RANK, "M": M, "H4": H4}

    if args.which in ("fwd", "all"):
        for name, (_, _, kind) in FWD_PROBES.items():
            fwd = (mid1N if kind in ("vpu1", "vpu12") else mid1T, p1, b1, a2T,
                   SCALES, name)
            records.append(timed(
                fields(f"fwd {name}"),
                lambda fwd=fwd: adapter_mid_probe(*fwd),
                lambda fwd=fwd: adapter_mid_probe_plain(*fwd),
                args.reps, args.rounds, card,
                lambda name=name: adapter_mid_probe.launches[name]))
    if args.which in ("bwd", "all"):
        for name in BWD_PROBES:
            bwd = (mid1T, p1, b1, a2T, SCALES, g, name)
            records.append(timed(
                fields(f"bwd {name}"),
                lambda bwd=bwd: adapter_mid_bwd_probe(*bwd),
                lambda bwd=bwd: adapter_mid_bwd_probe_plain(*bwd),
                args.reps, args.rounds, card,
                lambda name=name: adapter_mid_bwd_probe.launches[name]))
    print(json.dumps({"probe": "adapter_variants",
                      "max_abs_tanh_minus_erf": tanh_form_gap()}))
    return records


if __name__ == "__main__":
    main()
