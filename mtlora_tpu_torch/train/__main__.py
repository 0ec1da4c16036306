"""Training-throughput entry point of the port on one CUDA card.

    python -m mtlora_tpu_torch.train --batch-size 32 --steps 10 --seed 0

builds the flagship (``config.tiny_448_r64_pertask``: Swin-T 448, four
tasks, adapter dropout 0.05, drop-path 0.2) on the card with seeded random
weights, and runs the training step of ``train/step.py`` (forward,
backward, AdamW with the cosine schedule and clipping at 5.0) on the
synthetic batch of ``bench.py``: ``--warmup`` steps, then ``--steps``
timed with CUDA events. Prints one JSON line with the img/s, the step
time, the device and the launches of each kernel in the timed steps. It
needs a CUDA device and exits non-zero without one. The flagship runs the
JAX package's default route, ``TPU.USE_PALLAS_LN`` and
``TPU.USE_PALLAS_ADAPTER`` on (kernels 2 to 6 forward and backward);
``--no-pallas-adapter`` keeps the task streams materialized (kernels 2, 3,
4), and ``--no-pallas-ln`` also runs LayerNorm outside the GEMMs.
``--pallas-lora-gemm`` turns ``TPU.USE_PALLAS_LORA_GEMM`` on (kernel 8),
``--img-size 224`` runs the JAX package's default size, and
``--attn-dense`` sets ``MTLORA_ATTN_DENSE`` (kernel 1c in stage 3 at 224).

``--profile TRACE`` then runs 2 more steps under ``torch.profiler``,
writes the Chrome trace to TRACE and prints a second JSON line: device ms
per step by kernel class, busy time and idle share (``train/profile.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch
from torch.profiler import ProfilerActivity, profile

from mtlora_tpu_torch.config import tiny_448_r64_pertask
from mtlora_tpu_torch.ops import counters
from mtlora_tpu_torch.serve import random_model
from mtlora_tpu_torch.train.profile import breakdown
from mtlora_tpu_torch.train.optim import (
    TrainConfig,
    build_optimizer,
    build_schedule,
)
from mtlora_tpu_torch.train.step import synthetic_batch, train_step

# the bench's schedule length (bench.py:69)
ITERS_PER_EPOCH = 1000


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="TRACE", default=None)
    ap.add_argument("--no-pallas-ln", action="store_true",
                    help="TPU.USE_PALLAS_LN off: LayerNorm outside the GEMMs "
                    "(no kernels 2, 3, 4); implies --no-pallas-adapter")
    ap.add_argument("--no-pallas-adapter", action="store_true",
                    help="TPU.USE_PALLAS_ADAPTER off: materialized task "
                    "streams (no kernels 5, 6, nor kernel 2's tail mode)")
    ap.add_argument("--pallas-lora-gemm", action="store_true",
                    help="TPU.USE_PALLAS_LORA_GEMM on: every layer with a "
                    "shared adapter, no task branch and no LN kernel runs "
                    "kernel 8 (the LoRA GEMM)")
    ap.add_argument("--attn-dense", action="store_true",
                    help="MTLORA_ATTN_DENSE: a stage with one window per "
                    "image runs kernel 1c when the batch fills 8-window "
                    "cells (at --img-size 224, stage 3)")
    ap.add_argument("--img-size", type=int, default=448,
                    help="DATA.IMG_SIZE: 448 (the flagship YAML) or 224 "
                    "(the JAX package's default)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train: no CUDA device")
    cfg = dataclasses.replace(
        tiny_448_r64_pertask(
            use_pallas_ln=not args.no_pallas_ln,
            use_pallas_adapter=not (args.no_pallas_ln
                                    or args.no_pallas_adapter),
            use_pallas_lora_gemm=args.pallas_lora_gemm),
        img_size=args.img_size, attn_dense=args.attn_dense)
    tcfg = TrainConfig(batch_size=args.batch_size)
    model = random_model(cfg, args.seed, "cuda")
    optimizer = build_optimizer(model, tcfg)
    schedule = build_schedule(tcfg, ITERS_PER_EPOCH)
    batch = synthetic_batch(args.batch_size, cfg.img_size, args.seed)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def step():
        return train_step(model, optimizer, schedule, batch, gen,
                          clip_grad=tcfg.clip_grad)

    for _ in range(args.warmup):
        step()
    torch.cuda.synchronize()
    counters.reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.steps):
        metrics = step()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / args.steps
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "batch_size": args.batch_size, "steps": args.steps,
        "dtype": cfg.compute_dtype, "use_pallas_ln": cfg.use_pallas_ln,
        "use_pallas_adapter": cfg.use_pallas_adapter,
        "use_pallas_lora_gemm": cfg.use_pallas_lora_gemm,
        "attn_dense": cfg.attn_dense, "img_size": cfg.img_size,
        "img_per_s": args.batch_size / (ms / 1e3), "step_ms": ms,
        "loss": float(metrics["loss"]),
        "grad_norm": float(metrics["grad_norm"]),
        "kernels": counters.read()}))
    if args.profile:
        steps = 2
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        prof.export_chrome_trace(args.profile)
        print(json.dumps({"profile": breakdown(args.profile, steps)}))


if __name__ == "__main__":
    main()
