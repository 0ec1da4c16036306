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

``--synthetic-data`` feeds the steps from the data pipeline instead:
``data.synthetic.SyntheticMTL`` (length 64, seed ``--seed``, as
``main.py``'s synthetic branch) through the train transforms and the
loader (``data.loader``: worker processes, pinned batches copied to the
card without waiting for the stream); ``--pascal ROOT`` (or ``--nyud
ROOT``: the model then takes the four NYUD tasks) feeds them from the
train split of that dataset through ``data.loader.build_loader``. The
JSON line then also gives the host ms each timed step waited for its
batch from the loader (null for the fixed batch).

``--profile TRACE`` then runs 2 more steps under ``torch.profiler``,
writes the Chrome trace to TRACE and prints a second JSON line: device ms
per step by kernel class, busy time and idle share (``train/profile.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from mtlora_tpu_torch.config import tiny_448_r64_pertask
from mtlora_tpu_torch.ops import counters
from mtlora_tpu_torch.serve import (
    add_dataset_args,
    dataset_of,
    for_dataset,
    random_model,
)
from mtlora_tpu_torch.train.profile import breakdown
from mtlora_tpu_torch.train.optim import (
    TrainConfig,
    build_optimizer,
    build_schedule,
)
from mtlora_tpu_torch.train.step import (
    device_batch,
    synthetic_batch,
    train_step,
)

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
    data = ap.add_mutually_exclusive_group()
    data.add_argument("--synthetic-data", action="store_true",
                      help="feed the steps from SyntheticMTL (length 64) "
                      "through the train transforms and the loader")
    add_dataset_args(data)
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
    cfg = for_dataset(cfg, dataset_of(args)[0])
    tcfg = TrainConfig(batch_size=args.batch_size)
    model = random_model(cfg, args.seed, "cuda")
    optimizer = build_optimizer(model, tcfg)
    schedule = build_schedule(tcfg, ITERS_PER_EPOCH)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    stream = train_batches(cfg, args)
    waits = []

    def step():
        t0 = time.perf_counter()
        batch = next(stream)
        waits.append(time.perf_counter() - t0)
        return train_step(model, optimizer, schedule,
                          device_batch(batch, ("image", *cfg.tasks), "cuda"),
                          gen, clip_grad=tcfg.clip_grad)

    for _ in range(args.warmup):
        step()
    torch.cuda.synchronize()
    waits.clear()
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
        "data": data_name(args),
        "loader_wait_ms": (1e3 * sum(waits) / len(waits)
                           if data_name(args) != "fixed batch" else None),
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


def data_name(args) -> str:
    """What feeds the steps: "fixed batch", "synthetic" or the root."""
    if args.synthetic_data:
        return "synthetic"
    return dataset_of(args)[1] or "fixed batch"


def train_batches(cfg, args):
    """The steps' batches, without end: the bench's fixed batch, or the
    train loader's batches epoch after epoch."""
    from mtlora_tpu_torch.data.loader import (
        NUM_WORKERS,
        DataLoader,
        build_loader,
        data_node,
        epochs,
    )

    db, root = dataset_of(args)
    if root:
        return epochs(build_loader(data_node(
            db, root, cfg.tasks, cfg.img_size, args.batch_size,
            args.seed))[2])
    if args.synthetic_data:
        from mtlora_tpu_torch.data.synthetic import SyntheticMTL
        from mtlora_tpu_torch.data.task_config import get_tasks_config
        from mtlora_tpu_torch.data.transforms import get_transformations

        db = "PASCALContext"
        tc, _ = get_tasks_config(db, list(cfg.tasks), cfg.img_size)
        ds = SyntheticMTL(cfg.tasks, cfg.img_size, length=64, db_name=db,
                          seed=args.seed,
                          transform=get_transformations(db, tc)[0])
        return epochs(DataLoader(ds, args.batch_size,
                                 num_workers=NUM_WORKERS, seed=args.seed,
                                 pin_memory=True, persistent_workers=True))
    batch = synthetic_batch(args.batch_size, cfg.img_size, args.seed)
    return itertools.repeat(batch)


if __name__ == "__main__":
    main()
