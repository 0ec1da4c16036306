"""Serving entry point: batches of images in, four dense predictions out.

Counterpart of the JAX package's eval step (``train/step.py:108-118``)
and of ``main.py --throughput`` (``main.py:265-281``).

    python -m mtlora_tpu_torch.serve --batch-size 32 --requests 10 --seed 0

builds the flagship (``config.tiny_448_r64_pertask``) on the GPU with the
JAX package's init drawn from ``--seed`` (``models/init.py``), runs
synthetic images through :func:`predict` and prints the img/s timed with
CUDA events. ``--pretrained PATH`` first loads a reference ``.pth`` (an
ImageNet Swin backbone: decoders skipped, position tables resized,
non-strict), ``--resume PATH`` the weights of a checkpoint of the port or
of a reference ``.pth`` (``ckpt/checkpoint.py``). It needs a CUDA device,
and exits non-zero without one. The
flagship runs the JAX package's default route, ``TPU.USE_PALLAS_LN`` and
``TPU.USE_PALLAS_ADAPTER`` on (kernels 2 to 6); ``--no-pallas-adapter``
keeps the task streams materialized (kernels 2, 3, 4), and
``--no-pallas-ln`` also runs LayerNorm outside the GEMMs.
``--pallas-lora-gemm`` turns ``TPU.USE_PALLAS_LORA_GEMM`` on (kernel 8),
``--img-size 224`` runs the JAX package's default size, and
``--attn-dense`` sets ``MTLORA_ATTN_DENSE`` (kernel 1c in stage 3 at 224).
``--profile TRACE`` then runs 3 more forwards under ``torch.profiler``,
writes the Chrome trace to TRACE and prints a second JSON line: device
ms per forward by kernel class, busy time and idle share.

    python -m mtlora_tpu_torch.serve --validate 3 --eval-dtype bfloat16

instead scores the model (``train/loop.py:validate``) over 3 synthetic
labelled batches of ``--batch-size`` (``train/step.py:
synthetic_eval_batches``: the last one padded) on the eval path that
``--eval-dtype`` selects, ``TPU.EVAL_DTYPE``: ``float32`` (the default,
as the JAX package's) the fp32 clone with every kernel off
(``models.mtl.eval_model_for``), ``bfloat16`` the model's own bf16 kernel
path. With ``--pascal ROOT`` (or ``--nyud ROOT``: the model then takes
the four NYUD tasks) it scores the first 3 batches of the dataset's val
split instead, read through the padded val loader of
``data.loader.build_loader`` (workers, pinned batches). It prints one
JSON line: the scores, the per-task eval-loss averages and the eval img/s
of the path (``loop.throughput``, over ``--requests`` forwards; on the
fp32 path the bf16 path's rate beside it), the img/s of the whole
validate loop, meters (and loader) included, timed with CUDA events after
those forwards and a validate of the first batch warmed the path, and the
host ms the loop waited for each batch from the loader.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mtlora_tpu_torch.ckpt.checkpoint import (
    auto_resume_helper,
    load_pretrained_,
    resume_from,
)
from mtlora_tpu_torch.config import ModelConfig, tiny_448_r64_pertask
from mtlora_tpu_torch.data.task_config import NYUD_TASKS, get_tasks_config
from mtlora_tpu_torch.models.init import init_weights_
from mtlora_tpu_torch.models.mtl import (
    MultiTaskSwin,
    build_mtl_model,
    init_random_,
)


def predict(model: MultiTaskSwin, images) -> dict:
    """images [B, H, W, 3] (numpy or tensor) -> {task: [B, H, W, n]}."""
    device = next(model.parameters()).device
    x = torch.as_tensor(images).to(device, non_blocking=True)
    model.eval()
    with torch.inference_mode():
        return model(x)


def random_model(cfg: ModelConfig, seed: int, device) -> MultiTaskSwin:
    """The model, built on ``device``, with the test fill of
    ``models.mtl.init_random_`` (on which every branch counts: LoRA B is
    nonzero) drawn from ``torch.Generator().manual_seed(seed)`` (on the
    CPU, then copied, so every device gets the same weights); for the
    tests and the card's parity checks. The entry points start from
    :func:`initial_model`."""
    model = build_mtl_model(cfg, device)
    init_random_(model, torch.Generator().manual_seed(seed))
    return model


def initial_model(cfg: ModelConfig, seed: int, device) -> MultiTaskSwin:
    """The model, built on ``device``, with the JAX package's init
    (``models/init.py:init_weights_``, LoRA B zero) drawn from
    ``torch.Generator().manual_seed(seed)``, as JAX ``main.py:113`` starts
    from ``model.init``."""
    model = build_mtl_model(cfg, device)
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model


def add_weight_args(ap, train: bool = False):
    """``--pretrained PATH`` and ``--resume PATH`` (``main.py:31-37``); for
    training also ``--auto-resume`` and ``--skip-decoder``."""
    ap.add_argument("--pretrained", metavar="PATH", default=None,
                    help="start from the weights of a reference .pth (an "
                    "ImageNet Swin backbone): the decoders skipped, the "
                    "position tables resized, non-strict")
    ap.add_argument("--resume", metavar="PATH", default=None,
                    help="a checkpoint of the port (the whole state"
                    + (", the next epoch" if train else ": its weights")
                    + ") or a reference .pth (its weights)")
    if train:
        ap.add_argument("--auto-resume", action="store_true",
                        help="resume from the latest ckpt_epoch_*.pth of "
                        "--output, where there is one")
        ap.add_argument("--skip-decoder", action="store_true",
                        help="a reference .pth given to --resume loads "
                        "without its decoders and downsamplers")


def start_from(args, model, optimizer=None, generator=None) -> tuple:
    """Load what ``--resume`` (or ``--auto-resume``) or ``--pretrained``
    name into the model (and, on resume from the port's checkpoint, the
    optimizer and generator), the resume first as in ``main.py:212-243``;
    returns (the epoch the run starts at, the file loaded or "init")."""
    resume = args.resume
    if getattr(args, "auto_resume", False) and not resume:
        resume = auto_resume_helper(args.output)
    if resume:
        out = resume_from(resume, model, optimizer, generator,
                          skip_decoder=getattr(args, "skip_decoder", False))
        return out["start_epoch"], resume
    if args.pretrained:
        load_pretrained_(model, args.pretrained)
        return 0, args.pretrained
    return 0, "init"


def add_dataset_args(group):
    """``--pascal ROOT`` and ``--nyud ROOT`` (``main.py:29-30``) on an
    argparse group."""
    group.add_argument("--pascal", metavar="ROOT", default=None,
                       help="PASCAL-Context root (PASCAL_MT layout)")
    group.add_argument("--nyud", metavar="ROOT", default=None,
                       help="NYUD root (NYUD_MT layout); the model takes "
                       "the four NYUD tasks")


def dataset_of(args):
    """(DATA.DBNAME, root) of ``--pascal`` / ``--nyud``, or (None, None)."""
    if args.pascal:
        return "PASCALContext", args.pascal
    if args.nyud:
        return "NYUD", args.nyud
    return None, None


def for_dataset(cfg: ModelConfig, db) -> ModelConfig:
    """The flagship's tasks are PASCAL's; on NYUD the model takes the four
    NYUD tasks (as many as the per-task ranks) and their output widths."""
    if db != "NYUD":
        return cfg
    tc, _ = get_tasks_config(db, list(NYUD_TASKS), cfg.img_size)
    return dataclasses.replace(
        cfg, tasks=NYUD_TASKS,
        num_outputs=tuple(tc["NUM_OUTPUT"][t] for t in NYUD_TASKS))


def synthetic_images(batch: int, size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, size, size, 3), dtype=np.float32)


def throughput(model, images: torch.Tensor, iters: int,
               warmup: int = 2) -> float:
    """img/s of :func:`predict` on device-resident images, CUDA events
    (the host clock for images on the CPU)."""
    for _ in range(warmup):
        predict(model, images)
    if images.device.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            predict(model, images)
        return images.shape[0] * iters / (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        predict(model, images)
    end.record()
    end.synchronize()
    return images.shape[0] * iters / (start.elapsed_time(end) / 1e3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--requests", type=int, default=10)
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
    ap.add_argument("--validate", type=int, default=0, metavar="N",
                    help="score the model over N synthetic labelled batches "
                    "(the last padded), or the first N of the val split of "
                    "--pascal / --nyud, instead of serving")
    ap.add_argument("--eval-dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="TPU.EVAL_DTYPE of --validate: the fp32 clone with "
                    "every kernel off, or the bf16 kernel path")
    add_dataset_args(ap.add_mutually_exclusive_group())
    add_weight_args(ap)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve: no CUDA device")
    cfg = dataclasses.replace(
        tiny_448_r64_pertask(
            use_pallas_ln=not args.no_pallas_ln,
            use_pallas_adapter=not (args.no_pallas_ln
                                    or args.no_pallas_adapter),
            use_pallas_lora_gemm=args.pallas_lora_gemm),
        img_size=args.img_size, attn_dense=args.attn_dense)
    cfg = for_dataset(cfg, dataset_of(args)[0])
    model = initial_model(cfg, args.seed, "cuda")
    weights = start_from(args, model)[1]
    if args.validate:
        return _validate(model, cfg, args, weights)
    images = torch.from_numpy(synthetic_images(
        args.batch_size, cfg.img_size, args.seed)).cuda()
    rate = throughput(model, images, args.requests)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "batch_size": args.batch_size,
                      "requests": args.requests,
                      "dtype": cfg.compute_dtype,
                      "use_pallas_ln": cfg.use_pallas_ln,
                      "use_pallas_adapter": cfg.use_pallas_adapter,
                      "use_pallas_lora_gemm": cfg.use_pallas_lora_gemm,
                      "attn_dense": cfg.attn_dense,
                      "img_size": cfg.img_size, "img_per_s": rate,
                      "weights": weights}))
    if args.profile:
        from mtlora_tpu_torch.train.profile import breakdown
        forwards = 3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(forwards):
                predict(model, images)
            torch.cuda.synchronize()
        prof.export_chrome_trace(args.profile)
        print(json.dumps({"profile": breakdown(args.profile, forwards)}))


def _validate(model, cfg, args, weights):
    """``--validate N``: one JSON line of scores, eval losses and rates."""
    from mtlora_tpu_torch.data.loader import build_loader, data_node
    from mtlora_tpu_torch.models.mtl import eval_model_for
    from mtlora_tpu_torch.train.loop import path_label, throughput, validate
    from mtlora_tpu_torch.train.step import synthetic_eval_batches

    db, root = dataset_of(args)
    waits = []
    if root:
        loader = build_loader(data_node(db, root, cfg.tasks, cfg.img_size,
                                        args.batch_size, args.seed))[3]

        def batches():
            it = itertools.islice(loader.iter_epoch(0), args.validate)
            while True:
                t0 = time.perf_counter()
                batch = next(it, None)
                waits.append(time.perf_counter() - t0)
                if batch is None:
                    return
                yield batch

        first = next(iter(loader.iter_epoch(0)))
        first = {k: v.to("cuda") for k, v in first.items() if k != "meta"}
    else:
        db = "PASCALContext"
        fixed = synthetic_eval_batches(args.validate, args.batch_size,
                                       cfg.img_size, args.seed, "cuda")
        first = fixed[0]

        def batches():
            return iter(fixed)
    # the forward rates first, and a validate of the first batch: they warm
    # the path and the meters' kernels for the timed validate
    rates = throughput(model, first["image"], args.eval_dtype,
                       iters=args.requests)
    validate(model, [first], cfg.tasks, db, args.eval_dtype)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    scores, losses = validate(model, batches(), cfg.tasks, db,
                              args.eval_dtype)
    end.record()
    end.synchronize()
    secs = start.elapsed_time(end) / 1e3
    n = len(waits) - 1 if root else args.validate
    path = path_label(eval_model_for(model, args.eval_dtype))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "batch_size": args.batch_size,
                      "batches": n, "data": root or "synthetic",
                      "eval_dtype": args.eval_dtype, "path": path,
                      "img_size": cfg.img_size, "scores": scores,
                      "loss": losses, "eval_img_per_s": rates[path],
                      "img_per_s_by_path": rates,
                      "validate_img_per_s": n * args.batch_size / secs,
                      "loader_wait_ms": (1e3 * sum(waits) / n if root
                                         else None),
                      "weights": weights}))


if __name__ == "__main__":
    main()
