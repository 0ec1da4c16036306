"""Training and evaluation CLI of the port.

    python -m mtlora_tpu_torch \
        --cfg configs/mtlora/tiny_448/mtlora_tiny_448_r64_scale4_pertask.yaml \
        --tasks semseg,normals,sal,human_parts --synthetic-data \
        --batch-size 32 --epochs 2

Counterpart of the JAX package's ``main.py`` (the reference entry point's
flags, ``main.py:20-90``, and its control flow, :126-326): the config is
read from the YAML with its ``BASE`` chain, then ``--opts``, then the
flags (``config.get_config``); the model takes the route the config picks
(``config.from_config``: ``TPU.USE_PALLAS_LN`` and ``USE_PALLAS_ADAPTER``
on, as in every YAML, run kernels 2 to 6 besides 1 and 7) and starts from
the JAX package's init drawn from ``SEED``, from ``--pretrained``, from
``--resume`` or from the latest checkpoint of the output directory
(``TRAIN.AUTO_RESUME``). It trains epoch by epoch (``train/loop.py:
train_one_epoch``), saving every ``SAVE_FREQ`` epochs and at the last
(``--ckpt-freq``) and validating every ``EVAL_FREQ`` (``--eval-freq``)
and at epoch 50, then validates once more. ``--eval`` validates only,
``--throughput`` times the eval forward of both eval paths. Under
``OUTPUT/<MODEL.NAME>/<TAG>`` it writes ``config.json``,
``log_rank<r>.txt``, ``val_scores_r<r>.json``, ``ckpt_epoch_<N>.pth`` and
``config.yaml``.

It runs on the CUDA card unless ``--device cpu`` is given; without a card
and without ``--device cpu`` it exits non-zero. ``--sync-debug error``
runs every training step under ``torch.cuda.set_sync_debug_mode``: a
step that waits for the card fails the run.

Several processes: ``torchrun --nproc-per-node N -m mtlora_tpu_torch ...``
(NCCL, one card a process), or ``--coordinator host:port
--num-processes N --process-id R`` per process (gloo with ``--device
cpu``). ``DATA.BATCH_SIZE`` is the global batch; each process loads its
rows, and the step sums what the JAX package's SPMD step sums over the
global batch (``parallel/distributed.py``). The LR scales by batch *
world / 512, the world being the processes, one card each, as the JAX
package scales by its devices.

Accepted and not acted on, as in the JAX CLI: ``--fused_window_process``,
``--fused_layernorm``, ``--zip``, ``--cache-mode``, ``--amp-opt-level``,
``--mti``, ``--resume-backbone`` and ``--local_rank``. Refused: a config
without ``--tasks`` (classification) and ``--merged``, Queue 1 item 9 of
ROADMAP.md, and whatever ``from_config`` refuses.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time

import numpy as np
import torch

from mtlora_tpu_torch.config import (
    _unsupported,
    from_config,
    get_config,
)
from mtlora_tpu_torch.config import eval_dtype as config_eval_dtype


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "MTLoRA training and evaluation (PyTorch port)", add_help=True)
    p.add_argument("--cfg", type=str, required=True, metavar="FILE",
                   help="path to config yaml")
    p.add_argument("--opts", nargs="+", default=None,
                   help="override config options: KEY VALUE pairs")
    p.add_argument("--batch-size", type=int, help="global batch size")
    p.add_argument("--data-path", type=str, help="dataset path")
    p.add_argument("--pascal", type=str, help="PASCAL-Context root")
    p.add_argument("--nyud", type=str, help="NYUD root")
    p.add_argument("--tasks", type=str,
                   help="comma-separated task list, e.g. semseg,normals")
    p.add_argument("--pretrained", type=str,
                   help="pretrained backbone checkpoint (.pth)")
    p.add_argument("--resume", type=str,
                   help="a checkpoint of the port (the whole state) or a "
                   "reference .pth (its weights)")
    p.add_argument("--resume-backbone", action="store_true",
                   help="accepted; nothing reads it")
    p.add_argument("--freeze_backbone", action="store_true")
    p.add_argument("--accumulation-steps", type=int)
    p.add_argument("--use-checkpoint", action="store_true",
                   help="activation rematerialization (not ported)")
    p.add_argument("--disable_amp", action="store_true",
                   help="fp32 compute instead of bf16")
    p.add_argument("--output", default="output", type=str, metavar="PATH")
    p.add_argument("--tag", type=str, help="tag of experiment")
    p.add_argument("--name", type=str, help="override model name")
    p.add_argument("--eval", action="store_true", help="evaluation only")
    p.add_argument("--merged", action="store_true",
                   help="with --eval: merged-LoRA eval (not ported)")
    p.add_argument("--throughput", action="store_true",
                   help="throughput only")
    p.add_argument("--epochs", type=int)
    p.add_argument("--ckpt-freq", type=int, default=5)
    p.add_argument("--eval-freq", type=int, default=5)
    p.add_argument("--eval_training_freq", type=int)
    p.add_argument("--skip_initial_validation", action="store_true")
    p.add_argument("--no_eval_50", action="store_false",
                   help="disable the extra epoch-50 validation")
    p.add_argument("--decoder_map", type=str,
                   help="json file mapping task -> decoder head")
    p.add_argument("--skip_decoder", action="store_true",
                   help="drop decoder weights when loading checkpoints")
    p.add_argument("--save_sample", action="store_true")
    p.add_argument("--run_name", type=str)
    p.add_argument("--disable_wandb", action="store_true")
    p.add_argument("--synthetic-data", action="store_true",
                   help="train on synthetic data (no dataset needed)")
    p.add_argument("--coordinator", type=str,
                   default=os.environ.get("MTLORA_COORDINATOR"),
                   help="host:port of process 0 (several processes "
                   "without torchrun)")
    p.add_argument("--num-processes", type=int,
                   default=int(os.environ.get("MTLORA_NUM_PROCESSES", 0))
                   or None)
    p.add_argument("--process-id", type=int,
                   default=int(os.environ["MTLORA_PROCESS_ID"])
                   if os.environ.get("MTLORA_PROCESS_ID") else None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the default: the card, kernels on) or cpu "
                   "(the kernels' plain versions, gloo)")
    p.add_argument("--sync-debug", choices=("warn", "error"), default=None,
                   help="run each training step under "
                   "torch.cuda.set_sync_debug_mode (CUDA only)")
    # accepted for the reference CLI's sake, not acted on
    p.add_argument("--local_rank", "--local-rank", type=int, default=0)
    p.add_argument("--fused_window_process", action="store_true")
    p.add_argument("--fused_layernorm", action="store_true")
    p.add_argument("--optim", type=str)
    p.add_argument("--zip", action="store_true")
    p.add_argument("--cache-mode", type=str, default="part")
    p.add_argument("--amp-opt-level", type=str)
    p.add_argument("--mti", type=int)
    return p


def parse_option(argv=None):
    args = build_parser().parse_args(argv)
    return args, get_config(args)


def build_all(config, logger, device):
    """The model at the JAX package's init from ``SEED`` on ``device`` and
    its ``TrainConfig``; the parameter counts logged
    (``main.py:98-123``)."""
    from mtlora_tpu_torch.serve import initial_model
    from mtlora_tpu_torch.train.optim import count_params, train_from_config

    model = initial_model(from_config(config), int(config.SEED), device)
    tcfg = train_from_config(config)
    counts = count_params(model, tcfg)
    logger.info(
        f"Number of trainable params: {counts['trainable']:,}\n"
        f"Decoder params:             {counts['decoder']:,}\n"
        f"LoRA params:                {counts['lora']:,}\n"
        f"Extra params:               {counts['extra']:,}\n"
        f"Total params:               {counts['total']:,} "
        f"(trainable ratio: "
        f"{counts['trainable'] / counts['total'] * 100:.2f}%)")
    return model, tcfg


def _loaders(args, config, rank: int, world: int, device):
    """The train and the padded val loader: the synthetic sets of
    ``main.py:163-189`` (64 training samples; ``MTLORA_SYNTH_VAL_LEN``,
    16 by default, validation samples at seed 1), or ``build_loader``'s
    on the dataset. ``DATA.NUM_WORKERS`` workers, batches pinned for the
    card."""
    from mtlora_tpu_torch.data.loader import (
        DataLoader,
        build_loader,
        ignore_fill_sample,
    )

    if not (getattr(args, "synthetic_data", False)
            or not config.DATA.DATA_PATH):
        return build_loader(config, rank, world, device)[2:4]
    from mtlora_tpu_torch.data.synthetic import SyntheticMTL
    from mtlora_tpu_torch.data.transforms import get_transformations

    db = config.DATA.DBNAME
    tr_train, tr_val = get_transformations(db, config.TASKS_CONFIG)
    ds_train = SyntheticMTL(config.TASKS, config.DATA.IMG_SIZE, length=64,
                            db_name=db, transform=tr_train)
    val_len = int(os.environ.get("MTLORA_SYNTH_VAL_LEN", "16"))
    ds_val = SyntheticMTL(config.TASKS, config.DATA.IMG_SIZE,
                          length=val_len, db_name=db, transform=tr_val,
                          seed=1)
    workers = int(config.DATA.NUM_WORKERS)
    common = dict(num_workers=workers, rank=rank, world=world,
                  pin_memory=torch.device(device).type == "cuda",
                  persistent_workers=workers > 0)
    batch = int(config.DATA.BATCH_SIZE)
    loader_train = DataLoader(ds_train, batch, seed=int(config.SEED),
                              **common)
    loader_val = DataLoader(ds_val, batch, shuffle=False, drop_last=False,
                            pad_last=True, pad_fill=ignore_fill_sample,
                            **common)
    return loader_train, loader_val


def _log_scores(logger, scores, losses=None):
    for task, res in scores.items():
        logger.info(f"[{task}] " + ", ".join(
            f"{k}: {v:.4f}" for k, v in res.items()
            if isinstance(v, (int, float))))
    for task, v in (losses or {}).items():
        logger.info(f"val loss {task}: {v:.4f}")


def main(args, config) -> dict:
    """One run (``main.py:126-326``) on the device of ``args.device``;
    returns what it measured: ``{"rank", "world", "backend" (the process
    group's, or None), "start_epoch", "epochs" (train_one_epoch's
    results), "checkpoints", "scores", "throughput"}`` as far as the mode
    reaches."""
    from mtlora_tpu_torch.parallel.distributed import initialize, shutdown

    info = initialize(getattr(args, "coordinator", None),
                      getattr(args, "num_processes", None),
                      getattr(args, "process_id", None), device=args.device)
    try:
        return _run(args, config, info)
    finally:
        shutdown()


def _run(args, config, info) -> dict:
    from mtlora_tpu_torch.ckpt.checkpoint import (
        auto_resume_helper,
        load_pretrained_,
        resume_from,
        save_checkpoint,
    )
    from mtlora_tpu_torch.parallel.distributed import (
        backend,
        broadcast_module_,
        replicas_identical,
        step_seed,
    )
    from mtlora_tpu_torch.train.loop import (
        throughput,
        train_one_epoch,
        validate,
    )
    from mtlora_tpu_torch.train.optim import build_optimizer, build_schedule
    from mtlora_tpu_torch.utils.logger import create_logger

    rank, world, device = info["rank"], info["world"], info["device"]
    # host-side randomness offset by rank (reference main.py:570)
    np.random.seed(int(config.SEED) + rank)
    os.makedirs(config.OUTPUT, exist_ok=True)
    logger = create_logger(config.OUTPUT, dist_rank=rank,
                           name=config.MODEL.NAME)
    if rank == 0:
        with open(os.path.join(config.OUTPUT, "config.json"), "w") as f:
            f.write(json.dumps(config.to_dict(), default=str, indent=1))
    logger.info(f"Full config saved to {config.OUTPUT}/config.json")
    logger.info(f"rank {rank} of {world} on {device}")
    if getattr(args, "synthetic_data", False) or not config.DATA.DATA_PATH:
        logger.warning("using synthetic data (no --pascal/--nyud given)")
    loader_train, loader_val = _loaders(args, config, rank, world, device)

    model, tcfg = build_all(config, logger, device)
    optimizer = build_optimizer(model, tcfg)
    schedule = build_schedule(tcfg, len(loader_train), world_size=world)
    generator = torch.Generator(device=device).manual_seed(
        step_seed(int(config.SEED)))
    start_epoch, max_accuracy = 0, 0.0
    resume = config.MODEL.RESUME
    if config.TRAIN.AUTO_RESUME and not resume:
        found = auto_resume_helper(config.OUTPUT)
        if found:
            logger.info(f"auto resuming from {found}")
            resume = found
    if resume:
        out = resume_from(resume, model, optimizer, generator,
                          skip_decoder=bool(config.TRAIN.SKIP_DECODER_CKPT))
        start_epoch, max_accuracy = out["start_epoch"], out["max_accuracy"]
        logger.info(f"resumed from {resume}: epoch {start_epoch}")
    elif config.MODEL.PRETRAINED:
        load_pretrained_(model, config.MODEL.PRETRAINED)
        logger.info(f"loaded pretrained {config.MODEL.PRETRAINED}")
    broadcast_module_(model)
    eval_dtype = config_eval_dtype(config)
    log_fn = _wandb_log_fn(args, config, logger) if rank == 0 else None
    step_val = bool(config.get("WANDB_STEP_VAL", False))
    result = {"rank": rank, "world": world, "start_epoch": start_epoch,
              "backend": backend(), "epochs": [], "checkpoints": []}

    def run_validate(epoch):
        scores, losses = validate(model, loader_val.iter_epoch(0),
                                  config.TASKS, config.DATA.DBNAME,
                                  eval_dtype, epoch=epoch, log_fn=log_fn,
                                  step_val=step_val)
        _log_scores(logger, scores, losses)
        return scores

    if config.THROUGHPUT_MODE:
        batch = next(iter(loader_val.iter_epoch(0)))
        images = torch.as_tensor(batch["image"]).to(device)
        rates = throughput(model, images, eval_dtype, iters=30, warmup=5)
        for label, rate in rates.items():
            logger.info(f"batch_size {images.shape[0]} throughput "
                        f"{rate:.1f} img/s [measured: {label}]")
        result["throughput"] = rates
        return result
    if config.EVAL_MODE:
        result["scores"] = run_validate(0)
        _dump_scores(config, result["scores"], rank)
        return result

    sync_debug = args.sync_debug if device.type == "cuda" else None
    trainables = [p for g in optimizer.param_groups for p in g["params"]]
    logger.info("Start training")
    start = time.perf_counter()
    epoch = start_epoch
    for epoch in range(start_epoch, config.TRAIN.EPOCHS):
        stats = train_one_epoch(config, model, optimizer, schedule,
                                loader_train, epoch, generator, logger,
                                log_fn, sync_debug=sync_debug)
        result["epochs"].append({"epoch": epoch, **stats})
        if (epoch % config.SAVE_FREQ == 0
                or epoch == config.TRAIN.EPOCHS - 1):
            if not replicas_identical(trainables):
                raise RuntimeError(f"epoch {epoch}: the ranks' trainable "
                                   "parameters differ")
            if world > 1:
                logger.info(f"epoch {epoch}: the {world} ranks' trainable "
                            "parameters are identical")
            result["checkpoints"].append(save_checkpoint(
                config.OUTPUT, epoch, model, optimizer, generator,
                max_accuracy, config_dump=config.dump()))
        if epoch % config.EVAL_FREQ == 0 or (
                getattr(args, "no_eval_50", True) and epoch == 50):
            run_validate(epoch)
    result["scores"] = run_validate(epoch)
    _dump_scores(config, result["scores"], rank)
    total = time.perf_counter() - start
    logger.info(f"Training time {datetime.timedelta(seconds=int(total))}")
    return result


def _dump_scores(config, scores, rank: int):
    """The final task scores of this process, ``val_scores_r<rank>.json``
    beside the log."""
    path = os.path.join(config.OUTPUT, f"val_scores_r{rank}.json")
    with open(path, "w") as f:
        json.dump(scores, f, default=float, indent=1)


def _wandb_log_fn(args, config, logger):
    """``wandb.log`` after ``wandb.init``, or None: with
    ``--disable_wandb``, without ``wandb``, or where it cannot start."""
    if getattr(args, "disable_wandb", False):
        return None
    try:
        import wandb
    except ImportError:
        return None
    try:
        wandb.init(project="mtlora_tpu",
                   name=getattr(args, "run_name", None) or config.MODEL.NAME,
                   config=config.to_dict())
        return wandb.log
    except Exception as e:  # offline, not logged in
        logger.warning(f"wandb disabled: {e}")
        return None


def cli(argv=None) -> dict:
    """Parse, check what the port runs, then :func:`main`."""
    args, config = parse_option(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("mtlora_tpu_torch: no CUDA device (pass --device "
                         "cpu to run on the CPU)")
    if not config.get("MTL", False):
        _unsupported("classification mode (a run without --tasks, "
                     "main.py:main_classification)", "Queue 1, item 9")
    if args.merged:
        _unsupported("--merged (merged-LoRA eval)", "Queue 1, item 9")
    from_config(config)     # its refusals before anything starts
    return main(args, config)
