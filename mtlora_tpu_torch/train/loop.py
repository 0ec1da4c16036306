"""The epoch loops: train_one_epoch, validate, throughput.

Counterpart of ``mtlora_tpu/train/loop.py``. :func:`train_one_epoch`
(:40-130) runs the training step of ``train/step.py`` over a loader's
epoch, keeps every step's metrics summed on the device and reads the host
only every ``PRINT_FREQ`` steps and once at the epoch's end; on an
``EVAL_TRAINING`` epoch it scores the epoch's last batch. :func:`validate`
runs the eval model of ``TPU.EVAL_DTYPE`` (``models.mtl.eval_model_for``:
the fp32 clone with every kernel off by default, the model's own bf16
kernel path with ``"bfloat16"``) over a loader, streams the meters of
``evaluation/meters.py`` and the per-task eval losses on the device, and
reads the host once, after the loop (the reference reads back every
batch, main.py:466-476). Under several processes both sum what they read
over the ranks first (``parallel.distributed``). :func:`throughput` times
the eval forward through ``serve.throughput`` and names the path it
measured.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterable, Optional

import torch

from mtlora_tpu_torch.config import eval_dtype as config_eval_dtype
from mtlora_tpu_torch.evaluation.meters import PerformanceMeter
from mtlora_tpu_torch.models.mtl import MultiTaskSwin, eval_model_for
from mtlora_tpu_torch.parallel.distributed import (
    allreduce_tree,
    global_sum,
)
from mtlora_tpu_torch.train.losses import multi_task_loss
from mtlora_tpu_torch.train.step import device_batch, train_step
from mtlora_tpu_torch.utils.logger import AverageMeter


def _score_logs(scores, epoch, prefix="val"):
    """wandb metric schema of the reference (main.py:503-526):
    {prefix}/tasks/{task}/{metric}."""
    logs = {f"{prefix}/epoch": epoch}
    keymap = {
        "semseg": ("mIoU",),
        "normals": ("mean", "rmse", "mean_v2", "rmse_v2"),
        "human_parts": ("mIoU",),
        "sal": ("maxF", "Beta maxF", "mIoU"),
        "edge": ("loss",),
        "depth": ("rmse", "log_rmse"),
    }
    for task, res in scores.items():
        for m in keymap.get(task, ()):
            if m in res:
                logs[f"{prefix}/tasks/{task}/{m}"] = res[m]
    return logs


def _to_host(tree: Dict[str, Dict[str, torch.Tensor]]) -> Dict:
    """Nested dicts of fp32 tensors on one device -> the same on the CPU,
    in one device-to-host copy."""
    leaves = [(a, b, v) for a, sub in tree.items() for b, v in sub.items()]
    flat = torch.cat([v.reshape(-1) for _, _, v in leaves]).cpu()
    out, i = {}, 0
    for a, b, v in leaves:
        out.setdefault(a, {})[b] = flat[i:i + v.numel()].view(v.shape)
        i += v.numel()
    return out


def _put(v, device) -> torch.Tensor:
    """A batch entry (tensor or numpy) on ``device``; a no-op for a tensor
    already there, a copy that does not wait for the stream otherwise."""
    return torch.as_tensor(v).to(device, non_blocking=True)


@contextlib.contextmanager
def _sync_debug(mode: Optional[str]):
    """``torch.cuda.set_sync_debug_mode(mode)`` inside, the previous mode
    restored after; nothing for ``mode`` None."""
    if mode is None:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def train_one_epoch(config, model: MultiTaskSwin,
                    optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float], loader, epoch: int,
                    generator: Optional[torch.Generator], logger=None,
                    log_fn: Optional[Callable] = None,
                    sync_debug: Optional[str] = None) -> Dict:
    """One epoch of ``loader.iter_epoch(epoch)`` (reference
    train_one_epoch main.py:313-436). ``config`` is read by attribute:
    ``TASKS``, ``TRAIN.CLIP_GRAD``, ``TRAIN.ACCUMULATION_STEPS``,
    ``TRAIN.EPOCHS``, ``PRINT_FREQ``, ``EVAL_TRAINING``, ``DATA.DBNAME``
    and ``TPU.EVAL_DTYPE``.

    Every step's loss, grad norm and task losses are added up on the
    device; the host reads a step's metrics at steps ``idx %
    PRINT_FREQ == 0`` and the last (the log line, ``log_fn``'s
    ``train/*`` series), and the sums once after the loop.
    ``sync_debug`` runs each step (the batch's copy to the device, the
    step, the sums) under ``torch.cuda.set_sync_debug_mode(sync_debug)``:
    ``"error"`` checks that nothing between two reads waits for the card.
    Where ``EVAL_TRAINING`` divides the epoch, the eval model scores the
    epoch's last batch (:114-126; ``train_eval/*`` through ``log_fn``).

    Returns the epoch averages over every step, ``loss`` and one per task
    (as the JAX loop), and ``grad_norm``, ``steps``, ``samples`` (this
    process's rows), ``seconds`` (host clock, the loop and the final
    read) and ``logged``, the ``(idx, loss)`` pairs read at
    ``PRINT_FREQ``."""
    tasks = list(config.TASKS)
    device = next(model.parameters()).device
    clip = float(config.TRAIN.CLIP_GRAD or 0.0)
    accum = int(config.TRAIN.ACCUMULATION_STEPS)
    print_freq = int(config.PRINT_FREQ)
    num_steps = len(loader)
    loss_meter, norm_meter, batch_time = (AverageMeter(), AverageMeter(),
                                          AverageMeter())
    logged = []
    sums, dev, n_acc, samples = None, None, 0, 0
    start = time.perf_counter()
    end, last_sync = start, -1
    for idx, batch in enumerate(loader.iter_epoch(epoch)):
        with _sync_debug(sync_debug):
            dev = device_batch(batch, ("image", *tasks), device)
            m = train_step(model, optimizer, schedule, dev, generator,
                           clip_grad=clip, accum_steps=accum)
            vec = torch.stack([m["loss"], m["grad_norm"],
                               *(m[f"loss_{t}"] for t in tasks)])
            sums = vec if sums is None else sums + vec
        n_acc += 1
        bsz = int(batch["image"].shape[0])
        samples += bsz
        if idx % print_freq == 0 or idx == num_steps - 1:
            loss, norm, *task_losses = vec.tolist()
            logged.append((idx, loss))
            loss_meter.update(loss, bsz)
            norm_meter.update(norm)
            # the read drains the steps queued since the last one
            batch_time.update((time.perf_counter() - end)
                              / max(idx - last_sync, 1))
            last_sync = idx
            if logger:
                etas = batch_time.avg * (num_steps - idx)
                logger.info(
                    f"Train: [{epoch}/{config.TRAIN.EPOCHS}]"
                    f"[{idx}/{num_steps}] eta {etas:.0f}s "
                    f"lr {optimizer.param_groups[0]['lr']:.6g} "
                    f"loss {loss_meter.val:.4f} ({loss_meter.avg:.4f}) "
                    f"grad_norm {norm_meter.val:.4f}")
            if log_fn:
                log_fn({"train/loss": loss, "train/grad_norm": norm,
                        **{f"train/loss_{t}": v
                           for t, v in zip(tasks, task_losses)},
                        "epoch": epoch, "step": idx})
        end = time.perf_counter()
    out = {"loss": 0.0, **{t: 0.0 for t in tasks}, "grad_norm": 0.0}
    if sums is not None:
        loss, norm, *task_losses = (sums / n_acc).tolist()
        out.update(loss=loss, grad_norm=norm, **dict(zip(tasks, task_losses)))
    seconds = time.perf_counter() - start
    out.update(steps=n_acc, samples=samples, seconds=seconds, logged=logged)
    eval_training = config.get("EVAL_TRAINING", None)
    if eval_training and dev is not None and epoch % eval_training == 0:
        scores, _ = validate(model, [dev], tasks, config.DATA.DBNAME,
                             config_eval_dtype(config))
        if log_fn:
            log_fn(_score_logs(scores, epoch, prefix="train_eval"))
    if logger:
        logger.info(f"EPOCH {epoch} training takes {seconds:.1f}s; "
                    f"averages over {n_acc} steps: loss {out['loss']:.6f} "
                    f"grad_norm {out['grad_norm']:.8g} "
                    + " ".join(f"{t} {out[t]:.6f}" for t in tasks))
    return out


def validate(model: MultiTaskSwin, loader: Iterable[Dict], tasks,
             database: str = "PASCALContext", eval_dtype: str = "float32",
             epoch: int = 0, log_fn: Optional[Callable] = None,
             step_val: bool = False, sync_debug: Optional[str] = None):
    """Full validation pass (``train/loop.py:153-233``, reference main.py
    :439-528): streaming meters and per-task eval losses.

    ``loader`` yields batch dicts: ``"image"`` [B, H, W, 3] NHWC, one
    target per task, and optionally ``"_valid"`` [B] 0/1, the row weight
    of a padded batch (a row of weight 0 contributes exactly nothing;
    its targets arrive ignore-filled with 255, as
    ``mtlora_tpu/data/loader.py:42-49`` fills them). ``database`` is
    ``DATA.DBNAME``, ``eval_dtype`` ``TPU.EVAL_DTYPE``. Meter states and
    the loss sums (``multi_task_loss`` with the row weight, weighted by
    the valid rows, :170-178) accumulate on the model's device; the host
    reads them once after the loop, unless ``step_val``
    (``WANDB_STEP_VAL``) with a ``log_fn`` reads each batch's losses for
    the per-batch series (:183, :208-213). ``sync_debug`` runs the loop
    under ``torch.cuda.set_sync_debug_mode(sync_debug)`` (``"error"``: a
    check that the loop never waits for the card). The model's mode is
    restored after. Under several processes each rank scores its rows of
    every global batch, and the meter states and loss sums are summed
    over the ranks before the read, so every rank returns the global
    scores.

    Returns ``(scores, loss_avgs)``: the score dict by task and the
    per-task eval-loss averages."""
    tasks = list(tasks)
    device = next(model.parameters()).device
    eval_model = eval_model_for(model, eval_dtype)
    meter = PerformanceMeter(tasks, database, device)
    step_val = bool(step_val) and log_fn is not None
    step_loss_meter = AverageMeter()
    states = meter.states
    loss_sums = {k: torch.zeros((), device=device) for k in (*tasks, "_n")}
    was_training = model.training
    eval_model.eval()
    try:
        with _sync_debug(sync_debug), torch.inference_mode():
            for bidx, batch in enumerate(loader):
                images = _put(batch["image"], device)
                targets = {t: _put(batch[t], device) for t in tasks}
                preds = eval_model(images)
                if "_valid" in batch:
                    wrow = _put(batch["_valid"], device).float()
                    n_local = wrow.sum()
                else:
                    wrow = None
                    n_local = images.new_full((), images.shape[0],
                                              dtype=torch.float32)
                # the global batch's rows weight its (global) losses; each
                # rank adds its share, summed over the ranks after the loop
                n = global_sum(n_local)
                states = meter.update_states(states, preds, targets, wrow)
                total, per_task = multi_task_loss(preds, targets, tasks,
                                                  row_weight=wrow)
                for t in tasks:
                    loss_sums[t] = loss_sums[t] + per_task[t] * n
                loss_sums["_n"] = loss_sums["_n"] + n_local
                if step_val:
                    vals = global_sum(torch.stack(
                        [total, *(per_task[t] for t in tasks)]))
                    total_v, *task_v = vals.tolist()
                    step_loss_meter.update(total_v)
                    log_fn({"val/epoch_ndx": epoch, "val/batch_ndx": bidx,
                            "val/val_loss": step_loss_meter.val,
                            "val/val_loss_avg": step_loss_meter.avg,
                            **{f"val/tasks/{t}/loss": v
                               for t, v in zip(tasks, task_v)}})
    finally:
        model.train(was_training)
    host = _to_host(allreduce_tree({**states, "_loss": loss_sums}))
    loss_sums = host.pop("_loss")
    meter.states = host
    n = max(float(loss_sums["_n"]), 1.0)
    loss_avgs = {t: float(loss_sums[t]) / n for t in tasks}
    scores = meter.get_score(verbose=False)
    if log_fn:
        flat = _score_logs(scores, epoch, prefix="val")
        for t in tasks:
            flat[f"val/loss_{t}"] = loss_avgs[t]
        log_fn(flat)
    return scores, loss_avgs


def path_label(model: MultiTaskSwin) -> str:
    """The forward a model runs: "bf16 + kernels" (the bf16 eval path) or
    "fp32, kernels off" (the eval clone)."""
    dt = "bf16" if model.cfg.compute_dtype == "bfloat16" else "fp32"
    return f"{dt} + kernels" if model.cfg.use_pallas else f"{dt}, kernels off"


def throughput(model: MultiTaskSwin, images: torch.Tensor,
               eval_dtype: str = "float32", iters: int = 10,
               warmup: int = 2) -> Dict[str, float]:
    """Eval-forward img/s on device-resident ``images`` (:236-276), timed
    with CUDA events by ``serve.throughput``, keyed by :func:`path_label`
    of the forward measured: the eval model of ``eval_dtype`` and, where
    that is the fp32 clone, the model's own path as well, both in one run
    (``main.py:264-281``). The model's mode is restored after."""
    from mtlora_tpu_torch.serve import throughput as timed_rate

    eval_model = eval_model_for(model, eval_dtype)
    models = [eval_model] + ([model] if eval_model is not model else [])
    was_training = model.training
    rates = {}
    try:
        for m in models:
            rates[path_label(m)] = timed_rate(m, images, iters, warmup)
    finally:
        model.train(was_training)
    return rates
