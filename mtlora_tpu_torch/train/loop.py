"""Eval loop: validate, the score log schema, throughput.

Counterpart of ``mtlora_tpu/train/loop.py:134-276``. :func:`validate` runs
the eval model of ``TPU.EVAL_DTYPE`` (``models.mtl.eval_model_for``: the
fp32 clone with every kernel off by default, the model's own bf16 kernel
path with ``"bfloat16"``) over a loader, streams the meters of
``evaluation/meters.py`` and the per-task eval losses on the device, and
reads the host once, after the loop (the reference reads back every
batch, main.py:466-476). :func:`throughput` times the eval forward with
CUDA events through ``serve.throughput`` and names the path it measured.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Optional

import torch

from mtlora_tpu_torch.evaluation.meters import PerformanceMeter
from mtlora_tpu_torch.models.mtl import MultiTaskSwin, eval_model_for
from mtlora_tpu_torch.train.losses import multi_task_loss
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
    restored after.

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
                    n = wrow.sum()
                else:
                    wrow, n = None, float(images.shape[0])
                states = meter.update_states(states, preds, targets, wrow)
                total, per_task = multi_task_loss(preds, targets, tasks,
                                                  row_weight=wrow)
                for t in tasks:
                    loss_sums[t] = loss_sums[t] + per_task[t] * n
                loss_sums["_n"] = loss_sums["_n"] + n
                if step_val:
                    vals = torch.stack([total, *(per_task[t] for t in tasks)])
                    total_v, *task_v = vals.tolist()
                    step_loss_meter.update(total_v)
                    log_fn({"val/epoch_ndx": epoch, "val/batch_ndx": bidx,
                            "val/val_loss": step_loss_meter.val,
                            "val/val_loss_avg": step_loss_meter.avg,
                            **{f"val/tasks/{t}/loss": v
                               for t, v in zip(tasks, task_v)}})
    finally:
        model.train(was_training)
    host = _to_host({**states, "_loss": loss_sums})
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
