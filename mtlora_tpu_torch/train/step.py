"""The training step, and the synthetic batch of the JAX package's bench.

Counterpart of ``mtlora_tpu/train/step.py:make_train_step`` (:40-105):
forward in training mode, the weighted multi-task loss, backward, the
pre-clip global gradient norm, clipping, and one update at the LR
``schedule(k)`` for update ``k`` (counted from 0, as optax counts).
Gradients of the fp32 parameters come through the casts to the compute
dtype where the model uses them (the JAX package's ``AMP_ENABLE``).
Dropout and drop-path draw from the generator passed in.

With ``accum_steps`` > 1 the batch is split along its rows into that many
microbatches, rows ``[i m, (i + 1) m)`` the i-th (the JAX step's
``reshape((accum_steps, -1))``), run one after another: each takes its
own BatchNorm batch statistics and updates the running ones in turn, as
JAX's ``scan`` threads them; the gradients are summed, divided by
``accum_steps``, clipped once and applied once. Under several processes
the summed gradients are then summed over the ranks
(``parallel.distributed.allreduce_grads_``: each rank's loss is its share
of the global loss) before the norm and the clip, and the metrics are the
global batch's; microbatch i is then every rank's i-th slice of its rows.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from mtlora_tpu_torch.models.mtl import MultiTaskSwin
from mtlora_tpu_torch.parallel.distributed import (
    allreduce_grads_,
    global_sum,
)
from mtlora_tpu_torch.train.losses import multi_task_loss
from mtlora_tpu_torch.train.optim import clip_by_global_norm_, global_norm


def train_step(model: MultiTaskSwin, optimizer: torch.optim.Optimizer,
               schedule: Callable[[int], float], batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator], *, clip_grad: float = 5.0,
               accum_steps: int = 1) -> Dict[str, torch.Tensor]:
    """One update. ``batch``: ``{"image": [B, H, W, 3]}`` plus one NHWC
    target per task, on the model's device; ``B`` a multiple of
    ``accum_steps``. Returns 0-d tensors (no host sync): ``loss``,
    ``grad_norm`` (before clipping) and ``loss_{task}``, the means over
    the microbatches. ``clip_grad`` 0 turns clipping off."""
    tasks = model.cfg.tasks
    B = batch["image"].shape[0]
    if accum_steps < 1 or B % accum_steps:
        raise ValueError(f"a batch of {B} rows does not split into "
                         f"{accum_steps} microbatches")
    m = B // accum_steps
    model.train()
    optimizer.zero_grad(set_to_none=True)
    totals, per_tasks = [], []
    for i in range(accum_steps):
        micro = ({k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                 if accum_steps > 1 else batch)
        preds = model(micro["image"], generator)
        total, per_task = multi_task_loss(preds, micro, tasks)
        total.backward()
        totals.append(total.detach())
        per_tasks.append(torch.stack([per_task[t].detach() for t in tasks]))
    grad_norm = apply_update(optimizer, schedule, clip_grad, accum_steps)
    vals = torch.cat([torch.stack(totals).mean(0, keepdim=True),
                      torch.stack(per_tasks).mean(0)])
    vals = global_sum(vals)
    return {"loss": vals[0], "grad_norm": grad_norm,
            **{f"loss_{t}": vals[1 + i] for i, t in enumerate(tasks)}}


def apply_update(optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], clip_grad: float = 5.0,
                 accum_steps: int = 1) -> torch.Tensor:
    """The update from the summed gradients in ``p.grad`` (None counts as
    zero): divided by ``accum_steps``, summed over the ranks, clipped at
    ``clip_grad`` (0: not clipped), one step of ``optimizer`` at
    ``schedule(k)``. Returns the pre-clip global norm (0-d, on the
    device)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    if accum_steps > 1:
        for g in grads:
            g.div_(accum_steps)
    allreduce_grads_(grads)
    grad_norm = (clip_by_global_norm_(grads, clip_grad) if clip_grad
                 else global_norm(grads))
    k = optimizer.param_groups[0]["updates"]
    lr = schedule(k)
    for group in optimizer.param_groups:
        group["lr"] = lr
        group["updates"] = k + 1
    optimizer.step()
    return grad_norm.detach()


def device_batch(batch: Dict, keys, device) -> Dict[str, torch.Tensor]:
    """The entries ``keys`` of a batch on ``device``: a no-op for tensors
    already there; from the pinned batches of ``data.loader`` the copies
    do not wait for the stream."""
    return {k: torch.as_tensor(batch[k]).to(device, non_blocking=True)
            for k in keys}


def synthetic_batch(batch_size: int, img_size: int, seed: int,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """The bench's batch (``bench.py:76-85``): standard-normal images and
    random targets for the four PASCAL tasks, drawn with numpy."""
    r = np.random.RandomState(seed)
    B, S = batch_size, img_size
    arrays = {
        "image": r.randn(B, S, S, 3).astype(np.float32),
        "semseg": r.randint(0, 21, (B, S, S, 1)).astype(np.float32),
        "normals": r.uniform(-1, 1, (B, S, S, 3)).astype(np.float32),
        "sal": (r.rand(B, S, S, 1) > 0.5).astype(np.float32),
        "human_parts": r.randint(0, 7, (B, S, S, 1)).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def synthetic_eval_batches(n: int, batch_size: int, img_size: int, seed: int,
                           device="cuda", valid_last: Optional[int] = None):
    """``n`` labelled batches for ``loop.validate``: batch ``i`` is
    :func:`synthetic_batch` at seed ``seed + i`` with the first
    ``img_size // 8`` rows of semseg and human_parts set to the ignore
    label 255 (``mtlora_tpu/data/synthetic.py:97``). The last batch is
    padded as a ragged last batch is: rows from ``valid_last`` on
    (default ``max(1, 5 * batch_size // 8)``) carry ``"_valid"`` 0 and
    targets ignore-filled with 255 (``mtlora_tpu/data/loader.py:42-49``);
    the other batches carry no ``"_valid"``."""
    if valid_last is None:
        valid_last = max(1, 5 * batch_size // 8)
    batches = []
    for i in range(n):
        b = synthetic_batch(batch_size, img_size, seed + i, device)
        for t in ("semseg", "human_parts"):
            b[t][:, : img_size // 8] = 255.0
        if i == n - 1:
            for k, v in b.items():
                if k != "image":
                    v[valid_last:] = 255.0
            valid = torch.zeros(batch_size, dtype=torch.float32)
            valid[:valid_last] = 1.0
            b["_valid"] = valid.to(device)
        batches.append(b)
    return batches
