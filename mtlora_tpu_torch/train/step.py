"""The training step, and the synthetic batch of the JAX package's bench.

Counterpart of ``mtlora_tpu/train/step.py:make_train_step`` (:40-105):
forward in training mode, the weighted multi-task loss, backward, the
pre-clip global gradient norm, clipping, and one AdamW update at the LR
``schedule(k)`` for update ``k`` (counted from 0, as optax counts).
Gradients of the fp32 parameters come through the casts to the compute
dtype where the model uses them (the JAX package's ``AMP_ENABLE``).
Dropout and drop-path draw from the generator passed in.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from mtlora_tpu_torch.models.mtl import MultiTaskSwin
from mtlora_tpu_torch.train.losses import multi_task_loss
from mtlora_tpu_torch.train.optim import clip_by_global_norm_, global_norm


def train_step(model: MultiTaskSwin, optimizer: torch.optim.Optimizer,
               schedule: Callable[[int], float], batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator], *, clip_grad: float = 5.0
               ) -> Dict[str, torch.Tensor]:
    """One update per batch (gradient accumulation is not ported:
    ``optim.scaled_lrs`` refuses ``accumulation_steps > 1``). ``batch``:
    ``{"image": [B, H, W, 3]}`` plus one NHWC target per task, on the
    model's device. Returns 0-d tensors (no host sync): ``loss``,
    ``grad_norm`` (before clipping) and ``loss_{task}``. ``clip_grad`` 0
    turns clipping off."""
    tasks = model.cfg.tasks
    model.train()
    optimizer.zero_grad(set_to_none=True)
    preds = model(batch["image"], generator)
    total, per_task = multi_task_loss(preds, batch, tasks)
    total.backward()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    grad_norm = (clip_by_global_norm_(grads, clip_grad) if clip_grad
                 else global_norm(grads))
    k = optimizer.param_groups[0]["updates"]
    lr = schedule(k)
    for group in optimizer.param_groups:
        group["lr"] = lr
        group["updates"] = k + 1
    optimizer.step()
    return {"loss": total.detach(), "grad_norm": grad_norm.detach(),
            **{f"loss_{t}": per_task[t].detach() for t in tasks}}


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
