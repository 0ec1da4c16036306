"""Per-task losses and the weighted multi-task loss.

Counterpart of ``mtlora_tpu/train/losses.py`` (the reference
``mtl_loss_schemes.py``), with every reduction in fp32 and no host sync:
counts are clamped tensors, never Python numbers.

  - semseg / human_parts: softmax CE, ignore label 255, mean over valid;
  - sal / edge: class-balanced BCE on logits over ALL pixels (edge with
    the fixed positive weight 0.95); ``row_weight`` drops padded rows from
    every sum and from the denominator;
  - normals: L2-normalised prediction, masked L1, sum / valid count;
  - depth: masked L1, mean over valid;
  - total = sum_t w_t * loss_t with the fixed weights below.

Under several processes each normaliser (valid counts, the BCE's element
count and positives) is summed over the ranks
(``parallel.distributed.global_sum``), as the JAX package's SPMD step sums
it over the global batch: each rank's loss is then its share of the
global batch's loss, and the shares sum to it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from mtlora_tpu_torch.data.task_config import LOSS_WEIGHTS
from mtlora_tpu_torch.parallel.distributed import global_sum


def softmax_ce_ignore(logits: torch.Tensor, label: torch.Tensor,
                      ignore_index: int = 255) -> torch.Tensor:
    """Cross entropy with an ignore label, mean over valid pixels.

    logits [B, H, W, K] (NHWC); label [B, H, W] or [B, H, W, 1]."""
    if label.dim() == logits.dim():
        label = label[..., 0]
    label = label.to(torch.int64)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    x_lab = torch.gather(x, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, lse - x_lab, torch.zeros_like(lse))
    return nll.sum() / global_sum(valid.sum()).clamp(min=1)


def balanced_bce_logits(logits: torch.Tensor, label: torch.Tensor,
                        pos_weight: Optional[float] = None,
                        row_weight: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """HED-style class-balanced binary CE on logits, divided by the TOTAL
    element count (size_average), with the reference's stable
    ``log1p(exp)`` form. ``row_weight`` (per-sample [B] 0/1) removes
    0-weight rows from every sum and from the denominator."""
    x = logits.float()
    y = (label.float() >= 0.5).float()
    if row_weight is None:
        wrow = None
        num_total = global_sum(x.new_full((), float(y.numel())))
    else:
        wrow = row_weight.float().reshape((y.shape[0],) + (1,) * (y.dim() - 1))
        num_total = global_sum(row_weight.float().sum()
                               * (y.numel() // y.shape[0])).clamp(min=1.0)
        y = y * wrow
    if pos_weight is None:
        w = (num_total - global_sum(y.sum())) / num_total
    else:
        w = pos_weight
    x_gt0 = (x >= 0).float()
    loss_val = x * (y - x_gt0) - torch.log1p(torch.exp(x - 2.0 * x * x_gt0))
    if wrow is not None:
        loss_val = loss_val * wrow
    loss_pos = -(y * loss_val).sum()
    loss_neg = -((1.0 - y) * loss_val).sum()
    return (w * loss_pos + (1.0 - w) * loss_neg) / num_total


def normals_loss(pred: torch.Tensor, label: torch.Tensor,
                 ignore_label: int = 255) -> torch.Tensor:
    """L2-normalised prediction, element-wise masked L1, sum / n_valid."""
    p = pred.float()
    lbl = label.float()
    p = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-12)
    mask = lbl != ignore_label
    diff = torch.where(mask, (p - lbl).abs(), torch.zeros_like(p))
    return diff.sum() / global_sum(mask.sum()).clamp(min=1)


def depth_loss(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Masked L1, mean over valid pixels."""
    p = pred.float()
    lbl = label.float()
    mask = lbl != 255
    diff = torch.where(mask, (p - lbl).abs(), torch.zeros_like(p))
    return diff.sum() / global_sum(mask.sum()).clamp(min=1)


def get_task_loss(task: str):
    """Loss dispatch (reference get_loss)."""
    if task in ("semseg", "human_parts"):
        return softmax_ce_ignore
    if task == "edge":
        return lambda p, l: balanced_bce_logits(p, l, pos_weight=0.95)
    if task == "sal":
        return balanced_bce_logits
    if task == "normals":
        return normals_loss
    if task == "depth":
        return depth_loss
    raise NotImplementedError(
        f"Undefined loss for task {task!r}; choose among "
        "edge, semseg, human_parts, sal, depth, normals")


def multi_task_loss(preds: Dict[str, torch.Tensor],
                    targets: Dict[str, torch.Tensor], tasks,
                    row_weight: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of the per-task losses; returns (total, per task).
    ``row_weight`` reaches the balanced-BCE losses (sal, edge), whose
    denominator counts every element; the masked losses need no weight."""
    per_task = {}
    for t in tasks:
        if row_weight is not None and t in ("sal", "edge"):
            per_task[t] = balanced_bce_logits(
                preds[t], targets[t], pos_weight=0.95 if t == "edge" else None,
                row_weight=row_weight)
        else:
            per_task[t] = get_task_loss(t)(preds[t], targets[t])
    total = sum(LOSS_WEIGHTS[t] * per_task[t] for t in tasks)
    return total, per_task
