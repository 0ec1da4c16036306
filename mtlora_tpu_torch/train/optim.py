"""Optimizer, LR schedules, weight-decay and trainability masks, clipping.

Counterpart of ``mtlora_tpu/train/optim.py``:

  - the four step-wise schedules (timm parity), ``scaled_lrs`` (linear LR
    scaling by batch * world / 512, times the accumulation steps,
    :99-106) and ``build_schedule`` (over the epoch's updates, ``n_eff``,
    :109-130);
  - ``no_weight_decay_mask`` and ``lora_trainable_mask`` over the port's
    parameter names, which are the reference torch keys;
  - ``build_optimizer``: ``torch.optim.AdamW``, or ``torch.optim.SGD``
    with Nesterov momentum and the weight decay added to the gradient
    (optax's ``add_decayed_weights`` then ``sgd(momentum, nesterov=True)``,
    :234-239), over the trainable parameters in two groups, with and
    without weight decay; parameters that the mask freezes get
    ``requires_grad=False``, so they take no gradient (the JAX package
    computes their gradient and zeroes the update, ``multi_transform``
    with ``set_to_zero``);
  - ``clip_by_global_norm_``, optax's rule: ``(g / |g|) * max`` when
    ``|g| >= max``, else ``g`` unchanged;
  - ``count_params``, the parameter accounting ``main.py`` logs.

The schedules are Python functions of the update index, counted from 0
as optax counts; they return Python floats, so setting the LR needs no
host sync.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The ``TRAIN`` settings the step depends on (``mtlora_tpu/config.py``
    defaults, with the batch size of ``DATA.BATCH_SIZE``)."""
    batch_size: int = 32
    epochs: int = 300
    warmup_epochs: int = 20
    base_lr: float = 5e-4
    warmup_lr: float = 5e-7
    min_lr: float = 5e-6
    weight_decay: float = 0.05
    clip_grad: float = 5.0
    optimizer: str = "adamw"
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    momentum: float = 0.9             # SGD's
    scheduler: str = "cosine"
    warmup_prefix: bool = True
    decay_epochs: float = 30
    decay_rate: float = 0.1
    gamma: float = 0.1
    multisteps: Tuple[float, ...] = ()
    accumulation_steps: int = 1
    freeze_patch_embed: bool = False
    freeze_layer_norm: bool = False
    freeze_relative_position_bias: bool = False
    freeze_downsample_reduction: bool = False
    bias_mode: str = "none"           # MODEL.MTLORA.BIAS


def train_from_config(config) -> TrainConfig:
    """From a loaded reference-schema config node, read by attribute."""
    t = config.TRAIN
    sch = t.LR_SCHEDULER
    return TrainConfig(
        batch_size=int(config.DATA.BATCH_SIZE),
        epochs=int(t.EPOCHS),
        warmup_epochs=int(t.WARMUP_EPOCHS),
        base_lr=float(t.BASE_LR),
        warmup_lr=float(t.WARMUP_LR),
        min_lr=float(t.MIN_LR),
        weight_decay=float(t.WEIGHT_DECAY),
        clip_grad=float(t.CLIP_GRAD or 0.0),
        optimizer=str(t.OPTIMIZER.NAME).lower(),
        betas=tuple(float(b) for b in t.OPTIMIZER.BETAS),
        eps=float(t.OPTIMIZER.EPS),
        momentum=float(t.OPTIMIZER.MOMENTUM),
        scheduler=str(sch.NAME),
        warmup_prefix=bool(sch.WARMUP_PREFIX),
        decay_epochs=float(sch.DECAY_EPOCHS),
        decay_rate=float(sch.DECAY_RATE),
        gamma=float(sch.GAMMA),
        multisteps=tuple(float(m) for m in sch.MULTISTEPS),
        accumulation_steps=int(t.ACCUMULATION_STEPS),
        freeze_patch_embed=bool(t.FREEZE_PATCH_EMBED),
        freeze_layer_norm=bool(t.FREEZE_LAYER_NORM),
        freeze_relative_position_bias=bool(t.FREEZE_RELATIVE_POSITION_BIAS),
        freeze_downsample_reduction=bool(t.FREEZE_DOWNSAMPLE_REDUCTION),
        bias_mode=str(config.MODEL.MTLORA.BIAS),
    )


# ---------------------------------------------------------------------------
# Schedules (timm step-wise parity)
# ---------------------------------------------------------------------------

def _warm(step, base_lr, warmup_lr, warmup_steps):
    return warmup_lr + step * ((base_lr - warmup_lr) / max(warmup_steps, 1))


def cosine_schedule(base_lr, warmup_lr, min_lr, warmup_steps, total_steps,
                    warmup_prefix=True) -> Callable[[int], float]:
    """timm CosineLRScheduler, t_in_epochs=False, cycle_limit=1."""
    t_initial = (total_steps - warmup_steps) if warmup_prefix else total_steps

    def fn(step):
        if step < warmup_steps:
            return _warm(step, base_lr, warmup_lr, warmup_steps)
        t = min(step - warmup_steps if warmup_prefix else step, t_initial)
        return min_lr + 0.5 * (base_lr - min_lr) * (
            1.0 + math.cos(math.pi * t / max(t_initial, 1)))

    return fn


def linear_schedule(base_lr, warmup_lr, warmup_steps, total_steps,
                    lr_min_rate=0.01) -> Callable[[int], float]:
    """timm-style LinearLRScheduler."""
    total_t = max(total_steps - warmup_steps, 1)

    def fn(step):
        if step < warmup_steps:
            return _warm(step, base_lr, warmup_lr, warmup_steps)
        t = min(max(step - warmup_steps, 0), total_t)
        return base_lr - (base_lr - base_lr * lr_min_rate) * (t / total_t)

    return fn


def step_schedule(base_lr, warmup_lr, warmup_steps, decay_steps,
                  decay_rate) -> Callable[[int], float]:
    def fn(step):
        if step < warmup_steps:
            return _warm(step, base_lr, warmup_lr, warmup_steps)
        n = math.floor((step - warmup_steps) / max(decay_steps, 1))
        return base_lr * decay_rate ** max(n, 0)

    return fn


def multistep_schedule(base_lr, warmup_lr, warmup_steps, milestones,
                       gamma) -> Callable[[int], float]:
    milestones = sorted(milestones)

    def fn(step):
        if step < warmup_steps:
            return _warm(step, base_lr, warmup_lr, warmup_steps)
        return base_lr * gamma ** sum(step >= m for m in milestones)

    return fn


def scaled_lrs(tcfg: TrainConfig, world_size: int = 1
               ) -> Tuple[float, float, float]:
    """Linear LR scaling by batch * world / 512, times the accumulation
    steps where there are more than one (``main.py:578-592``)."""
    scale = tcfg.batch_size * world_size / 512.0
    if tcfg.accumulation_steps > 1:
        scale *= tcfg.accumulation_steps
    return (tcfg.base_lr * scale, tcfg.warmup_lr * scale,
            tcfg.min_lr * scale)


def build_schedule(tcfg: TrainConfig, n_iter_per_epoch: int,
                   world_size: int = 1) -> Callable[[int], float]:
    """Schedule dispatch with the LR scaling applied, over the updates of
    an epoch: ``n_iter_per_epoch // accumulation_steps`` where the steps
    accumulate."""
    base_lr, warmup_lr, min_lr = scaled_lrs(tcfg, world_size)
    accum = max(tcfg.accumulation_steps, 1)
    n = n_iter_per_epoch // accum if accum > 1 else n_iter_per_epoch
    num_steps = int(tcfg.epochs * n)
    warmup_steps = int(tcfg.warmup_epochs * n)
    if tcfg.scheduler == "cosine":
        return cosine_schedule(base_lr, warmup_lr, min_lr, warmup_steps,
                               num_steps, warmup_prefix=tcfg.warmup_prefix)
    if tcfg.scheduler == "linear":
        return linear_schedule(base_lr, warmup_lr, warmup_steps, num_steps)
    if tcfg.scheduler == "step":
        return step_schedule(base_lr, warmup_lr, warmup_steps,
                             int(tcfg.decay_epochs * n), tcfg.decay_rate)
    if tcfg.scheduler == "multistep":
        return multistep_schedule(
            base_lr, warmup_lr, warmup_steps,
            [int(m * n) for m in tcfg.multisteps], tcfg.gamma)
    raise NotImplementedError(f"scheduler {tcfg.scheduler}")


# ---------------------------------------------------------------------------
# Masks over the port's parameter names
# ---------------------------------------------------------------------------

def no_weight_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """True -> weight decay applies: not for 1-D parameters, biases, the
    absolute position embedding or the relative position bias table."""
    return {name: not (p.dim() <= 1 or name.rsplit(".", 1)[-1] == "bias"
                       or "absolute_pos_embed" in name
                       or "relative_position_bias_table" in name)
            for name, p in model.named_parameters()}


def lora_trainable_mask(model: nn.Module, tcfg: TrainConfig
                        ) -> Dict[str, bool]:
    """``mark_only_lora_as_trainable`` with frozen pretrained weights (the
    only mode the port runs): every parameter outside the backbone
    trains; inside it, only the adapters and what the ``TRAIN.FREEZE_*``
    flags leave free (patch embedding, norms, the merges' reduction, the
    relative position bias table), plus every bias under ``MTLORA.BIAS
    all``."""
    out = {}
    for name, _ in model.named_parameters():
        segs = name.split(".")
        if segs[0] != "backbone":
            out[name] = True
            continue
        trainable = (
            any(seg.startswith("lora_") for seg in segs)
            or (not tcfg.freeze_patch_embed and "patch_embed" in name)
            or (not tcfg.freeze_layer_norm and "norm" in name)
            or (not tcfg.freeze_downsample_reduction
                and "downsample" in name and "reduction" in name)
            or (not tcfg.freeze_relative_position_bias
                and "relative_position_bias_table" in name))
        if tcfg.bias_mode == "all" and segs[-1] == "bias":
            trainable = True
        out[name] = trainable
    return out


# ---------------------------------------------------------------------------
# Optimizer and clipping
# ---------------------------------------------------------------------------

def build_optimizer(model: nn.Module, tcfg: TrainConfig
                    ) -> torch.optim.Optimizer:
    """AdamW (``TRAIN.OPTIMIZER.NAME adamw``) or SGD with Nesterov
    momentum (``sgd``: the decay added to the gradient, then the momentum
    trace, as optax's chain) over the trainable parameters, in a
    weight-decay group and a no-decay group; frozen parameters get
    ``requires_grad=False``. Each group carries ``updates``, the number of
    updates made, from which the step takes the schedule's index."""
    if tcfg.optimizer not in ("adamw", "sgd"):
        raise NotImplementedError(
            f"optimizer {tcfg.optimizer!r} (the JAX package takes adamw "
            "and sgd)")
    trainable = lora_trainable_mask(model, tcfg)
    decay = no_weight_decay_mask(model)
    groups: Dict[bool, List[nn.Parameter]] = {True: [], False: []}
    for name, p in model.named_parameters():
        p.requires_grad_(trainable[name])
        if trainable[name]:
            groups[decay[name]].append(p)
    param_groups = [
        {"params": groups[True], "weight_decay": tcfg.weight_decay,
         "updates": 0},
        {"params": groups[False], "weight_decay": 0.0, "updates": 0}]
    if tcfg.optimizer == "sgd":
        return torch.optim.SGD(param_groups, lr=0.0,
                               momentum=tcfg.momentum, nesterov=True)
    return torch.optim.AdamW(param_groups, lr=0.0, betas=tcfg.betas,
                             eps=tcfg.eps)


def count_params(model: nn.Module, tcfg: TrainConfig) -> Dict[str, int]:
    """The parameter accounting of ``main.py:build_all``
    (``count_params``, :257-275): total, LoRA (any name segment holding
    "lora"), decoder (outside the backbone), trainable (the mask of
    :func:`lora_trainable_mask`) and extra (trainable, neither)."""
    trainable = lora_trainable_mask(model, tcfg)
    out = {"total": 0, "lora": 0, "decoder": 0, "trainable": 0}
    for name, p in model.named_parameters():
        n = p.numel()
        out["total"] += n
        out["lora"] += n if any("lora" in seg
                                for seg in name.split(".")) else 0
        out["decoder"] += n if name.split(".")[0] != "backbone" else 0
        out["trainable"] += n if trainable[name] else 0
    out["extra"] = out["trainable"] - (out["lora"] + out["decoder"])
    return out


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """In place, optax's ``clip_by_global_norm``: each g becomes
    ``(g / norm) * max_norm`` when ``norm >= max_norm``. Returns the
    pre-clip norm. No host sync: the choice is a ``torch.where``."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm
