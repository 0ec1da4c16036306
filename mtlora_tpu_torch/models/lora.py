"""Frozen linear layer with task-shared and per-task low-rank adapters.

Counterpart of ``MTLoRALinear`` in ``mtlora_tpu/models/lora.py:169-572``,
``matrix`` shared mode:

    y   = x W^T + b + s   * (drop(x) A^T) B^T             (shared stream)
    y_t = x W^T + b + s_t * (x_t A_t^T) B_t^T              (task t)

The frozen GEMM acts on the SHARED x for every task stream; a layer given
no task inputs feeds all T adapters from the shared, dropped x. Dropout
(training only, ``lora.py:409-421``) hits the adapters' shared input and
never the task inputs; its mask comes from an explicit
``torch.Generator``. The frozen ``linear`` weight and bias take no
gradient (``MTLORA.FREEZE_PRETRAINED``, the JAX ``stop_gradient``).
Parameters are
fp32 in the reference torch layout (``linear.weight [out, in]``,
``lora_shared_A [r, in]``, ``lora_shared_B [out, r]``); the per-task
adapters are stacked, ``lora_tasks_A [T, r_max, in]`` and
``lora_tasks_B [T, out, r_max]``, and a constant rank mask keeps the
padded slots of tasks with rank below ``r_max`` at exactly zero. The
layer computes in the dtype of its input.

:meth:`MTLoRALinear.ln_fused` is the ``TPU.USE_PALLAS_LN`` prologue
(``_ln_fused``, ``lora.py:207-265``): it takes the PRE-norm input and the
block's ``nn.LayerNorm`` and runs LayerNorm, the frozen GEMM and the shared
adapter as kernel 2 (``ops/ln_lora.py``), its dropout mask hashed in the
kernel from two seeds drawn from the generator. It has no task branch, as
``_ln_fused`` has no materialized-task form.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mtlora_tpu_torch.ops import dropout as hash_dropout
from mtlora_tpu_torch.ops.attention import dtype_const
from mtlora_tpu_torch.ops.ln_lora import fused_ln_lora_linear


def inverted_dropout(x: torch.Tensor, rate: float,
                     generator: torch.Generator | None) -> torch.Tensor:
    """Keep each element with probability ``1 - rate`` and divide it by
    ``1 - rate`` in x's dtype (``lora.py:_fast_drop``); the mask is drawn
    from ``generator``, never from the global RNG."""
    if generator is None:
        raise ValueError("dropout in training needs an explicit "
                         "torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / dtype_const(1.0 - rate, x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


class MTLoRALinear(nn.Module):
    def __init__(self, in_features: int, out_features: int, *,
                 r_shared: int = 0, shared_scale: float = 1.0,
                 tasks: Sequence[str] = (), r_tasks: Sequence[int] = (),
                 task_scales: Sequence[float] = (), bias: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        self.linear = nn.Linear(in_features, out_features, bias=bias)
        self.linear.requires_grad_(False)
        self.dropout = float(dropout)
        self.r_shared = r_shared
        self.shared_scale = float(shared_scale)
        # per-task adapters exist only beside a shared one (lora.py:401)
        self.tasks = tuple(tasks) if r_shared > 0 else ()
        self.r_tasks = tuple(r_tasks) if self.tasks else ()
        self.task_scales = tuple(float(s) for s in task_scales)
        if r_shared > 0:
            self.lora_shared_A = nn.Parameter(torch.zeros(r_shared,
                                                          in_features))
            self.lora_shared_B = nn.Parameter(torch.zeros(out_features,
                                                          r_shared))
        if self.tasks:
            T, r_max = len(self.tasks), max(self.r_tasks)
            self.lora_tasks_A = nn.Parameter(torch.zeros(T, r_max,
                                                         in_features))
            self.lora_tasks_B = nn.Parameter(torch.zeros(T, out_features,
                                                         r_max))
            mask = (torch.arange(r_max)[None, :]
                    < torch.tensor(self.r_tasks)[:, None])
            self.register_buffer("rank_mask", mask.float(), persistent=False)
            self.register_buffer("task_scale", torch.tensor(self.task_scales),
                                 persistent=False)

    def forward(self, x: torch.Tensor, x_tasks: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """x [..., in]; x_tasks [T, ..., in] or None. Returns
        ``(y [..., out], y_tasks [T, ..., out] or None)``. In training,
        dropout draws from ``generator``."""
        dt = x.dtype
        w = self.linear.weight.to(dt)
        b = self.linear.bias.to(dt) if self.linear.bias is not None else None
        pretrained = F.linear(x, w, b)
        if self.r_shared == 0:
            return pretrained, None
        if self.training and self.dropout > 0.0:
            x = inverted_dropout(x, self.dropout, generator)
        shared = F.linear(F.linear(x, self.lora_shared_A.to(dt)),
                          self.lora_shared_B.to(dt)) * self.shared_scale
        y = pretrained + shared
        if not self.tasks:
            return y, None
        T = len(self.tasks)
        a_t = (self.lora_tasks_A * self.rank_mask[:, :, None]).to(dt)
        # the per-task scale rides on B, as the JAX layer folds it
        b_eff = self.lora_tasks_B.to(dt) * self.task_scale.to(dt).view(T, 1, 1)
        lead = x.shape[:-1]
        if x_tasks is None:
            mid = torch.matmul(x.reshape(1, -1, x.shape[-1]),
                               a_t.transpose(1, 2))            # [T, M, r]
        else:
            mid = torch.bmm(x_tasks.reshape(T, -1, x.shape[-1]),
                            a_t.transpose(1, 2))
        update = torch.bmm(mid, b_eff.transpose(1, 2))          # [T, M, out]
        y_tasks = pretrained[None] + update.view(T, *lead, -1)
        return y, y_tasks

    def kernel_operands(self, dt: torch.dtype):
        """The frozen weight and bias and the shared adapter in compute
        dtype ``dt``, module layouts: ``(wt [out, in], bias [out],
        at [r, in], bt [out, r])``."""
        lin = self.linear
        bias = (lin.bias if lin.bias is not None
                else torch.zeros(lin.out_features, device=lin.weight.device))
        return (lin.weight.to(dt), bias.to(dt), self.lora_shared_A.to(dt),
                self.lora_shared_B.to(dt))

    def drop_rate(self) -> float:
        return self.dropout if (self.training and self.dropout > 0.0) else 0.0

    def ln_fused(self, x: torch.Tensor, norm: nn.LayerNorm,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """``LN(x) W^T + b + s (drop(LN x) A^T) B^T`` on the pre-norm
        ``x [..., in]`` in one kernel-2 call; shared stream only."""
        if self.r_shared == 0 or self.tasks:
            raise ValueError("ln_fused needs a shared adapter and no task "
                             "branch (_ln_fused has no materialized-task "
                             "form)")
        dt = x.dtype
        lead = x.shape[:-1]
        drop = self.drop_rate()
        seed = (hash_dropout.draw_seed(generator, x.device) if drop > 0.0
                else torch.zeros(2, dtype=torch.int32, device=x.device))
        y = fused_ln_lora_linear(
            x.reshape(-1, x.shape[-1]).contiguous(), norm.weight.to(dt),
            norm.bias.to(dt), *self.kernel_operands(dt), seed,
            self.shared_scale, drop)
        return y.view(*lead, -1)
