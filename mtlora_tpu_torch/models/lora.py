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

``use_pallas_gemm`` is ``TPU.USE_PALLAS_LORA_GEMM`` (``lora.py:445-456``):
a layer with a shared adapter and no task branch runs its frozen GEMM and
its shared adapter as kernel 8 (``ops/lora_matmul.py``), one input when
nothing is dropped and two in training with dropout, and adds its bias to
the kernel's output in the compute dtype. The JAX gate's other terms, a
frozen W and a static shared scale, hold for every layer of the port.

The ``TPU.USE_PALLAS_ADAPTER`` route keeps the stage-tail blocks' task
streams in rank space (``lora.py:33``, :575-757): proj returns a
:class:`FactoredTasks`, the attention task streams stay an implicit
:class:`TaskStream` whose LayerNorm and fc1 rank projection fold from the
shared tensors (:func:`fold_task_ln_project`), fc1 runs kernel 2's tail
mode (:meth:`MTLoRALinear.ln_fused_tail`), fc2 consumes fc1's factored
output through kernel 5 (``ops/adapter_mlp.py``) and stays factored, and
the block output is expanded once (:func:`expand_task_streams`) or handed
to the patch merge unexpanded (:class:`DeferredTasks`, kernel 6). Ranks
travel in the JAX layouts: ``midT [T, r, M]``, ``B [T, r, out]``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mtlora_tpu_torch.ops import dropout as hash_dropout
from mtlora_tpu_torch.ops.adapter_mlp import fused_adapter_mid
from mtlora_tpu_torch.ops.attention import dtype_const
from mtlora_tpu_torch.ops.ln_lora import fused_ln_lora_linear
from mtlora_tpu_torch.ops.lora_matmul import fused_lora_matmul

NO_TASK_INPUT = ("fc1 with task adapters but no upstream task streams on "
                 "the LN route (_ln_fused's x_tasks None branch, "
                 "lora.py:285-296) is not ported (ROADMAP.md, Queue 1, item "
                 "9); it is not on the flagship's path")


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


class FactoredTasks(NamedTuple):
    """A layer's per-task output in rank space (``lora.py:33``): task t is
    ``pretrained + scales[t] * midT[t]^T B[t]``."""
    pretrained: torch.Tensor       # [..., out], the frozen output
    midT: torch.Tensor             # [T, r, M] task A-projections
    B: torch.Tensor                # [T, r, out]
    scales: Tuple[float, ...]


class TaskStream(NamedTuple):
    """Implicit task streams ``y_t = base + coef_t (pre + s_t midT_t^T
    B_t)`` around the shared residual (``lora.py:575``): base the
    attention shortcut, pre proj's frozen output, coef the per-(task,
    sample) drop-path coefficients ``[T, B, 1]`` or None (all ones)."""
    base: torch.Tensor             # [B, L, C]
    pre: torch.Tensor              # [B, L, C]
    midT: torch.Tensor             # [T, r, M], M = B*L
    B: torch.Tensor                # [T, r, C]
    scales: Tuple[float, ...]
    coef: Optional[torch.Tensor]


class DeferredTasks(NamedTuple):
    """A stage-tail block's task streams handed to the patch merge
    unexpanded (``lora.py:595``): ``stream`` plus the MLP's factored output
    ``f2`` with its own drop-path coefficients ``coef2``."""
    stream: TaskStream
    f2: FactoredTasks
    coef2: Optional[torch.Tensor]


class MTLoRALinear(nn.Module):
    def __init__(self, in_features: int, out_features: int, *,
                 r_shared: int = 0, shared_scale: float = 1.0,
                 tasks: Sequence[str] = (), r_tasks: Sequence[int] = (),
                 task_scales: Sequence[float] = (), bias: bool = True,
                 dropout: float = 0.0, use_pallas_gemm: bool = False):
        super().__init__()
        self.use_pallas_gemm = use_pallas_gemm
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
                generator: torch.Generator | None = None, *,
                factored_tasks: bool = False,
                task_factored: FactoredTasks | None = None,
                x_dropped: torch.Tensor | None = None):
        """x [..., in]; x_tasks [T, ..., in] or None. Returns
        ``(y [..., out], y_tasks [T, ..., out] or None)``. In training,
        dropout draws from ``generator``, or takes ``x_dropped``, the
        input dropped upstream (kernel 2's ``out_drop`` output).
        ``factored_tasks``: the task output as a :class:`FactoredTasks`;
        its A-projections come from ``task_factored`` through kernel 5
        when an upstream layer's factored output is given
        (``lora.py:483-516``)."""
        if self.use_pallas_gemm and self.r_shared > 0 and not self.tasks:
            return self._lora_gemm(x, generator, x_dropped), None
        dt = x.dtype
        w = self.linear.weight.to(dt)
        b = self.linear.bias.to(dt) if self.linear.bias is not None else None
        pretrained = F.linear(x, w, b)
        if self.r_shared == 0:
            return pretrained, None
        if self.training and self.dropout > 0.0:
            x = (x_dropped.to(dt) if x_dropped is not None
                 else inverted_dropout(x, self.dropout, generator))
        shared = F.linear(F.linear(x, self.lora_shared_A.to(dt)),
                          self.lora_shared_B.to(dt)) * self.shared_scale
        y = pretrained + shared
        if not self.tasks:
            return y, None
        T = len(self.tasks)
        a_t = self.masked_task_A().to(dt)
        if factored_tasks:
            # proj (the shared, dropped input) or fc2 (fc1's factored output)
            if x_tasks is not None:
                raise ValueError("a factored task output takes the shared "
                                 "input or an upstream FactoredTasks")
            if task_factored is not None:
                f = task_factored
                mid = fused_adapter_mid(
                    f.midT, f.pretrained.reshape(-1, x.shape[-1]).contiguous(),
                    f.B, a_t, f.scales)
            else:
                mid = torch.matmul(a_t, x.reshape(-1, x.shape[-1]).t())
            return y, FactoredTasks(pretrained, mid, self.task_B(dt),
                                    self.task_scales)
        if task_factored is not None:
            raise ValueError("task_factored needs factored_tasks: the "
                             "adapter route keeps fc2's task output "
                             "factored")
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

    def _lora_gemm(self, x, generator, x_dropped):
        """``x W^T + s (drop(x) A^T) B^T`` in kernel 8, then ``+ b`` in x's
        dtype (``lora.py:445-456``); dropout stays outside the kernel, its
        mask drawn from ``generator`` as on the module path."""
        dt = x.dtype
        lead, K = x.shape[:-1], x.shape[-1]
        xd = None
        if self.training and self.dropout > 0.0:
            xd = (x_dropped.to(dt) if x_dropped is not None
                  else inverted_dropout(x, self.dropout, generator))
            xd = xd.reshape(-1, K).contiguous()
        wt, bias, at, bt = self.kernel_operands(dt)
        y = fused_lora_matmul(x.reshape(-1, K).contiguous(), xd, wt, at, bt,
                              self.shared_scale)
        if self.linear.bias is not None:
            y = y + bias
        return y.view(*lead, -1)

    def masked_task_A(self) -> torch.Tensor:
        """``lora_tasks_A [T, r_max, in]`` with the rank mask applied (the
        padded slots exactly zero), in the parameter dtype."""
        return self.lora_tasks_A * self.rank_mask[:, :, None]

    def task_B(self, dt: torch.dtype) -> torch.Tensor:
        """The task B matrices in the JAX layout ``[T, r_max, out]``."""
        return self.lora_tasks_B.to(dt).transpose(1, 2).contiguous()

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

    def ln_fused_tail(self, x: torch.Tensor, norm: nn.LayerNorm,
                      stream: TaskStream | None,
                      generator: torch.Generator | None = None,
                      out_drop: bool = False):
        """fc1 of a stage-tail block on the adapter route (``_ln_fused``
        with ``factored_tasks``, ``ln_act`` and ``out_drop``,
        ``lora.py:207-321``): one kernel-2 call in its tail mode on the
        pre-norm ``x [..., in]`` gives ``y = gelu(LN(x) W^T + b + s
        (drop(LN x) A^T) B^T)``, the frozen pre-activation ``p`` and, with
        ``out_drop`` in training, ``dropout(y)`` on hash stream 1; the
        task projection of LN(stream) folds from the shared tensors
        (:func:`fold_task_ln_project`). Returns ``(y, FactoredTasks(p,
        mid1T, B, scales), dropout(y) or None)``."""
        if self.r_shared == 0 or not self.tasks:
            raise ValueError("ln_fused_tail needs shared and task adapters")
        if stream is None:
            raise NotImplementedError(NO_TASK_INPUT)
        dt = x.dtype
        lead = x.shape[:-1]
        drop = self.drop_rate()
        seed = (hash_dropout.draw_seed(generator, x.device) if drop > 0.0
                else torch.zeros(2, dtype=torch.int32, device=x.device))
        want_d = out_drop and drop > 0.0
        outs = fused_ln_lora_linear(
            x.reshape(-1, x.shape[-1]).contiguous(), norm.weight.to(dt),
            norm.bias.to(dt), *self.kernel_operands(dt), seed,
            self.shared_scale, drop, out_p=True, out_act=True,
            out_drop=want_d)
        y, p = outs[0].view(*lead, -1), outs[1].view(*lead, -1)
        d = outs[2].view(*lead, -1) if want_d else None
        mid1 = fold_task_ln_project(stream, norm.weight, norm.bias,
                                    self.masked_task_A())
        return y, FactoredTasks(p, mid1, self.task_B(dt),
                                self.task_scales), d


def _scales(scales, dtype, device, ndim: int) -> torch.Tensor:
    """The per-task scales ``[T, 1, ..]`` (``ndim`` dims) in ``dtype``; to
    a card from pinned host memory without waiting, where a copy from
    pageable memory first waits for the stream (a host sync)."""
    t = torch.tensor(scales, dtype=dtype)
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    return t.view(-1, *([1] * (ndim - 1)))


def fold_task_ln_project(stream: TaskStream, gamma: torch.Tensor,
                         beta: torch.Tensor, a_t: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """``LN(y_t) A_t^T`` of the implicit streams without forming y_t
    (``lora.py:605-682``): with ``y_t = b + c (p + u_t)``, ``u_t = s_t
    midT_t^T B_t``, the statistics of y_t come from the moments of the
    shared b and p and rank-space cross terms, and
    ``LN(y) A^T = inv ((b g) A^T + c ((p g) A^T + s mid^T (B g) A^T) - mu
    (g A^T)) + beta A^T``; fp32 moments and ``var = max(E[y^2] - mu^2,
    0)`` as the JAX function. ``a_t [T, r1, C]`` (rank-masked).
    Returns mid1T ``[T, r1, M]`` in the stream's dtype."""
    C = stream.base.shape[-1]
    T, r, M = stream.midT.shape
    dt = stream.midT.dtype
    f = torch.promote_types(dt, torch.float32)
    dev = stream.midT.device
    # the JAX einsums take dt operands with fp32 accumulation: the dt
    # values in fp32
    b32 = stream.base.reshape(-1, C).to(dt).to(f)
    p32 = stream.pre.reshape(-1, C).to(dt).to(f)
    midf = stream.midT.to(f)
    Bm = stream.B.to(f)                                         # [T, r, C]
    s = _scales(stream.scales, f, dev, 2)                       # [T, 1]
    if stream.coef is None:
        c = torch.ones((T, 1), dtype=f, device=dev)
    else:
        nB = stream.coef.shape[1]
        c = stream.coef.reshape(T, nB, 1).to(f).expand(
            T, nB, M // nB).reshape(T, M)
    g32 = gamma.to(f)
    A32 = a_t.to(f)

    mu_b, mu_p = b32.mean(-1), p32.mean(-1)
    e_bb = (b32 * b32).mean(-1)
    e_pp = (p32 * p32).mean(-1)
    e_bp = (b32 * p32).mean(-1)
    bB = torch.einsum("mc,trc->tmr", b32, Bm)
    pB = torch.einsum("mc,trc->tmr", p32, Bm)
    mid_m = midf.transpose(1, 2)                                # [T, M, r]
    e_bu = s / C * (bB * mid_m).sum(-1)                         # [T, M]
    e_pu = s / C * (pB * mid_m).sum(-1)
    G = torch.einsum("tsc,trc->tsr", Bm, Bm)                    # [T, r, r]
    tmp = torch.einsum("tsr,trm->tsm", G, midf)
    e_uu = (s * s) / C * (midf * tmp).sum(1)
    mu_u = s / C * torch.einsum("tr,trm->tm", Bm.sum(-1), midf)

    mu = mu_b[None] + c * (mu_p[None] + mu_u)                   # [T, M]
    e_yy = (e_bb[None] + 2 * c * (e_bp[None] + e_bu)
            + c * c * (e_pp[None] + 2 * e_pu + e_uu))
    var = torch.clamp(e_yy - mu * mu, min=0.0)
    inv = torch.rsqrt(var + eps)

    gA = (A32 * g32[None, None, :]).to(dt).to(f)                # [T, r1, C]
    bgA = torch.einsum("mc,tqc->tqm", b32, gA)                  # [T, r1, M]
    pgA = torch.einsum("mc,tqc->tqm", p32, gA)
    BgA = torch.einsum("trc,tqc->trq", Bm, gA)                  # [T, r, r1]
    ugA = s.view(T, 1, 1) * torch.einsum("trm,trq->tqm", midf, BgA)
    gAs = torch.einsum("c,tqc->tq", g32, A32)
    bA = torch.einsum("c,tqc->tq", beta.to(f), A32)
    proj = (bgA + c[:, None, :] * (pgA + ugA)
            - mu[:, None, :] * gAs[..., None])
    return (inv[:, None, :] * proj + bA[..., None]).to(dt)


def expand_task_streams(stream: TaskStream, f2: FactoredTasks | None,
                        coef2: torch.Tensor | None = None) -> torch.Tensor:
    """The block-output task streams ``[T, B, L, C]`` in one pass
    (``lora.py:685-712``): ``base + c1 (pre + s midT^T B) [+ c2 (p2 +
    s2 mid2T^T B2)]``, in the stream's dtype."""
    Bb, L, C = stream.base.shape
    T = stream.midT.shape[0]
    dt, dev = stream.base.dtype, stream.base.device
    up1 = torch.bmm(stream.midT.transpose(1, 2),
                    stream.B * _scales(stream.scales, dt, dev, 3))
    d1 = stream.pre.reshape(1, -1, C) + up1
    if stream.coef is not None:
        d1 = (d1.view(T, Bb, L, C) * stream.coef.to(dt)[..., None]).view(
            T, -1, C)
    y = stream.base.reshape(1, -1, C) + d1
    if f2 is not None:
        up2 = torch.bmm(f2.midT.transpose(1, 2),
                        f2.B * _scales(f2.scales, dt, dev, 3))
        d2 = f2.pretrained.reshape(1, -1, C) + up2
        if coef2 is not None:
            d2 = (d2.view(T, Bb, L, C) * coef2.to(dt)[..., None]).view(
                T, -1, C)
        y = y + d2
    return y.view(T, Bb, L, C)


def droppath_coef(rate: float, T: int, B: int,
                  generator: torch.Generator | None,
                  device) -> torch.Tensor | None:
    """Per-(task, sample) stochastic-depth coefficients ``[T, B, 1]`` in
    {0, 1/keep} (fp32), one keep draw each from ``generator``; None when
    ``rate`` is 0 (``lora.py:715-722``)."""
    if rate <= 0.0:
        return None
    if generator is None:
        raise ValueError("drop-path in training needs an explicit "
                         "torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand((T, B, 1), generator=generator, device=device) < keep
    return mask.float() * dtype_const(1.0 / keep, torch.float32)


def expand_factored_tasks(f: FactoredTasks, lead, drop_path: float = 0.0,
                          generator: torch.Generator | None = None,
                          base: torch.Tensor | None = None) -> torch.Tensor:
    """``base + DropPath(pretrained + s_t midT_t^T B_t)`` as ``[T, *lead,
    out]`` (``lora.py:725-756``); ``drop_path`` > 0 draws one keep per
    (task, sample) from ``generator``; ``base`` None adds no residual
    (the reference's no-shortcut quirk)."""
    T, _, C = f.B.shape
    dt = f.B.dtype
    up = torch.bmm(f.midT.transpose(1, 2),
                   f.B * _scales(f.scales, dt, f.B.device, 3))
    y = (f.pretrained.reshape(1, -1, C) + up).view(T, *lead, C)
    if drop_path > 0.0:
        coef = droppath_coef(drop_path, T, lead[0], generator, y.device)
        y = y * coef.to(dt).view(T, lead[0], *([1] * (len(lead))))
    if base is None:
        return y
    return (base[None] if base.dim() == y.dim() - 1 else base) + y
