"""Fused factored-task patch merge: the CUDA kernels, their plain versions,
counters.

Counterpart of ``mtlora_tpu/ops/pallas_task_merge.py`` (kernel 6 and its
backward 6b). At a stage-tail block that hands its task streams to the
patch merge unexpanded, task t's stream is

    y_t = base + c1_t (pre + s1_t mid1_t^T B1_t) + c2_t (p2 + s2_t mid2_t^T B2_t)

(``base`` the attention shortcut, ``pre`` proj's and ``p2`` fc2's frozen
outputs on the shared stream, ``c1``, ``c2`` the per-(task, sample)
drop-path coefficients) and the merge is the 2x2 gather, LN(4C) and the
4C -> 2C reduction of kernel 3. The ``[T, B, L, C]`` streams are never
written: the kernels form each source row from the shared rows and the
eight rank values of its token.

Operands as ``make_task_merge_operands`` (:387) prepares them, without the
TPU's pair-split and block-diagonal layouts: the coefficients fold into the
rank rows, ``midc = bf16(mid * c)`` (compute dtype), and the scales into
the rank matrices, ``Bs = bf16(B * s)``; the kernel sums ``((base + c1
pre) + c2 p2) + midc^T Bs`` in fp32 (``_tm_fwd_kernel`` :70), the LN in
fp32, ``bf16(ln) W^T`` in fp32, rounded once. The backward (``_tm_bwd_rule``
:300): ``dln = bf16(gy) W``, the LN backward per task, ``dbase = sum_t
dy_t``, ``dpre = sum_t c1_t dy_t``, ``dp2 = sum_t c2_t dy_t`` in fp32 in
task order, ``dU = bf16(dy)``, ``dmidc = bf16(Bs dU)``, ``dBs = midc^T dU``
(fp32), ``dW = bf16(gy)^T bf16(ln)`` over every task's rows; the
coefficients take no gradient; the chain rule back through ``midc`` and
``Bs`` is plain torch, as the JAX package leaves it to XLA. Every output is
in the compute dtype (the dtype of ``base``), as on the expand-then-merge
route.
"""

from __future__ import annotations

import torch

from mtlora_tpu_torch.ops import _build
from mtlora_tpu_torch.ops.ln_lora import (
    _acc,
    _stream,
    layer_norm_bwd,
    layer_norm_parts,
    merge_rows,
    unmerge_rows,
    wgrad_stripes,
)

RANKS = 8       # the kernels' r1 + r2 (4 + 4: r_max of the flagship)


def token_coef(c, B: int, L: int, T: int, dtype, device):
    """Per-(task, sample) coefficients [T, B] (None: ones) -> per token
    ``[T, 1, B*L]`` in ``dtype``."""
    if c is None:
        return torch.ones((T, 1, B * L), dtype=dtype, device=device)
    return c.to(dtype).repeat_interleave(L, dim=1).view(T, 1, B * L)


def rank_operands(mid1T, b1, mid2T, b2, c1, c2, s1, s2, B: int, L: int):
    """``(midc [T, S, M], Bs [T, S, C])`` in the compute dtype: the
    coefficients folded into the rank rows, the scales into B."""
    T, dt, dev = mid1T.shape[0], mid1T.dtype, mid1T.device
    midc = torch.cat([mid1T * token_coef(c1, B, L, T, dt, dev),
                      mid2T * token_coef(c2, B, L, T, dt, dev)], dim=1)

    def scaled(b, s):
        f = _acc(dt)
        return (b.to(f) * torch.tensor(s, dtype=f, device=dev).view(T, 1, 1)
                ).to(dt)

    return midc, torch.cat([scaled(b1, s1), scaled(b2, s2)], dim=1)


def _sample_coef(c, T, B, f, device):
    return (torch.ones((T, B), dtype=f, device=device) if c is None
            else c.reshape(T, B).to(f))


def task_streams(base, pre, p2, midc, bs, c1, c2):
    """The implicit streams ``y [T, B, L, C]`` in the accumulation dtype,
    summed in the kernel's order."""
    Bn, L, C = base.shape
    T = midc.shape[0]
    f = _acc(base.dtype)
    k1 = _sample_coef(c1, T, Bn, f, base.device).view(T, Bn, 1, 1)
    k2 = _sample_coef(c2, T, Bn, f, base.device).view(T, Bn, 1, 1)
    u = torch.einsum("tsm,tsc->tmc", midc.to(f), bs.to(f)).view(T, Bn, L, C)
    return (base.to(f)[None] + k1 * pre.to(f)[None]) + k2 * p2.to(f)[None] + u


def task_merge_plain(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1, s2,
                     gamma, beta, wt, H: int, W: int):
    """y [T, B, H/2*W/2, O] in base's dtype. base, pre, p2 [B, L, C];
    mid [T, r, B*L], b [T, r, C]; c1, c2 [T, B] (or [T, B, 1]) or None;
    s1, s2 the per-task scales; gamma, beta [4C], wt [O, 4C]."""
    Bn, L, C = base.shape
    cdt, f = base.dtype, _acc(base.dtype)
    midc, bs = rank_operands(mid1T, b1, mid2T, b2, c1, c2, s1, s2, Bn, L)
    y = task_streams(base, pre, p2, midc, bs, c1, c2)
    T = y.shape[0]
    ln, _, _ = layer_norm_parts(merge_rows(y.reshape(T * Bn, L, C), H, W),
                                gamma, beta)
    out = ln.to(cdt).to(f) @ wt.to(f).t()
    return out.to(cdt).view(T, Bn, (H // 2) * (W // 2), -1)


def task_merge_bwd_plain(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1,
                         s2, gamma, beta, wt, H: int, W: int, gy):
    """``(dbase, dpre, dp2, dmid1T, db1, dmid2T, db2, dgamma, dbeta, dwt)``
    of :func:`task_merge_plain` from ``gy [T, B, H/2*W/2, O]``: the bf16
    ones in their inputs' dtypes, db1, db2, dgamma, dbeta, dwt in the
    accumulation dtype."""
    Bn, L, C = base.shape
    cdt, f = base.dtype, _acc(base.dtype)
    r1 = mid1T.shape[1]
    midc, bs = rank_operands(mid1T, b1, mid2T, b2, c1, c2, s1, s2, Bn, L)
    y = task_streams(base, pre, p2, midc, bs, c1, c2)
    T = y.shape[0]
    ln, xhat, inv = layer_norm_parts(
        merge_rows(y.reshape(T * Bn, L, C), H, W), gamma, beta)
    g = gy.reshape(-1, gy.shape[-1]).to(cdt).to(f)
    dln = g @ wt.to(f)
    dwt = g.t() @ ln.to(cdt).to(f)
    dy, dgamma, dbeta = layer_norm_bwd(dln, xhat, inv, gamma)
    dy = unmerge_rows(dy, T * Bn, H, W).view(T, Bn, L, C)
    sums = []
    for c in (None, c1, c2):
        k = _sample_coef(c, T, Bn, f, base.device).view(T, Bn, 1, 1)
        acc = k[0] * dy[0]
        for t in range(1, T):
            acc = acc + k[t] * dy[t]
        sums.append(acc.to(cdt))
    du = dy.to(cdt).to(f).view(T, Bn * L, C)
    dmidc = torch.einsum("tsc,tmc->tsm", bs.to(f), du).to(cdt)
    dbs = torch.einsum("tsm,tmc->tsc", midc.to(f), du)
    return (*sums, *rank_grads(dmidc, dbs, c1, c2, s1, s2, r1, Bn, L),
            dgamma, dbeta, dwt)


def rank_grads(dmidc, dbs, c1, c2, s1, s2, r1: int, B: int, L: int):
    """``(dmid1T, db1, dmid2T, db2)`` from the gradients of ``midc`` and
    ``Bs`` (the chain rule of :func:`rank_operands`): ``dmid = bf16(dmidc
    c)``, ``db = bf16(dBs) s``."""
    T, dt, dev = dmidc.shape[0], dmidc.dtype, dmidc.device

    def unscale(d, s):
        f = _acc(dt)
        return d.to(dt).to(f) * torch.tensor(s, dtype=f, device=dev).view(
            T, 1, 1)

    return (dmidc[:, :r1] * token_coef(c1, B, L, T, dt, dev),
            unscale(dbs[:, :r1], s1),
            dmidc[:, r1:] * token_coef(c2, B, L, T, dt, dev),
            unscale(dbs[:, r1:], s2))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _kernel_operands(name, base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1,
                     s2, gamma, beta, wt, H, W):
    """Checks, and the operands in the kernels' layouts: the rank rows
    token-major ``[T, B*L, 8]``, Bs as ``[T, C, 8]`` and ``[T, 8, C]``, the
    coefficients ``[T, B, 2]`` fp32."""
    if base.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {base.device}")
    Bn, L, C = base.shape
    T, r1, M = mid1T.shape
    O = wt.shape[0]
    if (r1 + mid2T.shape[1] != RANKS or L != H * W or H % 2 or W % 2
            or C % 16 or O % 16 or M != Bn * L):
        raise ValueError(f"{name} kernel: needs r1 + r2 == {RANKS}, even H "
                         f"and W, C % 16 == 0 and 2C % 16 == 0; got mid1T "
                         f"{tuple(mid1T.shape)}, mid2T {tuple(mid2T.shape)}, "
                         f"base {tuple(base.shape)}, H {H}, W {W}")
    for label, t, shape in (("base", base, (Bn, L, C)), ("pre", pre, (Bn, L, C)),
                            ("p2", p2, (Bn, L, C)), ("gamma", gamma, (4 * C,)),
                            ("beta", beta, (4 * C,)), ("wt", wt, (O, 4 * C))):
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != shape
                or t.device != base.device or not t.is_contiguous()):
            raise ValueError(f"{name} kernel: {label} must be contiguous "
                             f"bf16 {shape} on {base.device}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for label, t in (("mid1T", mid1T), ("b1", b1), ("mid2T", mid2T),
                     ("b2", b2)):
        if t.dtype != torch.bfloat16 or t.device != base.device:
            raise ValueError(f"{name} kernel: {label} must be bf16 on "
                             f"{base.device}")
    midc, bs = rank_operands(mid1T, b1, mid2T, b2, c1, c2, s1, s2, Bn, L)
    coef = torch.stack([_sample_coef(c1, T, Bn, torch.float32, base.device),
                        _sample_coef(c2, T, Bn, torch.float32, base.device)],
                       dim=-1).contiguous()
    return (midc.transpose(1, 2).contiguous(),
            bs.transpose(1, 2).contiguous(), bs, coef, T, Bn, L, C, O)


def task_merge_fwd(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1, s2,
                   gamma, beta, wt, H: int, W: int):
    """Kernel 6 forward, no autograd: plain for CPU tensors, the kernel for
    CUDA tensors (bf16, r1 + r2 == 8)."""
    args = (base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1, s2, gamma,
            beta, wt, H, W)
    if base.device.type == "cpu":
        return task_merge_plain(*args)
    mid_tok, bs_cs, _, coef, T, Bn, L, C, O = _kernel_operands(
        "task merge forward", *args)
    y = torch.empty((T, Bn, L // 4, O), dtype=base.dtype, device=base.device)
    err = _build.library().mtlora_task_merge_fwd(
        base.data_ptr(), pre.data_ptr(), p2.data_ptr(), mid_tok.data_ptr(),
        bs_cs.data_ptr(), coef.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), wt.data_ptr(), y.data_ptr(), T, Bn, H, W, C, O,
        _stream(base))
    _build.check(err, "mtlora_task_merge_fwd")
    task_merge_fwd.launches += 1
    return y


def task_merge_bwd(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1, s2,
                   gamma, beta, wt, H: int, W: int, gy):
    """The gradients of :func:`task_merge_bwd_plain`: plain for CPU
    tensors; for CUDA tensors the row kernel (per task: dln, the LN rows,
    dxhat, the rows' statistics, gamma/beta partials), the combine kernel
    (dbase, dpre, dp2 summed over the tasks, dU), the rank-row kernel
    (dmidc), the weight-gradient kernels (dBs per task, dW over every
    task's rows) and the fixed-order reductions."""
    args = (base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1, s2, gamma,
            beta, wt, H, W)
    if base.device.type == "cpu":
        return task_merge_bwd_plain(*args, gy)
    mid_tok, bs_cs, bs_sc, coef, T, Bn, L, C, O = _kernel_operands(
        "task merge backward", *args)
    Mm, K, Ms = Bn * L // 4, 4 * C, Bn * L
    if (gy.dtype != torch.bfloat16 or tuple(gy.shape) != (T, Bn, L // 4, O)
            or not gy.is_contiguous()):
        raise ValueError("task merge backward kernel: gy must be contiguous "
                         f"bf16 {(T, Bn, L // 4, O)}")
    dev = base.device
    f32 = dict(dtype=torch.float32, device=dev)
    bf = dict(dtype=base.dtype, device=dev)
    tiles = -(-Mm // 16)
    sb = wgrad_stripes(dev, Ms, C, RANKS)
    sw = wgrad_stripes(dev, T * Mm, O, K)
    stats = torch.empty((T, 4, Mm), **f32)
    work = torch.empty((T, Mm, K), **f32)
    lbuf = torch.empty((T, Mm, K), **bf)
    gb = torch.empty((T * tiles, 2, K), **f32)
    du = torch.empty((T, Ms, C), **bf)
    dmid = torch.empty((T, Ms, RANKS), **bf)
    pb = torch.empty((sb, C, RANKS), **f32)
    pw = torch.empty((sw, O, K), **f32)
    dbase, dpre, dp2 = (torch.empty_like(base) for _ in range(3))
    dbs = torch.empty((T, C, RANKS), **f32)
    dgb = torch.empty((2, K), **f32)
    dwt = torch.empty((O, K), **f32)
    w_ko = wt.t().contiguous()
    err = _build.library().mtlora_task_merge_bwd(
        base.data_ptr(), pre.data_ptr(), p2.data_ptr(), mid_tok.data_ptr(),
        bs_cs.data_ptr(), bs_sc.data_ptr(), coef.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), w_ko.data_ptr(), gy.data_ptr(),
        stats.data_ptr(), work.data_ptr(), lbuf.data_ptr(), gb.data_ptr(),
        du.data_ptr(), dmid.data_ptr(), pb.data_ptr(), pw.data_ptr(),
        dbase.data_ptr(), dpre.data_ptr(), dp2.data_ptr(), dbs.data_ptr(),
        dgb.data_ptr(), dwt.data_ptr(), T, Bn, H, W, C, O, sb, sw,
        _stream(base))
    _build.check(err, "mtlora_task_merge_bwd")
    task_merge_bwd.launches += 1
    r1 = mid1T.shape[1]
    rank = rank_grads(dmid.transpose(1, 2), dbs.transpose(1, 2), c1, c2, s1,
                      s2, r1, Bn, L)
    return (dbase, dpre, dp2, *rank, dgb[0], dgb[1], dwt)


task_merge_fwd.launches = 0
task_merge_bwd.launches = 0


class TaskMergeFn(torch.autograd.Function):
    """``custom_vjp`` of ``task_merge_ln_linear`` with ``train_w``:
    gradients for base, pre, p2, the rank rows and matrices, gamma, beta
    and the reduction weight; the coefficients are constants."""

    @staticmethod
    def forward(ctx, base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, gamma,
                beta, wt, s1, s2, H, W):
        ctx.save_for_backward(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2,
                              gamma, beta, wt)
        ctx.consts = (s1, s2, H, W)
        return task_merge_fwd(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2,
                              s1, s2, gamma, beta, wt, H, W)

    @staticmethod
    def backward(ctx, gy):
        base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, gamma, beta, wt = (
            ctx.saved_tensors)
        s1, s2, H, W = ctx.consts
        (dbase, dpre, dp2, dmid1, db1, dmid2, db2, dg, dbe,
         dwt) = task_merge_bwd(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2,
                               s1, s2, gamma, beta, wt, H, W, gy.contiguous())
        return (dbase, dpre, dp2, dmid1, db1, dmid2, db2, None, None, dg,
                dbe, dwt, None, None, None, None)


def fused_task_merge(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1, s2,
                     gamma, beta, wt, H: int, W: int):
    """Kernel 6 (see the module note): ``y [T, B, H/2*W/2, O]``."""
    return TaskMergeFn.apply(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2,
                             gamma, beta, wt, tuple(map(float, s1)),
                             tuple(map(float, s2)), H, W)
