"""Fused LayerNorm + whole MLP with shared LoRA on both layers: the CUDA
kernels, their plain versions, counters.

Counterpart of ``mtlora_tpu/ops/pallas_ln_mlp.py`` (kernel 4 and its
backward 4b), for the blocks that carry no task streams:

    ln = LN(x)                                   (fp32 statistics)
    h  = lnc W1^T + b1 + s1 (drop1(ln) A1^T) B1^T
    g  = gelu(h)                                 (tanh form in bf16)
    y  = gc W2^T + b2 + s2 (drop2(g) A2^T) B2^T

The forward never writes the ``[M, 4C]`` hidden: it walks it in chunks,
the weights streaming through shared memory; :func:`fwd_plan` sizes its
launch.
The backward recomputes ln, h, g and both masks once, in the same chunks,
and writes two bf16 ``[M, 4C]`` tensors, du1 = bf16(s1 dh) and
bf16(drop2(g)), from which the weight-gradient products take dB1 and dA2
(no second recompute); :func:`bwd_plan` sizes its launch. Weights
come in the port's module layouts (``fc1.linear.weight [4C, C]``,
``fc1.lora_shared_A [r, C]``, ``fc1.lora_shared_B [4C, r]``, and fc2's
likewise), cast to the compute dtype; the adapters' gradients come back in
those layouts. GELU is the JAX kernel's: the tanh form in bf16 (the
kernels' only dtype), exact erf otherwise (``ln_lora.gelu_form``); the
port's unfused MLP keeps the exact erf, as the JAX jnp path does.
Cast points as ``ln_mlp_reference`` (:326-349) and ``_bwd_kernel``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mtlora_tpu_torch.ops import _build, dropout
from mtlora_tpu_torch.ops.ln_lora import (
    ROW_TILE,
    SMEM_LIMIT,
    _acc,
    _check,
    _stream,
    _sms,
    gelu_pair,
    layer_norm_bwd,
    layer_norm_parts,
    require_cuda,
    stripes_for,
)


def _hidden(x, gamma, beta, w1, bias1, a1, bb1, seed, s1, drop):
    """LN, the masked LN and the hidden: ``(ln, xhat, inv, lnd, keep1, m1,
    h)`` in the accumulation dtype, lnd and m1 rounded as the kernel
    rounds them."""
    cdt, f = x.dtype, _acc(x.dtype)
    ln, xhat, inv = layer_norm_parts(x, gamma, beta)
    h = ln.to(cdt).to(f) @ w1.to(f).t() + bias1.to(f)
    lnd = keep1 = m1 = None
    if s1 != 0.0:
        keep1 = (dropout.keep_mask(seed, 0, *ln.shape, drop)
                 if drop > 0.0 else None)
        lnd = (ln if keep1 is None else dropout.apply(ln, keep1, drop))
        lnd = lnd.to(cdt).to(f)
        m1 = (lnd @ a1.to(f).t()).to(cdt).to(f)
        h = h + s1 * (m1 @ bb1.to(f).t())
    return ln, xhat, inv, lnd, keep1, m1, h


def _dropped_g(gl, seed, s2, drop, cdt):
    keep2 = (dropout.keep_mask(seed, 1, *gl.shape, drop)
             if (drop > 0.0 and s2 != 0.0) else None)
    gd = gl if keep2 is None else dropout.apply(gl, keep2, drop)
    return gd.to(cdt).to(gl.dtype), keep2


def ln_mlp_plain(x, gamma, beta, w1, bias1, a1, bb1, w2, bias2, a2, bb2,
                 seed, s1: float, s2: float, drop: float):
    """y [M, C] of kernel 4 from x [M, C]."""
    cdt, f = x.dtype, _acc(x.dtype)
    *_, h = _hidden(x, gamma, beta, w1, bias1, a1, bb1, seed, s1, drop)
    gl, _ = gelu_pair(h, cdt)
    y = gl.to(cdt).to(f) @ w2.to(f).t() + bias2.to(f)
    if s2 != 0.0:
        gd, _ = _dropped_g(gl, seed, s2, drop, cdt)
        m2 = (gd @ a2.to(f).t()).to(cdt).to(f)
        y = y + s2 * (m2 @ bb2.to(f).t())
    return y.to(cdt)


def ln_mlp_bwd_plain(x, gamma, beta, w1, bias1, a1, bb1, w2, bias2, a2, bb2,
                     seed, s1: float, s2: float, drop: float, gy):
    """``(dx, dgamma, dbeta, da1, dbb1, da2, dbb2)`` of
    :func:`ln_mlp_plain` with the cast points of ``_bwd_kernel``
    (:103-209): gy rounded for ``dg = gy W2``; ``du2 = s2 gy``,
    ``dm2 = du2 B2`` rounded; ``dh = dg gelu'(h)`` in fp32, rounded for
    ``dln = dh W1``; ``du1 = s1 dh``, ``dm1 = du1 B1`` rounded."""
    cdt, f = x.dtype, _acc(x.dtype)
    ln, xhat, inv, lnd, keep1, m1, h = _hidden(
        x, gamma, beta, w1, bias1, a1, bb1, seed, s1, drop)
    gl, dgelu = gelu_pair(h, cdt)
    gyf = gy.to(f)
    dg = gyf.to(cdt).to(f) @ w2.to(f)
    zeros = dict(dtype=f, device=x.device)
    da2, dbb2 = torch.zeros(a2.shape, **zeros), torch.zeros(bb2.shape, **zeros)
    if s2 != 0.0:
        gd, keep2 = _dropped_g(gl, seed, s2, drop, cdt)
        m2 = (gd @ a2.to(f).t()).to(cdt).to(f)
        du2 = (s2 * gyf).to(cdt).to(f)
        dm2 = (du2 @ bb2.to(f)).to(cdt).to(f)
        dbb2 = du2.t() @ m2
        da2 = dm2.t() @ gd
        dgd = dm2 @ a2.to(f)
        dg = dg + (dgd if keep2 is None else dropout.apply(dgd, keep2, drop))
    dh = dg * dgelu
    dln = dh.to(cdt).to(f) @ w1.to(f)
    da1, dbb1 = torch.zeros(a1.shape, **zeros), torch.zeros(bb1.shape, **zeros)
    if s1 != 0.0:
        du1 = (s1 * dh).to(cdt).to(f)
        dm1 = (du1 @ bb1.to(f)).to(cdt).to(f)
        dbb1 = du1.t() @ m1
        da1 = dm1.t() @ lnd
        dlnd = dm1 @ a1.to(f)
        dln = dln + (dlnd if keep1 is None
                     else dropout.apply(dlnd, keep1, drop))
    dx, dgam, dbet = layer_norm_bwd(dln, xhat, inv, gamma)
    return dx.to(x.dtype), dgam, dbet, da1, dbb1, da2, dbb2


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_dims(name, C: int, H4: int, r: int):
    if C % 32 or H4 % 64 or r != 64 or C > 768:
        raise ValueError(f"{name} kernel: needs C % 32 == 0 and C <= 768 "
                         f"({C}), 4C % 64 == 0 ({H4}) and r == 64 ({r})")


def _shapes(x, w1, a1, name):
    require_cuda(name, x)
    M, C = x.shape
    H4, r = w1.shape[0], a1.shape[0]
    _check_dims(name, C, H4, r)
    return M, C, H4, r


def _operands(x, gamma, beta, w1, bias1, a1, bb1, w2, bias2, a2, bb2, seed,
              M, C, H4, r):
    return ([("x", x), ("gamma", gamma), ("beta", beta), ("w1", w1),
             ("bias1", bias1), ("a1", a1), ("bb1", bb1), ("w2", w2),
             ("bias2", bias2), ("a2", a2), ("bb2", bb2), ("seed", seed)],
            [(M, C), (C,), (C,), (H4, C), (H4,), (r, C), (H4, r), (C, H4),
             (C,), (r, H4), (C, r), (2,)])


def _drop_args(drop):
    use = int(drop > 0.0)
    return (dropout.threshold(drop) if use else 0, use,
            dropout.inv_keep(drop) if use else 1.0)


# the constants of csrc/ln_mlp.cu that the forward's plan sizes its shared
# memory by (the kernel traps if the plan's bytes do not hold its layout)
FWD_CHUNK = 64          # a warp's hidden chunk and the slice width (kS)
FWD_STAGES = 16         # slots in the TMA ring (kStages)
FWD_GROUP = 8           # slots a ring barrier (kGroup)
FWD_WARPS = 8           # warps of a row block (kWarps)
FWD_WIDTHS = (96, 128, 192)   # y columns of a warp: the kernel's instances


class FwdPlan(NamedTuple):
    """Launch plan of kernel 4: rows per block, warps that share a row
    group (splitting its y columns), ring depth and slices a barrier,
    dynamic shared-memory bytes, blocks, and the bytes of weight slices
    they stream from L2."""

    bm: int
    wn: int
    stages: int
    group: int
    smem: int
    blocks: int
    slice_bytes: int


def fwd_plan(M: int, C: int, H4: int, r: int) -> FwdPlan:
    """Kernel 4's plan for x [M, C], hidden H4, rank r: WN warps share 16
    rows so that a warp's y tile (16 x C / WN fp32) stays at most 96
    registers a thread: WN = 1 at C <= 192, 2 at C <= 384, else 4; a block
    of 8 warps then owns 128 / WN rows, and the last block masks the rows
    past M. Shared memory: up to 1023 bytes to the ring's 1024-byte
    alignment, the ring, the bf16(ln) tile, and where WN > 1 the m1 tile
    and each row group's two g tiles (bf16); mu and inv (fp32); an
    mbarrier per group of the ring."""
    _check_dims("LN+MLP forward", C, H4, r)
    wn = 1 if C <= 192 else 2 if C <= 384 else 4
    if C % wn or C // wn not in FWD_WIDTHS or H4 % (FWD_CHUNK * wn):
        raise ValueError(
            f"LN+MLP forward kernel: needs C / WN in {FWD_WIDTHS} ({C} / "
            f"{wn}) and 4C % {FWD_CHUNK * wn} == 0 ({H4})")
    bm = ROW_TILE * FWD_WARPS // wn
    shared = (bm * (FWD_CHUNK + 8) + 2 * bm * (FWD_CHUNK * wn + 8)
              if wn > 1 else 0)
    smem = (1024 + 2 * (FWD_STAGES * FWD_CHUNK ** 2 + bm * (C + 8) + shared)
            + 4 * 2 * bm + 8 * (FWD_STAGES // FWD_GROUP))
    if smem > SMEM_LIMIT:
        raise ValueError(f"LN+MLP forward kernel: {smem} bytes of shared "
                         f"memory at C = {C} exceed {SMEM_LIMIT}")
    blocks = -(-M // bm)
    # per block: A1 and B2, per super-chunk of wn x 64 hidden columns B1,
    # W1, A2 and W2; a slice is 64 x 64 bf16
    ncs = -(-C // FWD_CHUNK)
    slices = 2 * ncs + H4 // (FWD_CHUNK * wn) * 2 * wn * (ncs + 1)
    return FwdPlan(bm, wn, FWD_STAGES, FWD_GROUP, smem, blocks,
                   blocks * slices * 2 * FWD_CHUNK ** 2)


def ln_mlp_fwd(x, gamma, beta, w1, bias1, a1, bb1, w2, bias2, a2, bb2, seed,
               s1: float, s2: float, drop: float):
    """Kernel 4 forward, no autograd: plain for CPU tensors, the kernel for
    CUDA tensors (bf16, int32 seed) at the launch of :func:`fwd_plan`."""
    args = (x, gamma, beta, w1, bias1, a1, bb1, w2, bias2, a2, bb2, seed)
    if x.device.type == "cpu":
        return ln_mlp_plain(*args, s1, s2, drop)
    M, C, H4, r = _shapes(x, w1, a1, "LN+MLP forward")
    _check("LN+MLP forward", x, *_operands(*args, M, C, H4, r))
    plan = fwd_plan(M, C, H4, r)
    y = torch.empty_like(x)
    err = _build.library().mtlora_ln_mlp_fwd(
        *(t.data_ptr() for t in args), y.data_ptr(), M, C, H4, r, plan.bm,
        plan.smem, float(s1), float(s2), *_drop_args(drop), _stream(x))
    _build.check(err, "mtlora_ln_mlp_fwd")
    ln_mlp_fwd.launches += 1
    return y


# the constants of csrc/ln_mlp_bwd.cu that the backward's plan sizes its
# shared memory by (the kernel traps if the plan's bytes do not hold its
# layout)
BWD_CHUNK = 64          # hidden chunk and weight-slice width (kS)
BWD_STAGES = 4          # slices in the cp.async ring (kStages)
BWD_WARPS = 8           # warps of a row block (kWarps)


class BwdPlan(NamedTuple):
    """Launch plan of kernel 4b: rows per block, hidden chunk width, ring
    depth, whether a block keeps its chunk's W1 slices from h for dln,
    dynamic shared-memory bytes of the row kernel, its blocks, the bytes of
    weight slices they stream from L2, the row stripes of the
    weight-gradient products of [r, C] (dA1, dB2) and [4C, r] (dB1, dA2),
    and the scratch the wrapper allocates: name -> (shape, dtype)."""

    bm: int
    chunk: int
    stages: int
    keep_w1: bool
    smem: int
    blocks: int
    slice_bytes: int
    sa: int
    sh: int
    scratch: dict


def bwd_plan(M: int, C: int, H4: int, r: int, sms: int) -> BwdPlan:
    """Kernel 4b's plan for x [M, C], hidden H4, rank r on a card of
    ``sms`` SMs: a block owns 64 rows, or 32 where C > 384 so that its fp32
    dln (rows x C) stays at 96 registers a thread; the last block masks the
    rows past M. Scratch: bf16(drop1(ln)) ``lnd`` [M, C], the rank rows
    ``mbuf`` (m1, dm1, m2, dm2) [4, M, r], ``hbuf`` (du1, bf16(drop2(g)))
    [2, M, H4] in bf16; the per-16-row dgamma/dbeta partials ``gb`` and
    the weight-gradient stripes ``part`` (the four products one after
    another) in fp32."""
    _check_dims("LN+MLP backward", C, H4, r)
    ncs = -(-C // BWD_CHUNK)
    bm = 64 if ncs <= 6 else 32
    wn = BWD_WARPS // (bm // ROW_TILE)
    # the chunk's W1 slices are kept for the dln products where they fit
    # beside the 64-row tiles and one block takes an SM (3 <= ncs <= 6)
    keep_w1 = 3 <= ncs <= 6
    keep = ncs if keep_w1 else 0
    smem = (2 * ((BWD_STAGES + keep) * BWD_CHUNK ** 2 + 2 * bm * (C + 8)
                 + 5 * bm * (BWD_CHUNK + 8))
            + 4 * (2 * bm + 2 * wn * bm))
    if smem > SMEM_LIMIT:
        raise ValueError(f"LN+MLP backward kernel: {smem} bytes of shared "
                         f"memory at C = {C} exceed {SMEM_LIMIT}")
    blocks = -(-M // bm)
    # per block: A1 and B2 (m1, dm2), per hidden chunk B1, W1, A2, W2, B1
    # and (unless kept) W1 again, then A1 (dl); a slice is 64 x 64 bf16
    slices = 3 * ncs + H4 // BWD_CHUNK * ((2 if keep else 3) * ncs + 3)
    sa = stripes_for(sms, M, r, C)
    sh = stripes_for(sms, M, H4, r)
    bf16, f32 = torch.bfloat16, torch.float32
    scratch = {
        "lnd": ((M, C), bf16),
        "mbuf": ((4, M, r), bf16),
        "hbuf": ((2, M, H4), bf16),
        "gb": ((blocks * bm // ROW_TILE, 2, C), f32),
        "part": ((max(sa * r * C, sh * H4 * r),), f32),
    }
    return BwdPlan(bm, BWD_CHUNK, BWD_STAGES, keep_w1, smem, blocks,
                   blocks * slices * 2 * BWD_CHUNK ** 2, sa, sh, scratch)


def bwd_scratch(plan: BwdPlan, device) -> dict:
    """The scratch tensors of ``plan``, as :func:`ln_mlp_bwd` allocates
    them."""
    return {name: torch.empty(shape, dtype=dt, device=device)
            for name, (shape, dt) in plan.scratch.items()}


def ln_mlp_bwd(x, gamma, beta, w1, bias1, a1, bb1, w2, bias2, a2, bb2, seed,
               s1: float, s2: float, drop: float, gy):
    """``(dx, dgamma, dbeta, da1, dbb1, da2, dbb2)`` of
    :func:`ln_mlp_bwd_plain`: plain for CPU tensors; for CUDA tensors the
    row kernel (dx, the rank rows, du1 and bf16(drop2(g)), gamma/beta
    partials), then the weight-gradient kernels of dA1, dB2, dB1 and dA2 and
    the fixed-order reductions, all on the weights' module layouts."""
    args = (x, gamma, beta, w1, bias1, a1, bb1, w2, bias2, a2, bb2, seed)
    if x.device.type == "cpu":
        return ln_mlp_bwd_plain(*args, s1, s2, drop, gy)
    M, C, H4, r = _shapes(x, w1, a1, "LN+MLP backward")
    names, shapes = _operands(*args, M, C, H4, r)
    _check("LN+MLP backward", x, names + [("gy", gy)], shapes + [(M, C)])
    plan = bwd_plan(M, C, H4, r, _sms(x.device))
    sc = bwd_scratch(plan, x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dgb, da1 = torch.empty((2, C), **f32), torch.empty((r, C), **f32)
    dh, dbb2 = torch.empty((2, H4 * r), **f32), torch.empty((C, r), **f32)
    err = _build.library().mtlora_ln_mlp_bwd(
        *(t.data_ptr() for t in (x, gamma, beta, w1, bias1, a1, bb1, w2, a2,
                                 bb2, seed, gy, dx)),
        *(sc[k].data_ptr() for k in ("lnd", "mbuf", "hbuf", "gb", "part")),
        dgb.data_ptr(), da1.data_ptr(), dh.data_ptr(), dbb2.data_ptr(),
        M, C, H4, r, plan.bm, int(plan.keep_w1), plan.smem, plan.sa,
        plan.sh, float(s1), float(s2), *_drop_args(drop), _stream(x))
    _build.check(err, "mtlora_ln_mlp_bwd")
    ln_mlp_bwd.launches += 1
    return (dx, dgb[0], dgb[1], da1, dh[0].view(H4, r), dh[1].view(r, H4),
            dbb2)


ln_mlp_fwd.launches = 0
ln_mlp_bwd.launches = 0


class LNMLPFn(torch.autograd.Function):
    """``custom_vjp`` of ``fused_ln_mlp``: gradients for x, gamma, beta and
    the four shared adapters; the frozen fc weights and biases take none."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, bias1, a1, bb1, w2, bias2, a2, bb2,
                seed, s1, s2, drop):
        ctx.save_for_backward(x, gamma, beta, w1, bias1, a1, bb1, w2, bias2,
                              a2, bb2, seed)
        ctx.consts = (s1, s2, drop)
        return ln_mlp_fwd(x, gamma, beta, w1, bias1, a1, bb1, w2, bias2, a2,
                          bb2, seed, s1, s2, drop)

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        dx, dg, db, da1, dbb1, da2, dbb2 = ln_mlp_bwd(
            *saved, *ctx.consts, gy.contiguous())
        return (dx, dg, db, None, None, da1, dbb1, None, None, da2, dbb2,
                None, None, None, None)


def fused_ln_mlp(x, gamma, beta, w1, bias1, a1, bb1, w2, bias2, a2, bb2,
                 seed, s1: float, s2: float, drop: float):
    """Kernel 4 on x [M, C] (see the module note), differentiable in x,
    gamma, beta and the shared adapters of both layers."""
    return LNMLPFn.apply(x, gamma, beta, w1, bias1, a1, bb1, w2, bias2, a2,
                         bb2, seed, float(s1), float(s2), float(drop))
