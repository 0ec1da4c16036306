"""Fused HRNet head MLP: the CUDA kernels, their plain versions, counters.

Counterpart of ``mtlora_tpu/ops/pallas_head.py``: the forward kernel
``csrc/head_mlp.cu`` and the backward kernel ``csrc/head_mlp_bwd.cu``
under one ``torch.autograd.Function`` (the ``custom_vjp`` of
``fused_head_mlp``), and :func:`bn_stats_from_x`, the exact batch moments
of the hidden from the input covariance, in plain differentiable torch.
The BN affine (``mul``, ``add``) is computed by the caller, from the
running statistics at eval and from :func:`bn_stats_from_x` in training,
so the gradient through the batch statistics composes with the kernel's
row-wise backward.
"""

from __future__ import annotations

import torch

from mtlora_tpu_torch.ops import _build

MAX_OUT = 64
MAX_C_BWD = 272


def _acc(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: fp32, or fp64 for fp64 inputs (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def bn_stats_from_x(x, ek, eb):
    """Batch moments of ``h = x @ ek + eb`` without forming h.

    x [M, C] and ek [C, O] in the compute dtype, eb [O] fp32. Returns
    ``(mu [O], var [O])`` fp32, biased variance, from one [C, C]
    covariance product over x read once:
    ``E[h^2] = diag(ek^T S ek) + 2 eb (E[x] ek) + eb^2``, ``S = E[x x^T]``."""
    M = x.shape[0]
    f = _acc(x.dtype)
    xf = x.to(f)
    s = torch.matmul(xf.t(), xf) / M
    mx = xf.mean(0)
    ekf = ek.to(f)
    ebf = eb.to(f)
    mxe = mx @ ekf
    mu = mxe + ebf
    e2 = (ekf * (s @ ekf)).sum(0) + 2.0 * ebf * mxe + ebf * ebf
    # E[h^2] - E[h]^2 can go epsilon-negative in fp32; BN adds eps anyway
    return mu, torch.clamp(e2 - mu * mu, min=0.0)


def head_mlp_plain(x, ek, eb, mul, add, pk, pb):
    """y = relu((x @ ek + eb) * mul + add) @ pk + pb with the kernel's cast
    points: fp32 accumulation of both products, h rounded to x's dtype
    before the BN affine, which runs in x's dtype, output in x's dtype.

    x [M, C]; ek [C, O], pk [O, n] in x's dtype; eb, mul, add [1, O] and
    pb [1, n] fp32."""
    cdt, f = x.dtype, _acc(x.dtype)
    h = torch.matmul(x.to(f), ek.to(f))
    hc = (h + eb.to(f)).to(cdt)
    z = torch.relu(hc * mul.to(cdt) + add.to(cdt))
    y = torch.matmul(z.to(f), pk.to(f))
    return (y + pb.to(f)).to(cdt)


def head_mlp_bwd_plain(x, ek, eb, mul, add, pk, pb, gy):
    """The seven gradients of :func:`head_mlp_plain` with the cast points of
    the JAX backward kernel (``_bwd_kernel``): the hidden recomputed,
    ``gy`` rounded to x's dtype for both products, ``dh = dzp * mul`` with
    the fp32 mul, rounded to x's dtype before ``dek`` and ``dx``; fp32
    accumulation everywhere. Returns ``(dx, dek, deb, dmul, dadd, dpk,
    dpb)`` cast as ``_bwd_rule`` casts them: dx in x's dtype, dek and dpk
    in the weights' dtype, the rest fp32 ``[1, O]`` / ``[1, n]``."""
    cdt, f = x.dtype, _acc(x.dtype)
    hc = (torch.matmul(x.to(f), ek.to(f)) + eb.to(f)).to(cdt)
    zpre = hc * mul.to(cdt) + add.to(cdt)
    z = torch.relu(zpre)
    gyf = gy.to(f)
    gyc = gy.to(cdt).to(f)
    dpb = gyf.sum(0, keepdim=True)
    dpk = torch.matmul(z.to(f).t(), gyc)
    dz = torch.matmul(gyc, pk.to(f).t())
    dzp = torch.where(zpre.to(f) > 0, dz, torch.zeros_like(dz))
    dadd = dzp.sum(0, keepdim=True)
    dmul = (dzp * hc.to(f)).sum(0, keepdim=True)
    dh = dzp * mul.to(f)
    deb = dh.sum(0, keepdim=True)
    dhc = dh.to(cdt).to(f)
    dek = torch.matmul(x.to(f).t(), dhc)
    dx = torch.matmul(dhc, ek.to(f).t())
    return (dx.to(x.dtype), dek.to(ek.dtype), deb.to(eb.dtype),
            dmul.to(mul.dtype), dadd.to(add.dtype), dpk.to(pk.dtype),
            dpb.to(pb.dtype))


def _check(x, ek, eb, mul, add, pk, pb, what):
    if x.device.type != "cuda":
        raise ValueError(f"head MLP {what}: no kernel for {x.device}")
    M, C = x.shape
    O = ek.shape[1]
    n = pk.shape[1]
    for name, t, shape, dtype in (
            ("x", x, (M, C), torch.bfloat16),
            ("ek", ek, (C, O), torch.bfloat16),
            ("eb", eb, (1, O), torch.float32),
            ("mul", mul, (1, O), torch.float32),
            ("add", add, (1, O), torch.float32),
            ("pk", pk, (O, n), torch.bfloat16),
            ("pb", pb, (1, n), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"head MLP {what} kernel: {name} must be "
                             f"{dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"head MLP {what} kernel: {name} on "
                             f"{t.device}, x on {x.device}")
    if C % 2 or O % 2 or not 0 < n <= MAX_OUT:
        raise ValueError(f"head MLP {what} kernel: needs even C ({C}) and "
                         f"O ({O}) and 1 <= n ({n}) <= {MAX_OUT}")
    for name, t in (("x", x), ("ek^T", ek.t()), ("eb", eb), ("mul", mul),
                    ("add", add), ("pk^T", pk.t()), ("pb", pb)):
        if not t.is_contiguous():
            raise ValueError(f"head MLP {what} kernel: {name} must be "
                             "contiguous")


def head_mlp_fwd(x, ek, eb, mul, add, pk, pb):
    """Forward, no autograd: the plain version for CPU tensors, the kernel
    for CUDA tensors (bf16 x/ek/pk, even C and O, n <= 64). ``ek`` and
    ``pk`` are read transposed: pass the transposed views of the conv
    weights ([O, C] and [n, O] contiguous) and no copy is made."""
    if x.device.type == "cpu":
        return head_mlp_plain(x, ek, eb, mul, add, pk, pb)
    _check(x, ek, eb, mul, add, pk, pb, "forward")
    M, C = x.shape
    O, n = ek.shape[1], pk.shape[1]
    lib = _build.library()
    y = torch.empty((M, n), dtype=x.dtype, device=x.device)
    err = lib.mtlora_head_mlp_fwd(
        x.data_ptr(), ek.t().data_ptr(), eb.data_ptr(), mul.data_ptr(),
        add.data_ptr(), pk.t().data_ptr(), pb.data_ptr(), y.data_ptr(),
        M, C, O, n, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "mtlora_head_mlp_fwd")
    head_mlp_fwd.launches += 1
    return y


def _stripes(device, hidden: int) -> int:
    """Row stripes of the weight-gradient kernel: one block per (hidden
    chunk of 64, stripe), about one wave of the card's SMs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, sms // -(-hidden // 64))


def head_mlp_bwd(x, ek, eb, mul, add, pk, pb, gy):
    """``(dx, dek, deb, dmul, dadd, dpk, dpb)`` of
    :func:`head_mlp_bwd_plain`: the plain version for CPU tensors, the
    kernel (dx pass, weight-gradient pass and its deterministic reduction)
    for CUDA tensors. ``dek`` and ``dpk`` come back as transposed views of
    ``[O, C]`` and ``[n, O]`` tensors, the layout of the conv weights."""
    if x.device.type == "cpu":
        return head_mlp_bwd_plain(x, ek, eb, mul, add, pk, pb, gy)
    _check(x, ek, eb, mul, add, pk, pb, "backward")
    M, C = x.shape
    O, n = ek.shape[1], pk.shape[1]
    if C > MAX_C_BWD:
        raise ValueError(f"head MLP backward kernel: C={C} above "
                         f"{MAX_C_BWD}")
    if (gy.shape != (M, n) or gy.dtype != x.dtype or gy.device != x.device
            or not gy.is_contiguous()):
        raise ValueError(f"head MLP backward kernel: gy must be contiguous "
                         f"{x.dtype} {(M, n)}, got {gy.dtype} "
                         f"{tuple(gy.shape)}")
    stripes = _stripes(x.device, O)
    lib = _build.library()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    part = torch.empty((stripes, O * C + n * O + 3 * O + n), **f32)
    dek_t = torch.empty((O, C), dtype=ek.dtype, device=x.device)
    dpk_t = torch.empty((n, O), dtype=pk.dtype, device=x.device)
    deb, dmul, dadd = (torch.empty((1, O), **f32) for _ in range(3))
    dpb = torch.empty((1, n), **f32)
    err = lib.mtlora_head_mlp_bwd(
        x.data_ptr(), ek.t().data_ptr(), eb.data_ptr(), mul.data_ptr(),
        add.data_ptr(), pk.t().data_ptr(), gy.data_ptr(), dx.data_ptr(),
        part.data_ptr(), dek_t.data_ptr(), deb.data_ptr(), dmul.data_ptr(),
        dadd.data_ptr(), dpk_t.data_ptr(), dpb.data_ptr(), M, C, O, n,
        stripes, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "mtlora_head_mlp_bwd")
    head_mlp_bwd.launches += 1
    return dx, dek_t.t(), deb, dmul, dadd, dpk_t.t(), dpb


head_mlp_fwd.launches = 0
head_mlp_bwd.launches = 0


class HeadMLPFn(torch.autograd.Function):
    """``custom_vjp`` of ``fused_head_mlp``: all seven operands get
    gradients (the decoder heads train under MTLoRA)."""

    @staticmethod
    def forward(ctx, x, ek, eb, mul, add, pk, pb):
        ctx.save_for_backward(x, ek, eb, mul, add, pk, pb)
        return head_mlp_fwd(x, ek, eb, mul, add, pk, pb)

    @staticmethod
    def backward(ctx, gy):
        x, ek, eb, mul, add, pk, pb = ctx.saved_tensors
        return head_mlp_bwd(x, ek, eb, mul, add, pk, pb, gy.contiguous())


def head_mlp(x, ek, eb, mul, add, pk, pb):
    """Fused head on ``x [M, C]`` (see :func:`head_mlp_plain`),
    differentiable in all seven operands. CPU tensors take the plain
    versions; CUDA tensors the kernels (see :func:`head_mlp_fwd`)."""
    return HeadMLPFn.apply(x, ek, eb, mul, add, pk, pb)
