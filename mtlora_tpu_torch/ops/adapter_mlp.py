"""Fused MTLoRA adapter MLP tail: the CUDA kernels, their plain versions,
counters.

Counterpart of ``mtlora_tpu/ops/pallas_adapter_mlp.py`` (kernel 5 and its
backward 5b). In the stage-tail blocks fc1's per-task output stays
factored, and fc2's task projection is, per task t,

    h_t    = gelu(p1 + s_t * mid1_t^T B1_t)      (never stored)
    mid2_t = h_t A2_t

with p1 fc1's frozen pre-activation on the shared stream. The public
layouts are the JAX function's: ``mid1T [T, r1, M]``, ``p1 [M, H4]``,
``b1 [T, r1, H4]``, ``a2T [T, r2, H4]``, result ``mid2T [T, r2, M]``.
Cast points as ``adapter_mid_reference`` (:335) and ``_bwd_kernel``
(:146): ``u = mid1^T B1`` and ``z = p1 + s u`` in fp32, h rounded to the
compute dtype before ``h A2`` (fp32 sum, rounded once); backward ``dh =
g^T A2T`` in fp32, ``dz = bf16(dh gelu'(z))``, ``dp1 = sum_t dz`` in fp32
in task order, ``dmid1 = s B1 dz`` and the fp32 sums ``dB1 = s mid1 dz``,
``dA2T = g h``. GELU is exact erf here and in the kernels; the TPU's bf16
kernel takes the tanh form (ROADMAP Queue 3).
"""

from __future__ import annotations

import torch

from mtlora_tpu_torch.ops import _build
from mtlora_tpu_torch.ops.ln_lora import _acc, _stream, _sms, gelu_pair

RANK = 4        # the kernels' per-task rank (r_max of the flagship)
MAX_TASKS = 4


def _z(mid1T, p1, b1, scales):
    """``z [T, M, H4] = p1 + s_t mid1_t^T B1_t`` in the accumulation dtype."""
    f = _acc(mid1T.dtype)
    s = torch.tensor(scales, dtype=f, device=p1.device).view(-1, 1, 1)
    u = torch.einsum("trm,trh->tmh", mid1T.to(f), b1.to(f))
    return p1.to(f)[None] + s * u


def adapter_mid_plain(mid1T, p1, b1, a2T, scales):
    """mid2T [T, r2, M] in mid1T's dtype."""
    cdt, f = mid1T.dtype, _acc(mid1T.dtype)
    h = gelu_pair(_z(mid1T, p1, b1, scales))[0].to(cdt).to(f)
    return torch.einsum("tmh,trh->trm", h, a2T.to(f)).to(cdt)


def adapter_mid_bwd_plain(mid1T, p1, b1, a2T, scales, g):
    """``(dmid1T, dp1, db1, da2T)`` of :func:`adapter_mid_plain` from the
    cotangent ``g [T, r2, M]``: dmid1T and dp1 in the inputs' dtypes, db1
    and da2T in the accumulation dtype."""
    cdt, f = mid1T.dtype, _acc(mid1T.dtype)
    gl, dgelu = gelu_pair(_z(mid1T, p1, b1, scales))
    h = gl.to(cdt).to(f)
    gf = g.to(f)
    dz = (torch.einsum("trm,trh->tmh", gf, a2T.to(f)) * dgelu).to(cdt).to(f)
    dp1 = dz[0]
    for t in range(1, dz.shape[0]):
        dp1 = dp1 + dz[t]
    s = torch.tensor(scales, dtype=f, device=p1.device).view(-1, 1, 1)
    dmid1 = (s * torch.einsum("trh,tmh->trm", b1.to(f), dz)).to(cdt)
    db1 = s * torch.einsum("trm,tmh->trh", mid1T.to(f), dz)
    da2 = torch.einsum("trm,tmh->trh", gf, h)
    return dmid1, dp1.to(p1.dtype), db1, da2


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, mid1T, p1, b1, a2T, scales, extra=()):
    if mid1T.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {mid1T.device}")
    T, r1, M = mid1T.shape
    H4 = p1.shape[1]
    if (T > MAX_TASKS or r1 != RANK or a2T.shape[1] != RANK or H4 % 64
            or len(scales) != T):
        raise ValueError(f"{name} kernel: needs at most {MAX_TASKS} tasks "
                         f"of rank {RANK} and 4C % 64 == 0, got mid1T "
                         f"{tuple(mid1T.shape)}, p1 {tuple(p1.shape)}, a2T "
                         f"{tuple(a2T.shape)}")
    want = [("mid1T", mid1T, (T, RANK, M)), ("p1", p1, (M, H4)),
            ("b1", b1, (T, RANK, H4)), ("a2T", a2T, (T, RANK, H4))]
    for label, t, shape in want + list(extra):
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != shape
                or t.device != mid1T.device or not t.is_contiguous()):
            raise ValueError(f"{name} kernel: {label} must be contiguous "
                             f"bf16 {shape} on {mid1T.device}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return T, M, H4


def _scales(scales):
    return [float(s) for s in scales] + [0.0] * (MAX_TASKS - len(scales))


def adapter_mid_fwd(mid1T, p1, b1, a2T, scales):
    """Kernel 5 forward, no autograd: plain for CPU tensors, the kernel for
    CUDA tensors (bf16, rank 4, at most 4 tasks)."""
    if mid1T.device.type == "cpu":
        return adapter_mid_plain(mid1T, p1, b1, a2T, scales)
    T, M, H4 = _check("adapter MLP tail forward", mid1T, p1, b1, a2T,
                      scales)
    out = torch.empty_like(mid1T)
    err = _build.library().mtlora_adapter_mid_fwd(
        mid1T.data_ptr(), p1.data_ptr(), b1.data_ptr(), a2T.data_ptr(),
        out.data_ptr(), T, M, H4, *_scales(scales), _stream(mid1T))
    _build.check(err, "mtlora_adapter_mid_fwd")
    adapter_mid_fwd.launches += 1
    return out


def weight_stripes(device, rows: int, H4: int) -> int:
    """Row stripes of the weight-gradient kernel: about four blocks of 256
    columns per SM."""
    return max(1, min(-(-rows // 32), 4 * _sms(device) // -(-H4 // 256)))


def adapter_mid_bwd(mid1T, p1, b1, a2T, scales, g):
    """``(dmid1T, dp1, db1, da2T)`` of :func:`adapter_mid_bwd_plain`: plain
    for CPU tensors; for CUDA tensors the row kernel (dmid1T, dp1), the
    weight kernel (fp32 partials of dB1 and dA2T per row stripe) and their
    fixed-order sum."""
    if mid1T.device.type == "cpu":
        return adapter_mid_bwd_plain(mid1T, p1, b1, a2T, scales, g)
    T, M, H4 = _check("adapter MLP tail backward", mid1T, p1, b1, a2T,
                      scales, [("g", g, tuple(mid1T.shape))])
    stripes = weight_stripes(mid1T.device, M, H4)
    f32 = dict(dtype=torch.float32, device=mid1T.device)
    dmid1 = torch.empty_like(mid1T)
    dp1 = torch.empty_like(p1)
    part = torch.empty((stripes, 2, T, RANK, H4), **f32)
    dw = torch.empty((2, T, RANK, H4), **f32)
    err = _build.library().mtlora_adapter_mid_bwd(
        mid1T.data_ptr(), p1.data_ptr(), b1.data_ptr(), a2T.data_ptr(),
        g.data_ptr(), dmid1.data_ptr(), dp1.data_ptr(), part.data_ptr(),
        dw.data_ptr(), T, M, H4, stripes, *_scales(scales), _stream(mid1T))
    _build.check(err, "mtlora_adapter_mid_bwd")
    adapter_mid_bwd.launches += 1
    return dmid1, dp1, dw[0], dw[1]


adapter_mid_fwd.launches = 0
adapter_mid_bwd.launches = 0


class AdapterMidFn(torch.autograd.Function):
    """``custom_vjp`` of ``fused_adapter_mid``: gradients for mid1T, p1, b1
    and a2T."""

    @staticmethod
    def forward(ctx, mid1T, p1, b1, a2T, scales):
        ctx.save_for_backward(mid1T, p1, b1, a2T)
        ctx.scales = scales
        return adapter_mid_fwd(mid1T, p1, b1, a2T, scales)

    @staticmethod
    def backward(ctx, g):
        dmid1, dp1, db1, da2 = adapter_mid_bwd(*ctx.saved_tensors, ctx.scales,
                                               g.contiguous())
        return dmid1, dp1, db1, da2, None


def fused_adapter_mid(mid1T, p1, b1, a2T, scales):
    """Kernel 5 (see the module note), differentiable in all four tensors;
    ``scales``: the per-task fc1 scales."""
    return AdapterMidFn.apply(mid1T, p1, b1, a2T,
                              tuple(float(s) for s in scales))
