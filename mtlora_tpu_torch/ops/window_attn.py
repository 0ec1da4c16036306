"""Window attention core: the CUDA kernels, their plain versions, counters.

Counterpart of ``mtlora_tpu/ops/pallas_window_attn.py``: the forward
kernel ``csrc/window_attn.cu`` and the backward kernel
``csrc/window_attn_bwd.cu`` under one ``torch.autograd.Function``, as the
JAX package puts ``_run_fwd`` and ``_run_bwd`` under one ``custom_vjp``.
Both read the plain window order that ``ops/window.py`` produces,
``[B*nW, N, 3C]``, not the TPU's padded pack-2 layout.
"""

from __future__ import annotations

import torch

from mtlora_tpu_torch.ops import _build
from mtlora_tpu_torch.ops.attention import attention_probs, dtype_const
from mtlora_tpu_torch.ops.attention import window_attention as plain

MAX_N = 64
# windows per block of the backward kernel: about 1024 blocks in all, so
# the [n_groups, nH, N, N] dbias partials stay near 10 MB at batch 32
BWD_BLOCKS = 1024
MAX_GROUP = 64


def window_attention_bwd_plain(qkv: torch.Tensor, num_heads: int,
                               rel_bias: torch.Tensor,
                               mask: torch.Tensor | None, scale: float,
                               dout: torch.Tensor):
    """Gradients of :func:`attention.window_attention` with the cast points
    of the JAX backward kernel (``_bwd_kernel``): P recomputed by the
    forward's :func:`attention.attention_probs` and kept in fp32;
    ``dv = P^T dO``, ``dP = dO v^T``,
    ``dS = P (dP - rowsum(dP P))``, ``dq = (dS k) scale``,
    ``dk = dS^T (q scale)`` with fp32 q and the unrounded scale.

    Returns ``dqkv [B*nW, N, 3C]`` in qkv's dtype and ``dbias [nH, N, N]``
    fp32, dS summed over every window. The mask gets no gradient."""
    Bw, N, C3 = qkv.shape
    hd = C3 // 3 // num_heads
    dt = qkv.dtype
    f = torch.promote_types(dt, torch.float32)
    q, k, v, p = attention_probs(qkv, num_heads, rel_bias, mask, scale)
    do = dout.reshape(Bw, N, num_heads, hd).transpose(1, 2).to(f)
    qf, kf, vf = q.to(f), k.to(f), v.to(f)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf * scale)
    dqkv = torch.stack([dq, dk, dv])                  # [3, Bw, nH, N, hd]
    dqkv = dqkv.permute(1, 3, 0, 2, 4).reshape(Bw, N, C3).to(dt)
    return dqkv, ds.sum(0)


def _check(qkv, num_heads, rel_bias, mask, what):
    if qkv.device.type != "cuda":
        raise ValueError(f"window attention {what}: no kernel for "
                         f"{qkv.device}")
    Bw, N, C3 = qkv.shape
    C = C3 // 3
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"window attention {what} kernel takes bf16, got "
                         f"{qkv.dtype}")
    if C3 % 3 or C % num_heads or (C // num_heads) % 8:
        raise ValueError(f"window attention {what} kernel: head dim of "
                         f"C={C}, {num_heads} heads is not a multiple of 8")
    if not 0 < N <= MAX_N:
        raise ValueError(f"window attention {what} kernel: N={N} outside "
                         f"1..{MAX_N}")
    if rel_bias.shape != (num_heads, N, N) or rel_bias.dtype != torch.float32:
        raise ValueError(f"rel_bias must be fp32 [{num_heads}, {N}, {N}], got "
                         f"{rel_bias.dtype} {tuple(rel_bias.shape)}")
    tensors = [qkv, rel_bias]
    if mask is not None:
        n_mask = mask.shape[0]
        if (mask.shape != (n_mask, N, N) or mask.dtype != torch.float32
                or Bw % n_mask):
            raise ValueError(f"mask must be fp32 [nW, {N}, {N}] with nW "
                             f"dividing {Bw}, got {mask.dtype} "
                             f"{tuple(mask.shape)}")
        tensors.append(mask)
    for t in tensors:
        if t.device != qkv.device or not t.is_contiguous():
            raise ValueError(f"window attention {what} kernel: operands "
                             "must be contiguous and on one device")


def window_attention_fwd(qkv: torch.Tensor, num_heads: int,
                         rel_bias: torch.Tensor, mask: torch.Tensor | None,
                         scale: float) -> torch.Tensor:
    """Forward core, no autograd: the plain version for CPU tensors, the
    kernel for CUDA tensors (bf16, N <= 64, head dim a multiple of 8)."""
    if qkv.device.type == "cpu":
        return plain(qkv, num_heads, rel_bias, mask, scale)
    _check(qkv, num_heads, rel_bias, mask, "forward")
    Bw, N, C3 = qkv.shape
    lib = _build.library()
    out = torch.empty((Bw, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    err = lib.mtlora_window_attn_fwd(
        qkv.data_ptr(), rel_bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        Bw, N, C3 // 3, num_heads, mask.shape[0] if mask is not None else 0,
        dtype_const(scale, qkv.dtype),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(err, "mtlora_window_attn_fwd")
    window_attention_fwd.launches += 1
    return out


def window_attention_bwd(qkv: torch.Tensor, num_heads: int,
                         rel_bias: torch.Tensor, mask: torch.Tensor | None,
                         scale: float, dout: torch.Tensor):
    """Backward core: ``(dqkv, dbias)`` of :func:`window_attention_bwd_plain`,
    from the plain version for CPU tensors and from the kernel (plus its
    deterministic group reduction) for CUDA tensors."""
    if qkv.device.type == "cpu":
        return window_attention_bwd_plain(qkv, num_heads, rel_bias, mask,
                                          scale, dout)
    _check(qkv, num_heads, rel_bias, mask, "backward")
    Bw, N, C3 = qkv.shape
    if (dout.shape != (Bw, N, C3 // 3) or dout.dtype != qkv.dtype
            or dout.device != qkv.device or not dout.is_contiguous()):
        raise ValueError(f"window attention backward kernel: dout must be "
                         f"contiguous {qkv.dtype} {(Bw, N, C3 // 3)}, got "
                         f"{dout.dtype} {tuple(dout.shape)}")
    group = max(1, min(MAX_GROUP, -(-Bw * num_heads // BWD_BLOCKS)))
    n_groups = -(-Bw // group)
    lib = _build.library()
    dqkv = torch.empty_like(qkv)
    part = torch.empty((n_groups, num_heads, N, N), dtype=torch.float32,
                       device=qkv.device)
    dbias = torch.empty((num_heads, N, N), dtype=torch.float32,
                        device=qkv.device)
    err = lib.mtlora_window_attn_bwd(
        qkv.data_ptr(), rel_bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, dout.data_ptr(),
        dqkv.data_ptr(), part.data_ptr(), dbias.data_ptr(),
        Bw, N, C3 // 3, num_heads, mask.shape[0] if mask is not None else 0,
        group, dtype_const(scale, qkv.dtype), float(scale),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(err, "mtlora_window_attn_bwd")
    window_attention_bwd.launches += 1
    return dqkv, dbias


window_attention_fwd.launches = 0
window_attention_bwd.launches = 0


class WindowAttentionFn(torch.autograd.Function):
    """``custom_vjp`` of ``_fused_windows``: gradients for qkv and the
    gathered bias; none for the mask."""

    @staticmethod
    def forward(ctx, qkv, rel_bias, mask, num_heads, scale):
        ctx.save_for_backward(qkv, rel_bias, mask)
        ctx.num_heads, ctx.scale = num_heads, scale
        return window_attention_fwd(qkv, num_heads, rel_bias, mask, scale)

    @staticmethod
    def backward(ctx, dout):
        qkv, rel_bias, mask = ctx.saved_tensors
        dqkv, dbias = window_attention_bwd(qkv, ctx.num_heads, rel_bias, mask,
                                           ctx.scale, dout.contiguous())
        return dqkv, dbias.to(rel_bias.dtype), None, None, None


def fused_window_attention(qkv: torch.Tensor, num_heads: int,
                           rel_bias: torch.Tensor, mask: torch.Tensor | None,
                           scale: float) -> torch.Tensor:
    """qkv [B*nW, N, 3C], rel_bias [nH, N, N] fp32, mask [nW, N, N] fp32
    or None -> [B*nW, N, C] in qkv's dtype (see ``attention.window_attention``
    for the math and its cast points), differentiable in qkv and rel_bias.

    CPU tensors take the plain versions; CUDA tensors the kernels, which
    take bf16 only, N <= 64 and a head dim that is a multiple of 8."""
    return WindowAttentionFn.apply(qkv, rel_bias, mask, num_heads, scale)
