"""Window attention core: the CUDA kernel, its plain version, its counter.

Counterpart of ``mtlora_tpu/ops/pallas_window_attn.py`` (forward). The
kernel is ``csrc/window_attn.cu``; it reads the plain window order that
``ops/window.py`` produces, ``[B*nW, N, 3C]``, not the TPU's padded
pack-2 layout.
"""

from __future__ import annotations

import torch

from mtlora_tpu_torch.ops import _build
from mtlora_tpu_torch.ops.attention import window_attention as plain

MAX_N = 64


def fused_window_attention(qkv: torch.Tensor, num_heads: int,
                           rel_bias: torch.Tensor, mask: torch.Tensor | None,
                           scale: float) -> torch.Tensor:
    """qkv [B*nW, N, 3C], rel_bias [nH, N, N] fp32, mask [nW, N, N] fp32
    or None -> [B*nW, N, C] in qkv's dtype (see ``attention.window_attention``
    for the math and its cast points).

    CPU tensors take the plain version; CUDA tensors the kernel, which
    takes bf16 only, N <= 64 and a head dim that is a multiple of 8."""
    if qkv.device.type == "cpu":
        return plain(qkv, num_heads, rel_bias, mask, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"window attention: no kernel for {qkv.device}")
    Bw, N, C3 = qkv.shape
    C = C3 // 3
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"window attention kernel takes bf16, got {qkv.dtype}")
    if C3 % 3 or C % num_heads or (C // num_heads) % 8:
        raise ValueError(f"window attention kernel: head dim of C={C}, "
                         f"{num_heads} heads is not a multiple of 8")
    if not 0 < N <= MAX_N:
        raise ValueError(f"window attention kernel: N={N} outside 1..{MAX_N}")
    if rel_bias.shape != (num_heads, N, N) or rel_bias.dtype != torch.float32:
        raise ValueError(f"rel_bias must be fp32 [{num_heads}, {N}, {N}], got "
                         f"{rel_bias.dtype} {tuple(rel_bias.shape)}")
    tensors = [qkv, rel_bias]
    n_mask = 0
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
            raise ValueError("window attention kernel: operands must be "
                             "contiguous and on one device")
    lib = _build.library()
    out = torch.empty((Bw, N, C), dtype=qkv.dtype, device=qkv.device)
    scale_c = float(torch.tensor(scale, dtype=qkv.dtype))
    err = lib.mtlora_window_attn_fwd(
        qkv.data_ptr(), rel_bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        Bw, N, C, num_heads, n_mask, scale_c,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(err, "mtlora_window_attn_fwd")
    fused_window_attention.launches += 1
    return out


fused_window_attention.launches = 0
