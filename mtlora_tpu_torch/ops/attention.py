"""Window attention constants and the plain attention core.

Counterpart of ``mtlora_tpu/ops/attention.py``: the relative-position
gather index and the shifted-window mask are numpy constants re-derived
here (the JAX module imports jax), and :func:`window_attention` is the
plain PyTorch attention core with the JAX cast points.
"""

from __future__ import annotations

import numpy as np
import torch


def relative_position_index(window_size: int) -> np.ndarray:
    """[N, N] index into the (2w-1)^2-row relative position bias table."""
    w = window_size
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel = rel + (w - 1)
    return rel[:, :, 0] * (2 * w - 1) + rel[:, :, 1]


def shift_attention_mask(H: int, W: int, window_size: int,
                         shift: int) -> np.ndarray:
    """[nW, N, N] additive mask (0 / -100) of shifted windows: a query
    sees only keys of its own region of the rolled map."""
    ws = window_size
    img_mask = np.zeros((H, W), dtype=np.int32)
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[h, w] = cnt
            cnt += 1
    m = img_mask.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3)
    m = m.reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def dtype_const(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: a JAX weakly typed Python scalar
    meeting an array of that dtype (``q * scale``, ``x / keep``)."""
    return float(torch.tensor(value, dtype=dtype))


def attention_probs(qkv: torch.Tensor, num_heads: int,
                    rel_bias: torch.Tensor, mask: torch.Tensor | None,
                    scale: float):
    """q, k, v ``[B*nW, nH, N, hd]`` (views of qkv) and the attention
    probabilities P ``[B*nW, nH, N, N]`` in fp32 (fp64 for fp64 qkv).

    Cast points, shared by the forward and the backward: q*scale rounds to
    qkv's dtype; scores, bias, mask and softmax are fp32."""
    Bw, N, C3 = qkv.shape
    hd = C3 // 3 // num_heads
    dt = qkv.dtype
    f = torch.promote_types(dt, torch.float32)       # fp64 stays fp64
    x = qkv.view(Bw, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = x[0], x[1], x[2]
    s = torch.matmul((q * dtype_const(scale, dt)).to(f),
                     k.to(f).transpose(-1, -2))
    s = s + rel_bias.to(f)[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.view(Bw // nW, nW, num_heads, N, N)
             + mask.to(f)[None, :, None]).view(Bw, num_heads, N, N)
    return q, k, v, torch.softmax(s, dim=-1)


def window_attention(qkv: torch.Tensor, num_heads: int,
                     rel_bias: torch.Tensor, mask: torch.Tensor | None,
                     scale: float) -> torch.Tensor:
    """softmax(q*scale @ k^T + bias[h] + mask[w % nW]) @ v per window/head.

    qkv [B*nW, N, 3C] with columns q | k | v and head h at h*hd;
    rel_bias [nH, N, N] and mask [nW, N, N] fp32. Returns [B*nW, N, C]
    in qkv's dtype. Cast points: those of :func:`attention_probs`, then
    P rounds to the working dtype before P@V, which accumulates in fp32.
    """
    Bw, N, C3 = qkv.shape
    dt = qkv.dtype
    f = torch.promote_types(dt, torch.float32)
    _, _, v, p = attention_probs(qkv, num_heads, rel_bias, mask, scale)
    out = torch.matmul(p.to(dt).to(f), v.to(f)).to(dt)   # [Bw, nH, N, hd]
    return out.transpose(1, 2).reshape(Bw, N, C3 // 3)
