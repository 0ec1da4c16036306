"""Attention on pre-marshaled quad operands: the CUDA kernel, its plain
version, its counter.

Counterpart of ``tools/attn_variants.py:kern_quad_pre`` (:438, launched by
``run_quad_pre`` :475), a TPU probe of the two products per head of eight
windows on operands marshaled ahead of the kernel: per block i and head h,

    S   = qb[i, h] kb[i, h, 0]^T              fp32, no scale
    P   = bf16(softmax(S + bias[h]))          over the keys
    O   = P kb[i, h, 1]                       fp32, 128 columns
    out[i, :, 32 h:32 h + 32] = bf16(O[:, :32] + O[:, 32:64] + O[:, 64:96]
                                     + O[:, 96:])

with ``qb [nq, nH, 392, 128]``, ``kb [nq, nH, 2, 98, 128]`` (bf16) and
``bias [nH, 392, 98]`` (fp32); the row and key counts may differ from the
probe's 392 and 98, the lane count 128 and the head width 32 may not.
"""

from __future__ import annotations

import torch

from mtlora_tpu_torch.ops import _build

LANES = 128
HEAD = 32     # output columns per head: the four 32-lane blocks summed
MAX_KEYS = 128


def quad_attention_plain(qb: torch.Tensor, kb: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """``[nq, Rq, 32 nH]`` in qb's dtype, with the probe's cast points."""
    nq, nH, Rq, _ = qb.shape
    dt = qb.dtype
    f = torch.promote_types(dt, torch.float32)
    s = torch.matmul(qb.to(f), kb[:, :, 0].to(f).transpose(-1, -2))
    p = torch.softmax(s + bias.to(f)[None], dim=-1)
    o = torch.matmul(p.to(dt).to(f), kb[:, :, 1].to(f))   # [nq, nH, Rq, 128]
    o = ((o[..., :HEAD] + o[..., HEAD:2 * HEAD]) + o[..., 2 * HEAD:3 * HEAD]
         + o[..., 3 * HEAD:])
    return o.transpose(1, 2).reshape(nq, Rq, nH * HEAD).to(dt)


def quad_attention(qb: torch.Tensor, kb: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for CUDA tensors (bf16
    qb and kb, fp32 bias, at most 128 keys)."""
    if qb.device.type == "cpu":
        return quad_attention_plain(qb, kb, bias)
    if qb.device.type != "cuda":
        raise ValueError(f"quad attention: no kernel for {qb.device}")
    nq, nH, Rq, _ = qb.shape
    Nk = kb.shape[3]
    want = [("qb", qb, (nq, nH, Rq, LANES), torch.bfloat16),
            ("kb", kb, (nq, nH, 2, Nk, LANES), torch.bfloat16),
            ("bias", bias, (nH, Rq, Nk), torch.float32)]
    for label, t, shape, dt in want:
        if (t.dtype != dt or tuple(t.shape) != shape or t.device != qb.device
                or not t.is_contiguous()):
            raise ValueError(f"quad attention kernel: {label} must be "
                             f"contiguous {dt} {shape} on {qb.device}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not 0 < Nk <= MAX_KEYS:
        raise ValueError(f"quad attention kernel: {Nk} keys outside "
                         f"1..{MAX_KEYS}")
    out = torch.empty((nq, Rq, nH * HEAD), dtype=qb.dtype, device=qb.device)
    err = _build.library().mtlora_quad_attn_fwd(
        qb.data_ptr(), kb.data_ptr(), bias.data_ptr(), out.data_ptr(), nq,
        nH, Rq, Nk, torch.cuda.current_stream(qb.device).cuda_stream)
    _build.check(err, "mtlora_quad_attn_fwd")
    quad_attention.launches += 1
    return out


quad_attention.launches = 0
