"""Fused HRNet head MLP: the CUDA kernel, its plain version, its counter.

Counterpart of ``mtlora_tpu/ops/pallas_head.py`` (forward; eval BN, whose
affine is folded from the running statistics by the caller). The kernel
is ``csrc/head_mlp.cu``.
"""

from __future__ import annotations

import torch

from mtlora_tpu_torch.ops import _build

MAX_OUT = 64


def head_mlp_plain(x, ek, eb, mul, add, pk, pb):
    """y = relu((x @ ek + eb) * mul + add) @ pk + pb with the kernel's cast
    points: fp32 accumulation of both products, h rounded to x's dtype
    before the BN affine, which runs in x's dtype, output in x's dtype.

    x [M, C]; ek [C, O], pk [O, n] in x's dtype; eb, mul, add [1, O] and
    pb [1, n] fp32."""
    cdt = x.dtype
    h = torch.matmul(x.float(), ek.float())
    hc = (h + eb.float()).to(cdt)
    z = torch.relu(hc * mul.to(cdt) + add.to(cdt))
    y = torch.matmul(z.float(), pk.float())
    return (y + pb.float()).to(cdt)


def head_mlp(x, ek, eb, mul, add, pk, pb):
    """Fused head on ``x [M, C]`` (see :func:`head_mlp_plain`).

    CPU tensors take the plain version; CUDA tensors the kernel, which
    takes bf16 x/ek/pk, even C and O, and n <= 64. ``ek`` and ``pk`` are
    read transposed: pass the transposed views of the conv weights
    ([O, C] and [n, O] contiguous) and no copy is made."""
    if x.device.type == "cpu":
        return head_mlp_plain(x, ek, eb, mul, add, pk, pb)
    if x.device.type != "cuda":
        raise ValueError(f"head MLP: no kernel for {x.device}")
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
            raise ValueError(f"head MLP kernel: {name} must be {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"head MLP kernel: {name} on {t.device}, "
                             f"x on {x.device}")
    if C % 2 or O % 2 or not 0 < n <= MAX_OUT:
        raise ValueError(f"head MLP kernel: needs even C ({C}) and O ({O}) "
                         f"and 1 <= n ({n}) <= {MAX_OUT}")
    ek_t, pk_t = ek.t(), pk.t()
    for name, t in (("x", x), ("ek^T", ek_t), ("eb", eb), ("mul", mul),
                    ("add", add), ("pk^T", pk_t), ("pb", pb)):
        if not t.is_contiguous():
            raise ValueError(f"head MLP kernel: {name} must be contiguous")
    lib = _build.library()
    y = torch.empty((M, n), dtype=x.dtype, device=x.device)
    err = lib.mtlora_head_mlp_fwd(
        x.data_ptr(), ek_t.data_ptr(), eb.data_ptr(), mul.data_ptr(),
        add.data_ptr(), pk_t.data_ptr(), pb.data_ptr(), y.data_ptr(),
        M, C, O, n, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "mtlora_head_mlp_fwd")
    head_mlp.launches += 1
    return y


head_mlp.launches = 0
