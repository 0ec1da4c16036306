"""LoRA GEMM (kernel 8): the CUDA kernel, its plain version, counters.

Counterpart of ``mtlora_tpu/ops/pallas_lora_matmul.py``: the frozen GEMM
and the shared adapter of one linear layer in one pass,

    y = x W^T + s * bf16(x_drop A^T) B^T

with both products accumulated in fp32, ``u = x_drop A^T`` rounded to the
input dtype before its product with B, and ``y = acc + upd * s`` rounded
once (``_kernel`` :29, ``_kernel_same`` :50). ``x_drop`` None is the
one-input kernel (no dropout: x is read once). Weights come in the port's
module layouts, ``wt [N, K]`` (``linear.weight``), ``at [r, K]``
(``lora_shared_A``), ``bt [N, r]`` (``lora_shared_B``), in the input dtype;
the layer's bias is not an operand: the caller adds it to the output in
that dtype, as ``lora.py:454-455`` does.

The backward is ``_bwd`` (:155-188): no gradient for the frozen W; with
one input, dx comes from the same kernel with swapped operands,
``dx = dy W + s * bf16(dy B) A`` (:167-172, the kernel's dx layout, which
reads W, A and B in place); with two inputs ``dx = dy W`` and
``dx_drop = s * bf16(dy B) A`` are plain products. In both modes
``dA = s * bf16(dy B)^T x_drop`` and ``dB = s * dy^T bf16(x_drop A^T)`` are
thin plain products, each rounded once after its scale.
"""

from __future__ import annotations

import torch

from mtlora_tpu_torch.ops import _build

MAX_RANK = 64


def _acc(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: fp32, or fp64 for fp64 inputs (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def lora_matmul_plain(x, x_drop, wt, at, bt, scale: float) -> torch.Tensor:
    """``x [M, K]``, ``x_drop [M, K]`` or None -> ``y [M, N]`` in x's dtype,
    with the TPU kernel's cast points."""
    f = _acc(x.dtype)
    xd = x if x_drop is None else x_drop
    acc = torch.matmul(x.to(f), wt.to(f).t())
    u = torch.matmul(xd.to(f), at.to(f).t()).to(x.dtype)
    upd = torch.matmul(u.to(f), bt.to(f).t())
    return (acc + upd * scale).to(x.dtype)


def lora_matmul_dx_plain(dy, wt, at, bt, scale: float) -> torch.Tensor:
    """``dx [M, K] = dy W + s * bf16(dy B) A`` for ``dy [M, N]``: the
    one-input kernel on W^T, B^T as the left and A^T as the right rank
    factor (``_bwd`` :167-170)."""
    return lora_matmul_plain(dy, None, wt.t(), bt.t(), at.t(), scale)


def _scaled_mm(a, b, scale: float) -> torch.Tensor:
    """``scale * (a @ b)`` rounded once to the operands' dtype: the scale
    applies to the fp32 accumulator (``dot(..) * scale`` then ``astype``)."""
    return torch.addmm(a.new_zeros(()), a, b, beta=0.0, alpha=scale)


def _check(name, lead, named, K, N, r):
    """The CUDA route's checks: ``named`` holds (label, tensor, shape)
    triples, ``lead`` the tensor whose device they must share."""
    if lead.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {lead.device}")
    if K % 8 or N % 8 or r % 16 or not 0 < r <= MAX_RANK:
        raise ValueError(f"{name} kernel: needs K % 8 == 0 ({K}), N % 8 == 0 "
                         f"({N}) and r a multiple of 16 up to {MAX_RANK} "
                         f"({r})")
    for label, t, shape in named:
        if t.dtype != torch.bfloat16 or tuple(t.shape) != shape:
            raise ValueError(f"{name} kernel: {label} must be bf16 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if (t.device != lead.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name} kernel: {label} must be contiguous, "
                             f"16-byte aligned and on {lead.device}")


def lora_matmul_fwd(x, x_drop, wt, at, bt, scale: float) -> torch.Tensor:
    """Kernel 8 forward, no autograd: the plain version for CPU tensors, the
    kernel for CUDA tensors (bf16, contiguous); ``x_drop`` None runs the
    one-input kernel."""
    if x.device.type == "cpu":
        return lora_matmul_plain(x, x_drop, wt, at, bt, scale)
    (M, K), N, r = x.shape, wt.shape[0], at.shape[0]
    named = [("x", x, (M, K)), ("wt", wt, (N, K)), ("at", at, (r, K)),
             ("bt", bt, (N, r))]
    if x_drop is not None:
        named.append(("x_drop", x_drop, (M, K)))
    _check("LoRA GEMM", x, named, K, N, r)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _build.library().mtlora_lora_matmul_fwd(
        x.data_ptr(), x_drop.data_ptr() if x_drop is not None else None,
        wt.data_ptr(), at.data_ptr(), bt.data_ptr(), y.data_ptr(), M, K, N,
        r, float(scale), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "mtlora_lora_matmul_fwd")
    lora_matmul_fwd.launches += 1
    return y


def lora_matmul_dx(dy, wt, at, bt, scale: float) -> torch.Tensor:
    """Kernel 8 in its dx layout: :func:`lora_matmul_dx_plain` for CPU
    tensors, the kernel for CUDA tensors (bf16, contiguous)."""
    if dy.device.type == "cpu":
        return lora_matmul_dx_plain(dy, wt, at, bt, scale)
    (N, K), r, M = wt.shape, at.shape[0], dy.shape[0]
    _check("LoRA GEMM dx", dy, [("dy", dy, (M, N)), ("wt", wt, (N, K)),
                                ("at", at, (r, K)), ("bt", bt, (N, r))],
           K, N, r)
    dx = torch.empty((M, K), dtype=dy.dtype, device=dy.device)
    err = _build.library().mtlora_lora_matmul_dx(
        dy.data_ptr(), wt.data_ptr(), at.data_ptr(), bt.data_ptr(),
        dx.data_ptr(), M, N, K, r, float(scale),
        torch.cuda.current_stream(dy.device).cuda_stream)
    _build.check(err, "mtlora_lora_matmul_dx")
    lora_matmul_dx.launches += 1
    return dx


lora_matmul_fwd.launches = 0
lora_matmul_dx.launches = 0


def lora_matmul_bwd(xd, two: bool, wt, at, bt, scale: float, dy):
    """``(dx, dx_drop or None, dat, dbt)`` of ``_bwd`` from the adapter's
    input ``xd`` (x_drop with ``two`` inputs, else x: x itself is never
    needed); dx through :func:`lora_matmul_dx` with one input."""
    du = torch.matmul(dy, bt)                       # [M, r], rounded
    if two:
        dx, dxd = torch.matmul(dy, wt), _scaled_mm(du, at, scale)
    else:
        dx, dxd = lora_matmul_dx(dy, wt, at, bt, scale), None
    u = torch.matmul(xd, at.t())                    # [M, r], rounded
    return dx, dxd, _scaled_mm(du.t(), xd, scale), _scaled_mm(dy.t(), u,
                                                              scale)


class LoRAMatmulFn(torch.autograd.Function):
    """``custom_vjp`` of ``lora_matmul``: gradients for x, x_drop, A and B,
    none for the frozen W. With two inputs only x_drop is kept for the
    backward."""

    @staticmethod
    def forward(ctx, x, x_drop, wt, at, bt, scale):
        ctx.two = x_drop is not None
        ctx.save_for_backward(x_drop if ctx.two else x, wt, at, bt)
        ctx.scale = scale
        return lora_matmul_fwd(x, x_drop, wt, at, bt, scale)

    @staticmethod
    def backward(ctx, dy):
        xd, wt, at, bt = ctx.saved_tensors
        dx, dxd, dat, dbt = lora_matmul_bwd(xd, ctx.two, wt, at, bt,
                                            ctx.scale, dy.contiguous())
        return dx, dxd, None, dat, dbt, None


def fused_lora_matmul(x, x_drop, wt, at, bt, scale: float) -> torch.Tensor:
    """``x [M, K]``, ``x_drop [M, K]`` (the adapter's dropped input) or None
    -> ``y [M, N]`` without the bias, differentiable in x, x_drop, at and
    bt. CPU tensors take the plain versions; CUDA tensors the kernel, which
    takes bf16 only, K and N multiples of 8 and r a multiple of 16 up to
    64."""
    return LoRAMatmulFn.apply(x, x_drop, wt, at, bt, scale)
