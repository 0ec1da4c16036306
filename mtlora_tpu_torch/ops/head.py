"""Fused HRNet head MLP: the CUDA kernels, their plain versions, counters.

Counterpart of ``mtlora_tpu/ops/pallas_head.py``: the forward kernel
``csrc/head_mlp_fwd.cu`` and the backward ``csrc/head_mlp_bwd.cu`` under one
``torch.autograd.Function`` (the ``custom_vjp`` of ``fused_head_mlp``),
and :func:`bn_stats_from_x`, the exact batch moments of the hidden from
the input covariance, in plain differentiable torch. The BN affine
(``mul``, ``add``) is computed by the caller, from the running statistics
at eval and from :func:`bn_stats_from_x` in training, so the gradient
through the batch statistics composes with the kernel's row-wise backward.

The backward is a row pass and two products over rows. The TPU kernel
carries the weight gradients from grid step to grid step and never writes
the hidden; blocks on the card run in parallel, so the row kernel
computes the hidden once, writes dhc = bf16(dh) and z = relu(zpre) as bf16
``[M, O]`` scratch with dx and per-block column sums
(:func:`head_bwd_rows_plain`), and dWe and dWp are products over those
rows (:func:`head_bwd_weights_plain`). :func:`fwd_plan` and
:func:`bwd_plan` size the launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mtlora_tpu_torch.ops import _build
from mtlora_tpu_torch.ops.ln_lora import SMEM_LIMIT, _sms, stripes_for
from mtlora_tpu_torch.parallel.distributed import global_sum

MAX_OUT = 64
MAX_C_BWD = 272
# the constants of csrc/head_mlp_fwd.cu that the forward's plan sizes its
# shared memory by (the kernel traps if the plan's bytes do not hold its
# layout)
FWD_ROWS = 128          # rows of a tile (kTileRows), 64 a warpgroup
FWD_CHUNK = 64          # hidden columns of a ring stage (kS)
FWD_SLICES = 4          # 64-wide We^T slots of a stage (kSlices)
FWD_TAIL = 16           # C padded to 272: the last slot's width (kTail)
FWD_VEC_BYTES = 512     # a stage's eb, bf16(mul), bf16(add) (kVecBytes)
FWD_MAX_STAGES = 4      # (kMaxStages)
# the constants of csrc/head_mlp_bwd.cu that the backward's plan sizes its
# shared memory by (the kernel traps if the plan's bytes do not hold its
# layout)
BWD_ROWS = 64           # rows of a block (kBM)
BWD_CHUNK = 64          # hidden columns of a ring stage (kHC)
BWD_WARPS = 8           # warps of a block (kWarps)
WGRAD_PER_SM = 12       # weight-gradient blocks per SM in a call: 2 waves


def _acc(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: fp32, or fp64 for fp64 inputs (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def bn_stats_from_x(x, ek, eb):
    """Batch moments of ``h = x @ ek + eb`` without forming h.

    x [M, C] and ek [C, O] in the compute dtype, eb [O] fp32. Returns
    ``(mu [O], var [O])`` fp32, biased variance, from one [C, C]
    covariance product over x read once:
    ``E[h^2] = diag(ek^T S ek) + 2 eb (E[x] ek) + eb^2``, ``S = E[x x^T]``.
    The sums of ``x x^T``, x and the row count go through
    ``parallel.distributed.global_sum`` before the means, so under several
    processes the moments are the global batch's, differentiably."""
    M, C = x.shape
    f = _acc(x.dtype)
    xf = x.to(f)
    sums = global_sum(torch.cat([torch.matmul(xf.t(), xf).reshape(-1),
                                 xf.sum(0), xf.new_full((1,), float(M))]))
    s = sums[:C * C].view(C, C) / sums[-1]
    mx = sums[C * C:C * C + C] / sums[-1]
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


def head_bwd_rows_plain(x, ek, eb, mul, add, pk, gy):
    """The row pass of the backward, with the cast points of the JAX
    backward kernel (``_bwd_kernel``): the hidden recomputed, ``gy``
    rounded to x's dtype, ``dh = dzp * mul`` with the fp32 mul, rounded to
    x's dtype (dhc) before ``dx``. Returns ``(dx, dhc, z, deb, dmul, dadd,
    dpb)``: dx, dhc and z ``[M, O]`` in x's dtype (dx's products in fp32),
    the column sums fp32 ``[1, O]`` / ``[1, n]`` of the unrounded
    values."""
    cdt, f = x.dtype, _acc(x.dtype)
    hc = (torch.matmul(x.to(f), ek.to(f)) + eb.to(f)).to(cdt)
    zpre = hc * mul.to(cdt) + add.to(cdt)
    z = torch.relu(zpre)
    gyc = gy.to(cdt).to(f)
    dpb = gy.to(f).sum(0, keepdim=True)
    dz = torch.matmul(gyc, pk.to(f).t())
    dzp = torch.where(zpre.to(f) > 0, dz, torch.zeros_like(dz))
    dadd = dzp.sum(0, keepdim=True)
    dmul = (dzp * hc.to(f)).sum(0, keepdim=True)
    dh = dzp * mul.to(f)
    deb = dh.sum(0, keepdim=True)
    dhc = dh.to(cdt)
    dx = torch.matmul(dhc.to(f), ek.to(f).t())
    return dx.to(cdt), dhc, z, deb, dmul, dadd, dpb


def head_bwd_weights_plain(x, gy, dhc, z):
    """``(dek, dpk)`` from the row pass's outputs: ``x^T dhc`` and
    ``z^T bf16(gy)``, fp32 accumulation, in fp32 (fp64 for fp64)."""
    f = _acc(x.dtype)
    gyc = gy.to(x.dtype).to(f)
    return (torch.matmul(x.to(f).t(), dhc.to(f)),
            torch.matmul(z.to(f).t(), gyc))


def head_mlp_bwd_plain(x, ek, eb, mul, add, pk, pb, gy):
    """The seven gradients of :func:`head_mlp_plain`:
    :func:`head_bwd_rows_plain`, then :func:`head_bwd_weights_plain`.
    Returns ``(dx, dek, deb, dmul, dadd, dpk, dpb)`` cast as ``_bwd_rule``
    casts them: dx in x's dtype, dek and dpk in the weights' dtype, the
    rest fp32 ``[1, O]`` / ``[1, n]``."""
    dx, dhc, z, deb, dmul, dadd, dpb = head_bwd_rows_plain(
        x, ek, eb, mul, add, pk, gy)
    dek, dpk = head_bwd_weights_plain(x, gy, dhc, z)
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


class FwdPlan(NamedTuple):
    """Launch plan of kernel 7: rows of a tile, n padded to NP rows of
    Wp^T's slot (16, 32, 48 or 64), ring stages, dynamic shared-memory
    bytes, the tiles and the persistent blocks that walk them (one an SM;
    the last tile masks its rows past M), the bytes the ring's stages
    bring a launch (We^T's slots, Wp^T's, the vectors: every block reads
    every stage once a tile), and the scratch the wrapper allocates:
    name -> (shape, dtype)."""

    rows: int
    np: int
    stages: int
    smem: int
    tiles: int
    blocks: int
    slot_bytes: int
    scratch: dict


def _fwd_stage_bytes(np_: int) -> int:
    """Bytes of a ring stage: the chunk's We^T slots (64 x 64 bf16 each,
    then the last 16 columns), Wp^T's slot of np rows, its vectors, padded
    to 1024 (the swizzle's period)."""
    return (2 * (FWD_SLICES * FWD_CHUNK + FWD_TAIL) * FWD_CHUNK
            + 2 * np_ * FWD_CHUNK + 1024)


def _fwd_smem(stages: int, np_: int, C: int) -> int:
    """Bytes of kernel 7's layout: up to 1024 to the first 1024-byte
    boundary, the ring's stages, the two warpgroups' x buffers [64][C]
    (bf16), the ring's full and empty mbarriers and the buffers' two
    each."""
    return (1024 + stages * _fwd_stage_bytes(np_)
            + 2 * (FWD_ROWS // 2) * 2 * C + 8 * (2 * stages + 4))


def fwd_plan(M: int, C: int, O: int, n: int, sms: int) -> FwdPlan:
    """Kernel 7's plan for x [M, C], hidden O, n outputs on a card of
    ``sms`` SMs: 128-row tiles walked by min(tiles, sms) blocks, the
    deepest ring of 2 to 4 hidden chunks that fits. Scratch: the padded
    bf16 copy of We^T ``wpad`` [O, 272] and the chunks' vectors ``vec``
    (512 bytes a chunk)."""
    if (M < 1 or C % 2 or not 2 <= C <= MAX_C_BWD or O < 8 or O % 8
            or not 0 < n <= MAX_OUT):
        raise ValueError(f"head MLP forward kernel: needs M >= 1 ({M}), "
                         f"even C <= {MAX_C_BWD} ({C}), O % 8 == 0 ({O}) "
                         f"and 1 <= n <= {MAX_OUT} ({n})")
    np_ = -(-n // 16) * 16
    stages = max((s for s in range(2, FWD_MAX_STAGES + 1)
                  if _fwd_smem(s, np_, C) <= SMEM_LIMIT))
    tiles = -(-M // FWD_ROWS)
    chunks = -(-O // FWD_CHUNK)
    tx = _fwd_stage_bytes(np_) - 1024 + FWD_VEC_BYTES
    scratch = {"wpad": ((O, MAX_C_BWD), torch.bfloat16),
               "vec": ((chunks * FWD_VEC_BYTES,), torch.uint8)}
    return FwdPlan(FWD_ROWS, np_, stages, _fwd_smem(stages, np_, C),
                   tiles, min(tiles, sms), tiles * chunks * tx, scratch)


def head_mlp_fwd_kernel(x, ek, eb, mul, add, pk, pb):
    """The CUDA route of :func:`head_mlp_fwd`; raises for anything it does
    not take (a CPU tensor included)."""
    _check(x, ek, eb, mul, add, pk, pb, "forward")
    M, C = x.shape
    O, n = ek.shape[1], pk.shape[1]
    plan = fwd_plan(M, C, O, n, _sms(x.device))
    for name, t in (("x", x), ("pk^T", pk.t())):
        if t.data_ptr() % 16:
            raise ValueError(f"head MLP forward kernel: {name} must start "
                             "16-byte aligned")
    sc = {k: torch.empty(shape, dtype=dt, device=x.device)
          for k, (shape, dt) in plan.scratch.items()}
    y = torch.empty((M, n), dtype=x.dtype, device=x.device)
    err = _build.library().mtlora_head_mlp_fwd(
        *(t.data_ptr() for t in (x, ek.t(), eb, mul, add, pk.t(), pb, y,
                                 sc["wpad"], sc["vec"])),
        M, C, O, n, plan.stages, plan.blocks, plan.smem,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "mtlora_head_mlp_fwd")
    head_mlp_fwd.launches += 1
    return y


def head_mlp_fwd(x, ek, eb, mul, add, pk, pb, kernel: bool = True):
    """Forward, no autograd: the plain version for CPU tensors, the kernel
    for CUDA tensors (bf16 x/ek/pk, the shapes :func:`fwd_plan` takes).
    ``ek`` and ``pk`` are read transposed: pass the transposed views of
    the conv weights ([O, C] and [n, O] contiguous) and no copy is
    made. ``kernel`` False (``TPU.USE_PALLAS`` off) takes the plain
    version on any device."""
    if x.device.type == "cpu" or not kernel:
        return head_mlp_plain(x, ek, eb, mul, add, pk, pb)
    return head_mlp_fwd_kernel(x, ek, eb, mul, add, pk, pb)


class BwdPlan(NamedTuple):
    """Launch plan of kernel 7b: rows per block, hidden columns per ring
    stage, ring depth, dynamic shared-memory bytes of the row kernel, its
    blocks (the last masks the rows past M), the padded widths of gy in
    shared memory (np) and in the scratch (ng; x and We^T are padded to
    ``MAX_C_BWD`` whatever C), the row stripes of the weight-gradient
    products dWe^T [O, C] (sw) and dWp^T [n, O] (sp), and the scratch the
    wrapper allocates: name -> (shape, dtype)."""

    bm: int
    chunk: int
    stages: int
    smem: int
    blocks: int
    np: int
    ng: int
    sw: int
    sp: int
    scratch: dict


def _row_smem(stages: int, np_: int) -> int:
    """Bytes of the row kernel's layout: the ring (We^T rows [64][280],
    Wp^T columns [np][72], eb, mul, add [3][64] fp32 a stage), the x and
    gy tiles, the dhc and z tiles, the warps' column sums."""
    t = BWD_CHUNK + 8
    ld = MAX_C_BWD + 8
    stage = 2 * (BWD_CHUNK * ld + np_ * t) + 4 * 3 * BWD_CHUNK
    return (stages * stage
            + 2 * BWD_ROWS * (ld + (np_ + 8) + 2 * t)
            + 4 * 4 * 3 * BWD_CHUNK)


def bwd_plan(M: int, C: int, O: int, n: int, sms: int) -> BwdPlan:
    """Kernel 7b's plan for x [M, C], hidden O, n outputs on a card of
    ``sms`` SMs: 64-row blocks, a ring of 4 hidden chunks where they fit
    in shared memory, else 3. Scratch: the padded bf16 copy of We^T
    ``wpad`` [O, 272], x and bf16(gy) as padded rows ``xpad`` [M, 272] and
    ``gypad`` [M, ng], ``dhc`` and ``z`` [M, O] (bf16); the blocks' column
    partials ``cols`` [blocks, 3 O + n], the weight-gradient stripes
    ``part`` (the two products one after the other) and their sums
    ``sums`` [O C + n O + 3 O + n] (fp32)."""
    if C % 2 or O % 8 or not 0 < n <= MAX_OUT or C > MAX_C_BWD:
        raise ValueError(f"head MLP backward kernel: needs even C <= "
                         f"{MAX_C_BWD} ({C}), O % 8 == 0 ({O}) and "
                         f"1 <= n <= {MAX_OUT} ({n})")
    np_, ng = -(-n // 16) * 16, -(-n // 8) * 8
    stages = 4 if _row_smem(4, np_) <= SMEM_LIMIT else 3
    smem = _row_smem(stages, np_)
    blocks = -(-M // BWD_ROWS)
    # two whole waves of the weight-gradient blocks (six fit on an SM)
    sw = stripes_for(sms, M, O, C, WGRAD_PER_SM)
    sp = stripes_for(sms, M, n, O, WGRAD_PER_SM)
    bf16, f32 = torch.bfloat16, torch.float32
    scratch = {
        "wpad": ((O, MAX_C_BWD), bf16),
        "xpad": ((M, MAX_C_BWD), bf16),
        "gypad": ((M, ng), bf16),
        "dhc": ((M, O), bf16),
        "z": ((M, O), bf16),
        "cols": ((blocks, 3 * O + n), f32),
        "part": ((max(sw * O * C, sp * n * O),), f32),
        "sums": ((O * C + n * O + 3 * O + n,), f32),
    }
    return BwdPlan(BWD_ROWS, BWD_CHUNK, stages, smem, blocks, np_, ng, sw,
                   sp, scratch)


def bwd_scratch(plan: BwdPlan, device) -> dict:
    """The scratch tensors of ``plan``, as :func:`head_mlp_bwd` allocates
    them."""
    return {name: torch.empty(shape, dtype=dt, device=device)
            for name, (shape, dt) in plan.scratch.items()}


def head_mlp_bwd_kernel(x, ek, eb, mul, add, pk, pb, gy, scratch=None):
    """The CUDA route of :func:`head_mlp_bwd`; raises for anything it does
    not take (a CPU tensor included). ``scratch``: the tensors of
    :func:`bwd_scratch` to use (the row pass leaves dhc and z there), or
    None to allocate them."""
    _check(x, ek, eb, mul, add, pk, pb, "backward")
    M, C = x.shape
    O, n = ek.shape[1], pk.shape[1]
    if (gy.shape != (M, n) or gy.dtype != x.dtype or gy.device != x.device
            or not gy.is_contiguous()):
        raise ValueError(f"head MLP backward kernel: gy must be contiguous "
                         f"{x.dtype} {(M, n)}, got {gy.dtype} "
                         f"{tuple(gy.shape)}")
    for name, t in (("x", x), ("gy", gy)):
        if t.data_ptr() % 16:
            raise ValueError(f"head MLP backward kernel: {name} must start "
                             "16-byte aligned")
    plan = bwd_plan(M, C, O, n, _sms(x.device))
    sc = bwd_scratch(plan, x.device) if scratch is None else scratch
    if {k: (tuple(v.shape), v.dtype) for k, v in sc.items()} != plan.scratch:
        raise ValueError("head MLP backward kernel: scratch does not match "
                         "the plan")
    dx = torch.empty_like(x)
    dek_t = torch.empty((O, C), dtype=ek.dtype, device=x.device)
    dpk_t = torch.empty((n, O), dtype=pk.dtype, device=x.device)
    err = _build.library().mtlora_head_mlp_bwd(
        *(t.data_ptr() for t in (x, ek.t(), eb, mul, add, pk.t(), gy, dx)),
        *(sc[k].data_ptr() for k in ("wpad", "xpad", "gypad", "dhc", "z",
                                     "cols", "part", "sums")),
        dek_t.data_ptr(), dpk_t.data_ptr(), M, C, O, n, plan.ng,
        plan.stages, plan.smem, plan.sw, plan.sp,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "mtlora_head_mlp_bwd")
    head_mlp_bwd.launches += 1
    tail = sc["sums"][O * C + n * O:]
    deb, dmul, dadd = (tail[k * O:(k + 1) * O].view(1, O) for k in range(3))
    return (dx, dek_t.t(), deb, dmul, dadd, dpk_t.t(),
            tail[3 * O:].view(1, n))


def head_mlp_bwd(x, ek, eb, mul, add, pk, pb, gy, kernel: bool = True):
    """``(dx, dek, deb, dmul, dadd, dpk, dpb)`` of
    :func:`head_mlp_bwd_plain`: the plain version for CPU tensors (and,
    ``kernel`` False, for any); for CUDA tensors the row kernel (dx, dhc,
    z, the column partials), the weight-gradient products of dWe and dWp
    and the fixed-order sums. ``dek`` and ``dpk`` come back as transposed
    views of ``[O, C]`` and ``[n, O]`` tensors, the layout of the conv
    weights."""
    if x.device.type == "cpu" or not kernel:
        return head_mlp_bwd_plain(x, ek, eb, mul, add, pk, pb, gy)
    return head_mlp_bwd_kernel(x, ek, eb, mul, add, pk, pb, gy)


head_mlp_fwd.launches = 0
head_mlp_bwd.launches = 0


class HeadMLPFn(torch.autograd.Function):
    """``custom_vjp`` of ``fused_head_mlp``: all seven operands get
    gradients (the decoder heads train under MTLoRA)."""

    @staticmethod
    def forward(ctx, x, ek, eb, mul, add, pk, pb, kernel=True):
        ctx.save_for_backward(x, ek, eb, mul, add, pk, pb)
        ctx.kernel = kernel
        return head_mlp_fwd(x, ek, eb, mul, add, pk, pb, kernel)

    @staticmethod
    def backward(ctx, gy):
        x, ek, eb, mul, add, pk, pb = ctx.saved_tensors
        return (*head_mlp_bwd(x, ek, eb, mul, add, pk, pb, gy.contiguous(),
                              ctx.kernel), None)


def head_mlp(x, ek, eb, mul, add, pk, pb, kernel: bool = True):
    """Fused head on ``x [M, C]`` (see :func:`head_mlp_plain`),
    differentiable in all seven operands. CPU tensors take the plain
    versions; CUDA tensors the kernels (see :func:`head_mlp_fwd`);
    ``kernel`` False (a model with ``TPU.USE_PALLAS`` off) the plain
    versions on any device."""
    return HeadMLPFn.apply(x, ek, eb, mul, add, pk, pb, kernel)
