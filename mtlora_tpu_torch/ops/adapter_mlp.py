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
``dA2T = g h``. GELU is the JAX kernel's (``ln_lora.gelu_form``): the
tanh form in bf16, the kernels' only dtype, exact erf otherwise.

Kernels 5 and 5b run their rank products on bf16 tensor cores, the four
tasks' (task, rank) pairs one 16-deep ``mma.sync`` operand masked per
task. Kernel 5 (``csrc/adapter_mlp_fwd.cu``) stages a chunk of B1 and A2T
columns once a block; each warp walks 16-row steps over the chunk's
pairs of n8 tiles, p1 straight into the C layout, z, the GELU and bf16(h)
in registers, the projection's sums in C fragments across the chunk, its
result out as 16-byte stores (fp32 partials a chunk, summed in chunk
order, where H4 takes more than one); :func:`fwd_plan` is its launch
plan. Kernel 5b is one fused pass (``csrc/adapter_mlp_bwd.cu``);
:func:`bwd_plan` is its launch plan. The probes of
``tools/adapter_variants.py`` are switches on the first port's forward
body (``csrc/adapter_mlp.cu``, its rank products on the CUDA cores) and
on 5b's fused body, at T = 4 (:data:`FWD_PROBES`, :data:`BWD_PROBES`):
the form of the activation, the rank expansion left out (``nodot1``),
and the ``[T, M, r]`` layout of mid1 and the result (``vpu*``), with its
own order of the expansion's sums. The probe's ``nodot2`` has no
counterpart: JAX refuses it at the probe's shape (it stores an ``[R,
H4]`` hidden into an ``[R, 1024]`` block).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mtlora_tpu_torch.ops import _build
from mtlora_tpu_torch.ops.ln_lora import (
    _acc,
    _sms,
    _stream,
    act_pair,
    gelu_form,
)

RANK = 4        # the kernels' per-task rank (r_max of the flagship)
MAX_TASKS = 4
# forward probes -> (the CUDA source's FwdId, activation form, variant):
# make_fwd(_gelu), make_fwd(_tanh_gelu) (here the kernels' tanh algebra:
# kernel 5's function on the first port's body), make_fwd(_sig_gelu),
# make_fwd(None), make_fwd(_gelu, dot1=False), make_fwd_vpu(_sig_gelu),
# make_fwd_vpu(_sig_gelu, vpu_dot2=True), make_fwd_vpu(None)
FWD_PROBES = {
    "base": (0, "erf", "main"), "tanh": (1, "tanh", "main"),
    "sig": (2, "sig", "main"), "noact": (3, "none", "main"),
    "nodot1": (4, "erf", "nodot1"), "vpu1sig": (5, "sig", "vpu1"),
    "vpu12sig": (6, "sig", "vpu12"), "vpu1noac": (7, "none", "vpu1"),
}
# backward probes -> (the CUDA source's BwdId, activation form):
# make_bwd(erf_pair), kernel 5b, make_bwd(sig_pair)
BWD_PROBES = {"base": (0, "erf"), "tanh": (1, "tanh"), "sig": (2, "sig")}
# kernel 5b: the tanh form, at any T <= 4 (kBwdTanh)
KERNEL5B_ACT = 1


def _z(mid1T, p1, b1, scales):
    """``z [T, M, H4] = p1 + s_t mid1_t^T B1_t`` in the accumulation dtype."""
    f = _acc(mid1T.dtype)
    s = torch.tensor(scales, dtype=f, device=p1.device).view(-1, 1, 1)
    u = torch.einsum("trm,trh->tmh", mid1T.to(f), b1.to(f))
    return p1.to(f)[None] + s * u


def adapter_mid_plain(mid1T, p1, b1, a2T, scales):
    """mid2T [T, r2, M] in mid1T's dtype."""
    return adapter_mid_probe_plain(mid1T, p1, b1, a2T, scales,
                                   gelu_form(mid1T.dtype))


def adapter_mid_probe_plain(mid1, p1, b1, a2T, scales, probe: str):
    """A forward probe (a name of :data:`FWD_PROBES`, or a bare activation
    form for kernel 5's own variant): mid1 and the result ``[T, r, M]``,
    or ``[T, M, r]`` for the ``vpu*`` probes, in mid1's dtype.

    ``nodot1``: ``z = s_t p1``. ``vpu*``: ``z = p1``, then ``z += (s_t
    mid[:, r]) B1[r]`` in r order; ``vpu12sig`` projects the fp32 hidden,
    never rounded."""
    _, form, kind = FWD_PROBES.get(probe, (None, probe, "main"))
    cdt, f = mid1.dtype, _acc(mid1.dtype)
    T, M, H4 = len(scales), p1.shape[0], p1.shape[1]
    s = torch.tensor(scales, dtype=f, device=p1.device).view(-1, 1, 1)
    if kind == "nodot1":
        z = p1.to(f)[None] * s
    elif kind in ("vpu1", "vpu12"):
        m, bf = mid1.to(f), b1.to(f)
        z = p1.to(f)[None].expand(T, M, H4)
        for r in range(m.shape[2]):
            z = z + (s * m[:, :, r:r + 1]) * bf[:, r:r + 1, :]
    else:
        z = _z(mid1, p1, b1, scales)
    h = act_pair(z, form)[0]
    if kind != "vpu12":
        h = h.to(cdt).to(f)
    if kind in ("vpu1", "vpu12"):
        return torch.einsum("tmh,trh->tmr", h, a2T.to(f)).to(cdt)
    return torch.einsum("tmh,trh->trm", h, a2T.to(f)).to(cdt)


def adapter_mid_bwd_plain(mid1T, p1, b1, a2T, scales, g):
    """``(dmid1T, dp1, db1, da2T)`` of :func:`adapter_mid_plain` from the
    cotangent ``g [T, r2, M]``: dmid1T and dp1 in the inputs' dtypes, db1
    and da2T in the accumulation dtype."""
    return adapter_mid_bwd_probe_plain(mid1T, p1, b1, a2T, scales, g,
                                       gelu_form(mid1T.dtype))


def adapter_mid_bwd_probe_plain(mid1T, p1, b1, a2T, scales, g, probe: str):
    """:func:`adapter_mid_bwd_plain` with the activation of a backward
    probe (a name of :data:`BWD_PROBES`, or a form)."""
    cdt, f = mid1T.dtype, _acc(mid1T.dtype)
    gl, dgelu = act_pair(_z(mid1T, p1, b1, scales),
                         BWD_PROBES.get(probe, (None, probe))[1])
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

def _check(name, mid1T, p1, b1, a2T, scales, extra=(), tmr=False):
    """``tmr``: mid1 in the ``[T, M, r]`` layout of the ``vpu*`` probes."""
    T, M, H4 = mid1T.shape[0], p1.shape[0], p1.shape[1]
    r1 = mid1T.shape[2] if tmr else mid1T.shape[1]
    if (T > MAX_TASKS or r1 != RANK or a2T.shape[1] != RANK or H4 % 64
            or len(scales) != T):
        raise ValueError(f"{name} kernel: needs at most {MAX_TASKS} tasks "
                         f"of rank {RANK} and 4C % 64 == 0, got mid1T "
                         f"{tuple(mid1T.shape)}, p1 {tuple(p1.shape)}, a2T "
                         f"{tuple(a2T.shape)}")
    if mid1T.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {mid1T.device}")
    mid = (T, M, RANK) if tmr else (T, RANK, M)
    want = [("mid1T", mid1T, mid), ("p1", p1, (M, H4)),
            ("b1", b1, (T, RANK, H4)), ("a2T", a2T, (T, RANK, H4))]
    for label, t, shape in want + list(extra):
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != shape
                or t.device != mid1T.device or not t.is_contiguous()):
            raise ValueError(f"{name} kernel: {label} must be contiguous "
                             f"bf16 {shape} on {mid1T.device}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for label, t in (("p1", p1), ("b1", b1), ("a2T", a2T)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: {label} must start on a "
                             f"16-byte boundary")
    return T, M, H4


def _scales(scales):
    return [float(s) for s in scales] + [0.0] * (MAX_TASKS - len(scales))


def _launch_probe(what, fid, tmr, mid1, p1, b1, a2T, scales):
    """The first port's forward body in probe ``fid`` (an id of
    :data:`FWD_PROBES`), at 4 tasks; ``tmr``: the ``[T, M, r]``
    layout."""
    T, M, H4 = _check(what, mid1, p1, b1, a2T, scales, tmr=tmr)
    if T != MAX_TASKS:
        raise ValueError(f"{what}: runs at T = {MAX_TASKS}, got {T}")
    out = torch.empty((T, M, RANK) if tmr else (T, RANK, M),
                      dtype=mid1.dtype, device=mid1.device)
    err = _build.library().mtlora_adapter_mid_fwd(
        fid, mid1.data_ptr(), p1.data_ptr(), b1.data_ptr(), a2T.data_ptr(),
        out.data_ptr(), T, M, H4, *_scales(scales), _stream(mid1))
    _build.check(err, "mtlora_adapter_mid_fwd")
    return out


class FwdPlan(NamedTuple):
    """Launch plan of kernel 5: ``chunks`` chunks of ``cols`` columns (a
    multiple of 16, at most FWD_MAX_COLS), the ``steps`` 16-row steps of a
    chunk spread over ``stripes`` blocks of FWD_WARPS warps, ``blocks`` =
    chunks * stripes (``per_sm`` an SM), ``smem`` bytes a block, ``part``
    fp32 scratch elements: the mid2 partials a chunk where chunks > 1."""

    cols: int
    chunks: int
    steps: int
    stripes: int
    blocks: int
    per_sm: int
    smem: int
    part: int


FWD_WARPS = 8            # warps a block (kWarps)
FWD_PER_SM = 2           # blocks an SM (__launch_bounds__)
FWD_MAX_COLS = 384       # columns a chunk at most (kMaxCols)
FWD_MAX_H4 = 4096        # kMaxH4, Swin-B's widest hidden
FWD_STG = 16 + 4         # row stride of a warp's result rows (kStg)


def fwd_smem() -> int:
    """Shared-memory bytes of a block (``fwd_smem_bytes``): B1 and A2T of
    FWD_MAX_COLS columns as [h][16] bf16, and each warp's [16][FWD_STG]
    fp32 result rows."""
    tr = MAX_TASKS * RANK
    return 2 * FWD_MAX_COLS * tr * 2 + FWD_WARPS * tr * FWD_STG * 4


def fwd_plan(M: int, H4: int, T: int, sms: int) -> FwdPlan:
    """Kernel 5's plan for T tasks of rank 4, M rows and H4 hidden columns
    on a card of ``sms`` SMs: the fewest chunks of at most FWD_MAX_COLS
    columns, of equal width in whole pairs of n8 tiles; about
    ``FWD_PER_SM`` blocks an SM, at most one a 16-row step. Refuses what
    the kernel does not take, naming the bound."""
    if (not 1 <= T <= MAX_TASKS or M < 1 or H4 % 64
            or not 64 <= H4 <= FWD_MAX_H4):
        raise ValueError(f"adapter MLP tail forward kernel: needs 1 <= T <= "
                         f"{MAX_TASKS} ({T}), M >= 1 ({M}) and H4 % 64 == 0 "
                         f"up to {FWD_MAX_H4} ({H4})")
    chunks = -(-H4 // FWD_MAX_COLS)
    cols = 16 * -(-H4 // (16 * chunks))
    steps = -(-M // 16)
    stripes = max(1, min(steps, FWD_PER_SM * sms // chunks))
    part = chunks * T * RANK * M if chunks > 1 else 0
    return FwdPlan(cols, chunks, steps, stripes, chunks * stripes,
                   FWD_PER_SM, fwd_smem(), part)


def _launch_fwd(mid1T, p1, b1, a2T, scales):
    """Kernel 5 under :func:`fwd_plan`, then, where the plan has more than
    one chunk, the fixed-order sum of its partials."""
    T, M, H4 = _check("adapter MLP tail forward", mid1T, p1, b1, a2T,
                      scales)
    plan = fwd_plan(M, H4, T, _sms(mid1T.device))
    out = torch.empty_like(mid1T)
    part = torch.empty((plan.part,), dtype=torch.float32,
                       device=mid1T.device)
    err = _build.library().mtlora_adapter_mid_fwd_fused(
        mid1T.data_ptr(), p1.data_ptr(), b1.data_ptr(), a2T.data_ptr(),
        out.data_ptr(), part.data_ptr(), T, M, H4, plan.cols, plan.chunks,
        plan.stripes, plan.smem, *_scales(scales), _stream(mid1T))
    _build.check(err, "mtlora_adapter_mid_fwd_fused")
    return out


def adapter_mid_fwd(mid1T, p1, b1, a2T, scales):
    """Kernel 5 forward, no autograd: plain for CPU tensors, the kernel of
    :func:`_launch_fwd` for CUDA tensors (bf16, rank 4, at most 4
    tasks)."""
    if mid1T.device.type == "cpu":
        return adapter_mid_plain(mid1T, p1, b1, a2T, scales)
    out = _launch_fwd(mid1T, p1, b1, a2T, scales)
    adapter_mid_fwd.launches += 1
    return out


class BwdPlan(NamedTuple):
    """Launch plan of kernel 5b's fused pass: ``cols`` = BWD_WARPS * 16 *
    BWD_PAIRS columns a block (a chunk of H4, ``chunks`` of them),
    ``tiles`` row tiles of BWD_ROWS walked in ``stripes`` of ``tps``
    tiles, ``blocks`` = chunks * stripes (``per_sm`` an SM), ``smem``
    bytes a block, ``part`` fp32 scratch elements: the dB1 and dA2T
    partials a stripe and, where chunks > 1, the dmid1 partials a
    chunk."""

    cols: int
    tiles: int
    chunks: int
    stripes: int
    tps: int
    blocks: int
    per_sm: int
    smem: int
    part: int


BWD_WARPS = 8            # warps a block (kWarps)
BWD_PAIRS = 3            # column pairs of n8 tiles a warp (kPairs)
BWD_ROWS = 64            # rows a tile (kRows)
BWD_PER_SM = 2           # blocks an SM (__launch_bounds__)
BWD_MAX_H4 = 4096        # kMaxH4, Swin-B's widest hidden


def bwd_smem() -> int:
    """Shared-memory bytes of a block (``bwd_smem_bytes``): B1 and A2T of
    its columns as [h][16] bf16, mid1 and g of a row tile as [16][BWD_ROWS
    + 8] bf16, the warps' dmid1 partials [warps][16][BWD_ROWS] fp32, each
    lane's dB1 and dA2T sums of its pairs (16 fp32 a pair)."""
    tr = MAX_TASKS * RANK
    return (2 * BWD_WARPS * 16 * BWD_PAIRS * tr * 2
            + 2 * tr * (BWD_ROWS + 8) * 2 + BWD_WARPS * tr * BWD_ROWS * 4
            + BWD_WARPS * 32 * BWD_PAIRS * 16 * 4)


def bwd_plan(M: int, H4: int, T: int, sms: int) -> BwdPlan:
    """Kernel 5b's plan for T tasks of rank 4, M rows and H4 hidden columns
    on a card of ``sms`` SMs: chunks of BWD_WARPS * 16 * BWD_PAIRS
    columns, about ``BWD_PER_SM`` blocks an SM (their shared memory fits
    the SM's), the row tiles split evenly into stripes, none empty.
    Refuses what the kernel does not take, naming the bound."""
    if (not 1 <= T <= MAX_TASKS or M < 1 or H4 % 64
            or not 64 <= H4 <= BWD_MAX_H4):
        raise ValueError(f"adapter MLP tail backward kernel: needs 1 <= T <= "
                         f"{MAX_TASKS} ({T}), M >= 1 ({M}) and H4 % 64 == 0 "
                         f"up to {BWD_MAX_H4} ({H4})")
    cols = BWD_WARPS * 16 * BWD_PAIRS
    chunks = -(-H4 // cols)
    tiles = -(-M // BWD_ROWS)
    tps = -(-tiles // max(1, min(tiles, BWD_PER_SM * sms // chunks)))
    stripes = -(-tiles // tps)
    part = stripes * 2 * T * RANK * H4 + (chunks * T * RANK * M
                                          if chunks > 1 else 0)
    return BwdPlan(cols, tiles, chunks, stripes, tps, chunks * stripes,
                   BWD_PER_SM, bwd_smem(), part)


def _launch_bwd(what, act, mid1T, p1, b1, a2T, scales, g):
    """Kernel 5b's fused pass (:func:`bwd_plan`) with the activation
    ``act`` (an id of :data:`BWD_PROBES`; :data:`KERNEL5B_ACT` at up to 4
    tasks, the others at 4), then the fixed-order sums of its partials."""
    T, M, H4 = _check(what, mid1T, p1, b1, a2T, scales,
                      [("g", g, tuple(mid1T.shape))])
    if act != KERNEL5B_ACT and T != MAX_TASKS:
        raise ValueError(f"{what}: runs at T = {MAX_TASKS}, got {T}")
    plan = bwd_plan(M, H4, T, _sms(mid1T.device))
    f32 = dict(dtype=torch.float32, device=mid1T.device)
    dmid1 = torch.empty_like(mid1T)
    dp1 = torch.empty_like(p1)
    part = torch.empty((plan.part,), **f32)
    dw = torch.empty((2, T, RANK, H4), **f32)
    err = _build.library().mtlora_adapter_mid_bwd(
        act, mid1T.data_ptr(), p1.data_ptr(), b1.data_ptr(), a2T.data_ptr(),
        g.data_ptr(), dmid1.data_ptr(), dp1.data_ptr(), part.data_ptr(),
        dw.data_ptr(), T, M, H4, plan.chunks, plan.stripes, plan.tps,
        plan.smem, *_scales(scales), _stream(mid1T))
    _build.check(err, "mtlora_adapter_mid_bwd")
    return dmid1, dp1, dw[0], dw[1]


def adapter_mid_bwd(mid1T, p1, b1, a2T, scales, g):
    """``(dmid1T, dp1, db1, da2T)`` of :func:`adapter_mid_bwd_plain`: plain
    for CPU tensors, the kernels of :func:`_launch_bwd` for CUDA
    tensors."""
    if mid1T.device.type == "cpu":
        return adapter_mid_bwd_plain(mid1T, p1, b1, a2T, scales, g)
    out = _launch_bwd("adapter MLP tail backward", KERNEL5B_ACT, mid1T, p1,
                      b1, a2T, scales, g)
    adapter_mid_bwd.launches += 1
    return out


def adapter_mid_probe(mid1, p1, b1, a2T, scales, probe: str):
    """A forward probe of :data:`FWD_PROBES` at T = 4: plain for CPU
    tensors (:func:`adapter_mid_probe_plain`), the kernel for CUDA
    tensors (bf16, rank 4)."""
    if mid1.device.type == "cpu":
        return adapter_mid_probe_plain(mid1, p1, b1, a2T, scales, probe)
    fid, _, kind = FWD_PROBES[probe]
    out = _launch_probe(f"adapter MLP tail probe {probe}", fid,
                        kind in ("vpu1", "vpu12"), mid1, p1, b1, a2T, scales)
    adapter_mid_probe.launches[probe] += 1
    return out


def adapter_mid_bwd_probe(mid1T, p1, b1, a2T, scales, g, probe: str):
    """A backward probe of :data:`BWD_PROBES` at T = 4: ``(dmid1T, dp1,
    db1, da2T)``, plain for CPU tensors, the kernels of
    :func:`adapter_mid_bwd` with the probe's activation for CUDA
    tensors."""
    if mid1T.device.type == "cpu":
        return adapter_mid_bwd_probe_plain(mid1T, p1, b1, a2T, scales, g,
                                           probe)
    out = _launch_bwd(f"adapter MLP tail backward probe {probe}",
                      BWD_PROBES[probe][0], mid1T, p1, b1, a2T, scales, g)
    adapter_mid_bwd_probe.launches[probe] += 1
    return out


adapter_mid_fwd.launches = 0
adapter_mid_bwd.launches = 0
# launches by probe
adapter_mid_probe.launches = dict.fromkeys(FWD_PROBES, 0)
adapter_mid_bwd_probe.launches = dict.fromkeys(BWD_PROBES, 0)


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
