"""Window attention core: the CUDA kernels, their plain versions, counters.

Counterpart of ``mtlora_tpu/ops/pallas_window_attn.py``: the forward
kernel ``csrc/window_attn_fwd.cu`` and the backward kernel
``csrc/window_attn_bwd.cu`` under one ``torch.autograd.Function``, as the
JAX package puts ``_run_fwd`` and ``_run_bwd`` under one ``custom_vjp``.
Both read the plain window order that ``ops/window.py`` produces,
``[B*nW, N, 3C]``, not the TPU's padded pack-2 layout; both run on bf16
tensor cores at head dim 32, blocks of consecutive windows of one head
under a launch plan (:func:`fwd_plan`, :func:`bwd_plan`).

Kernel 1c, the dense cells of ``_fused_windows_dense`` (``MTLORA_ATTN_DENSE``),
is the dense instance of each body: whole 8-window cells (the TPU's four
pack-2 pairs, 392 rows at N = 49), a cell's mask tiles staged at once.
Its function is kernel 1's, so its plain versions are kernel 1's;
:func:`dense_applies` is the JAX package's decision to take it.

The probes of ``tools/attn_probe.py`` and ``tools/attn_variants.py`` are
the first port's forward body (``csrc/window_attn.cu``) with a part
switched (:data:`PROBE_MODES`); :func:`window_attention_probe_plain` is
their function per 49-token window, not on the TPU's pack-2 pairs.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from mtlora_tpu_torch.ops import _build
from mtlora_tpu_torch.ops.attention import attention_probs, dtype_const
from mtlora_tpu_torch.ops.attention import window_attention as plain

MAX_N = 64
# windows per dense cell: four pack-2 pairs (``_DENSE_CHUNKS``)
DENSE_CELL = 8
# the backward kernel (``csrc/window_attn_bwd.cu``, N padded to MAX_N
# rows): head dim, blocks an SM (its ``__launch_bounds__``), the fp32 row
# stride of the staged bias; shared memory of one SM and of one block on
# the H100 (1 KB of an SM is reserved for each block)
BWD_HEAD_DIM = 32
BWD_BLOCKS_PER_SM = 3
BWD_BIAS_LD = 72
SM_SMEM = 233_472
SMEM_LIMIT = 232_448
# the forward kernel (``csrc/window_attn_fwd.cu``, N padded to MAX_N rows):
# head dim, blocks an SM (its ``__launch_bounds__``), buffers of a
# window's q, k, v tiles (and its mask slot), the floats a mask slot holds
# past its tile's chunks
FWD_HEAD_DIM = 32
FWD_BLOCKS_PER_SM = 4
FWD_STAGES = 2
FWD_MASK_TAIL = 64
# the probe modes -> the CUDA source's Mode ids: attn_probe's _kern modes
# "full" (kernel 1), "nosmax", "nodots", then attn_variants'
# kern_dots_only and kern_softmax_only
PROBE_MODES = {"full": 0, "nosmax": 1, "nodots": 2, "dots_only": 3,
               "softmax_only": 4}
UNMASKED_MODES = ("dots_only", "softmax_only")


def window_attention_probe_plain(qkv: torch.Tensor, num_heads: int,
                                 rel_bias: torch.Tensor,
                                 mask: torch.Tensor | None, scale: float,
                                 mode: str) -> torch.Tensor:
    """A probe of the first port's forward body per window and head,
    ``[B*nW, N, C]`` in qkv's dtype, with the probes' cast points:

    - ``full``: :func:`attention.window_attention`;
    - ``nosmax``: ``P = S``, ``S = q*scale k^T + bias + mask`` in fp32,
      rounded to the working dtype before ``P V``;
    - ``nodots``: ``S = bf16(q[:, 0] + k[:, 0]^T)`` (unscaled), then bias,
      mask, softmax and ``P V`` as kernel 1;
    - ``dots_only``: ``bf16(q*scale k^T) V``, no bias, mask or softmax;
    - ``softmax_only``: the row sums of ``softmax(x[:, 0] + bias[h])``
      over the keys, with ``x[:, 0]`` the window's first qkv column, head
      ``c % nH`` in output column c.
    """
    if mode == "full":
        return plain(qkv, num_heads, rel_bias, mask, scale)
    if mode not in PROBE_MODES:
        raise ValueError(f"probe mode {mode!r} not in {list(PROBE_MODES)}")
    if mode in UNMASKED_MODES and mask is not None:
        raise ValueError(f"probe mode {mode} takes no mask")
    Bw, N, C3 = qkv.shape
    C, dt = C3 // 3, qkv.dtype
    hd = C // num_heads
    f = torch.promote_types(dt, torch.float32)
    if mode == "softmax_only":
        s = qkv[:, None, :, :1].to(f) + rel_bias.to(f)[None]  # [Bw, nH, N, N]
        rows = torch.softmax(s, dim=-1).sum(-1)               # [Bw, nH, N]
        return rows.transpose(1, 2).repeat(1, 1, hd).to(dt)
    x = qkv.view(Bw, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = x[0], x[1], x[2]
    if mode == "nodots":
        s = (q[..., :1] + k[..., :1].transpose(-1, -2)).to(f)
    else:
        s = torch.matmul((q * dtype_const(scale, dt)).to(f),
                         k.to(f).transpose(-1, -2))
    if mode != "dots_only":
        s = s + rel_bias.to(f)[None]
        if mask is not None:
            nW = mask.shape[0]
            s = (s.view(Bw // nW, nW, num_heads, N, N)
                 + mask.to(f)[None, :, None]).view(Bw, num_heads, N, N)
    p = torch.softmax(s, dim=-1) if mode == "nodots" else s
    out = torch.matmul(p.to(dt).to(f), v.to(f)).to(dt)
    return out.transpose(1, 2).reshape(Bw, N, C)


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


def dense_tiles(n_windows: int, mask: torch.Tensor | None) -> bool:
    """The op-level condition of kernel 1c: whole 8-window cells, and a
    mask period that tiles them (``_dense_mask``: ``nW/2 % 4 == 0`` or
    ``4 % (nW/2) == 0``, in windows: nW a multiple or a divisor of 8)."""
    if n_windows % DENSE_CELL:
        return False
    if mask is None:
        return True
    nw = mask.shape[0]
    return nw % DENSE_CELL == 0 or DENSE_CELL % nw == 0


def dense_applies(dtype: torch.dtype, N: int, nw: int, batch: int,
                  mask: torch.Tensor | None) -> bool:
    """Whether ``_maybe_packed`` (``pallas_window_attn.py:260-291``), with
    ``MTLORA_ATTN_DENSE`` set, sends ``[batch*nw, N, 3C]`` windows to the
    dense cells: two windows pack when ``2N <= 128`` and nw is even, or
    nw is 1 with no mask and an even window count; the pairs go dense for
    bf16, N = 49, a pair count that is a multiple of 4, and a mask period
    that tiles the cells (``_dense_mask`` :246-257)."""
    n_windows = batch * nw
    if not (2 * N <= 128 and (nw % 2 == 0 or (
            nw == 1 and mask is None and n_windows % 2 == 0))):
        return False
    if not (dtype == torch.bfloat16 and N == 49
            and (n_windows // 2) % 4 == 0):
        return False
    if mask is None:
        return True
    nw2 = max(1, nw // 2)
    return nw2 % 4 == 0 or 4 % nw2 == 0


class BwdPlan(NamedTuple):
    """Launch plan of the backward kernel: windows per block (kernel 1c:
    whole cells), window groups, blocks (groups x heads), mask tiles staged
    per block, shared-memory bytes, resident blocks an SM, and the shape of
    the fp32 dbias partials (one per group and head)."""
    group: int
    n_groups: int
    blocks: int
    tiles: int
    smem: int
    per_sm: int
    part: tuple


def bwd_plan(n_windows: int, N: int, num_heads: int, mask_windows: int,
             dense: bool, sms: int) -> BwdPlan:
    """The backward's plan for ``n_windows`` windows of N tokens and
    ``num_heads`` heads (a mask of ``mask_windows`` tiles, 0 for none) on a
    card of ``sms`` SMs. One wave: the resident blocks (``per_sm`` an SM,
    as many as shared memory and the kernel's register cap allow) are
    shared among the heads, and each head's windows are cut into that many
    groups of consecutive windows; a block walks its group one window after
    another, the next window's tiles loading while it computes this one.
    Kernel 1c (``dense``) rounds a group up to whole 8-window cells and
    stages a cell's mask tiles (``min(8, nW)``) at once; kernel 1b stages
    one tile per window."""
    if not (0 < N <= MAX_N and n_windows > 0 and num_heads > 0):
        raise ValueError(f"window attention backward kernel: {n_windows} "
                         f"windows of N={N} (at most {MAX_N}), "
                         f"{num_heads} heads")
    tiles = (0 if not mask_windows
             else min(DENSE_CELL, mask_windows) if dense else 1)
    # two windows' q, k, v and dO tiles (MAX_N x 32 bf16 each), P and dS
    # (MAX_N x MAX_N bf16 each; the staged output rows reuse them), the
    # bias (N rows of BWD_BIAS_LD fp32), and the mask tiles, each copied
    # from the 16-byte chunk that holds its first element
    smem = (2 * 4 * MAX_N * BWD_HEAD_DIM * 2 + 2 * MAX_N * MAX_N * 2
            + N * BWD_BIAS_LD * 4 + tiles * 16 * ((N * N + 6) // 4))
    if smem > SMEM_LIMIT:
        raise ValueError(f"window attention backward kernel: {smem} bytes "
                         f"of shared memory exceed {SMEM_LIMIT}")
    per_sm = min(BWD_BLOCKS_PER_SM, SM_SMEM // (smem + 1024))
    slots = max(1, sms * per_sm // num_heads)
    group = -(-n_windows // slots)
    if dense:
        group = -(-group // DENSE_CELL) * DENSE_CELL
    n_groups = -(-n_windows // group)
    return BwdPlan(group, n_groups, n_groups * num_heads, tiles, smem,
                   per_sm, (n_groups, num_heads, N, N))


class FwdPlan(NamedTuple):
    """Launch plan of the forward kernel: windows per block, window
    groups, blocks (groups x heads), buffers of a window's tiles, resident
    mask tiles (kernel 1c, nW dividing the cell), shared-memory bytes and
    resident blocks an SM."""
    group: int
    n_groups: int
    blocks: int
    buffers: int
    tiles: int
    smem: int
    per_sm: int


@functools.lru_cache(maxsize=None)
def fwd_plan(n_windows: int, N: int, num_heads: int, mask_windows: int,
             dense: bool, sms: int, head_dim: int = FWD_HEAD_DIM) -> FwdPlan:
    """The forward's plan for ``n_windows`` windows of N tokens and
    ``num_heads`` heads of ``head_dim`` (a mask of ``mask_windows`` tiles,
    0 for none) on a card of ``sms`` SMs. One wave: the resident blocks
    (``per_sm`` an SM, as many as shared memory and the kernel's register
    cap allow) are shared among the heads, and each head's windows are cut
    into that many groups of consecutive windows; a block walks its group,
    the next ``buffers - 1`` windows' tiles loading while it computes one.
    The forward keeps no partial per cell, so kernel 1c's groups are cut
    as kernel 1's; where nW divides the 8-window cell (``min(8, nW)`` =
    nW tiles) it stages the mask tiles once a block, else each window's
    tile comes with its q, k and v into a slot of its buffer.

    Refuses a head dim other than 32 and N above 64 (the kernel's tiles),
    naming the bound."""
    if head_dim != FWD_HEAD_DIM:
        raise ValueError(f"window attention forward kernel: head dim "
                         f"{head_dim}; the kernel's tiles take "
                         f"{FWD_HEAD_DIM} only")
    if not (0 < N <= MAX_N and n_windows > 0 and num_heads > 0):
        raise ValueError(f"window attention forward kernel: {n_windows} "
                         f"windows of N={N} (at most {MAX_N}), "
                         f"{num_heads} heads")
    tiles = mask_windows if dense and 0 < mask_windows <= DENSE_CELL else 0
    per_window = FWD_STAGES if mask_windows and not tiles else 0
    # the buffers' q, k, v tiles (MAX_N x 32 bf16 each), then the mask
    # slots: a tile's 16-byte chunks from the one that holds its first
    # element, and FWD_MASK_TAIL floats more
    slot = 4 * (4 * ((N * N + 6) // 4) + FWD_MASK_TAIL)
    smem = (FWD_STAGES * 3 * MAX_N * FWD_HEAD_DIM * 2
            + (per_window + tiles) * slot)
    if smem > SMEM_LIMIT:
        raise ValueError(f"window attention forward kernel: {smem} bytes "
                         f"of shared memory exceed {SMEM_LIMIT}")
    per_sm = min(FWD_BLOCKS_PER_SM, SM_SMEM // (smem + 1024))
    slots = max(1, per_sm * sms // num_heads)
    group = -(-n_windows // slots)
    n_groups = -(-n_windows // group)
    return FwdPlan(group, n_groups, n_groups * num_heads, FWD_STAGES, tiles,
                   smem, per_sm)


def _check(qkv, num_heads, rel_bias, mask, what, dense=False):
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
    if dense and not dense_tiles(Bw, mask):
        raise ValueError(f"window attention {what} kernel 1c: {Bw} windows "
                         f"do not fill {DENSE_CELL}-window cells, or the "
                         "mask period does not tile them")
    for t in tensors:
        if t.device != qkv.device or not t.is_contiguous():
            raise ValueError(f"window attention {what} kernel: operands "
                             "must be contiguous and on one device")


def _check_dout(qkv, dout):
    Bw, N, C3 = qkv.shape
    if (dout.shape != (Bw, N, C3 // 3) or dout.dtype != qkv.dtype
            or dout.device != qkv.device or not dout.is_contiguous()):
        raise ValueError(f"window attention backward kernel: dout must be "
                         f"contiguous {qkv.dtype} {(Bw, N, C3 // 3)}, got "
                         f"{dout.dtype} {tuple(dout.shape)}")


def _launch_bwd(qkv, num_heads, rel_bias, mask, scale, dout, dense):
    """Kernel 1b (``dense``: 1c's backward) under :func:`bwd_plan`. Its
    operands: kernel 1's, a head dim of 32 (every Swin config of the repo:
    96 / 3 heads, 128 / 4; the kernel's tiles are specialised to it), dout
    of the forward output's shape, and the mask 16-byte aligned (its tiles
    are copied in 16-byte chunks)."""
    hd = qkv.shape[2] // 3 // num_heads
    if hd != BWD_HEAD_DIM:
        raise ValueError(f"window attention backward kernel: head dim {hd}; "
                         f"the kernel's tiles take {BWD_HEAD_DIM} only")
    _check(qkv, num_heads, rel_bias, mask, "backward", dense)
    if mask is not None and mask.data_ptr() % 16:
        raise ValueError("window attention backward kernel: the mask must "
                         "start on a 16-byte boundary")
    _check_dout(qkv, dout)
    Bw, N, C3 = qkv.shape
    n_mask = mask.shape[0] if mask is not None else 0
    plan = bwd_plan(Bw, N, num_heads, n_mask, dense,
                    torch.cuda.get_device_properties(
                        qkv.device).multi_processor_count)
    dqkv = torch.empty_like(qkv)
    part = torch.empty(plan.part, dtype=torch.float32, device=qkv.device)
    dbias = torch.empty((num_heads, N, N), dtype=torch.float32,
                        device=qkv.device)
    name = ("mtlora_window_attn_dense_bwd" if dense
            else "mtlora_window_attn_bwd")
    err = getattr(_build.library(), name)(
        qkv.data_ptr(), rel_bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, dout.data_ptr(),
        dqkv.data_ptr(), part.data_ptr(), dbias.data_ptr(),
        Bw, N, C3 // 3, num_heads, n_mask, plan.group, plan.smem,
        dtype_const(scale, qkv.dtype), float(scale),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(err, name)
    return dqkv, dbias


def _launch_fwd(qkv, num_heads, rel_bias, mask, scale, mode, what):
    """The probes' source in ``mode`` of :data:`PROBE_MODES` (``full``:
    kernel 1's function)."""
    _check(qkv, num_heads, rel_bias, mask, what)
    Bw, N, C3 = qkv.shape
    out = torch.empty((Bw, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    err = _build.library().mtlora_window_attn_fwd(
        PROBE_MODES[mode], qkv.data_ptr(), rel_bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        Bw, N, C3 // 3, num_heads, mask.shape[0] if mask is not None else 0,
        dtype_const(scale, qkv.dtype),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(err, "mtlora_window_attn_fwd")
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the scale rounded to a dtype, once per (scale, dtype): the forward's
# wrapper is on the host's path twelve times a forward
_scale_c = functools.lru_cache(maxsize=None)(dtype_const)


def _launch_fwd_rows(qkv, num_heads, rel_bias, mask, scale, dense):
    """Kernel 1 (``dense``: 1c) under :func:`fwd_plan`. Its operands:
    kernel 1's, a head dim of 32 (every Swin config of the repo: 96 / 3
    heads, 128 / 4; the kernel's tiles are specialised to it), and the
    mask 16-byte aligned (its tiles are copied in 16-byte chunks)."""
    _check(qkv, num_heads, rel_bias, mask, "forward", dense)
    Bw, N, C3 = qkv.shape
    if mask is not None and mask.data_ptr() % 16:
        raise ValueError("window attention forward kernel: the mask must "
                         "start on a 16-byte boundary")
    n_mask = mask.shape[0] if mask is not None else 0
    plan = fwd_plan(Bw, N, num_heads, n_mask, dense,
                    _sm_count(qkv.device.index), C3 // 3 // num_heads)
    out = torch.empty((Bw, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    args = [qkv.data_ptr(), rel_bias.data_ptr(),
            mask.data_ptr() if mask is not None else None, out.data_ptr(),
            Bw, N, C3 // 3, num_heads, n_mask, plan.group]
    name = "mtlora_window_attn_fwd_rows"
    if dense:
        name, args = "mtlora_window_attn_dense_fwd_rows", args + [plan.tiles]
    err = getattr(_build.library(), name)(
        *args, plan.smem, _scale_c(scale, qkv.dtype),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(err, name)
    return out


def window_attention_fwd(qkv: torch.Tensor, num_heads: int,
                         rel_bias: torch.Tensor, mask: torch.Tensor | None,
                         scale: float, kernel: bool = True) -> torch.Tensor:
    """Forward core, no autograd: the plain version for CPU tensors, the
    kernel for CUDA tensors (bf16, N <= 64, head dim 32; any other CUDA
    tensor raises). ``kernel`` False (``TPU.USE_PALLAS`` off) takes the
    plain version on any device."""
    if qkv.device.type == "cpu" or not kernel:
        return plain(qkv, num_heads, rel_bias, mask, scale)
    out = _launch_fwd_rows(qkv, num_heads, rel_bias, mask, scale, False)
    window_attention_fwd.launches += 1
    return out


def window_attention_bwd(qkv: torch.Tensor, num_heads: int,
                         rel_bias: torch.Tensor, mask: torch.Tensor | None,
                         scale: float, dout: torch.Tensor,
                         kernel: bool = True):
    """Backward core: ``(dqkv, dbias)`` of :func:`window_attention_bwd_plain`,
    from the plain version for CPU tensors (and, ``kernel`` False, for any)
    and from the kernel (plus its deterministic group reduction) for CUDA
    tensors."""
    if qkv.device.type == "cpu" or not kernel:
        return window_attention_bwd_plain(qkv, num_heads, rel_bias, mask,
                                          scale, dout)
    out = _launch_bwd(qkv, num_heads, rel_bias, mask, scale, dout, False)
    window_attention_bwd.launches += 1
    return out


def window_attention_dense_fwd(qkv: torch.Tensor, num_heads: int,
                               rel_bias: torch.Tensor,
                               mask: torch.Tensor | None,
                               scale: float) -> torch.Tensor:
    """Kernel 1c forward, no autograd: kernel 1's plain version for CPU
    tensors, the kernel's dense instance for CUDA tensors (as kernel 1's,
    and whole 8-window cells tiled by the mask period)."""
    if qkv.device.type == "cpu":
        return plain(qkv, num_heads, rel_bias, mask, scale)
    out = _launch_fwd_rows(qkv, num_heads, rel_bias, mask, scale, True)
    window_attention_dense_fwd.launches += 1
    return out


def window_attention_dense_bwd(qkv: torch.Tensor, num_heads: int,
                               rel_bias: torch.Tensor,
                               mask: torch.Tensor | None, scale: float,
                               dout: torch.Tensor):
    """Kernel 1c backward: ``(dqkv, dbias)`` of
    :func:`window_attention_bwd_plain` for CPU tensors, and from the
    dense-cell kernel (groups of whole cells, their dbias partials summed
    in group order) for CUDA tensors."""
    if qkv.device.type == "cpu":
        return window_attention_bwd_plain(qkv, num_heads, rel_bias, mask,
                                          scale, dout)
    out = _launch_bwd(qkv, num_heads, rel_bias, mask, scale, dout, True)
    window_attention_dense_bwd.launches += 1
    return out


def window_attention_probe(qkv: torch.Tensor, num_heads: int,
                           rel_bias: torch.Tensor, mask: torch.Tensor | None,
                           scale: float, mode: str) -> torch.Tensor:
    """A probe mode of :data:`PROBE_MODES`: the plain version for CPU
    tensors, the first port's forward body with the mode's part switched
    for CUDA tensors (kernel 1's operands; no mask for ``dots_only`` and
    ``softmax_only``)."""
    if qkv.device.type == "cpu":
        return window_attention_probe_plain(qkv, num_heads, rel_bias, mask,
                                            scale, mode)
    if mode not in PROBE_MODES or (mode in UNMASKED_MODES
                                   and mask is not None):
        raise ValueError(f"window attention probe: mode {mode!r} (with a "
                         f"mask: {mask is not None}) is not one of "
                         f"{list(PROBE_MODES)} (no mask for "
                         f"{UNMASKED_MODES})")
    out = _launch_fwd(qkv, num_heads, rel_bias, mask, scale, mode,
                      f"probe {mode}")
    window_attention_probe.launches[mode] += 1
    return out


window_attention_fwd.launches = 0
window_attention_bwd.launches = 0
# launches by mode
window_attention_probe.launches = dict.fromkeys(PROBE_MODES, 0)
window_attention_dense_fwd.launches = 0
window_attention_dense_bwd.launches = 0


class WindowAttentionFn(torch.autograd.Function):
    """``custom_vjp`` of ``_fused_windows``: gradients for qkv and the
    gathered bias; none for the mask."""

    @staticmethod
    def forward(ctx, qkv, rel_bias, mask, num_heads, scale, kernel=True):
        ctx.save_for_backward(qkv, rel_bias, mask)
        ctx.num_heads, ctx.scale, ctx.kernel = num_heads, scale, kernel
        return window_attention_fwd(qkv, num_heads, rel_bias, mask, scale,
                                    kernel)

    @staticmethod
    def backward(ctx, dout):
        qkv, rel_bias, mask = ctx.saved_tensors
        dqkv, dbias = window_attention_bwd(qkv, ctx.num_heads, rel_bias, mask,
                                           ctx.scale, dout.contiguous(),
                                           ctx.kernel)
        return dqkv, dbias.to(rel_bias.dtype), None, None, None, None


def fused_window_attention(qkv: torch.Tensor, num_heads: int,
                           rel_bias: torch.Tensor, mask: torch.Tensor | None,
                           scale: float, kernel: bool = True) -> torch.Tensor:
    """qkv [B*nW, N, 3C], rel_bias [nH, N, N] fp32, mask [nW, N, N] fp32
    or None -> [B*nW, N, C] in qkv's dtype (see ``attention.window_attention``
    for the math and its cast points), differentiable in qkv and rel_bias.

    CPU tensors take the plain versions; CUDA tensors the kernels, which
    take bf16 only, N <= 64 and a head dim of 32. ``kernel`` False (a
    model with ``TPU.USE_PALLAS`` off) takes the plain versions on any
    device."""
    return WindowAttentionFn.apply(qkv, rel_bias, mask, num_heads, scale,
                                   kernel)


class WindowAttentionDenseFn(torch.autograd.Function):
    """``custom_vjp`` of ``_fused_windows_dense``: kernel 1c forward and
    backward; gradients for qkv and the gathered bias, none for the
    mask."""

    @staticmethod
    def forward(ctx, qkv, rel_bias, mask, num_heads, scale):
        ctx.save_for_backward(qkv, rel_bias, mask)
        ctx.num_heads, ctx.scale = num_heads, scale
        return window_attention_dense_fwd(qkv, num_heads, rel_bias, mask,
                                          scale)

    @staticmethod
    def backward(ctx, dout):
        qkv, rel_bias, mask = ctx.saved_tensors
        dqkv, dbias = window_attention_dense_bwd(
            qkv, ctx.num_heads, rel_bias, mask, ctx.scale, dout.contiguous())
        return dqkv, dbias.to(rel_bias.dtype), None, None, None


def fused_window_attention_dense(qkv: torch.Tensor, num_heads: int,
                                 rel_bias: torch.Tensor,
                                 mask: torch.Tensor | None,
                                 scale: float) -> torch.Tensor:
    """:func:`fused_window_attention` through kernel 1c: the same function
    and operands; the windows fill whole 8-window cells and a mask's period
    tiles them (:func:`dense_tiles`)."""
    return WindowAttentionDenseFn.apply(qkv, rel_bias, mask, num_heads, scale)
