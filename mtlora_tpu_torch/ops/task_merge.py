"""Fused factored-task patch merge: the CUDA kernels, their plain versions,
counters.

Counterpart of ``mtlora_tpu/ops/pallas_task_merge.py`` (kernel 6 and its
backward 6b). At a stage-tail block that hands its task streams to the
patch merge unexpanded, task t's stream is

    y_t = base + c1_t (pre + s1_t mid1_t^T B1_t) + c2_t (p2 + s2_t mid2_t^T B2_t)

(``base`` the attention shortcut, ``pre`` proj's and ``p2`` fc2's frozen
outputs on the shared stream, ``c1``, ``c2`` the per-(task, sample)
drop-path coefficients) and the merge is the 2x2 gather, LN(4C) and the
4C -> 2C reduction of kernel 3. The ``[T, B, L, C]`` streams are never
written: the kernels form each source row from the shared rows and the
eight rank values of its token.

Operands as ``make_task_merge_operands`` (:387) prepares them, without the
TPU's pair-split and block-diagonal layouts: the coefficients fold into the
rank rows, ``midc = bf16(mid * c)`` (compute dtype), and the scales into
the rank matrices, ``Bs = bf16(B * s)``; the kernel sums ``((base + c1
pre) + c2 p2) + midc^T Bs`` in fp32 (``_tm_fwd_kernel`` :70), the LN in
fp32, ``bf16(ln) W^T`` in fp32, rounded once. The backward (``_tm_bwd_rule``
:300): ``dln = bf16(gy) W``, the LN backward per task, ``dbase = sum_t
dy_t``, ``dpre = sum_t c1_t dy_t``, ``dp2 = sum_t c2_t dy_t`` in fp32 in
task order, ``dU = bf16(dy)``, ``dmidc = bf16(Bs dU)``, ``dBs = midc^T dU``
(fp32), ``dW = bf16(gy)^T bf16(ln)`` over every task's rows; the
coefficients take no gradient; the chain rule back through ``midc`` and
``Bs`` is plain torch, as the JAX package leaves it to XLA. Every output is
in the compute dtype (the dtype of ``base``), as on the expand-then-merge
route.

Kernel 6 is the task mode of kernel 3's forward (``csrc/merge_ln_fwd.cu``,
its own symbol ``task_merge_fwd_rows``; its plan
:func:`task_merge_fwd_plan`); kernel 6b is ``csrc/task_merge_bwd.cu``
(:func:`task_merge_bwd_plan`). Both form each task's rows from the shared
rows on the chip (``csrc/task_merge.cuh``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mtlora_tpu_torch.ops import _build
from mtlora_tpu_torch.ops.ln_lora import (
    ROW_TILE,
    SM_SMEM,
    SMEM_LIMIT,
    MergeFwdPlan,
    _acc,
    _sms,
    _stream,
    layer_norm_bwd,
    layer_norm_parts,
    merge_fwd_items,
    merge_fwd_plan,
    merge_rows,
    stripes_for,
    unmerge_rows,
)

RANKS = 8       # the kernels' r1 + r2 (4 + 4: r_max of the flagship)


def token_coef(c, B: int, L: int, T: int, dtype, device):
    """Per-(task, sample) coefficients [T, B] (None: ones) -> per token
    ``[T, 1, B*L]`` in ``dtype``."""
    if c is None:
        return torch.ones((T, 1, B * L), dtype=dtype, device=device)
    return c.to(dtype).repeat_interleave(L, dim=1).view(T, 1, B * L)


def _scales(s, f, device):
    """The per-task scales ``s`` as a ``[T, 1, 1]`` tensor of dtype ``f`` on
    ``device``; to a card they go from pinned host memory without waiting,
    where a copy from pageable memory first waits for the stream."""
    if device.type == "cuda":
        return torch.tensor(s, dtype=f).pin_memory().to(
            device, non_blocking=True).view(len(s), 1, 1)
    return torch.tensor(s, dtype=f, device=device).view(len(s), 1, 1)


def rank_operands(mid1T, b1, mid2T, b2, c1, c2, s1, s2, B: int, L: int):
    """``(midc [T, S, M], Bs [T, S, C])`` in the compute dtype: the
    coefficients folded into the rank rows, the scales into B."""
    T, dt, dev = mid1T.shape[0], mid1T.dtype, mid1T.device
    midc = torch.cat([mid1T * token_coef(c1, B, L, T, dt, dev),
                      mid2T * token_coef(c2, B, L, T, dt, dev)], dim=1)

    def scaled(b, s):
        f = _acc(dt)
        return (b.to(f) * _scales(s, f, dev)).to(dt)

    return midc, torch.cat([scaled(b1, s1), scaled(b2, s2)], dim=1)


def _sample_coef(c, T, B, f, device):
    return (torch.ones((T, B), dtype=f, device=device) if c is None
            else c.reshape(T, B).to(f))


def task_streams(base, pre, p2, midc, bs, c1, c2):
    """The implicit streams ``y [T, B, L, C]`` in the accumulation dtype,
    summed in the kernel's order."""
    Bn, L, C = base.shape
    T = midc.shape[0]
    f = _acc(base.dtype)
    k1 = _sample_coef(c1, T, Bn, f, base.device).view(T, Bn, 1, 1)
    k2 = _sample_coef(c2, T, Bn, f, base.device).view(T, Bn, 1, 1)
    u = torch.einsum("tsm,tsc->tmc", midc.to(f), bs.to(f)).view(T, Bn, L, C)
    return (base.to(f)[None] + k1 * pre.to(f)[None]) + k2 * p2.to(f)[None] + u


def task_merge_plain(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1, s2,
                     gamma, beta, wt, H: int, W: int):
    """y [T, B, H/2*W/2, O] in base's dtype. base, pre, p2 [B, L, C];
    mid [T, r, B*L], b [T, r, C]; c1, c2 [T, B] (or [T, B, 1]) or None;
    s1, s2 the per-task scales; gamma, beta [4C], wt [O, 4C]."""
    Bn, L, C = base.shape
    cdt, f = base.dtype, _acc(base.dtype)
    midc, bs = rank_operands(mid1T, b1, mid2T, b2, c1, c2, s1, s2, Bn, L)
    y = task_streams(base, pre, p2, midc, bs, c1, c2)
    T = y.shape[0]
    ln, _, _ = layer_norm_parts(merge_rows(y.reshape(T * Bn, L, C), H, W),
                                gamma, beta)
    out = ln.to(cdt).to(f) @ wt.to(f).t()
    return out.to(cdt).view(T, Bn, (H // 2) * (W // 2), -1)


def task_merge_bwd_rows_plain(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2,
                              s1, s2, gamma, beta, wt, H: int, W: int, gy):
    """What kernel 6b's row kernel stores, as :func:`task_merge_bwd_plain`
    computes it: ``(dbase, dpre, dp2, dmid1T, db1, dmid2T, db2, dgamma,
    dbeta, lnd)``, with every task's bf16(ln) rows ``lnd [T * B * H/2 *
    W/2, 4C]`` in the compute dtype (the rows of the weight product)."""
    Bn, L, C = base.shape
    cdt, f = base.dtype, _acc(base.dtype)
    r1 = mid1T.shape[1]
    midc, bs = rank_operands(mid1T, b1, mid2T, b2, c1, c2, s1, s2, Bn, L)
    y = task_streams(base, pre, p2, midc, bs, c1, c2)
    T = y.shape[0]
    ln, xhat, inv = layer_norm_parts(
        merge_rows(y.reshape(T * Bn, L, C), H, W), gamma, beta)
    g = gy.reshape(-1, gy.shape[-1]).to(cdt).to(f)
    dln = g @ wt.to(f)
    dy, dgamma, dbeta = layer_norm_bwd(dln, xhat, inv, gamma)
    dy = unmerge_rows(dy, T * Bn, H, W).view(T, Bn, L, C)
    sums = []
    for c in (None, c1, c2):
        k = _sample_coef(c, T, Bn, f, base.device).view(T, Bn, 1, 1)
        acc = k[0] * dy[0]
        for t in range(1, T):
            acc = acc + k[t] * dy[t]
        sums.append(acc.to(cdt))
    du = dy.to(cdt).to(f).view(T, Bn * L, C)
    dmidc = torch.einsum("tsc,tmc->tsm", bs.to(f), du).to(cdt)
    dbs = torch.einsum("tsm,tmc->tsc", midc.to(f), du)
    return (*sums, *rank_grads(dmidc, dbs, c1, c2, s1, s2, r1, Bn, L),
            dgamma, dbeta, ln.to(cdt))


def task_merge_bwd_weights_plain(lnd, gy):
    """dW ``[O, 4C]`` (accumulation dtype) of kernel 6b's weight product:
    ``bf16(gy)^T`` times the stored rows ``lnd`` over every task's rows."""
    f = _acc(lnd.dtype)
    g = gy.reshape(-1, gy.shape[-1]).to(lnd.dtype).to(f)
    return g.t() @ lnd.to(f)


def task_merge_bwd_plain(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1,
                         s2, gamma, beta, wt, H: int, W: int, gy):
    """``(dbase, dpre, dp2, dmid1T, db1, dmid2T, db2, dgamma, dbeta, dwt)``
    of :func:`task_merge_plain` from ``gy [T, B, H/2*W/2, O]``: the bf16
    ones in their inputs' dtypes, db1, db2, dgamma, dbeta, dwt in the
    accumulation dtype."""
    rows = task_merge_bwd_rows_plain(base, pre, p2, mid1T, b1, mid2T, b2, c1,
                                     c2, s1, s2, gamma, beta, wt, H, W, gy)
    return (*rows[:9], task_merge_bwd_weights_plain(rows[9], gy))


def rank_grads(dmidc, dbs, c1, c2, s1, s2, r1: int, B: int, L: int):
    """``(dmid1T, db1, dmid2T, db2)`` from the gradients of ``midc`` and
    ``Bs`` (the chain rule of :func:`rank_operands`): ``dmid = bf16(dmidc
    c)``, ``db = bf16(dBs) s``."""
    T, dt, dev = dmidc.shape[0], dmidc.dtype, dmidc.device

    def unscale(d, s):
        f = _acc(dt)
        return d.to(dt).to(f) * _scales(s, f, dev)

    return (dmidc[:, :r1] * token_coef(c1, B, L, T, dt, dev),
            unscale(dbs[:, :r1], s1),
            dmidc[:, r1:] * token_coef(c2, B, L, T, dt, dev),
            unscale(dbs[:, r1:], s2))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _kernel_operands(name, base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1,
                     s2, gamma, beta, wt, H, W):
    """Checks, and the operands in the kernels' layouts: the rank rows
    token-major ``[T, B*L, 8]``, Bs as ``[T, C, 8]``, the coefficients
    ``[T, B, 2]`` fp32."""
    if base.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {base.device}")
    Bn, L, C = base.shape
    T, r1, M = mid1T.shape
    O = wt.shape[0]
    if (r1 + mid2T.shape[1] != RANKS or L != H * W or H % 2 or W % 2
            or C % 16 or O % 16 or M != Bn * L):
        raise ValueError(f"{name} kernel: needs r1 + r2 == {RANKS}, even H "
                         f"and W, C % 16 == 0 and 2C % 16 == 0; got mid1T "
                         f"{tuple(mid1T.shape)}, mid2T {tuple(mid2T.shape)}, "
                         f"base {tuple(base.shape)}, H {H}, W {W}")
    for label, t, shape in (("base", base, (Bn, L, C)), ("pre", pre, (Bn, L, C)),
                            ("p2", p2, (Bn, L, C)), ("gamma", gamma, (4 * C,)),
                            ("beta", beta, (4 * C,)), ("wt", wt, (O, 4 * C))):
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != shape
                or t.device != base.device or not t.is_contiguous()):
            raise ValueError(f"{name} kernel: {label} must be contiguous "
                             f"bf16 {shape} on {base.device}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for label, t in (("mid1T", mid1T), ("b1", b1), ("mid2T", mid2T),
                     ("b2", b2)):
        if t.dtype != torch.bfloat16 or t.device != base.device:
            raise ValueError(f"{name} kernel: {label} must be bf16 on "
                             f"{base.device}")
    midc, bs = rank_operands(mid1T, b1, mid2T, b2, c1, c2, s1, s2, Bn, L)
    coef = torch.stack([_sample_coef(c1, T, Bn, torch.float32, base.device),
                        _sample_coef(c2, T, Bn, torch.float32, base.device)],
                       dim=-1).contiguous()
    return (midc.transpose(1, 2).contiguous(),
            bs.transpose(1, 2).contiguous(), coef, T, Bn, L, C, O)


# the task mode of csrc/merge_ln_fwd.cu (kernel 6): its widest merged row
# (kMaxKTask), whose y a lane holds in fp32, and the rows a block it takes
# of kernel 3's plans
TM_FWD_MAX_K = 2048
TM_FWD_ROWS = (128, 64, 32)


def task_merge_fwd_plan(T: int, Mm: int, K: int, O: int, Wh: int,
                        per_sample: int, sms: int) -> MergeFwdPlan:
    """Kernel 6's plan for T tasks of Mm merged rows of K = 4C columns (the
    shared rows gathered 2x2, Wh merged rows a row of the merged grid,
    ``per_sample`` merged rows a sample) -> O on a card of ``sms`` SMs:
    kernel 3's layout at K (:func:`merge_fwd_plan`: rows a block, the TMA
    ring and the shared-memory bytes, Bs_t staged in the tile), its items
    a row block of one task, the T tasks of a row block adjacent, so that
    each W slot serves a block's rows of one task. The last row block of
    each task masks the rows past Mm."""
    if (T < 1 or K % 64 or not 64 <= K <= TM_FWD_MAX_K or O % 16 or O < 16
            or Wh < 1 or per_sample < 1 or per_sample % Wh or Mm < 1
            or Mm % per_sample):
        raise ValueError(f"task merge forward kernel: needs T >= 1 ({T}), "
                         f"C % 16 == 0 and K = 4C <= {TM_FWD_MAX_K} ({K}), "
                         f"O % 16 == 0 ({O}) and whole samples of "
                         f"{per_sample} merged rows in rows of Wh = {Wh} "
                         f"({Mm} rows)")
    layout = merge_fwd_plan(Mm, K, O, Wh, sms)
    assert layout.bm in TM_FWD_ROWS
    return merge_fwd_items(layout, T * -(-Mm // layout.bm), K, O, sms)


def task_merge_fwd_kernel(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1,
                          s2, gamma, beta, wt, H: int, W: int):
    """The CUDA route of :func:`task_merge_fwd` at the launch of
    :func:`task_merge_fwd_plan`, W read in its module layout; raises for
    anything it does not take (a CPU tensor included)."""
    mid_tok, bs_cs, coef, T, Bn, L, C, O = _kernel_operands(
        "task merge forward", base, pre, p2, mid1T, b1, mid2T, b2, c1, c2,
        s1, s2, gamma, beta, wt, H, W)
    plan = task_merge_fwd_plan(T, Bn * L // 4, 4 * C, O, W // 2,
                               (H // 2) * (W // 2), _sms(base.device))
    y = torch.empty((T, Bn, L // 4, O), dtype=base.dtype, device=base.device)
    err = _build.library().mtlora_task_merge_fwd(
        *(t.data_ptr() for t in (base, pre, p2, mid_tok, bs_cs, coef, gamma,
                                 beta, wt, y)),
        T, Bn, H, W, C, O, plan.bm, plan.splits, plan.blocks, plan.stages,
        plan.group, plan.smem, _stream(base))
    _build.check(err, "mtlora_task_merge_fwd")
    task_merge_fwd.launches += 1
    return y


def task_merge_fwd(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1, s2,
                   gamma, beta, wt, H: int, W: int):
    """Kernel 6 forward, no autograd: plain for CPU tensors,
    :func:`task_merge_fwd_kernel` for CUDA tensors."""
    args = (base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1, s2, gamma,
            beta, wt, H, W)
    if base.device.type == "cpu":
        return task_merge_plain(*args)
    return task_merge_fwd_kernel(*args)


# the constants of csrc/task_merge_bwd.cu that its plan sizes shared
# memory by (the kernel traps if the plan's bytes do not hold its layout)
TM_BWD_ROWS = 32        # merged rows a block (kBM)
TM_BWD_CHUNK = 64       # hidden chunk and slot width (kS)
TM_BWD_WARPS = 8        # warps of a row block (kWarps)
TM_BWD_CHUNK_SLOTS = 6  # slots a chunk of the ring, at most (kChunkMax)
TM_BWD_MAX_CHUNKS = 4   # chunks in the ring, at most
TM_BWD_SPLITS = (1, 2, 4, 8)   # blocks of a cluster that split K (kSplitMax)
# the slices of 64 columns of K a block -> the tasks a group of the
# kernel's instances: dln of TG tasks and the three task sums, (TG + 3) x
# 8 x slices fp32 a thread, at most 168 registers
TM_BWD_INSTANCES = {2: (1, 2, 3, 4), 3: (1, 2), 4: (1,)}
TM_BWD_MAX_K = max(TM_BWD_SPLITS) * max(TM_BWD_INSTANCES) * TM_BWD_CHUNK


class TaskMergeBwdPlan(NamedTuple):
    """Launch plan of kernel 6b: rows per block, the blocks of a cluster
    that split the merged rows' K columns, the columns a block takes, the
    runs of C it holds (1 where it holds part of one) and the blocks that
    share a run, the tasks a group and the groups, the TMA ring's slots a
    chunk and slots, dynamic shared-memory bytes of the row kernel (one
    block an SM), its row blocks and blocks (row blocks x split), the
    bytes of W's slots they stream from L2, the row stripes of the weight
    product dW [O, K], and the scratch the wrapper allocates: name ->
    (shape, dtype)."""

    bm: int
    split: int
    ks: int
    runs: int
    share: int
    tg: int
    groups: int
    per: int
    stages: int
    smem: int
    blocks: int
    ctas: int
    slice_bytes: int
    sw: int
    scratch: dict


def task_merge_bwd_smem(ks: int, runs: int, cw: int, tg: int, stages: int,
                        per: int) -> int:
    """Shared-memory bytes of the row kernel's layout: up to 1023 bytes to
    the ring's 1024-byte alignment; the ring's slots; the shared rows and
    dU of the group's tasks (bf16) and their y (fp32) [bm][ks + 8]; the
    rank rows and Bs slices of two groups, gamma and beta (bf16); the
    coefficients of the rows' samples of two groups, mu, inv, the means,
    the row sums, the dgamma/dbeta sums, dmidc's and dBs's partials
    (fp32); the exchanged pairs; the ring's mbarrier and count a chunk."""
    bm, ld = TM_BWD_ROWS, ks + 8
    wm = bm // ROW_TILE
    wn = TM_BWD_WARPS // wm
    return (1024 + stages * 2 * TM_BWD_CHUNK ** 2 + 2 * (3 + tg) * bm * ld
            + 4 * tg * bm * ld + 2 * 2 * tg * bm * runs * RANKS
            + 2 * 2 * tg * cw * RANKS + 2 * 2 * ks
            + 4 * (2 * tg * (bm + 1) * 2
                   + tg * bm * (2 + 2 + 2 * wn + RANKS) + wm * 2 * ks
                   + tg * cw * RANKS)
            + 8 * 2 * tg * bm + 12 * (stages // per))


def task_merge_bwd_plan(T: int, Mm: int, K: int, O: int, Wh: int,
                        per_sample: int, sms: int) -> TaskMergeBwdPlan:
    """Kernel 6b's plan for T tasks of Mm merged rows of K = 4C columns
    (the shared rows gathered 2x2, Wh merged rows a row of the merged
    grid, ``per_sample`` merged rows a sample) -> O on a card of ``sms``
    SMs. A block of 8 warps owns 32 rows and walks the tasks in groups of
    TG, one block an SM; the blocks of a cluster of 1, 2, 4 or 8 split K
    into whole runs of C or equal parts of one, at most 256 columns a
    block. Per split the largest TG of the instances that fits shared
    memory with a ring of two chunks at least, the groups balanced (six
    tasks: two of three); of those the split whose blocks stream the
    fewest bytes of W from L2 (each W slot serves a group), the fewer
    blocks a cluster on a tie. The last row block masks the rows past Mm.
    The ring takes what shared memory leaves, in chunks of the group's gy
    boxes (two tasks a box) and the block's W slices, at most 4 chunks.
    Scratch: every task's bf16(ln) rows ``lnd`` [T * Mm, K] (bf16), the
    per-row-block dgamma/dbeta partials ``gb`` and dBs partials ``pbs``
    (each the sum over the blocks of its cluster) and the weight-gradient
    stripes ``part`` (fp32)."""
    C = K // 4
    if (T < 1 or K % 64 or not 64 <= K <= TM_BWD_MAX_K or O % 16 or O < 16
            or Wh < 1 or per_sample < 1 or per_sample % Wh or Mm < 1
            or Mm % per_sample):
        raise ValueError(f"task merge backward kernel: needs T >= 1 ({T}), "
                         f"C % 16 == 0 and K = 4C <= {TM_BWD_MAX_K} ({K}), "
                         f"O % 16 == 0 ({O}) and whole samples of "
                         f"{per_sample} merged rows in rows of Wh = {Wh} "
                         f"({Mm} rows)")
    bm = TM_BWD_ROWS
    limit = min(SMEM_LIMIT, SM_SMEM - 1024)
    blocks, nch = -(-Mm // bm), -(-O // TM_BWD_CHUNK)
    best = None
    for split in TM_BWD_SPLITS:
        ks = K // split
        ncs = -(-ks // TM_BWD_CHUNK)
        if ks % 16 or (ks % C and C % ks) or ncs > max(TM_BWD_INSTANCES):
            continue
        runs, share, cw = (ks // C, 1, C) if ks >= C else (1, C // ks, ks)
        for most in sorted(TM_BWD_INSTANCES[max(ncs, 2)], reverse=True):
            groups = -(-T // min(most, T))
            tg = -(-T // groups)
            per = -(-tg // 2) + ncs
            chunks = next((n for n in range(TM_BWD_MAX_CHUNKS, 1, -1)
                           if task_merge_bwd_smem(ks, runs, cw, tg, n * per,
                                                  per) <= limit), None)
            if chunks is None:
                continue
            w_bytes = (blocks * split * groups * nch * ncs * 2
                       * TM_BWD_CHUNK ** 2)
            if best is None or w_bytes < best[0]:
                best = (w_bytes, split, ks, runs, share, tg, groups, per,
                        chunks * per)
            break
    if best is None:
        raise ValueError(f"task merge backward kernel: no plan for K = {K}")
    w_bytes, split, ks, runs, share, tg, groups, per, stages = best
    sw = stripes_for(sms, T * Mm, O, K)
    bf16, f32 = torch.bfloat16, torch.float32
    scratch = {
        "lnd": ((T * Mm, K), bf16),
        "gb": ((blocks, 2, K), f32),
        "pbs": ((blocks, T, C, RANKS), f32),
        "part": ((sw * O * K,), f32),
    }
    cw = C if ks >= C else ks
    return TaskMergeBwdPlan(
        bm, split, ks, runs, share, tg, groups, per, stages,
        task_merge_bwd_smem(ks, runs, cw, tg, stages, per), blocks,
        blocks * split, w_bytes, sw, scratch)


def task_merge_bwd_scratch(plan: TaskMergeBwdPlan, device) -> dict:
    """The scratch tensors of ``plan``, as :func:`task_merge_bwd_kernel`
    allocates them."""
    return {name: torch.empty(shape, dtype=dt, device=device)
            for name, (shape, dt) in plan.scratch.items()}


def task_merge_bwd_kernel(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1,
                          s2, gamma, beta, wt, H: int, W: int, gy,
                          scratch=None):
    """The CUDA route of :func:`task_merge_bwd`: the row kernel (per row
    block every task in order: dbase, dpre, dp2, dmidc, the dBs and
    dgamma/dbeta partials, the rows lnd), then the weight product dW and
    the fixed-order sums, W read in its module layout; raises for anything
    it does not take (a CPU tensor included). ``scratch``: the tensors of
    :func:`task_merge_bwd_scratch` to use (the row kernel leaves its rows
    there), or None to allocate them."""
    args = (base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1, s2, gamma,
            beta, wt, H, W)
    mid_tok, bs_cs, coef, T, Bn, L, C, O = _kernel_operands(
        "task merge backward", *args)
    Mm, K = Bn * L // 4, 4 * C
    if (gy.dtype != torch.bfloat16 or tuple(gy.shape) != (T, Bn, L // 4, O)
            or not gy.is_contiguous()):
        raise ValueError("task merge backward kernel: gy must be contiguous "
                         f"bf16 {(T, Bn, L // 4, O)}")
    dev = base.device
    plan = task_merge_bwd_plan(T, Mm, K, O, W // 2, (H // 2) * (W // 2),
                               _sms(dev))
    sc = task_merge_bwd_scratch(plan, dev) if scratch is None else scratch
    if {k: (tuple(v.shape), v.dtype) for k, v in sc.items()} != plan.scratch:
        raise ValueError("task merge backward kernel: scratch does not match "
                         "the plan")
    f32 = dict(dtype=torch.float32, device=dev)
    dbase, dpre, dp2 = (torch.empty_like(base) for _ in range(3))
    dmid = torch.empty((T, Bn * L, RANKS), dtype=base.dtype, device=dev)
    dbs = torch.empty((T, C, RANKS), **f32)
    dgb = torch.empty((2, K), **f32)
    dwt = torch.empty((O, K), **f32)
    err = _build.library().mtlora_task_merge_bwd(
        *(t.data_ptr() for t in (base, pre, p2, mid_tok, bs_cs, coef, gamma,
                                 beta, wt, gy)),
        *(sc[k].data_ptr() for k in ("lnd", "gb", "pbs", "part")),
        *(t.data_ptr() for t in (dbase, dpre, dp2, dmid, dbs, dgb, dwt)),
        T, Bn, H, W, C, O, plan.split, plan.tg, plan.stages, plan.smem,
        plan.sw, _stream(base))
    _build.check(err, "mtlora_task_merge_bwd")
    task_merge_bwd.launches += 1
    r1 = mid1T.shape[1]
    rank = rank_grads(dmid.transpose(1, 2), dbs.transpose(1, 2), c1, c2, s1,
                      s2, r1, Bn, L)
    return (dbase, dpre, dp2, *rank, dgb[0], dgb[1], dwt)


def task_merge_bwd(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1, s2,
                   gamma, beta, wt, H: int, W: int, gy):
    """The gradients of :func:`task_merge_bwd_plain`: plain for CPU
    tensors, :func:`task_merge_bwd_kernel` for CUDA tensors."""
    args = (base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1, s2, gamma,
            beta, wt, H, W)
    if base.device.type == "cpu":
        return task_merge_bwd_plain(*args, gy)
    return task_merge_bwd_kernel(*args, gy)


task_merge_fwd.launches = 0
task_merge_bwd.launches = 0


class TaskMergeFn(torch.autograd.Function):
    """``custom_vjp`` of ``task_merge_ln_linear`` with ``train_w``:
    gradients for base, pre, p2, the rank rows and matrices, gamma, beta
    and the reduction weight; the coefficients are constants."""

    @staticmethod
    def forward(ctx, base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, gamma,
                beta, wt, s1, s2, H, W):
        ctx.save_for_backward(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2,
                              gamma, beta, wt)
        ctx.consts = (s1, s2, H, W)
        return task_merge_fwd(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2,
                              s1, s2, gamma, beta, wt, H, W)

    @staticmethod
    def backward(ctx, gy):
        base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, gamma, beta, wt = (
            ctx.saved_tensors)
        s1, s2, H, W = ctx.consts
        (dbase, dpre, dp2, dmid1, db1, dmid2, db2, dg, dbe,
         dwt) = task_merge_bwd(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2,
                               s1, s2, gamma, beta, wt, H, W, gy.contiguous())
        return (dbase, dpre, dp2, dmid1, db1, dmid2, db2, None, None, dg,
                dbe, dwt, None, None, None, None)


def fused_task_merge(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1, s2,
                     gamma, beta, wt, H: int, W: int):
    """Kernel 6 (see the module note): ``y [T, B, H/2*W/2, O]``."""
    return TaskMergeFn.apply(base, pre, p2, mid1T, b1, mid2T, b2, c1, c2,
                             gamma, beta, wt, tuple(map(float, s1)),
                             tuple(map(float, s2)), H, W)
