"""Kernel 6 (the factored per-task merge's forward: the task mode of
``csrc/merge_ln_fwd.cu``) on the CPU: its launch plan, the index arithmetic
of its rows, the shapes its wrapper and C entry take, and its plain
version against the JAX package.

The plan (``ops/task_merge.py:task_merge_fwd_plan``) pinned at the three
merges of the batch-32 step (four tasks), and held to its rules at path B's
merges at 224 px (Wh = 28, 14 and 7, odd: blocks straddle samples), the
ragged rows of the batch-2 step, Swin-B's merges (K = 2048 at the last) and
the merge shapes of every YAML under ``configs/mtlora/``, at T = 1, 4 and
6: kernel 3's layout at K (rows a block, the TMA ring, shared memory
against the H100's 232,448 bytes a block), items a row block of one task
and one split of its chunks, blocks and the bytes of W's slots; the
constants of the CUDA source; the refusals of shapes outside the kernel and
of a CPU tensor on the kernel route, which are the C entry's; the profile
class of the kernel's symbol.

The kernel's arithmetic that a CPU can hold: its rows, formed by a mirror
of the LayerNorm pass's offsets (a row's first token from one division,
each lane's token offsets and columns kept) and of its Bs_t staging (the
columns swizzled within groups of 8), are ``task_streams`` gathered by
``merge_rows``; the item walk takes each (row block, task, split) once, the
tasks of a row block adjacent; Bs_t fits the tile's last two rows of a row
group, and the 16-byte reads of eight neighbouring lanes fall in distinct
bank groups.

``task_merge_plain`` against the JAX package: ``task_merge_reference`` at
Wh = 7 with six tasks, ``task_merge_down`` (the interpret-mode Pallas
kernel) at Wh = 8; fp32, 1e-4 of the largest element (the merged row's
LayerNorm sums and the rank term in another order).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlora_tpu.config import load_config
from mtlora_tpu.models.lora import FactoredTasks as JFactored
from mtlora_tpu.models.lora import TaskStream as JStream
from mtlora_tpu.ops.pallas_task_merge import (
    task_merge_down,
    task_merge_reference,
)
from mtlora_tpu_torch.ops import _build, ln_lora, task_merge
from mtlora_tpu_torch.ops.ln_lora import merge_rows
from mtlora_tpu_torch.ops.task_merge import (
    rank_operands,
    task_merge_plain,
    task_streams,
)

torch.set_num_threads(2)
SMS = 132   # the H100's SMs
REL = 1e-4
SRC = _build.CSRC / "merge_ln_fwd.cu"
YAMLS = sorted((Path(__file__).resolve().parents[1] / "configs" / "mtlora")
               .rglob("mtlora_*.yaml"))


def _merge(L, res, C):
    """(Mm, K, O, Wh, per_sample) of the merge of task streams [.., L,
    res^2, C]."""
    per = (res // 2) ** 2
    return L * per, 4 * C, 2 * C, res // 2, per


# the three merges of the flagship (Swin-T 448) at batch 32
FLAGSHIP = [_merge(32, 112 // 2 ** s, 96 * 2 ** s) for s in range(3)]
# (rows a block, warps a row group, items a row block, items, blocks an
# SM, ring slots, slots a group, shared-memory bytes, W's slot bytes,
# blocks): kernel 3's layout at L = 128 (the LN route's four streams)
PLANS = [(128, 2, 1, 3136, 1, 16, 4, 230_656, 462_422_016, 132),
         (128, 2, 1, 784, 1, 4, 2, 230_464, 462_422_016, 132),
         (64, 4, 1, 392, 1, 4, 2, 230_464, 924_844_032, 132)]
# the batch-2 step's merges (phase 8), 392 rows at the last
RAGGED = [_merge(2, 112 // 2 ** s, 96 * 2 ** s) for s in range(3)]
# path B at 224 px, batch 32 and 8: Wh = 28, 14 and 7
PATH_B = [_merge(L, 56 // 2 ** s, 96 * 2 ** s) for L in (32, 8)
          for s in range(3)]
# Swin-B (mtlora_base_448): C = 128, 256, 512
SWIN_B = [_merge(32, 112 // 2 ** s, 128 * 2 ** s) for s in range(3)]
SHAPES = FLAGSHIP + RAGGED + PATH_B + SWIN_B
TASKS = (1, 4, 6)


def _check_plan(plan, T, Mm, K, O, Wh):
    """What every plan holds to."""
    layout = ln_lora.merge_fwd_plan(Mm, K, O, Wh, SMS)
    # kernel 3's layout at K: rows a block, the ring, shared memory (one
    # block an SM; Bs_t lives in the tile)
    assert (plan.bm, plan.wn, plan.per_sm, plan.stages, plan.group,
            plan.smem) == (layout.bm, layout.wn, layout.per_sm,
                           layout.stages, layout.group, layout.smem)
    assert plan.bm in task_merge.TM_FWD_ROWS == (128, 64, 32)
    assert plan.smem <= ln_lora.SMEM_LIMIT == 232_448
    assert plan.smem + 1024 <= 228 * 1024
    # a lane's pieces of a row hold y in fp32: 3, 6, 8 of 32 lanes
    assert K // 8 <= 32 * {128: 3, 64: 6, 32: 8}[plan.bm]
    # Bs_t [C][8] in the tile's last two rows of a row group
    kp = -(-K // 64) * 64
    assert (K // 4) * 8 * 2 <= 2 * kp * 2
    # items: a row block of one task and one split of its chunks, the last
    # row block of each task masking its rows past Mm
    rows = -(-Mm // plan.bm)
    nch, ncs = -(-O // 64), kp // 64
    assert (rows - 1) * plan.bm < Mm <= rows * plan.bm
    assert nch % plan.splits == 0 and plan.items == T * rows * plan.splits
    assert plan.blocks == min(plan.items, SMS)
    # W's slots: each item streams its chunks' slices of K once, so each
    # slot serves a block's rows of one task
    assert plan.slice_bytes == T * rows * nch * ncs * 2 * 64 * 64


@pytest.mark.parametrize("shape,want", zip(FLAGSHIP, PLANS))
def test_plan_pinned_at_the_flagship_merges(shape, want):
    plan = task_merge.task_merge_fwd_plan(4, *shape, SMS)
    assert tuple(plan) == want
    _check_plan(plan, 4, *shape[:4])
    # W's L2 traffic: 1.85 GB a pass, from T Mm / 16 K O 2 (11.1 GB)
    Mm, K, O = shape[:3]
    first = 4 * Mm // 16 * K * O * 2
    assert plan.slice_bytes == 4 * Mm // plan.bm * K * O * 2
    assert plan.slice_bytes * plan.bm == first * 16
    assert sum(p[8] for p in PLANS) <= 1.85e9


@pytest.mark.parametrize("T", TASKS)
@pytest.mark.parametrize("Mm,K,O,Wh,per", SHAPES)
def test_plan_rows_items_ring_and_shared_memory(Mm, K, O, Wh, per, T):
    _check_plan(task_merge.task_merge_fwd_plan(T, Mm, K, O, Wh, per, SMS),
                T, Mm, K, O, Wh)


def test_plan_ragged_rows_and_odd_wh():
    """392 rows at the batch-2 step's last merge: six whole blocks of 64
    and one of 8 a task, split where the items are few; path B's 14 -> 7
    merge: 49 merged rows a sample, so that blocks straddle samples; Swin-B's
    K = 2048: 32 rows a block."""
    plan = task_merge.task_merge_fwd_plan(4, 392, 1536, 768, 14, 196, SMS)
    assert plan.bm == 64 and 392 % plan.bm == 8
    assert plan.items == 4 * 7 * plan.splits and plan.splits > 1
    Mm, K, O, Wh, per = _merge(32, 14, 384)
    plan = task_merge.task_merge_fwd_plan(4, Mm, K, O, Wh, per, SMS)
    assert (per, Wh) == (49, 7) and per % plan.bm
    assert any((b * plan.bm) // per != (b * plan.bm + plan.bm - 1) // per
               for b in range(-(-Mm // plan.bm)))
    plan = task_merge.task_merge_fwd_plan(4, *_merge(32, 28, 512), SMS)
    assert (plan.bm, plan.wn, plan.stages) == (32, 8, 12)


def _yaml_merges():
    """(yaml, merge, L, res, C) of every merge of every YAML at batch 32
    and 2: the task streams [.., res^2, C] of the stage before each
    merge."""
    merges = []
    for path in YAMLS:
        cfg = load_config(str(path))
        res0 = cfg.DATA.IMG_SIZE // cfg.MODEL.SWIN.PATCH_SIZE
        for s in range(len(cfg.MODEL.SWIN.DEPTHS) - 1):
            for L in (32, 2):
                merges.append((path.name, s, L, res0 // 2 ** s,
                               cfg.MODEL.SWIN.EMBED_DIM * 2 ** s))
    return merges


MERGES = _yaml_merges()


def test_the_yamls_give_the_widths_the_plan_is_held_to():
    assert {(res, C) for _, _, _, res, C in MERGES} == {
        (112 // 2 ** s, e * 2 ** s) for e in (96, 128) for s in range(3)}


@pytest.mark.parametrize("name,s,L,res,C", MERGES,
                         ids=[f"{n}-{s}-{L}" for n, s, L, _, _ in MERGES])
def test_plan_takes_every_yaml_merge(name, s, L, res, C):
    Mm, K, O, Wh, per = _merge(L, res, C)
    for T in TASKS:
        _check_plan(task_merge.task_merge_fwd_plan(T, Mm, K, O, Wh, per,
                                                   SMS), T, Mm, K, O, Wh)


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def test_plan_constants_match_the_cuda_source():
    src = SRC.read_text()
    assert _const(src, "kMaxKTask") == task_merge.TM_FWD_MAX_K == 2048
    assert task_merge.TM_FWD_MAX_K == task_merge.TM_BWD_MAX_K
    # the instances the C entry dispatches to: (m-tiles, warps a row
    # group, pieces of a row a lane) of each row count, in the task mode;
    # the pieces cover K / 8 at the widest row each instance takes
    assert "return bm == 128  ? (K <= 512 ? 2 : 3)" in src
    assert ": bm == 64 ? (K <= 1024 ? 4 : 6)" in src
    for bm, ut, kmax in ((128, 2, 512), (128, 3, 768), (64, 4, 1024),
                         (64, 6, 1536), (32, 8, 2048)):
        wn = ln_lora.MERGE_FWD_ROWS[bm]
        assert f"launch<2, {wn}, {ut}>(p, blocks, smem, st)" in src
        assert kmax // 8 <= 32 * ut
        if kmax < 2048:
            plan = task_merge.task_merge_fwd_plan(1, 1, kmax, 16, 1, 1, SMS)
            assert plan.bm == bm
    # its refusals
    entry = src[src.index('extern "C" int mtlora_task_merge_fwd'):]
    for text in ("T < 1 || B < 1 || H < 2 || H % 2 || W < 2 || W % 2 ||",
                 "C % 16 || K > kMaxKTask || O < 16 || O % 16 || !rows ||",
                 "K / 8 > 32 * ut_of(bm, K) || splits < 1 || nch % splits ||",
                 "stages % group || stages < 2 * group)"):
        assert text in entry
    # the item order: the T tasks of a row block one after another
    assert "tk = TASK ? rbt % a.T : 0;" in src
    assert "(TASK ? rbt / a.T : rbt) * BM + wr;" in src
    # its own symbol, the same body
    assert "task_merge_fwd_rows(const __grid_constant__ Params p)" in src
    # the first port is gone: its source, kernel, row source and the 16-row
    # product read from device memory
    assert not (_build.CSRC / "task_merge.cu").exists()
    cuh = (_build.CSRC / "task_merge.cuh").read_text()
    for gone in ("TmArgs", "TaskRows", "task_rows", "make_tm_args"):
        assert gone not in cuh
    assert "mma_tile" not in (_build.CSRC / "ln_common.cuh").read_text()
    assert not any("task_merge_fwd_kernel" in f.read_text()
                   for f in _build.CSRC.glob("*.cu"))


# (T, Mm, K, O, Wh, per): K past 2048, C % 16 != 0, O % 16 != 0, rows that
# are not whole samples, samples that are not whole rows of the merged
# grid, no task
REFUSED = [(4, 392, 4096, 2048, 14, 196), (4, 392, 4 * 24, 48, 14, 196),
           (4, 392, 1536, 776, 14, 196), (4, 390, 1536, 768, 14, 196),
           (4, 392, 1536, 768, 14, 98 + 3), (0, 392, 1536, 768, 14, 196)]


@pytest.mark.parametrize("T,Mm,K,O,Wh,per", REFUSED)
def test_plan_refuses_shapes_outside_the_kernel(T, Mm, K, O, Wh, per):
    msg = (f"task merge forward kernel: needs T >= 1 ({T}), C % 16 == 0 "
           f"and K = 4C <= 2048 ({K}), O % 16 == 0 ({O}) and whole samples "
           f"of {per} merged rows in rows of Wh = {Wh} ({Mm} rows)")
    with pytest.raises(ValueError) as err:
        task_merge.task_merge_fwd_plan(T, Mm, K, O, Wh, per, SMS)
    assert str(err.value) == msg


def _c_entry_takes(T, B, H, W, C, O, plan=None):
    """The C entry's conditions (mtlora_task_merge_fwd), in Python: on the
    shapes, and on the plan where one is given."""
    K, nch = 4 * C, -(-O // 64)
    shapes = (T >= 1 and B >= 1 and H >= 2 and H % 2 == 0 and W >= 2
              and W % 2 == 0 and C >= 16 and C % 16 == 0 and K <= 2048
              and O >= 16 and O % 16 == 0)
    if plan is None or not shapes:
        return shapes
    ur = {128: 3, 64: 6, 32: 8}.get(plan.bm)
    M = B * (H // 2) * (W // 2)
    return (ur is not None and K // 8 <= 32 * ur and plan.splits >= 1
            and nch % plan.splits == 0 and 1 <= plan.blocks
            and plan.blocks <= -(-M // plan.bm) * T * plan.splits
            and 1 <= plan.group <= 4 and plan.stages % plan.group == 0
            and plan.stages >= 2 * plan.group)


def _inputs(seed, H=14, T=3, B=3, C=16, coefs=True, r=4, dtype=np.float32):
    """The operands of ``task_merge_plain`` as numpy arrays (the JAX
    kernel's ``kernel`` [4C, O]) and the scales."""
    rng = np.random.RandomState(seed)
    L = H * H

    def f(*s):
        return (0.5 * rng.randn(*s)).astype(dtype)

    c1 = c2 = None
    if coefs:
        c1, c2 = ((rng.rand(T, B, 1) < 0.8).astype(dtype) / 0.8
                  for _ in range(2))
    return dict(base=f(B, L, C), pre=f(B, L, C), p2=f(B, L, C),
                mid1T=f(T, r, B * L), b1=f(T, r, C), mid2T=f(T, 8 - r, B * L),
                b2=f(T, 8 - r, C), c1=c1, c2=c2,
                s1=tuple(rng.uniform(0.5, 2.0, T)),
                s2=tuple(rng.uniform(0.5, 2.0, T)),
                gamma=f(4 * C) + 1.0, beta=f(4 * C), kernel=f(4 * C, 2 * C))


def _port_args(d, H, W=None, dtype=torch.float32):
    def t(k):
        return None if d[k] is None else torch.from_numpy(d[k]).to(dtype)

    return ([t(k) for k in ("base", "pre", "p2", "mid1T", "b1", "mid2T",
                            "b2", "c1", "c2")]
            + [d["s1"], d["s2"], t("gamma"), t("beta"),
               torch.from_numpy(np.ascontiguousarray(d["kernel"].T))
               .to(dtype), H, H if W is None else W])


# (T, B, H, W, C, O): the flagship's first merge at batch 1, path B's odd
# Wh, the widest row taken, one task at the narrowest
TAKEN = [(4, 1, 112, 112, 96, 192), (4, 2, 14, 14, 384, 768),
         (6, 1, 4, 4, 512, 1024), (1, 1, 2, 2, 16, 16)]


@pytest.mark.parametrize("T,B,H,W,C,O", TAKEN)
def test_wrapper_takes_what_the_c_entry_takes(T, B, H, W, C, O):
    """Shapes within the C entry's bounds have a plan that the C entry
    takes, and stop only at the device (a CPU tensor has no kernel)."""
    per = (H // 2) * (W // 2)
    plan = task_merge.task_merge_fwd_plan(T, B * per, 4 * C, O, W // 2,
                                          per, SMS)
    assert _c_entry_takes(T, B, H, W, C, O, plan)
    d = _inputs(0, H=H, T=T, B=B, C=C, coefs=False)
    d["kernel"] = np.zeros((4 * C, O), np.float32)
    args = _port_args(d, H, W, torch.bfloat16)
    with pytest.raises(ValueError,
                       match="task merge forward: no kernel for cpu"):
        task_merge.task_merge_fwd_kernel(*args)


# (T, B, H, W, C, O): K past 2048, C % 16 != 0, O % 16 != 0, no task
NOT_TAKEN = [(4, 1, 4, 4, 1024, 2048), (4, 1, 4, 4, 24, 48),
             (4, 1, 4, 4, 96, 200), (0, 1, 4, 4, 96, 192)]


@pytest.mark.parametrize("T,B,H,W,C,O", NOT_TAKEN)
def test_wrapper_refuses_what_the_c_entry_refuses(T, B, H, W, C, O):
    """Outside the C entry's bounds the plan refuses, naming the bound,
    before any launch. (Odd H or W: ``_kernel_operands`` refuses them by
    name, as the C entry does.)"""
    assert not _c_entry_takes(T, B, H, W, C, O)
    per = (H // 2) * (W // 2)
    with pytest.raises(ValueError, match="task merge forward kernel: needs"):
        task_merge.task_merge_fwd_plan(T, B * per, 4 * C, O, W // 2, per,
                                       SMS)
    src = Path(task_merge.__file__).read_text()
    assert "needs r1 + r2 == {RANKS}, even H " in src


def test_kernel_route_refuses_a_cpu_tensor():
    """The plain version runs only through ``task_merge_fwd``'s CPU branch;
    the kernel route itself raises."""
    d = _inputs(0)
    args = _port_args(d, 14, dtype=torch.bfloat16)
    with pytest.raises(ValueError,
                       match="task merge forward: no kernel for cpu"):
        task_merge.task_merge_fwd_kernel(*args)
    y = task_merge.task_merge_fwd(*args)
    assert y.shape == (3, 3, 49, 32) and y.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The kernel's index arithmetic, in Python
# ---------------------------------------------------------------------------

def _lane_offsets(C, Wh, lanes=32):
    """dt[u], cb[u] of the source: each LayerNorm-pass lane's pieces lane +
    32 u of a row, as tokens from the row's first token and columns of
    C."""
    K = 4 * C
    P = K // 8
    out = {}
    for lane in range(lanes):
        for u in range(-(-P // 32)):
            pc = lane + 32 * u
            if pc >= P:
                continue
            q, c = divmod(8 * pc, C)
            out[pc] = ((q & 1) * 2 * Wh + (q >> 1), c)
    return out


def _staged(bs_t):
    """Bs_t [C, 8] as the staging copies it: column c's 8 values at 16-byte
    position c ^ (c / 8 % 8)."""
    C = bs_t.shape[0]
    out = torch.zeros_like(bs_t)
    for c in range(C):
        out[c ^ (c >> 3 & 7)] = bs_t[c]
    return out


def _mirror_rows(base, pre, p2, midc_tok, bs_cs, coef, H, W, t):
    """Task t's merged rows y [Mm, 4C] as the LayerNorm pass forms them:
    per row its first token 2 (m / Wh Wh + m) and its sample's
    coefficients (one division each), per lane piece the token and column
    offsets kept; the shared rows at the piece's offset, its token's rank
    row and Bs_t read at the staged positions (columns cb + (j ^ cb / 8 %
    8)), summed ((base + c1 pre) + c2 p2) + rank term."""
    B, L, C = base.shape
    Wh, per = W // 2, (H // 2) * (W // 2)
    Mm = B * per
    offs = _lane_offsets(C, Wh)
    pcs = sorted(offs)
    dt = torch.tensor([offs[pc][0] for pc in pcs])
    cb = torch.tensor([offs[pc][1] for pc in pcs])
    m = torch.arange(Mm)
    tok = (2 * (m // Wh * Wh + m))[:, None] + dt[None]      # [Mm, P]
    cols = (tok * C + cb)[..., None] + torch.arange(8)      # [Mm, P, 8]
    b, p, q = (x.reshape(-1)[cols] for x in (base, pre, p2))
    sw = cb >> 3 & 7
    at = cb[:, None] + (torch.arange(8)[None] ^ sw[:, None])   # [P, 8]
    bs = _staged(bs_cs[t])[at]                               # [P, 8, 8]
    u = torch.einsum("mps,pjs->mpj", midc_tok[t][tok], bs)
    c = coef[t, m // per]
    c1, c2 = c[:, 0, None, None], c[:, 1, None, None]
    y = ((b + c1 * p) + c2 * q) + u
    return y.reshape(Mm, 4 * C)


@pytest.mark.parametrize("H,W,B,C", [(14, 14, 2, 16), (8, 8, 1, 32),
                                     (4, 12, 2, 48)])
def test_rows_offsets_form_the_reference_streams(H, W, B, C):
    """At Wh = 7 (odd) and 4, 6; C = 16, 32 and 48 (runs of C that a lane's
    pieces cross): every task's rows, as the LayerNorm pass forms them from
    its offsets, the staged Bs_t and each run's token for the rank rows,
    are ``task_streams`` gathered by ``merge_rows`` (fp64 here: only the
    order of the rank term's sum differs)."""
    T = 2
    d = _inputs(7, H=H, T=T, B=B, C=C)
    rng = np.random.RandomState(1)
    L = H * W
    d.update(base=rng.randn(B, L, C), pre=rng.randn(B, L, C),
             p2=rng.randn(B, L, C), mid1T=rng.randn(T, 4, B * L),
             mid2T=rng.randn(T, 4, B * L))
    args = _port_args(d, H, W, torch.float64)
    base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, s1, s2 = args[:11]
    midc, bs = rank_operands(mid1T, b1, mid2T, b2, c1, c2, s1, s2, B, L)
    want = merge_rows(task_streams(base, pre, p2, midc, bs, c1, c2)
                      .reshape(T * B, L, C), H, W).view(T, -1, 4 * C)
    coef = torch.stack([c1.reshape(T, B), c2.reshape(T, B)], dim=-1)
    for t in range(T):
        got = _mirror_rows(base, pre, p2, midc.transpose(1, 2),
                           bs.transpose(1, 2), coef, H, W, t)
        torch.testing.assert_close(got, want[t], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("C", [16, 96, 384, 512])
def test_staged_bs_reads_meet_no_bank_twice(C):
    """The staging's swizzle permutes the columns within each group of 8
    (Bs_t stays in its 16 C bytes, the tile's last two rows of a row
    group), and the 16-byte reads of eight neighbouring lanes at one column
    of their pieces fall in eight distinct 16-byte bank groups, but for
    lanes on either side of a run's end."""
    pos = [c ^ (c >> 3 & 7) for c in range(C)]
    assert sorted(pos) == list(range(C))
    assert all(p // 8 == c // 8 for c, p in enumerate(pos))
    assert 16 * C <= 2 * 2 * (4 * C)
    P = 4 * C // 8
    for j in range(8):
        for first in range(0, P - 7, 8):
            cbs = [8 * pc % C for pc in range(first, first + 8)]
            if len({8 * pc // C for pc in range(first, first + 8)}) > 1:
                continue
            banks = {(cb + (j ^ (cb >> 3 & 7))) % 8 for cb in cbs}
            assert len(banks) == 8
    src = SRC.read_text()
    assert "cp_async16(bsg + tmk::S * (c ^ (c >> 3 & 7))" in src
    assert "tmk::S * (cb[u] + ((2 * e + i) ^ sw))" in src
    assert "bf16* bsg = xt + (RW - 2) * kp;" in src


def _items(T, rows, splits):
    """(row block, task, split) of each item of the walk, as the source
    decodes it: rbt = item / splits, task rbt % T, row block rbt / T."""
    out = []
    for item in range(T * rows * splits):
        rbt = item // splits
        out.append((rbt // T, rbt % T, item % splits))
    return out


@pytest.mark.parametrize("T,rows,splits", [(4, 7, 2), (6, 25, 1), (1, 3, 3),
                                           (4, 784, 1)])
def test_items_take_each_row_block_task_and_split_once(T, rows, splits):
    """Every (row block, task, split) once; a row block's T tasks (and
    their splits) are consecutive items, so that the blocks that read the
    row block's shared rows run together."""
    got = _items(T, rows, splits)
    assert sorted(got) == [(r, t, s) for r in range(rows) for t in range(T)
                           for s in range(splits)]
    for i in range(0, len(got), T * splits):
        assert {g[0] for g in got[i:i + T * splits]} == {i // (T * splits)}


def test_profile_class_names_the_kernel():
    from mtlora_tpu_torch.train.profile import classify

    pre = "void (anonymous namespace)::"
    for inst in ("<2, 2, 2>", "<2, 2, 3>", "<2, 4, 4>", "<2, 4, 6>",
                 "<2, 8, 8>"):
        assert classify(f"{pre}task_merge_fwd_rows{inst}(Params)") == (
            "task-merge kernel 6 (fwd)")
    for inst in ("<2, 2>", "<2, 4>", "<2, 8>", "<1, 8>"):
        assert classify(f"{pre}patch_merge_fwd_rows{inst}(Params)") == (
            "patch merge kernel 3 (fwd)")
    assert classify(f"{pre}task_merge_bwd_rows<2, 4>(Params)") == (
        "task-merge kernel 6b (bwd rows)")


# ---------------------------------------------------------------------------
# The plain version against the JAX package
# ---------------------------------------------------------------------------

def _jax_forward(d, H, fn):
    c = None if d["c1"] is None else jnp.asarray(d["c1"])
    c2 = None if d["c2"] is None else jnp.asarray(d["c2"])
    s = JStream(base=jnp.asarray(d["base"]), pre=jnp.asarray(d["pre"]),
                midT=jnp.asarray(d["mid1T"]), B=jnp.asarray(d["b1"]),
                scales=d["s1"], coef=c)
    f2 = JFactored(pretrained=jnp.asarray(d["p2"]),
                   midT=jnp.asarray(d["mid2T"]), B=jnp.asarray(d["b2"]),
                   scales=d["s2"])
    args = (s, f2, c2, jnp.asarray(d["gamma"]), jnp.asarray(d["beta"]),
            jnp.asarray(d["kernel"]), H, H)
    if fn is task_merge_down:
        return np.asarray(fn(*args, interpret=True))
    return np.asarray(fn(*args))


@pytest.mark.parametrize("oracle,H,T,B", [("reference", 14, 6, 3),
                                          ("kernel", 16, 4, 2)])
def test_plain_matches_the_jax_forward(oracle, H, T, B):
    """``task_merge_plain`` against ``task_merge_reference`` at H = W = 14
    (Wh = 7, odd: 147 merged rows in samples of 49) with six tasks, and
    against the interpret-mode Pallas kernel (``task_merge_down``) at Wh =
    8; drop-path coefficients on. fp32, 1e-4 of the largest element."""
    d = _inputs(5, H=H, T=T, B=B)
    fn = task_merge_down if oracle == "kernel" else task_merge_reference
    want = _jax_forward(d, H, fn)
    got = task_merge_plain(*_port_args(d, H)).numpy()
    assert got.shape == want.shape == (T, B, (H // 2) ** 2, 32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())
