"""Kernel 3 (the patch merge's forward, ``csrc/merge_ln_fwd.cu``) on the
CPU: its launch plan, the index arithmetic of its row loader and ring, and
the shapes its wrapper and C entry take.

The plan (``ops/ln_lora.py:merge_fwd_plan``) at the three merges of the
batch-32 step for the shared stream (L = 32) and the task streams the LN
route merges (L = 128), at the ragged rows of the batch-2 step, at path
B's merges at 224 px (Wh = 28, 14 and 7, odd), at the merge shapes of
every YAML under ``configs/mtlora/`` and at Swin-B's K = 2048 and twice
that: rows per block, the warps of a row group, the items of a row block
that split its chunks, blocks an SM, the TMA ring's slots and groups,
shared memory against the H100's 232,448 bytes a block, the persistent
blocks and the bytes of W's slots they stream; the constants of the CUDA
source (its setmaxnreg split of the block's registers among them); the
refusals of shapes outside the kernel and of a CPU tensor on the kernel
route; the profile class of the kernel's symbol.

The kernel's arithmetic that a CPU can hold: its row loader's offsets (a
merged row's base, kept and stepped row by row, plus each lane's column
offsets) gather x in the order of ``merge_rows`` (the plain version's
2x2 gather), at even and odd Wh; the producer warp's decoding of its
slots walks the (chunk, slice) pairs in the order the consumer warps take
them; the tile's swizzle permutes whole 16-byte chunks within a row.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mtlora_tpu.config import load_config
from mtlora_tpu_torch.ops import _build, ln_lora
from mtlora_tpu_torch.ops.ln_lora import merge_rows

SMS = 132   # the H100's SMs
SRC = _build.CSRC / "merge_ln_fwd.cu"
YAMLS = sorted((Path(__file__).resolve().parents[1] / "configs" / "mtlora")
               .rglob("mtlora_*.yaml"))


def _merge(L, res, C):
    """(M, K, O, Wh) of the merge of x [L, res^2, C]."""
    return L * (res // 2) ** 2, 4 * C, 2 * C, res // 2


# the three merges of the flagship (Swin-T 448) at L = 32 (the shared
# stream) and 128 (the four task streams of the LN route)
FLAGSHIP = [_merge(L, 112 // 2 ** s, 96 * 2 ** s)
            for L in (32, 128) for s in range(3)]
# (rows a block, warps a row group, items a row block, blocks an SM, ring
# slots, slots a group, shared-memory bytes, blocks, W's slot bytes)
PLANS = [(128, 2, 1, 1, 16, 4, 230_656, 132, 115_605_504),
         (128, 2, 2, 1, 4, 2, 230_464, 132, 115_605_504),
         (64, 4, 1, 1, 4, 2, 230_464, 98, 231_211_008),
         (128, 2, 1, 1, 16, 4, 230_656, 132, 462_422_016),
         (128, 2, 1, 1, 4, 2, 230_464, 132, 462_422_016),
         (64, 4, 1, 1, 4, 2, 230_464, 132, 924_844_032)]
# the batch-2 step's merges (phase 8), 392 rows at the last
RAGGED = [_merge(2, 112 // 2 ** s, 96 * 2 ** s) for s in range(3)]
# path B at 224 px, batch 32 and 8: Wh = 28, 14 and 7
PATH_B = [_merge(L, 56 // 2 ** s, 96 * 2 ** s) for L in (32, 8)
          for s in range(3)]
SHAPES = FLAGSHIP + RAGGED + PATH_B


def _check_plan(plan, M, K, O):
    """What every plan holds to."""
    kp = -(-K // 64) * 64
    slot = 2 * 64 * 64
    # 32 rows a row group (16 at 16 rows a block) and 8 warps
    assert ln_lora.MERGE_FWD_ROWS[plan.bm] == plan.wn
    rw = 32 if plan.bm >= 32 else 16
    assert plan.bm // rw * plan.wn == 8
    # the ring: groups of 4 slots (2 where fewer than 8 fit), two groups
    # and MERGE_FWD_MIN_STAGES at least, 16 at most
    assert plan.group == (4 if plan.stages >= 8 else 2)
    assert max(2 * plan.group, ln_lora.MERGE_FWD_MIN_STAGES) <= plan.stages
    assert plan.stages <= ln_lora.MERGE_FWD_MAX_STAGES == 16
    assert plan.stages % plan.group == 0
    # the tile [bm][kp] and the ring's slots and two mbarriers a slot, from
    # a 1024-byte boundary, in a block's shared memory
    assert plan.smem == 1024 + 2 * plan.bm * kp + plan.stages * (slot + 16)
    assert plan.smem <= ln_lora.SMEM_LIMIT == 232_448
    assert plan.per_sm == 1
    assert plan.per_sm * (plan.smem + 1024) <= 228 * 1024
    # the most rows whose tile leaves the ring its least slots
    wider = [b for b in ln_lora.MERGE_FWD_ROWS if b > plan.bm]
    for b in wider:
        assert (1024 + 2 * b * kp + ln_lora.MERGE_FWD_MIN_STAGES
                * (slot + 16) > ln_lora.SMEM_LIMIT)
    # a loader lane copies at most two 16-byte pieces of a row (kMaxU)
    assert K // 8 <= 2 * 32 * plan.wn
    # items: row blocks x splits, the splits dividing the chunks; the last
    # row block masks its rows past M
    rows = -(-M // plan.bm)
    nch = -(-O // 64)
    assert (rows - 1) * plan.bm < M <= rows * plan.bm
    assert nch % plan.splits == 0 and plan.items == rows * plan.splits
    assert plan.blocks == min(plan.items, SMS)
    # W's slots: each item streams its chunks' slices of K once
    assert plan.slice_bytes == rows * nch * (kp // 64) * slot


@pytest.mark.parametrize("shape,want", zip(FLAGSHIP, PLANS))
def test_plan_pinned_at_the_flagship_merges(shape, want):
    plan = ln_lora.merge_fwd_plan(*shape, SMS)
    assert (plan.bm, plan.wn, plan.splits, plan.per_sm, plan.stages,
            plan.group, plan.smem, plan.blocks, plan.slice_bytes) == want
    _check_plan(plan, *shape[:3])
    # W's L2 traffic: M / bm K O 2 bytes, against the first port's 16 rows
    M, K, O, _ = shape
    assert plan.slice_bytes == M // plan.bm * K * O * 2


@pytest.mark.parametrize("M,K,O,Wh", SHAPES)
def test_plan_rows_splits_ring_and_shared_memory(M, K, O, Wh):
    _check_plan(ln_lora.merge_fwd_plan(M, K, O, Wh, SMS), M, K, O)


def test_plan_ragged_rows_take_one_more_block():
    """392 rows at the batch-2 step's last merge: six whole blocks of 64
    and one of 8; the splits give every SM work it can take."""
    plan = ln_lora.merge_fwd_plan(392, 1536, 768, 14, SMS)
    assert plan.bm == 64 and -(-392 // plan.bm) == 7 and 392 % plan.bm == 8
    assert plan.items == 7 * plan.splits and plan.blocks == plan.items


def _yaml_merges():
    """(yaml, merge, L, res, C) of every merge of every YAML at batch 32
    and 2: x [L, res^2, C] of the stage before each merge."""
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
    M, K, O, Wh = _merge(L, res, C)
    plan = ln_lora.merge_fwd_plan(M, K, O, Wh, SMS)
    _check_plan(plan, M, K, O)
    # Swin-B's last merge, [6272, 2048] -> 1024: 32 rows, 12 ring slots
    if K == 2048:
        assert (plan.bm, plan.wn, plan.stages) == (32, 8, 12)


@pytest.mark.parametrize("K,want", [(2048, (32, 8, 12)), (4096, (16, 8, 12))])
def test_plan_takes_swin_b_widest_merge_and_twice_it(K, want):
    """Swin-B's K = 2048 and K = 4096 (C = 1024, the widest 3b takes):
    32 and 16 rows a block, one row group of 8 warps."""
    plan = ln_lora.merge_fwd_plan(6272, K, K // 2, 14, SMS)
    _check_plan(plan, 6272, K, K // 2)
    assert (plan.bm, plan.wn, plan.stages) == want


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def test_plan_constants_match_the_cuda_source():
    src = SRC.read_text()
    assert _const(src, "kS") == ln_lora.MERGE_FWD_CHUNK
    assert _const(src, "kWarps") == ln_lora.MERGE_FWD_WARPS
    assert _const(src, "kGroupMax") == ln_lora.MERGE_FWD_GROUP
    assert _const(src, "kMaxU") == 2
    # the instances the C entry point dispatches to: (m-tiles, warps a row
    # group) of each row count
    for bm, wn in ln_lora.MERGE_FWD_ROWS.items():
        mt = 2 if bm >= 32 else 1
        assert f"launch<{mt}, {wn}>(p, blocks, smem, st)" in src
        assert f"bm == {bm}" in src
    # its refusals
    assert ("if (M < 1 || C < 8 || C % 8 || K > kMaxK || O < 16 || O % 16 ||"
            in src)
    assert "nch % splits || K / 8 > kMaxU * 32 * wn" in src
    assert "stages % group ||\n      stages < 2 * group)" in src
    # the producer warpgroup hands its registers to the two consumer
    # warpgroups (setmaxnreg: multiples of 8 in [24, 256], the block's
    # 65,536 at most, each side's launch share of 384 threads at least)
    cons, prod = _const(src, "kConsumerRegs"), _const(src, "kProducerRegs")
    assert cons % 8 == prod % 8 == 0 and 24 <= prod < cons <= 256
    assert 256 * cons + 128 * prod <= 65536
    assert prod <= 65536 // 384 <= cons
    assert "constexpr int kThreads = 32 * (kWarps + 4);" in src
    # one block an SM, as the plan's per_sm; the plan's layout: the ring,
    # the tile, then two mbarriers a slot
    assert "__launch_bounds__(kThreads, 1)" in src
    assert "reinterpret_cast<uint64_t*>(tile + BM * kp)" in src
    assert "reinterpret_cast<unsigned char*>(empty + stages)" in src


def test_merge_forward_bounds_match_the_cuda_source():
    """The widest row (kMaxK = 4096) has a plan; one 32-column step
    further is refused; the first port's source and entry are gone."""
    src = SRC.read_text()
    kmax = _const(src, "kMaxK")
    assert kmax == ln_lora.MERGE_FWD_MAX_K == ln_lora.MERGE_MAX_K
    ln_lora.merge_fwd_plan(16, kmax, 16, 1, SMS)
    with pytest.raises(ValueError, match="K = 4C <= 4096"):
        ln_lora.merge_fwd_plan(16, kmax + 32, 16, 1, SMS)
    assert not (_build.CSRC / "ln_lora.cu").exists()
    assert "mtlora_ln_lora_fwd" not in _build.SIGNATURES
    assert "mtlora_merge_ln_fwd" in _build.SIGNATURES
    # one body, two kernels: kernel 3 and its task mode (kernel 6)
    assert src.count("__global__") == 2
    assert "fwd_rows<MT, WN, 0>(p);" in src
    assert "fwd_rows<MT, WN, UT>(p);" in src


# (M, K, O, Wh): C % 8 != 0, K past 4096, O % 16 != 0, O below 16, rows
# that are not whole rows of the merged grid, no row
REFUSED = [(392, 4 * 12, 32, 14), (392, 8192, 4096, 14),
           (392, 1536, 776, 14), (392, 1536, 0, 14), (390, 1536, 768, 14),
           (0, 384, 192, 28)]


@pytest.mark.parametrize("M,K,O,Wh", REFUSED)
def test_merge_wrapper_refuses_what_the_c_entry_refuses(M, K, O, Wh):
    msg = (f"patch merge forward kernel: needs C % 8 == 0 and K = 4C <= "
           f"4096 ({K}), O % 16 == 0 ({O}) and whole rows of Wh = {Wh} "
           f"merged tokens ({M} rows)")
    with pytest.raises(ValueError) as err:
        ln_lora.merge_fwd_plan(M, K, O, Wh, SMS)
    assert str(err.value) == msg


def _merge_operands(L, H, W, C, O):
    x = torch.zeros(L, H * W, C, dtype=torch.bfloat16)
    return x, torch.zeros(4 * C), torch.zeros(4 * C), torch.zeros(O, 4 * C)


# (L, H, W, C, O): the widest and narrowest taken, and an odd Wh
TAKEN = [(1, 2, 2, 1024, 16), (1, 2, 2, 8, 16), (2, 14, 14, 384, 768)]


@pytest.mark.parametrize("L,H,W,C,O", TAKEN)
def test_merge_wrapper_takes_what_the_c_entry_takes(L, H, W, C, O):
    """Shapes within the C entry's bounds have a plan and stop only at the
    device (a CPU tensor has no kernel)."""
    x, g, b, w = _merge_operands(L, H, W, C, O)
    M = L * (H // 2) * (W // 2)
    _check_plan(ln_lora.merge_fwd_plan(M, 4 * C, O, W // 2, SMS), M, 4 * C,
                O)
    with pytest.raises(ValueError, match="patch merge: no kernel for cpu"):
        ln_lora.merge_ln_fwd_kernel(x, g, b, w, H, W)


@pytest.mark.parametrize("H,W", [(13, 14), (14, 13)])
def test_kernel_route_refuses_odd_h_or_w(H, W):
    x, g, b, w = _merge_operands(3, H, W, 8, 16)
    with pytest.raises(ValueError, match=f"even H \\({H}\\), W \\({W}\\)"):
        ln_lora.merge_ln_fwd_kernel(x, g, b, w, H, W)


def test_kernel_route_refuses_a_cpu_tensor():
    """The plain version runs only through ``merge_ln_fwd``'s CPU branch;
    the kernel route itself raises."""
    x, g, b, w = _merge_operands(3, 14, 14, 8, 16)
    with pytest.raises(ValueError, match="patch merge: no kernel for cpu"):
        ln_lora.merge_ln_fwd_kernel(x, g, b, w, 14, 14)
    y = ln_lora.merge_ln_fwd(x, g, b, w, 14, 14)
    assert y.shape == (3, 49, 16)


# ---------------------------------------------------------------------------
# The kernel's index arithmetic, in Python
# ---------------------------------------------------------------------------

def _loader_rows(x, Wh, row0, rows, lanes):
    """The merged rows row0.. as the loader copies them: a row's base kept
    and stepped (one division per item), each lane's pieces at offsets
    computed once; x flattened."""
    C = x.shape[-1]
    K, flat = 4 * C, x.reshape(-1)
    P = K // 8
    d = {}
    for tau in range(lanes):
        for u in range(2):
            pc = tau + lanes * u
            k = 8 * min(pc, P - 1)
            q, c = divmod(k, C)
            d[pc] = ((q & 1) * 2 * Wh + (q >> 1)) * C + c
    out = np.zeros((rows, K), x.dtype)
    rr, j = divmod(row0, Wh)
    for i in range(rows):
        base = (4 * rr * Wh + 2 * j) * C
        for pc in range(P):
            out[i, 8 * pc:8 * pc + 8] = flat[base + d[pc]:base + d[pc] + 8]
        j += 1
        if j == Wh:
            j, rr = 0, rr + 1
    return out


@pytest.mark.parametrize("L,res,C,lanes", [(2, 14, 8, 64), (3, 14, 24, 128),
                                           (2, 28, 16, 64), (1, 8, 32, 256)])
def test_loader_offsets_gather_the_reference_order(L, res, C, lanes):
    """At Wh = 7 (odd), 14 and 4, C = 8, 16, 24 (runs of C that a 64-column
    slice crosses) and 32: every row block's rows, as the loader copies
    them, are ``merge_rows``'s."""
    x = np.arange(L * res * res * C, dtype=np.float64).reshape(
        L, res * res, C)
    want = merge_rows(torch.from_numpy(x), res, res).numpy()
    Wh, M = res // 2, want.shape[0]
    assert 4 * C // 8 <= 2 * lanes
    for row0 in range(0, M, 32):
        rows = min(32, M - row0)
        np.testing.assert_array_equal(
            _loader_rows(x, Wh, row0, rows, lanes), want[row0:row0 + rows])


def _slot_box(q, c0, nci, ncs, wn):
    """``slot_box<WN>`` of the source: the producer's q-th slot of an item
    as (slice, chunk)."""
    pp = q // (wn * ncs)
    live = min(wn, nci - pp * wn)
    r = q - pp * wn * ncs
    cs, i = divmod(r, live)
    return cs, c0 + pp * wn + i


@pytest.mark.parametrize("nci,ncs,wn", [(3, 6, 2), (3, 12, 2), (6, 12, 2),
                                        (3, 24, 4), (12, 24, 4), (8, 32, 8),
                                        (1, 2, 8), (5, 3, 4)])
def test_producer_walks_the_slots_in_the_consumers_order(nci, ncs, wn):
    """The consumer warps take, per pass of up to wn chunks, per slice, one
    slot a chunk; the producer's decoding gives the same (slice, chunk)
    sequence, each pair of the item once."""
    c0 = 5
    want = [(cs, c0 + c1 + i) for c1 in range(0, nci, wn)
            for cs in range(ncs) for i in range(min(wn, nci - c1))]
    got = [_slot_box(q, c0, nci, ncs, wn) for q in range(nci * ncs)]
    assert got == want
    assert sorted(got) == sorted((cs, c0 + c) for cs in range(ncs)
                                 for c in range(nci))
    # the source decodes the same way
    src = SRC.read_text()
    assert ("const int pp = q / (WN * ncs), live = min(WN, nci - pp * WN);"
            in src)
    assert "const int r = q - pp * WN * ncs, cs = r / live, i = r - cs * live;" in src


@pytest.mark.parametrize("K", [96, 384, 1536])
def test_tile_swizzle_permutes_chunks_within_a_row(K):
    """``tsw``: row r's 16-byte chunks XOR-swizzled by r % 8 stay in the
    row (K rounded up to 64), and the 8 rows an ldmatrix phase reads at
    one column fall in 8 distinct 16-byte bank groups."""
    kp = -(-K // 64) * 64

    def tsw(r, k):
        return r * kp + (((k >> 3) ^ (r & 7)) << 3) + (k & 7)

    for r in range(16):
        offs = [tsw(r, k) for k in range(K)]
        assert len(set(offs)) == K
        assert all(r * kp <= o < (r + 1) * kp for o in offs)
    for k in range(0, K, 8):
        banks = {(tsw(r, k) * 2 // 16) % 8 for r in range(8)}
        assert len(banks) == 8
    assert "((((k >> 3) ^ (r & 7))) << 3) + (k & 7)" in SRC.read_text()


def test_profile_class_names_the_kernel():
    from mtlora_tpu_torch.train.profile import classify

    pre = "void (anonymous namespace)::"
    for inst in ("<2, 2>", "<2, 4>", "<2, 8>", "<1, 8>"):
        assert classify(f"{pre}patch_merge_fwd_rows{inst}(Params)") == (
            "patch merge kernel 3 (fwd)")
    # 3b's row kernel keeps its own class
    assert classify(f"{pre}patch_merge_bwd_rows<64, 3>(Params)") == (
        "patch merge kernel 3b (bwd rows)")
