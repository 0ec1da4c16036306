"""Kernel 2's tail mode (the stage-tail LN + LoRA forward) on the CPU: its
launch plan.

The plan (``ops/ln_lora.py:tail_fwd_plan``) at the four fc1 sites of the
batch-32 step (M = 32 * 112^2 / 4^s, C = 96 * 2^s, O = 4C, r = 64) and at
the ragged 392 rows of stage 3 (the batch-2 step): rows per block, the
warps on the same rows, the items of a row block that split its chunks,
blocks an SM, the TMA ring's slots and groups, shared memory against the
H100's 232,448 bytes a block (and two blocks in an SM's 228 KB where the
plan takes two), the persistent blocks and the items with the ragged row
block counted, and the weight bytes they stream; at every (C, r) of the
YAMLs under ``configs/mtlora/`` (O =
4C), a plan that fits for every rank that is a multiple of 16 and the
refusal of the others (r = 4, 8, which kernel 2 refused before too); the
constants of ``csrc/ln_lora_tail_fwd.cu`` that the plan sizes shared
memory by; the refusals of shapes outside the kernel and of a CPU tensor
on the kernel route.
"""

import re
from pathlib import Path

import pytest
import torch

from mtlora_tpu.config import load_config
from mtlora_tpu_torch.ops import _build, ln_lora

SMS = 132   # the H100's SMs
R = 64
# (M, C): rows and width of the four fc1 sites at batch 32, and stage 3 at
# batch 2
SHAPES = [(401408, 96), (100352, 192), (25088, 384), (6272, 768),
          (392, 768)]
# (rows a block, warps on 16 rows, items a row block, blocks an SM, ring
# slots, slots a group, shared-memory bytes, blocks) at SHAPES
PLANS = [(128, 1, 1, 2, 8, 4, 112_024, 264),
         (128, 1, 1, 2, 4, 2, 104_216, 264),
         (128, 1, 2, 1, 8, 4, 205_336, 132),
         (64, 2, 4, 1, 8, 4, 205_848, 132),
         (64, 2, 12, 1, 8, 4, 205_848, 84)]
YAMLS = sorted((Path(__file__).resolve().parents[1] / "configs" / "mtlora")
               .rglob("mtlora_*.yaml"))


@pytest.mark.parametrize("shape,want", zip(SHAPES, PLANS))
def test_plan_rows_ring_and_shared_memory(shape, want):
    M, C = shape
    plan = ln_lora.tail_fwd_plan(M, C, 4 * C, R, SMS)
    assert (plan.bm, plan.wn, plan.splits, plan.per_sm, plan.stages,
            plan.group, plan.smem, plan.blocks) == want
    assert plan.smem <= ln_lora.SMEM_LIMIT == 232_448
    # two blocks an SM only with one warp on 16 rows, each within half of
    # the SM's 228 KB (1 KB reserved a block)
    if plan.per_sm == 2:
        assert plan.wn == 1 and 2 * (plan.smem + 1024) <= 228 * 1024
    # 8 warps, each 16 rows and one 64-column chunk at a time
    assert plan.bm * plan.wn == 16 * 8
    # the last row block masks its rows past M; the split divides the
    # super-chunks (wn chunks of 64 columns) evenly; the persistent blocks
    # take the items in turn
    rows = -(-M // plan.bm)
    assert (rows - 1) * plan.bm < M <= rows * plan.bm
    assert plan.items == rows * plan.splits
    assert plan.blocks == min(plan.items, plan.per_sm * SMS)
    nsc = -(-(4 * C // 64) // plan.wn)
    assert nsc % plan.splits == 0
    # every weight slot once per item: A (m), then W's slices and B of each
    # of its chunks; a slot is 64 x 64 bf16
    ncs = -(-C // 64)
    assert plan.slice_bytes == plan.items * (
        ncs + nsc // plan.splits * plan.wn * (ncs + 1)) * 2 * 64 * 64


def test_plan_fills_the_card_where_the_row_blocks_are_few():
    """Stages 2 and 3 have 196 and 98 row blocks for 132 SMs: the split
    brings each to three rounds of items less a few, not one and a half."""
    for M, C in SHAPES[2:4]:
        plan = ln_lora.tail_fwd_plan(M, C, 4 * C, R, SMS)
        assert plan.splits > 1 and plan.items / SMS > 2.9
    # enough row blocks take no split
    assert ln_lora.tail_fwd_plan(401408, 96, 384, R, SMS).splits == 1


def _yaml_sites():
    """(yaml, stage, C, r) of every stage of every YAML: the width and the
    shared rank of its fc1 sites (O = 4C)."""
    sites = []
    for path in YAMLS:
        cfg = load_config(str(path))
        m = cfg.MODEL.MTLORA
        # one rank, or one a stage (as normalize_mtlora broadcasts them)
        ranks = list(m.R_PER_TASK["shared"] if "shared" in m.R_PER_TASK
                     else m.R)
        for s in range(len(cfg.MODEL.SWIN.DEPTHS)):
            r = ranks[s] if len(ranks) > 1 else ranks[0]
            sites.append((path.name, s, cfg.MODEL.SWIN.EMBED_DIM * 2 ** s,
                          int(r)))
    return sites


SITES = _yaml_sites()


def test_plan_takes_every_yaml_shape_with_r_a_multiple_of_16():
    """Tiny, small and base at every rank a multiple of 16 that the YAMLs
    give, C up to 1024, at the batch-32 rows of a 448 image and at ragged
    rows; ranks 4 and 8 are refused, as kernel 2 refused them before."""
    taken = set()
    for name, s, C, r in SITES:
        if r % 16:
            with pytest.raises(ValueError, match="r a multiple of 16"):
                ln_lora.tail_fwd_plan(6272, C, 4 * C, r, SMS)
            continue
        for M in (32 * (112 // 2 ** s) ** 2, 392, 1):
            plan = ln_lora.tail_fwd_plan(M, C, 4 * C, r, SMS)
            assert plan.smem <= ln_lora.SMEM_LIMIT, (name, s)
            assert plan.stages >= 2 * plan.group and plan.group in (2, 4)
            assert plan.stages <= ln_lora.TAIL_FWD_MAX_STAGES
            assert plan.wn == (1 if C <= 384 else 2)
            assert plan.per_sm == (2 if C <= 192 else 1)
        taken.add((C, r))
    assert taken == {(C, r) for C in (96, 192, 384, 768)
                     for r in (16, 32, 64)} | {(C, 64) for C in
                                               (128, 256, 512, 1024)}


@pytest.mark.parametrize("C,O", [(16, 8), (48, 200), (80, 320), (1024, 4096),
                                 (96, 4104), (1008, 4032)])
def test_plan_takes_the_shapes_kernel_2_took(C, O):
    """What ``_kernel2_shapes`` lets through (C % 16 == 0, O % 8 == 0, r a
    multiple of 16 up to 64) up to C = 1024: half slices, a last chunk of
    8 columns, an odd number of chunks where two warps share rows."""
    for r in (16, 48, 64):
        plan = ln_lora.tail_fwd_plan(100, C, O, r, SMS)
        assert plan.smem <= ln_lora.SMEM_LIMIT
        assert plan.items == -(-100 // plan.bm) * plan.splits


def test_plan_constants_match_the_cuda_source():
    src = (_build.CSRC / "ln_lora_tail_fwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kS") == ln_lora.TAIL_FWD_CHUNK
    assert const("kWarps") == ln_lora.TAIL_FWD_WARPS
    assert const("kGroupMax") >= ln_lora.TAIL_FWD_GROUP
    assert const("kWide") == ln_lora.TAIL_FWD_WIDE
    assert const("kRank") == 64
    pad = int(re.search(r"constexpr int kLdS = kS \+ (\d+);", src)[1])
    assert ln_lora.TAIL_FWD_CHUNK + pad == ln_lora.TAIL_FWD_TILE
    # the C entry point refuses what the plan refuses, and takes the plan's
    # rows and split
    assert ("M < 1 || C < 16 || C % 16 || C > 1024 || O < 8 || O % 8 || "
            "r < 16 ||") in src
    assert f"{ln_lora.TAIL_FWD_MAX_C}" in src
    assert "bm != kRows * kWarps / wn" in src and "nsc % splits" in src
    assert "!(per_sm == 1 || (per_sm == 2 && wn == 1))" in src
    assert "blocks < 1 || blocks > items" in src
    assert "group > kGroupMax || stages % group || stages < 2 * group" in src
    # the three instances: (WN, blocks an SM), 3 - blocks an SM staging
    # tiles a warp in the tail mode (the qkv mode shares the body)
    assert set(re.findall(r"launch<(\d), (\d)>\(pr,", src)) == {
        ("2", "1"), ("1", "1"), ("1", "2")}
    assert "__launch_bounds__(kThreads, PER_SM)" in src
    assert "constexpr int NBUF = TAIL ? 3 - PER_SM : WN;" in src


# (C, O, r): C not a multiple of 16, or past Swin-B's 1024; O % 8; a rank
# of 8 (the r8 YAMLs), 0 or past one slot
REFUSED = [(24, 96, 64), (1040, 4160, 64), (96, 380, 64), (96, 384, 8),
           (96, 384, 0), (96, 384, 80)]


@pytest.mark.parametrize("C,O,r", REFUSED)
def test_plan_refuses_shapes_outside_the_kernel(C, O, r):
    msg = (f"LN+LoRA tail forward kernel: needs C % 16 == 0 and 16 <= C <= "
           f"1024 ({C}), O % 8 == 0 ({O}) and r a multiple of 16 up to 64 "
           f"({r})")
    with pytest.raises(ValueError) as err:
        ln_lora.tail_fwd_plan(64, C, O, r, SMS)
    assert str(err.value) == msg


def test_kernel_route_refuses_a_cpu_tensor():
    """The plain version runs only through ``ln_lora_tail_fwd``'s CPU
    branch; the kernel route itself raises."""
    M, C, O, r = 8, 96, 384, 64
    x = torch.zeros(M, C, dtype=torch.bfloat16)
    ws = [torch.zeros(s, dtype=torch.bfloat16)
          for s in ((C,), (C,), (O, C), (O,), (r, C), (O, r))]
    seed = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="LN\\+LoRA: no kernel for cpu"):
        ln_lora.ln_lora_tail_fwd_kernel(x, *ws, seed, 4.0, 0.05, True, True)
    # the dispatcher takes the plain version for the same tensors
    y, p, d = ln_lora.ln_lora_tail_fwd(x, *ws, seed, 4.0, 0.05, True, True)
    assert y.shape == p.shape == d.shape == (M, O)
