"""Kernel 2 at the qkv sites (the y-only LN + LoRA forward, the qkv mode
of ``csrc/ln_lora_tail_fwd.cu``) on the CPU: its launch plan.

The plan (``ops/ln_lora.py:qkv_fwd_plan``) at the four qkv sites of the
batch-32 step (M = 32 * 112^2 / 4^s, C = 96 * 2^s, O = 3C, r = 64): rows
per block, the warps on the same rows, the items of a row block that
split its chunks, blocks an SM, the TMA ring's slots and groups,
shared-memory bytes (against the H100's 232,448 bytes a block, and two
blocks in an SM's 228 KB where the plan takes two), the persistent blocks
and the bytes of weight slots they stream; the ragged 392 rows of the
batch-2 step; every (C, r) of the YAMLs under ``configs/mtlora/`` (O =
3C) and every rank a multiple of 16 up to 64; the constants of the CUDA
source; the refusals of r = 0, C above 1024 and a CPU tensor. The plain
version: the tail mode's without GELU is kernel 2's y-only function, bit
for bit, so that one kernel body serves both.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mtlora_tpu.config import load_config
from mtlora_tpu_torch.ops import _build, ln_lora
from mtlora_tpu_torch.ops.ln_lora import ln_lora_plain, ln_lora_tail_plain

SMS = 132   # the H100's SMs
R = 64
# (M, C): rows and width of the four qkv sites at batch 32
SHAPES = [(401408, 96), (100352, 192), (25088, 384), (6272, 768)]
# (rows a block, warps on 16 rows, items a row block, blocks an SM, ring
# slots, slots a group, shared-memory bytes, blocks, weight-slot bytes)
PLANS = [(128, 1, 1, 2, 8, 4, 112_024, 264, 436_731_904),
         (128, 1, 1, 2, 4, 2, 104_216, 264, 250_478_592),
         (128, 1, 2, 1, 12, 4, 219_684, 132, 221_577_216),
         (64, 2, 1, 1, 8, 4, 205_848, 98, 385_351_680)]
YAMLS = sorted((Path(__file__).resolve().parents[1] / "configs" / "mtlora")
               .rglob("mtlora_*.yaml"))
SRC = _build.CSRC / "ln_lora_tail_fwd.cu"


@pytest.mark.parametrize("shape,want", zip(SHAPES, PLANS))
def test_plan_pinned_at_the_qkv_sites(shape, want):
    M, C = shape
    plan = ln_lora.qkv_fwd_plan(M, C, 3 * C, R, SMS)
    assert (plan.bm, plan.wn, plan.splits, plan.per_sm, plan.stages,
            plan.group, plan.smem, plan.blocks, plan.slice_bytes) == want
    assert plan.smem <= ln_lora.SMEM_LIMIT == 232_448
    if plan.per_sm == 2:
        assert plan.wn == 1 and 2 * (plan.smem + 1024) <= 228 * 1024
    # 8 warps, each 16 rows and one 64-column chunk at a time
    assert plan.bm * plan.wn == 16 * 8
    # an item: a row block and one split of its super-chunks; the blocks
    # take the items in turn
    rows = -(-M // plan.bm)
    assert plan.items == rows * plan.splits
    assert plan.blocks == min(plan.items, plan.per_sm * SMS)
    nsc = -(-(-(-3 * C // 64)) // plan.wn)
    assert nsc % plan.splits == 0
    # every weight slot once per item: A (m), then W's slices and B of
    # each of its chunks; a slot is 64 x 64 bf16
    ncs = -(-C // 64)
    assert plan.slice_bytes == plan.items * (
        ncs + nsc // plan.splits * plan.wn * (ncs + 1)) * 2 * 64 * 64


@pytest.mark.parametrize("M,C", SHAPES)
def test_plan_differs_from_the_tail_mode_only_by_its_staging(M, C):
    """The qkv mode stages y alone: one staging tile a warp (two where two
    warps share 16 rows, for m's shares), so that one block an SM has the
    shared memory of the tail mode's second tile for its ring."""
    qkv = ln_lora.qkv_fwd_plan(M, C, 3 * C, R, SMS)
    tail = ln_lora.tail_fwd_plan(M, C, 3 * C, R, SMS)
    assert qkv._replace(stages=tail.stages, smem=tail.smem) == tail
    tile = 8 * 16 * ln_lora.TAIL_FWD_TILE * 2   # a staging tile a warp
    if qkv.per_sm == 1 and qkv.wn == 1:
        assert qkv.stages > tail.stages
        assert tail.smem - qkv.smem == (tile - 8192 * (qkv.stages
                                                       - tail.stages)
                                        - 12 * (qkv.stages - tail.stages)
                                        // qkv.group)
    else:
        assert qkv == tail


def test_plan_ragged_rows_take_one_more_block():
    """392 rows at stage 3 (the batch-2 step): six whole blocks of 64 and
    one of 8, each split into items; 392 rows at stage 0's width: three
    whole blocks of 128 and one of 8."""
    plan = ln_lora.qkv_fwd_plan(392, 768, 2304, R, SMS)
    assert plan.bm == 64 and 392 % plan.bm == 8
    assert plan.items == 7 * plan.splits
    plan = ln_lora.qkv_fwd_plan(392, 96, 288, R, SMS)
    assert plan.bm == 128 and plan.items == 4 * plan.splits


def _yaml_sites():
    """(yaml, stage, C, r) of every stage of every YAML: the width and the
    shared rank of its qkv sites (O = 3C)."""
    sites = []
    for path in YAMLS:
        cfg = load_config(str(path))
        m = cfg.MODEL.MTLORA
        ranks = list(m.R_PER_TASK["shared"] if "shared" in m.R_PER_TASK
                     else m.R)
        for s in range(len(cfg.MODEL.SWIN.DEPTHS)):
            r = ranks[s] if len(ranks) > 1 else ranks[0]
            sites.append((path.name, s, cfg.MODEL.SWIN.EMBED_DIM * 2 ** s,
                          int(r)))
    return sites


def test_plan_takes_every_yaml_qkv_shape_at_every_rank():
    """Every YAML's qkv width (C = 96 or 128 times 2^s, O = 3C) has a plan
    within a block's shared memory at r 16, 32, 48 and 64, at the batch-32
    rows of a 448 image, at ragged rows and at one row."""
    widths = {C for _, _, C, _ in _yaml_sites()}
    assert widths == {96, 192, 384, 768, 128, 256, 512, 1024}
    for C in sorted(widths):
        for r in (16, 32, 48, 64):
            for M in (25088, 392, 1):
                plan = ln_lora.qkv_fwd_plan(M, C, 3 * C, r, SMS)
                assert plan.smem <= ln_lora.SMEM_LIMIT, (C, r, M)
                assert plan.stages >= 2 * plan.group
                assert plan.group in (2, 4)
                assert plan.stages <= ln_lora.TAIL_FWD_MAX_STAGES
                assert plan.wn == (1 if C <= 384 else 2)
                assert plan.per_sm == (2 if C <= 192 else 1)
                assert plan.items == -(-M // plan.bm) * plan.splits


def test_plan_constants_match_the_cuda_source():
    src = SRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kS") == ln_lora.TAIL_FWD_CHUNK
    assert const("kWarps") == ln_lora.TAIL_FWD_WARPS
    assert const("kGroupMax") >= ln_lora.TAIL_FWD_GROUP
    assert const("kWide") == ln_lora.TAIL_FWD_WIDE
    assert const("kRank") == 64
    # one staging tile a warp in the qkv mode, two where WN = 2
    assert "constexpr int NBUF = TAIL ? 3 - PER_SM : WN;" in src
    # the qkv mode has its own symbol and C entry, which passes no p, no d
    # and no act to the checks and launch that both modes share
    assert "ln_lora_qkv_fwd_kernel(const __grid_constant__ Params p)" in src
    assert "fwd_body<WN, PER_SM, false>(p);" in src
    assert 'extern "C" int mtlora_ln_lora_qkv_fwd(' in src
    assert ("return run(x, gamma, beta, wt, bias, at, bt, seed, y, nullptr, "
            "nullptr, M,") in src
    assert ("M < 1 || C < 16 || C % 16 || C > 1024 || O < 8 || O % 8 || "
            "r < 16 ||") in src
    assert f"C > {ln_lora.TAIL_FWD_MAX_C}" in src


# (C, O, r): the rank kernel 2's old route took without an adapter (0),
# C past the widest YAML's 1024, C not a multiple of 16, O % 8
REFUSED = [(96, 288, 0), (1040, 3120, 64), (1056, 3168, 16), (24, 72, 64),
           (96, 284, 64), (96, 288, 8)]


@pytest.mark.parametrize("C,O,r", REFUSED)
def test_plan_refuses_r_0_and_c_above_1024(C, O, r):
    msg = (f"LN+LoRA qkv forward kernel: needs C % 16 == 0 and 16 <= C <= "
           f"1024 ({C}), O % 8 == 0 ({O}) and r a multiple of 16 up to 64 "
           f"({r})")
    with pytest.raises(ValueError) as err:
        ln_lora.qkv_fwd_plan(64, C, O, r, SMS)
    assert str(err.value) == msg


def test_kernel_route_refuses_a_cpu_tensor():
    """The plain version runs only through ``ln_lora_fwd``'s CPU branch;
    the kernel route itself raises, and counts nothing."""
    M, C, O, r = 8, 96, 288, 64
    x = torch.zeros(M, C, dtype=torch.bfloat16)
    ws = [torch.zeros(s, dtype=torch.bfloat16)
          for s in ((C,), (C,), (O, C), (O,), (r, C), (O, r))]
    seed = torch.zeros(2, dtype=torch.int32)
    before = ln_lora.ln_lora_fwd.launches
    with pytest.raises(ValueError, match="LN\\+LoRA: no kernel for cpu"):
        ln_lora.ln_lora_fwd_kernel(x, *ws, seed, 4.0, 0.05)
    y = ln_lora.ln_lora_fwd(x, *ws, seed, 4.0, 0.05)
    assert y.shape == (M, O) and ln_lora.ln_lora_fwd.launches == before


def _operands(dtype, M=40, C=32, O=96, r=16, seed=3):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)

    return (t(M, C), 1.0 + t(C, scale=0.1), t(C, scale=0.05),
            t(O, C, scale=C ** -0.5), t(O, scale=0.02),
            t(r, C, scale=C ** -0.5), t(O, r, scale=r ** -0.5),
            torch.tensor([123, 456], dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_tail_mode_without_act_is_the_qkv_forward(dtype, drop):
    """``ln_lora_tail_plain(..., act=False)[0]`` is ``ln_lora_plain``, bit
    for bit: kernel 2's qkv mode is the tail mode's body without GELU, p
    and d."""
    args = _operands(dtype)
    got = ln_lora_tail_plain(*args, 4.0, drop, act=False)[0]
    want = ln_lora_plain(*args, 4.0, drop)
    assert got.dtype == want.dtype == dtype and torch.equal(got, want)
