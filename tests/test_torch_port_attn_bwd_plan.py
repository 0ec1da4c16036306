"""Kernel 1b (the window attention backward on tensor cores) on the CPU:
its launch plan and its cast points.

The plan (``ops/window_attn.py:bwd_plan``) at the four Swin-T 448 stage
shapes of the batch-32 step, shifted and not, at kernel 1c's path-B shape
(224 px, stage 3: 32 windows, 24 heads, no mask) and at ragged window
counts: the window groups cover every window exactly once, the blocks fit
one wave of the H100's 132 SMs, the shared memory fits a block's 232,448
bytes (three blocks an SM at the main path's shapes), and the dbias
partials have one [N, N] tile per group and head; the constants of
``csrc/window_attn_bwd.cu`` that the plan sizes shared memory by; the
refusals of a head dim other than 32 and of a CPU tensor on the kernel
route (no fallback to the plain version).

The cast points: the kernel multiplies on bf16 tensor cores, so P and dS
are rounded to bf16 before dv, dq and dk (the TPU kernel's own single
bf16 pass), with fp32 sums. That function, emulated in plain torch on
inputs drawn as ``chip_smoke.py`` draws them (numpy seeds), stays within
the smoke's bound of ``window_attention_bwd_plain`` (``BWD_BF16_REL`` of
dqkv's largest element) at the four stage shapes, shifted and not, at
batch 1 and 2; dbias, the fp32 sum of the fp32 dS, is the same.
"""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from mtlora_tpu_torch.ops import _build, window_attn
from mtlora_tpu_torch.ops.attention import (
    attention_probs,
    shift_attention_mask,
)
from mtlora_tpu_torch.ops.window_attn import (
    bwd_plan,
    window_attention_bwd_plain,
)
from mtlora_tpu_torch.tools import ln_mlp_bwd_variants

torch.set_num_threads(2)
SMS = 132   # the H100's SMs
N = 49
# (windows per image, heads, width) of the four stages of Swin-T 448
STAGES = [(256, 3, 96), (64, 6, 192), (16, 12, 384), (4, 24, 768)]


def _groups(plan, n_windows):
    return [range(g * plan.group, min((g + 1) * plan.group, n_windows))
            for g in range(plan.n_groups)]


def _assert_plan(plan, n_windows, heads, mask_windows, dense):
    groups = _groups(plan, n_windows)
    assert all(len(g) > 0 for g in groups)
    assert [w for g in groups for w in g] == list(range(n_windows))
    assert plan.blocks == plan.n_groups * heads
    # one wave: every block resident at once
    assert plan.blocks <= SMS * plan.per_sm
    # the tiles of two windows, P and dS, the bias, the mask tiles
    assert plan.smem == (32_768 + 16_384 + N * 72 * 4
                         + plan.tiles * 16 * ((N * N + 6) // 4))
    assert plan.smem <= window_attn.SMEM_LIMIT == 232_448
    # an SM's 228 KB hold per_sm blocks, 1 KB reserved for each
    assert 1 <= plan.per_sm <= window_attn.BWD_BLOCKS_PER_SM
    assert plan.per_sm * (plan.smem + 1024) <= window_attn.SM_SMEM
    assert plan.part == (plan.n_groups, heads, N, N)
    if dense:
        assert plan.group % window_attn.DENSE_CELL == 0
        assert plan.tiles == (min(window_attn.DENSE_CELL, mask_windows)
                              if mask_windows else 0)
    else:
        assert plan.tiles == (1 if mask_windows else 0)


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("stage", range(4))
def test_plan_at_the_stage_shapes(stage, shift):
    nw, heads, _ = STAGES[stage]
    n_windows = 32 * nw
    mask_windows = nw if shift else 0
    plan = bwd_plan(n_windows, N, heads, mask_windows, False, SMS)
    _assert_plan(plan, n_windows, heads, mask_windows, False)
    # three blocks an SM on the main path, and a group per resident block
    # of each head: 393 blocks at stage 0, 384 at stages 1-3
    assert plan.per_sm == 3
    assert plan.group == {0: 63, 1: 32, 2: 16, 3: 8}[stage]
    assert plan.blocks == (393 if stage == 0 else 384)
    # the unshifted blocks stage no mask tile; the shifted ones one
    assert plan.smem == 63_264 + (9_616 if shift else 0)


def test_plan_of_kernel_1c_at_path_b():
    """Kernel 1c's main-path shape: stage 3 at 224 px, one window per
    image at batch 32, no mask: four one-cell groups a head."""
    plan = bwd_plan(32, N, 24, 0, True, SMS)
    _assert_plan(plan, 32, 24, 0, True)
    assert (plan.group, plan.n_groups, plan.blocks) == (8, 4, 96)


@pytest.mark.parametrize("stage", range(4))
def test_plan_of_kernel_1c_with_the_shift_masks(stage):
    """Kernel 1c at the 448 stages with their masks (the smoke checks it
    there): a cell's min(8, nW) tiles staged at once."""
    nw, heads, _ = STAGES[stage]
    plan = bwd_plan(32 * nw, N, heads, nw, True, SMS)
    _assert_plan(plan, 32 * nw, heads, nw, True)


@pytest.mark.parametrize("n_windows,heads,mask_windows", [
    (1000, 3, 8), (50, 24, 0), (7, 12, 7), (1, 3, 0)])
def test_plan_at_ragged_window_counts(n_windows, heads, mask_windows):
    """Window counts no group size divides: the last group is short and
    no window is left out or taken twice."""
    plan = bwd_plan(n_windows, N, heads, mask_windows, False, SMS)
    _assert_plan(plan, n_windows, heads, mask_windows, False)


def test_plan_refuses_windows_beyond_the_tile():
    with pytest.raises(ValueError, match="at most 64"):
        bwd_plan(8, 65, 3, 0, False, SMS)


def test_plan_constants_match_the_cuda_source():
    """The plan sizes shared memory by the source's constants: head dim,
    padded rows, bias row stride, blocks an SM, the dense cell, and the
    layout's own formula (the tile constants and the mask-chunk count in
    ``window_tiles.cuh``, which the source includes)."""
    src = ((_build.CSRC / "window_attn_bwd.cu").read_text()
           + (_build.CSRC / "window_tiles.cuh").read_text())
    assert '#include "window_tiles.cuh"' in src

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kHd") == window_attn.BWD_HEAD_DIM == 32
    assert const("kRows") == window_attn.MAX_N
    assert const("kBiasLd") == window_attn.BWD_BIAS_LD == 72
    assert const("kBlocksPerSm") == window_attn.BWD_BLOCKS_PER_SM
    assert const("kCell") == window_attn.DENSE_CELL
    assert "return (N * N + 6) / 4;" in src
    assert ("2 * (size_t)kBufBytes + kPsBytes + (size_t)N * kBiasLd * 4 +"
            in src)


def test_wrappers_refuse_other_head_dims_and_cpu_tensors():
    """No fallback: the kernel route refuses a head dim other than 32 and
    a tensor that is not on the card, before any launch."""
    qkv = torch.zeros(8, N, 3 * 64, dtype=torch.bfloat16)
    bias = torch.zeros(4, N, N)
    with pytest.raises(ValueError, match="head dim 16"):
        window_attn._launch_bwd(qkv, 4, bias, None, 0.25,
                                torch.zeros(8, N, 64, dtype=torch.bfloat16),
                                False)
    with pytest.raises(ValueError, match="no kernel for cpu"):
        window_attn._launch_bwd(qkv, 2, bias[:2], None, 0.25,
                                torch.zeros(8, N, 64, dtype=torch.bfloat16),
                                True)


PTXAS = """\
ptxas info    : Function properties for _ZN51_GLOBAL__N__a89b467a_18_window_attn_bwd_cu_d2e56c5422window_attn_bwd_kernelILb1EEEvPK13__nv_bfloat16PKfS5_S3_PS1_Pfiiiiiiff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 159 registers, used 1 barriers
ptxas info    : Function properties for _ZN51_GLOBAL__N__a89b467a_18_window_attn_bwd_cu_d2e56c5417sum_groups_kernelEPKfPfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""


def test_variant_probe_reports_the_kernels_registers():
    """``tools/ln_mlp_bwd_variants.py`` reads the attention backward's
    registers and spills from nvcc's ptxas report (its variants of the
    kernel compare blocks an SM and waves)."""
    got = ln_mlp_bwd_variants._ptxas(PTXAS)
    assert list(got.values()) == [{"spill_stores": 0, "registers": 159}]
    assert "window_attn_bwd_kernel" in next(iter(got))
    assert {"attn-bwd-2-per-sm", "attn-bwd-4-waves"} <= set(
        ln_mlp_bwd_variants.VARIANTS)


def _kernel_cast_points(qkv, num_heads, rel_bias, mask, scale, dout):
    """``window_attention_bwd_plain`` with the kernel's cast points: P and
    dS rounded to bf16 before dv, dq and dk; q as stored and the fp32
    scale after dk's product; fp32 sums."""
    Bw, n, C3 = qkv.shape
    hd = C3 // 3 // num_heads
    q, k, v, p = attention_probs(qkv, num_heads, rel_bias, mask, scale)
    do = dout.reshape(Bw, n, num_heads, hd).transpose(1, 2).float()
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.matmul(pb.transpose(-1, -2), do)
    dq = torch.matmul(dsb, k.float()) * scale
    dk = torch.matmul(dsb.transpose(-1, -2), q.float()) * scale
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4)
    return dqkv.reshape(Bw, n, C3).to(qkv.dtype), ds.sum(0)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("stage", range(4))
def test_kernel_cast_points_within_the_smoke_bound(stage, shift, batch):
    nw, heads, C = STAGES[stage]
    rng = np.random.default_rng(1000 * stage + 10 * shift + batch)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            torch.bfloat16)

    qkv = bf16(batch * nw, N, 3 * C)
    dout = bf16(batch * nw, N, C)
    bias = torch.from_numpy(0.1 * rng.standard_normal((heads, N, N),
                                                      np.float32))
    res = 7 * int(nw ** 0.5)
    mask = (torch.from_numpy(shift_attention_mask(res, res, 7, shift))
            if shift else None)
    scale = (C // heads) ** -0.5
    got_q, got_b = _kernel_cast_points(qkv, heads, bias, mask, scale, dout)
    want_q, want_b = window_attention_bwd_plain(qkv, heads, bias, mask,
                                                scale, dout)
    err = (got_q.float() - want_q.float()).abs().max().item()
    top = want_q.float().abs().max().item()
    assert err <= chip_smoke.BWD_BF16_REL * top, (err, top)
    assert torch.equal(got_b, want_b)
