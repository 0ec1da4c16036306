"""Kernels 1 and 1c (the window attention forward on tensor cores) on the
CPU: their launch plan, refusals and cast points.

The plan (``ops/window_attn.py:fwd_plan``) at the four Swin-T 448 stage
shapes, shifted and not, at batch 1, 2 and 32, at kernel 1c's path-B
cells (224 px, stage 3: one window an image, 24 heads, no mask), at
ragged window counts and at Swin-B's heads (128 wide, 4 to 32 heads, head
dim 32): the window groups cover every window exactly once, the blocks
fit one wave of the H100's 132 SMs, the shared memory holds the layout of
``csrc/window_attn_fwd.cu`` within a block's 232,448 bytes; the plan's
constants held to that source's text; the refusals of a head dim other
than 32, of N above 64 and of a CPU tensor on the kernel route (no
fallback to the plain version), each naming its bound.

The cast points: the kernel rounds q*scale_c to bf16, sums S = q k^T in
fp32 on the tensor cores, adds bias and mask in fp32 with -inf on the
padded keys (N padded to 64), takes an fp32 softmax by exp2 of the
log2(e)-prescaled scores, rounds P = e / sum to bf16 and sums P v in fp32.
That function, emulated in plain torch on inputs drawn from numpy seeds,
stays within ``chip_smoke.KERNEL_ATOL`` of ``window_attention`` at every
stage shape, and at N = 49, head dim 32 of the JAX package's
``fused_window_attention_windowed`` (its Pallas kernel in interpret mode).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mtlora_tpu.ops.pallas_window_attn import fused_window_attention_windowed
from mtlora_tpu_torch.ops import _build, window_attn
from mtlora_tpu_torch.ops.attention import (
    dtype_const,
    shift_attention_mask,
    window_attention,
)
from mtlora_tpu_torch.ops.window_attn import fwd_plan
from mtlora_tpu_torch.tools import ln_mlp_bwd_variants
from mtlora_tpu_torch.train.profile import classify

torch.set_num_threads(2)
SMS = 132   # the H100's SMs
N = 49
# (windows per image, heads, width) of the four stages of Swin-T 448
STAGES = [(256, 3, 96), (64, 6, 192), (16, 12, 384), (4, 24, 768)]
# Swin-B 448: embed 128, heads 4 / 8 / 16 / 32
SWIN_B = [(256, 4, 128), (64, 8, 256), (16, 16, 512), (4, 32, 1024)]
QKV_TILES = 3 * 64 * 32 * 2      # one window's q, k, v tiles, bytes
SLOT = 4 * (4 * ((N * N + 6) // 4) + 64)   # a mask slot, bytes


def _assert_plan(plan, n_windows, heads, mask_windows, dense):
    groups = [range(g * plan.group, min((g + 1) * plan.group, n_windows))
              for g in range(plan.n_groups)]
    assert all(len(g) > 0 for g in groups)
    assert [w for g in groups for w in g] == list(range(n_windows))
    assert plan.blocks == plan.n_groups * heads
    # one wave: every block resident at once
    assert plan.blocks <= SMS * plan.per_sm
    assert plan.buffers == window_attn.FWD_STAGES == 2
    # resident tiles only for kernel 1c where nW divides the cell; else a
    # slot a buffer with a mask
    want_tiles = (mask_windows if dense and 0 < mask_windows <= 8 else 0)
    assert plan.tiles == want_tiles
    per_window = 2 if mask_windows and not want_tiles else 0
    assert plan.smem == 2 * QKV_TILES + (per_window + plan.tiles) * SLOT
    assert plan.smem <= window_attn.SMEM_LIMIT == 232_448
    # an SM's 228 KB hold per_sm blocks, 1 KB reserved for each
    assert 1 <= plan.per_sm <= window_attn.FWD_BLOCKS_PER_SM
    assert plan.per_sm * (plan.smem + 1024) <= window_attn.SM_SMEM


@pytest.mark.parametrize("batch", [1, 2, 32])
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("stage", range(4))
def test_plan_at_the_stage_shapes(stage, shift, batch):
    nw, heads, _ = STAGES[stage]
    n_windows = batch * nw
    mask_windows = nw if shift else 0
    plan = fwd_plan(n_windows, N, heads, mask_windows, False, SMS)
    _assert_plan(plan, n_windows, heads, mask_windows, False)
    # four blocks an SM, with a mask slot a buffer too
    assert plan.per_sm == 4
    if batch == 32:
        assert plan.group == {0: 47, 1: 24, 2: 12, 3: 6}[stage]
        assert plan.smem == (44_320 if shift else 24_576)


@pytest.mark.parametrize("batch", [8, 32])
def test_plan_of_kernel_1c_at_path_b(batch):
    """Kernel 1c's main-path shape: stage 3 at 224 px, one window per
    image, no mask. The forward keeps no per-cell partial, so its groups
    need not be whole cells: at batch 32 the 768 (window, head) pairs run
    in 384 blocks, not the 96 of one block a cell."""
    plan = fwd_plan(batch, N, 24, 0, True, SMS)
    _assert_plan(plan, batch, 24, 0, True)
    if batch == 32:
        assert (plan.group, plan.n_groups, plan.blocks) == (2, 16, 384)
        assert plan.blocks > SMS


@pytest.mark.parametrize("stage", range(4))
def test_plan_of_kernel_1c_with_the_shift_masks(stage):
    """Kernel 1c at the 448 stages with their masks: nW = 4 (stage 3)
    stages its 4 tiles once a block, the others (nW a multiple of 8) a
    tile a window with its q, k, v."""
    nw, heads, _ = STAGES[stage]
    plan = fwd_plan(32 * nw, N, heads, nw, True, SMS)
    _assert_plan(plan, 32 * nw, heads, nw, True)
    assert plan.tiles == (4 if stage == 3 else 0)


@pytest.mark.parametrize("n_windows,heads,mask_windows,dense", [
    (1000, 3, 8, False), (50, 24, 0, False), (7, 12, 7, False),
    (1, 3, 0, False), (8, 24, 0, True), (40, 6, 8, True), (136, 32, 4, True)])
def test_plan_at_ragged_window_counts(n_windows, heads, mask_windows, dense):
    """Window counts no group size divides: the last group is short and
    no window is left out or taken twice."""
    plan = fwd_plan(n_windows, N, heads, mask_windows, dense, SMS)
    _assert_plan(plan, n_windows, heads, mask_windows, dense)


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("stage", range(4))
def test_plan_at_swin_b_heads(stage, shift):
    """Swin-B (``mtlora_base_448_r64_scale4_pertask.yaml``): 128 / 4 heads,
    head dim 32 at every stage, up to 32 heads."""
    nw, heads, C = SWIN_B[stage]
    assert C // heads == 32
    mask_windows = nw if shift else 0
    for dense in (False, True):
        plan = fwd_plan(32 * nw, N, heads, mask_windows, dense, SMS,
                        C // heads)
        _assert_plan(plan, 32 * nw, heads, mask_windows, dense)


@pytest.mark.parametrize("head_dim", [16, 64])
def test_plan_refuses_other_head_dims(head_dim):
    with pytest.raises(ValueError, match=f"head dim {head_dim}; the "
                                         "kernel's tiles take 32 only"):
        fwd_plan(8, N, 3, 0, False, SMS, head_dim)


def test_plan_refuses_windows_beyond_the_tile():
    with pytest.raises(ValueError, match="N=65 \\(at most 64\\)"):
        fwd_plan(8, 65, 3, 0, False, SMS)


@pytest.mark.parametrize("dense", [False, True])
def test_kernel_route_refuses_cpu_tensors(dense):
    """No fallback: the kernel route refuses a tensor that is not on the
    card, before any launch; the wrappers take the plain version only
    for CPU tensors and count no launch there."""
    qkv = torch.zeros(8, N, 3 * 64, dtype=torch.bfloat16)
    bias = torch.zeros(2, N, N)
    with pytest.raises(ValueError, match="no kernel for cpu"):
        window_attn._launch_fwd_rows(qkv, 2, bias, None, 0.25, dense)
    fn = (window_attn.window_attention_dense_fwd if dense
          else window_attn.window_attention_fwd)
    before = fn.launches
    out = fn(qkv, 2, bias, None, 0.25)
    assert fn.launches == before
    assert torch.equal(out, window_attention(qkv, 2, bias, None, 0.25))


def test_plan_constants_match_the_cuda_source():
    """The plan sizes shared memory by the source's constants: warps,
    blocks an SM, buffers, the mask slot's tail, the tile constants of
    ``window_tiles.cuh``, and the layout's own formula."""
    src = (_build.CSRC / "window_attn_fwd.cu").read_text()
    tiles = (_build.CSRC / "window_tiles.cuh").read_text()

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert '#include "window_tiles.cuh"' in src
    assert const(src, "kWarps") == 4
    assert const(src, "kBlocksPerSm") == window_attn.FWD_BLOCKS_PER_SM
    assert const(src, "kStages") == window_attn.FWD_STAGES
    assert const(tiles, "kHd") == window_attn.FWD_HEAD_DIM == 32
    assert const(tiles, "kRows") == window_attn.MAX_N == 64
    assert const(tiles, "kCell") == window_attn.DENSE_CELL == 8
    assert "return (N * N + 6) / 4;" in tiles
    assert (f"return 4 * mask_chunks(N) + {window_attn.FWD_MASK_TAIL};"
            in src)
    assert "(size_t)kStages * kQkvBytes +" in src
    assert ("((per_window ? kStages : 0) + tiles) * mask_slot_floats(N) *"
            in src)
    assert "constexpr int kQkvBytes = 3 * kTile * 2;" in src


def test_both_entries_are_bound():
    sig = _build.SIGNATURES
    assert len(sig["mtlora_window_attn_fwd_rows"]) == 13
    assert len(sig["mtlora_window_attn_dense_fwd_rows"]) == 14
    assert "mtlora_window_attn_dense_fwd" not in sig


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::window_attn_fwd_rows<false>("
     "__nv_bfloat16 const*, float const*, float const*, __nv_bfloat16*, "
     "int, int, int, int, int, int, float)",
     "window attention kernel (fwd)"),
    ("void (anonymous namespace)::window_attn_fwd_rows<true>("
     "__nv_bfloat16 const*, float const*, float const*, __nv_bfloat16*, "
     "int, int, int, int, int, int, float)",
     "window attention kernel 1c (fwd)"),
    ("void (anonymous namespace)::window_attn_bwd_kernel<true>(...)",
     "window attention kernel 1c (bwd)"),
    ("void (anonymous namespace)::window_attn_bwd_kernel<false>(...)",
     "window attention kernel (bwd)")])
def test_profile_classes_match_the_kernel_symbols(name, cls):
    assert classify(name) == cls


PTXAS = """\
ptxas info    : Function properties for _ZN52_GLOBAL__N__1b2c3d4e_18_window_attn_fwd_cu_0a1b2c3d20window_attn_fwd_rowsILb0EEEvPK13__nv_bfloat16PKfS5_PS1_iiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 110 registers, used 1 barriers
"""


def test_variant_probe_reports_the_kernels_registers():
    """``tools/ln_mlp_bwd_variants.py`` reads the forward's registers and
    spills from nvcc's ptxas report, and holds its variants."""
    got = ln_mlp_bwd_variants._ptxas(PTXAS)
    assert list(got.values()) == [{"spill_stores": 0, "registers": 110}]
    assert "window_attn_fwd_rows" in next(iter(got))
    assert {"attn-fwd-3-buffers", "attn-fwd-expf", "attn-fwd-p-smem",
            "attn-fwd-3-per-sm", "attn-fwd-2-waves"} <= set(
        ln_mlp_bwd_variants.VARIANTS)


def _kernel_cast_points(qkv, num_heads, rel_bias, mask, scale):
    """``window_attention`` with the kernel's cast points, keys padded to
    64 with -inf."""
    Bw, n, C3 = qkv.shape
    hd = C3 // 3 // num_heads
    x = qkv.view(Bw, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q = (x[0].float() * dtype_const(scale, qkv.dtype)).bfloat16().float()
    k, v = x[1].float(), x[2].float()
    pad = 64 - n
    k = torch.nn.functional.pad(k, (0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    s = torch.matmul(q, k.transpose(-1, -2))              # [Bw, nH, n, 64]
    b = torch.nn.functional.pad(rel_bias.float(), (0, pad),
                                value=-float("inf"))
    s = s + b[None]
    if mask is not None:
        nW = mask.shape[0]
        m = torch.nn.functional.pad(mask.float(), (0, pad))
        s = (s.view(Bw // nW, nW, num_heads, n, 64)
             + m[None, :, None]).view(Bw, num_heads, n, 64)
    log2e = 1.4426950408889634
    mo = s.amax(-1, keepdim=True) * log2e
    e = torch.exp2(s * log2e - mo)
    p = (e * (1.0 / e.sum(-1, keepdim=True))).bfloat16().float()
    out = torch.matmul(p, v).bfloat16()
    return out.transpose(1, 2).reshape(Bw, n, C3 // 3)


def _operands(rng, batch, nw, heads, C, shift):
    qkv = torch.from_numpy(rng.standard_normal(
        (batch * nw, N, 3 * C), np.float32)).bfloat16()
    bias = torch.from_numpy(0.1 * rng.standard_normal((heads, N, N),
                                                      np.float32))
    res = 7 * int(nw ** 0.5)
    mask = (torch.from_numpy(shift_attention_mask(res, res, 7, shift))
            if shift else None)
    return qkv, bias, mask, (C // heads) ** -0.5


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("stage", range(4))
def test_kernel_cast_points_within_the_smoke_bound(stage, shift, batch):
    nw, heads, C = STAGES[stage]
    rng = np.random.default_rng(2000 * stage + 10 * shift + batch)
    qkv, bias, mask, scale = _operands(rng, batch, nw, heads, C, shift)
    got = _kernel_cast_points(qkv, heads, bias, mask, scale)
    want = window_attention(qkv, heads, bias, mask, scale)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= chip_smoke.KERNEL_ATOL, err


@pytest.mark.parametrize("shift", [0, 3])
def test_kernel_cast_points_match_the_jax_kernel(shift):
    """N = 49, head dim 32, two heads, the batch-2 windows of a 14 x 14
    map, against the JAX forward (the Pallas kernel in interpret mode) on
    the same bf16 inputs."""
    rng = np.random.default_rng(7 + shift)
    qkv, bias, mask, scale = _operands(rng, 2, 4, 2, 64, shift)
    ref = fused_window_attention_windowed(
        jnp.asarray(qkv.float().numpy(), jnp.bfloat16), 2,
        jnp.asarray(bias.numpy()), 4,
        jnp.asarray(mask.numpy()) if mask is not None else None,
        scale=scale, interpret=True)
    got = _kernel_cast_points(qkv, 2, bias, mask, scale)
    err = np.abs(got.float().numpy()
                 - np.asarray(ref.astype(jnp.float32))).max()
    assert err <= chip_smoke.KERNEL_ATOL, err
