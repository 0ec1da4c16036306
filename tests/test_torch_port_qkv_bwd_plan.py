"""Kernel 2b in y-only mode (the LN + LoRA backward at the qkv sites) on
the CPU: its launch plan and its plain split.

The plan (``ops/ln_lora.py:qkv_bwd_plan``) at the four qkv sites of the
batch-32 step (M = 32 * 112^2 / 4^s, C = 96 * 2^s, O = 3C, r = 64) and at
the ragged 392 rows of stage 3 (the batch-2 step): rows per block, the
TMA ring's slots and groups, the two-block split of the 32-row blocks,
shared memory against the H100's 232,448 bytes a block (and two blocks an
SM where the kernel's launch bounds ask for them), blocks with the ragged
one counted, and the scratch the wrapper allocates; at every (C, r) of
the YAMLs under ``configs/mtlora/`` (O = 3C), the plan for every rank
that is a multiple of 16 and the refusal of the others (r = 4, 8); the
constants of ``csrc/ln_lora_qkv_bwd.cu`` that the plan sizes shared
memory by; the refusals of shapes outside the kernel and of a CPU tensor
on the kernel route; the profile classes of the row kernels.

The plain split: ``ln_lora_bwd_rows_plain`` (what the row kernel stores)
then ``ln_lora_bwd_weights_plain`` (dA, dB from those rows and gy) is
``ln_lora_bwd_plain``, bit for bit, with dropout on and off and scales
4, 3 and 0; the tail mode's plain backward without GELU and without the
cotangents of p and d is the same function; and the split matches the
JAX ``fused_ln_lora_linear`` y-only VJP (the interpret-mode kernel,
without dropout: Mosaic's PRNG has no interpreter) at a shape whose O =
3K leaves a last hidden chunk of 32 columns. Tolerance: fp32, 2e-5 of
each output's largest element (the order of fp32 sums).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlora_tpu.config import load_config
from mtlora_tpu.ops.pallas_ln_lora import fused_ln_lora_linear as jax_ln_lora
from mtlora_tpu_torch.ops import _build, ln_lora
from mtlora_tpu_torch.ops.ln_lora import (
    ln_lora_bwd_plain,
    ln_lora_bwd_rows_plain,
    ln_lora_bwd_weights_plain,
    ln_lora_tail_bwd_plain,
)

torch.set_num_threads(2)
SMS = 132   # the H100's SMs
R = 64
# (M, C): rows and width of the four qkv sites at batch 32, and stage 3 at
# batch 2
SHAPES = [(401408, 96), (100352, 192), (25088, 384), (6272, 768),
          (392, 768)]
SEED = np.array([123, 456], np.int32)
REL = 2e-5
YAMLS = sorted((Path(__file__).resolve().parents[1] / "configs" / "mtlora")
               .rglob("mtlora_*.yaml"))


@pytest.mark.parametrize("M,C", SHAPES)
def test_plan_rows_ring_and_shared_memory(M, C):
    plan = ln_lora.qkv_bwd_plan(M, C, 3 * C, R, SMS)
    ncs, nch = -(-C // 64), -(-3 * C // 64)
    # dln (rows x C fp32) at 48 registers a thread, two blocks an SM, up
    # to C = 384 (64 rows at C = 96 and 192, 32 at C = 384); at 96 above,
    # one block an SM (32 rows at C = 768)
    assert plan.bm == {96: 64, 192: 64, 384: 32, 768: 32}[C]
    assert plan.bm * C <= (48 if C <= 384 else 96) * 256
    # the TMA ring: groups of 4 slots (2 where fewer than 8 slots fit),
    # two groups at least, 12 slots at most
    assert plan.chunk == 64 and ln_lora.QKV_GROUP == 4
    assert plan.group == (4 if plan.stages >= 8 else 2)
    assert 2 * plan.group <= plan.stages <= ln_lora.QKV_MAX_STAGES == 12
    assert plan.stages % plan.group == 0
    assert plan.smem <= ln_lora.SMEM_LIMIT == 232_448
    # two blocks an SM (228 KB, 1 KB reserved for each) up to C = 384, as
    # the kernel's launch bounds ask
    assert plan.per_sm == (2 if C <= 384 else 1)
    assert plan.per_sm * (plan.smem + 1024) <= 228 * 1024
    # the 32-row blocks alone on an SM, few, share a row block's hidden
    # chunks in pairs
    assert plan.split == (2 if plan.bm == 32 and plan.per_sm == 1 else 1)
    # the last block masks its rows past M
    assert plan.blocks == -(-M // plan.bm)
    assert (plan.blocks - 1) * plan.bm < M <= plan.blocks * plan.bm
    assert 1 <= plan.sa <= -(-M // 64) and 1 <= plan.sb <= -(-M // 64)
    # every weight slice is staged once per row block: A for m (in each
    # block of a split) and for dl, B and W per hidden chunk
    assert plan.slice_bytes == plan.blocks * ((plan.split + 1) * ncs
                                              + nch * (ncs + 1)) * 2 * 64 * 64


def test_plan_ragged_rows_take_one_more_block():
    """392 rows at stage 3: twelve whole blocks of 32 and one of 8."""
    plan = ln_lora.qkv_bwd_plan(392, 768, 2304, R, SMS)
    assert plan.bm == 32 and plan.blocks == 13 and 392 % plan.bm == 8


@pytest.mark.parametrize("M,C", SHAPES)
def test_plan_scratch_is_what_the_wrapper_allocates(M, C):
    plan = ln_lora.qkv_bwd_plan(M, C, 3 * C, R, SMS)
    bf16, f32 = torch.bfloat16, torch.float32
    want = {
        "lnd": ((M, C), bf16),
        "mbuf": ((2, M, R), bf16),
        "gb": ((plan.blocks, 2, C), f32),
        "part": ((max(plan.sa * R * C, plan.sb * 3 * C * R),), f32),
    }
    if plan.split == 2:
        # per row block, the second block's dln slices and dm, by thread
        # and n-tile (2 of a warp's 16 columns)
        want["xfer"] = ((plan.blocks * (C // 64 + 1) * 2 * 4 * 256,), f32)
    assert plan.scratch == want
    # no du rows: dB's pass reads gy itself
    assert "du" not in plan.scratch
    # small rows allocate the same layout for real
    small = ln_lora.qkv_bwd_plan(40, C, 3 * C, R, SMS)
    got = ln_lora.qkv_bwd_scratch(small, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (tuple(s), dt) for k, (s, dt) in small.scratch.items()}


def _yaml_sites():
    """(yaml, stage, C, r) of every stage of every YAML: the width and the
    shared rank of its qkv sites (O = 3C)."""
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


def test_the_yamls_give_the_widths_and_ranks_the_plan_is_held_to():
    assert {(C, r) for _, _, C, r in SITES} == {
        (C, r) for C in (96, 192, 384, 768) for r in (4, 8, 16, 32, 64)} | {
        (C, 64) for C in (128, 256, 512, 1024)}


def test_plan_takes_every_yaml_shape_with_r_a_multiple_of_16():
    """At every (C, r) of the YAMLs with r a multiple of 16, at the
    batch-32 rows of a 448 image and at ragged rows; ranks 4 and 8 are
    refused, as before."""
    taken = set()
    for name, s, C, r in SITES:
        if r % 16:
            with pytest.raises(ValueError, match="r a multiple of 16"):
                ln_lora.qkv_bwd_plan(6272, C, 3 * C, r, SMS)
            continue
        for M in (32 * (112 // 2 ** s) ** 2, 392):
            plan = ln_lora.qkv_bwd_plan(M, C, 3 * C, r, SMS)
            assert plan.smem <= ln_lora.SMEM_LIMIT, (name, s)
            assert plan.per_sm * (plan.smem + 1024) <= 228 * 1024
            assert plan.stages >= 2 * plan.group and plan.group in (2, 4)
            # dln at 96 registers a thread, 128 at C = 1024 (32 rows, the
            # least a block takes)
            assert plan.bm * C <= (128 if C == 1024 else 96) * 256, (name, s)
            assert plan.scratch["mbuf"] == ((2, M, r), torch.bfloat16)
        taken.add((C, r))
    assert taken == {(C, r) for C in (96, 192, 384, 768)
                     for r in (16, 32, 64)} | {(C, 64) for C in
                                               (128, 256, 512, 1024)}


def test_plan_constants_match_the_cuda_source():
    src = (_build.CSRC / "ln_lora_qkv_bwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kS") == ln_lora.QKV_CHUNK
    assert const("kWarps") == ln_lora.QKV_WARPS
    assert const("kGroupMax") >= ln_lora.QKV_GROUP
    pad = int(re.search(r"constexpr int kLdS = kS \+ (\d+);", src)[1])
    assert ln_lora.QKV_CHUNK + pad == ln_lora.QKV_TILE
    # the C entry point refuses what the plan refuses
    assert "C <= kS || C % 32 || C > 1024 || O < 16 || O % 16" in src
    assert "r < 16 || r % 16 || r > kRank" in src
    assert "constexpr int kRank = 64;" in src
    assert "!(bm == 32 || (bm == 64 && ncs <= 3))" in src
    assert "split == 2 && bm == 32 && nch % 2 == 0" in src
    assert "stages % group || stages < 2 * group" in src
    # the launch bounds that the plan's per_sm reads
    assert "__launch_bounds__(kThreads, BM * NCS <= 192 ? 2 : 1)" in src


# (C, O, r): C of one slice (the kernel is built and checked for two or
# more), then each bound: a rank under 16 (the r8 YAMLs), C % 32, C past
# Swin-B's 1024, O % 16, a rank past one slice
REFUSED = [(64, 192, 64), (96, 288, 8), (100, 300, 64), (1056, 3168, 64),
           (96, 296, 64), (96, 288, 80)]


@pytest.mark.parametrize("C,O,r", REFUSED)
def test_plan_refuses_shapes_outside_the_kernel(C, O, r):
    msg = (f"LN+LoRA backward kernel: needs C % 32 == 0 and 64 < C <= 1024 "
           f"({C}), O % 16 == 0 ({O}) and r a multiple of 16 up to 64 ({r})")
    with pytest.raises(ValueError) as err:
        ln_lora.qkv_bwd_plan(64, C, O, r, SMS)
    assert str(err.value) == msg


def test_kernel_route_refuses_a_cpu_tensor():
    """The plain version runs only through ``ln_lora_bwd``'s CPU branch;
    the kernel route itself raises."""
    args, gy = _port_args(*_inputs(M=8, K=96, O=288, r=64))
    with pytest.raises(ValueError, match="LN\\+LoRA: no kernel for cpu"):
        ln_lora.ln_lora_bwd_kernel(*args, torch.zeros(2, dtype=torch.int32),
                                   4.0, 0.0, gy)


# ---------------------------------------------------------------------------
# The plain split
# ---------------------------------------------------------------------------

def _inputs(seed=0, M=64, K=32, O=96, r=16):
    rng = np.random.RandomState(seed)
    x = (rng.randn(M, K) * 2 + 0.5).astype(np.float32)
    gamma = rng.uniform(0.8, 1.2, K).astype(np.float32)
    beta = (0.1 * rng.randn(K)).astype(np.float32)
    w = (rng.randn(K, O) / np.sqrt(K)).astype(np.float32)
    b = (0.1 * rng.randn(O)).astype(np.float32)
    A = (rng.randn(K, r) / np.sqrt(K)).astype(np.float32)
    B = (0.1 * rng.randn(r, O)).astype(np.float32)
    gy = rng.randn(M, O).astype(np.float32)
    return (x, gamma, beta, w, b, A, B), gy


def _port_args(params, gy):
    x, gamma, beta, w, b, A, B = params
    t = [torch.from_numpy(np.array(a)) for a in
         (x, gamma, beta, w.T, b, A.T, B.T)]
    return t, torch.from_numpy(gy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [4.0, 3.0, 0.0])
@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_rows_then_weights_is_the_plain_backward(drop, scale, dtype):
    """The composition, with the rows in the compute dtype as the kernel
    stores them, is ``ln_lora_bwd_plain`` bit for bit; the rows have the
    kernel's shapes and dtype."""
    args, gy = _port_args(*_inputs(seed=3))
    args, gy = [a.to(dtype) for a in args], gy.to(dtype)
    seed = torch.from_numpy(SEED)
    rows = ln_lora_bwd_rows_plain(*args, seed, scale, drop, gy)
    M, K = args[0].shape
    r = args[5].shape[0]
    assert [(tuple(t.shape), t.dtype) for t in rows[3:]] == [
        ((M, K), dtype), ((M, r), dtype), ((M, r), dtype)]
    got = rows[:3] + ln_lora_bwd_weights_plain(*rows[3:], gy, scale)
    want = ln_lora_bwd_plain(*args, seed, scale, drop, gy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_tail_mode_without_act_and_cotangents_is_the_qkv_backward(drop):
    """``ln_lora_tail_bwd_plain(..., act=False)`` with no gp and no gd
    computes exactly ``ln_lora_bwd_plain``: kernel 2b's two modes share
    one function."""
    args, gy = _port_args(*_inputs(seed=6, O=128))
    seed = torch.from_numpy(SEED)
    got = ln_lora_tail_bwd_plain(*args, seed, 4.0, drop, gy, None, None,
                                 act=False)
    want = ln_lora_bwd_plain(*args, seed, 4.0, drop, gy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_split_matches_the_jax_kernel_without_dropout():
    """The y-only VJP of the interpret-mode kernel at K = 32, O = 96 (the
    stage-0 ratio O = 3K, whose last 64-column hidden chunk has 32)."""
    params, gy = _inputs(seed=4)
    x, gamma, beta, w, b, A, B = params
    assert w.shape[1] == 3 * w.shape[0] and w.shape[1] % 64 == 32
    zs = jnp.zeros((2,), jnp.int32)

    def f(x, g, be, A, B):
        return jax_ln_lora(x, g, be, jnp.asarray(w), jnp.asarray(b), A, B,
                           zs, 4.0, 0.0, False, False, False,
                           interpret=True)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (x, gamma, beta, A, B)))
    refs = vjp(jnp.asarray(gy))
    args, tgy = _port_args(params, gy)
    rows = ln_lora_bwd_rows_plain(*args, torch.zeros(2, dtype=torch.int32),
                                  4.0, 0.0, tgy)
    got = rows[:3] + ln_lora_bwd_weights_plain(*rows[3:], tgy, 4.0)
    for a, ref, tr in zip(got, refs, (False, False, False, True, True)):
        ref = np.asarray(ref, np.float32)
        ref = ref.T if tr else ref
        np.testing.assert_allclose(a.detach().float().numpy(), ref, rtol=0,
                                   atol=REL * np.abs(ref).max())


def test_profile_classes_name_each_row_kernel():
    """The trace names of kernel 2b's row kernels (qkv sites, stage tails)
    and of kernel 3b's go to their own classes, and so do the forward
    kernels of 2 (the qkv mode), 2-tail (the tail mode of the same body)
    and 3."""
    from mtlora_tpu_torch.train.profile import classify

    pre = "void (anonymous namespace)::"
    assert classify(pre + "ln_lora_qkv_bwd_rows<64, 2>(Params)") == (
        "LN+LoRA kernel 2b, qkv sites (bwd rows)")
    assert classify(pre + "ln_lora_tail_bwd_rows<32, 12>(Args)") == (
        "LN+LoRA kernel 2b, tail mode (fused rows)")
    assert classify(pre + "patch_merge_bwd_rows<64, 3>(Params)") == (
        "patch merge kernel 3b (bwd rows)")
    assert classify(pre + "ln_lora_qkv_fwd_kernel<1, 2>(Params)") == (
        "LN+LoRA kernel 2, qkv sites (fwd)")
    assert classify(pre + "ln_lora_tail_fwd_kernel<2, 1>(Params)") == (
        "LN+LoRA kernel 2, tail mode (fwd)")
    assert classify(pre + "patch_merge_fwd_rows<2, 2>(Params)") == (
        "patch merge kernel 3 (fwd)")
