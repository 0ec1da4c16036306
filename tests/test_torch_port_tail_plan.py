"""Kernel 2b's tail mode (the stage-tail LN + LoRA backward) on the CPU:
its launch plan and its plain split.

The plan (``ops/ln_lora.py:tail_bwd_plan``) at the four fc1 sites of the
batch-32 step (M = 32 * 112^2 / 4^s, C = 96 * 2^s, O = 4C), at the ragged
392 rows of stage 3 (the batch-2 step) and at Swin-B's last stage (C =
1024), each at ranks 64, 32 and 16: rows per block, ring depth, kept
slices (none of W's above C = 768), the two-block split of the 32-row
blocks, shared memory against the H100's 232,448 bytes a block (and two
blocks an SM where C <= 128), blocks with the ragged one counted, and the
scratch the wrapper allocates; the flagship's plans, pinned; the
constants of ``csrc/ln_lora_tail_bwd.cu`` that the plan sizes shared
memory by; the refusals of shapes outside the kernel and of a CPU tensor
on the kernel route.

The plain split: ``ln_lora_tail_bwd_rows_plain`` (what the row kernel
stores) then ``ln_lora_tail_bwd_weights_plain`` (dA, dB from those rows)
is ``ln_lora_tail_bwd_plain``, bit for bit, and matches the JAX
``fused_ln_lora_linear`` tail-mode VJP: without dropout the interpret-mode
kernel, with dropout ``ln_lora_reference`` given the port's hash masks
(Mosaic's PRNG has no interpreter), with the cotangents of p and of
``dropout(y)`` present and absent. Tolerance: fp32, 2e-5 of each output's
largest element (the JAX fp32 kernel's GELU takes an Abramowitz-Stegun
erf, 1.5e-7 from the port's exact erf).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlora_tpu.ops.pallas_ln_lora import (
    fused_ln_lora_linear as jax_ln_lora,
    ln_lora_reference,
)
from mtlora_tpu_torch.ops import _build, dropout, ln_lora
from mtlora_tpu_torch.ops.ln_lora import (
    ln_lora_tail_bwd_plain,
    ln_lora_tail_bwd_rows_plain,
    ln_lora_tail_bwd_weights_plain,
)

torch.set_num_threads(2)
SMS = 132   # the H100's SMs
R = 64
# (M, C): rows and width of the four fc1 sites at batch 32, stage 3 at
# batch 2, and Swin-B's last stage at batch 32
SHAPES = [(401408, 96), (100352, 192), (25088, 384), (6272, 768),
          (392, 768), (6272, 1024)]
RANKS = [64, 32, 16]
SEED = np.array([123, 456], np.int32)
REL = 2e-5


@pytest.mark.parametrize("r", RANKS)
@pytest.mark.parametrize("M,C", SHAPES)
def test_plan_rows_ring_and_shared_memory(M, C, r):
    plan = ln_lora.tail_bwd_plan(M, C, 4 * C, r, SMS)
    ncs = -(-C // 64)
    keep = ncs <= 12
    # dln (rows x C fp32) at 96 registers a thread at most (128 at C =
    # 1024): 128 rows at C = 192, 64 up to C = 384, 32 above
    assert plan.bm == {96: 64, 192: 128, 384: 64, 768: 32, 1024: 32}[C]
    assert plan.bm * C <= 128 * (192 if keep else 256)
    assert plan.chunk == 64 and plan.stages >= 3
    # the chunk's W slices (up to C = 768) and its B slice, kept for dln
    # and dm
    assert plan.kept == (ncs if keep else 0) + 1
    # the 32-row blocks, few, share a row block's hidden chunks in pairs
    assert plan.split == (2 if plan.bm == 32 else 1)
    assert plan.smem <= ln_lora.SMEM_LIMIT == 232_448
    # two blocks an SM (228 KB, 1 KB reserved for each) where C <= 128
    if C <= 128:
        assert 2 * (plan.smem + 1024) <= 228 * 1024
    # the last block masks its rows past M
    assert plan.blocks == -(-M // plan.bm)
    assert (plan.blocks - 1) * plan.bm < M <= plan.blocks * plan.bm
    assert 1 <= plan.sa <= -(-M // 64) and 1 <= plan.sb <= -(-M // 64)
    # every weight slice is staged once per row block: A for m (in each
    # block of a split) and for dl, B and W per hidden chunk (W twice
    # where it is not kept)
    per = ncs + 1 if keep else 2 * ncs + 1
    assert plan.slice_bytes == plan.blocks * ((plan.split + 1) * ncs + 4 * C
                                              // 64 * per) * 2 * 64 * 64


# the flagship's plans (r = 64) at SHAPES[:5]: (rows a block, kept slices,
# split, shared-memory bytes, blocks, bytes of weight slices)
FLAGSHIP_PLANS = [(64, 3, 1, 105_984, 6272, 1_130_364_928),
                  (128, 4, 1, 198_656, 784, 346_816_512),
                  (64, 7, 1, 194_048, 392, 578_027_520),
                  (32, 13, 2, 228_608, 196, 1_059_717_120),
                  (32, 13, 2, 228_608, 13, 70_287_360)]


@pytest.mark.parametrize("shape,want", zip(SHAPES, FLAGSHIP_PLANS))
def test_flagship_plans_are_unchanged(shape, want):
    """The ranks and widths that the kernel took besides r = 64 and C <=
    768 leave the flagship's launches as they were."""
    M, C = shape
    plan = ln_lora.tail_bwd_plan(M, C, 4 * C, R, SMS)
    assert (plan.bm, plan.kept, plan.split, plan.smem, plan.blocks,
            plan.slice_bytes) == want


def test_plan_ragged_rows_take_one_more_block():
    """392 rows at stage 3: twelve whole blocks of 32 and one of 8."""
    plan = ln_lora.tail_bwd_plan(392, 768, 3072, R, SMS)
    assert plan.bm == 32 and plan.blocks == 13 and 392 % plan.bm == 8


@pytest.mark.parametrize("r", RANKS)
@pytest.mark.parametrize("M,C", SHAPES)
def test_plan_scratch_is_what_the_wrapper_allocates(M, C, r):
    plan = ln_lora.tail_bwd_plan(M, C, 4 * C, r, SMS)
    bf16, f32 = torch.bfloat16, torch.float32
    want = {
        "lnd": ((M, C), bf16),
        "mbuf": ((2, M, r), bf16),
        "du": ((M, 4 * C), bf16),
        "gb": ((plan.blocks, 2, C), f32),
        "part": ((max(plan.sa * r * C, plan.sb * 4 * C * r),), f32),
    }
    if plan.split == 2:
        # per row block, the second block's dln slices and dm, by thread
        # and n-tile (2 of a warp's 16 columns)
        want["xfer"] = ((plan.blocks * (C // 64 + 1) * 2 * 4 * 256,), f32)
    assert plan.scratch == want
    # small rows allocate the same layout for real
    small = ln_lora.tail_bwd_plan(40, C, 4 * C, r, SMS)
    got = ln_lora.tail_bwd_scratch(small, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (tuple(s), dt) for k, (s, dt) in small.scratch.items()}


def test_plan_constants_match_the_cuda_source():
    src = (_build.CSRC / "ln_lora_tail_bwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kS") == ln_lora.TAIL_CHUNK
    assert const("kStages") == ln_lora.TAIL_STAGES
    assert const("kWarps") == ln_lora.TAIL_WARPS
    assert const("kGroup") >= 1 and ln_lora.TAIL_STAGES % const("kGroup") == 0
    pad = int(re.search(r"constexpr int kLdS = kS \+ (\d+);", src)[1])
    assert ln_lora.TAIL_CHUNK + pad == ln_lora.TAIL_TILE
    assert const("kRank") == max(ln_lora.TAIL_RANKS) == 64
    # the instances keep W's slices up to the plan's count, and the C entry
    # streams them twice above it
    keep = ln_lora.TAIL_KEEP_SLICES
    assert f"constexpr bool kKeepW = NCS <= {keep};" in src
    assert f"a.per = ncs <= {keep} ? ncs + 1 : 2 * ncs + 1;" in src
    # the C entry point refuses what the plan refuses
    assert "C <= kS || C % 32 || C > 1024" in src
    assert "r < 16 || r % 16 || r > kRank" in src
    assert "(bm == 128 && C == 192)" in src and "split == 2 && bm == 32" in src


# (C, O, r): C of one slice (the kernel is built and checked for two or
# more, the fc1 sites' least), then each bound: a rank that is not a
# multiple of 16, or above 64; C not a multiple of 32, or above 1024; O
# not whole chunks
REFUSED = [(64, 256, 64), (96, 384, 8), (96, 384, 80), (100, 400, 64),
           (1056, 4224, 64), (96, 360, 64)]


@pytest.mark.parametrize("C,O,r", REFUSED)
def test_plan_refuses_shapes_outside_the_kernel(C, O, r):
    msg = (f"LN+LoRA tail backward kernel: needs C % 32 == 0 and 64 < C <= "
           f"1024 ({C}), O % 64 == 0 ({O}) and r in (16, 32, 48, 64) "
           f"({r})")
    with pytest.raises(ValueError) as err:
        ln_lora.tail_bwd_plan(64, C, O, r, SMS)
    assert str(err.value) == msg


def test_kernel_route_refuses_a_cpu_tensor():
    """The plain version runs only through ``ln_lora_tail_bwd``'s CPU
    branch; the kernel route itself raises."""
    args, (gy, gp, gd) = _port_args(*_inputs(M=8, K=96, O=384, r=64))
    with pytest.raises(ValueError, match="LN\\+LoRA: no kernel for cpu"):
        ln_lora.ln_lora_tail_bwd_kernel(*args, torch.zeros(2, dtype=torch.int32),
                                        4.0, 0.0, gy, gp, gd)


# ---------------------------------------------------------------------------
# The plain split
# ---------------------------------------------------------------------------

def _inputs(seed=0, M=64, K=32, O=128, r=16):
    rng = np.random.RandomState(seed)
    x = (rng.randn(M, K) * 2 + 0.5).astype(np.float32)
    gamma = rng.uniform(0.8, 1.2, K).astype(np.float32)
    beta = (0.1 * rng.randn(K)).astype(np.float32)
    w = (rng.randn(K, O) / np.sqrt(K)).astype(np.float32)
    b = (0.1 * rng.randn(O)).astype(np.float32)
    A = (rng.randn(K, r) / np.sqrt(K)).astype(np.float32)
    B = (0.1 * rng.randn(r, O)).astype(np.float32)
    gs = [rng.randn(M, O).astype(np.float32) for _ in range(3)]
    return (x, gamma, beta, w, b, A, B), gs


def _port_args(params, cots):
    x, gamma, beta, w, b, A, B = params
    t = [torch.from_numpy(np.array(a)) for a in
         (x, gamma, beta, w.T, b, A.T, B.T)]
    return t, tuple(torch.from_numpy(c) for c in cots)


def _near_top(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=REL * np.abs(want).max())


CASES = [(gp, gd, drop) for drop in (0.0, 0.3) for gp in (True, False)
         for gd in (True, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("has_gp,has_gd,drop", CASES)
def test_rows_then_weights_is_the_plain_backward(has_gp, has_gd, drop,
                                                 dtype):
    """The composition, with the rows in the compute dtype as the kernel
    stores them, is ``ln_lora_tail_bwd_plain`` bit for bit; the rows have
    the kernel's shapes and dtype."""
    params, cots = _inputs(seed=3)
    args, (gy, gp, gd) = _port_args(params, cots)
    args = [a.to(dtype) for a in args]
    gy, gp, gd = (c.to(dtype) for c in (gy, gp, gd))
    gp, gd = (gp if has_gp else None), (gd if has_gd else None)
    seed = torch.from_numpy(SEED)
    rows = ln_lora_tail_bwd_rows_plain(*args, seed, 4.0, drop, gy, gp, gd)
    M, K = args[0].shape
    O, r = args[3].shape[0], args[5].shape[0]
    assert [(tuple(t.shape), t.dtype) for t in rows[3:]] == [
        ((M, K), dtype), ((M, r), dtype), ((M, r), dtype), ((M, O), dtype)]
    got = rows[:3] + ln_lora_tail_bwd_weights_plain(*rows[3:])
    want = ln_lora_tail_bwd_plain(*args, seed, 4.0, drop, gy, gp, gd)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("r", [16, 32])
@pytest.mark.parametrize("has_gp", [True, False])
def test_split_matches_the_jax_kernel_without_dropout(has_gp, r):
    """``out_act`` (and ``out_p`` where p has a cotangent) against the
    interpret-mode kernel's VJP, at ranks 16 and 32."""
    params, (gy, gp, _) = _inputs(seed=4, r=r)
    x, gamma, beta, w, b, A, B = params
    zs = jnp.zeros((2,), jnp.int32)

    def f(x, g, be, A, B):
        return jax_ln_lora(x, g, be, jnp.asarray(w), jnp.asarray(b), A, B,
                           zs, 4.0, 0.0, has_gp, True, False,
                           interpret=True)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (x, gamma, beta, A, B)))
    refs = vjp((jnp.asarray(gy), jnp.asarray(gp)) if has_gp
               else jnp.asarray(gy))
    args, (tgy, tgp, _) = _port_args(params, (gy, gp, gy))
    rows = ln_lora_tail_bwd_rows_plain(*args, torch.zeros(2, dtype=torch.int32),
                                       4.0, 0.0, tgy,
                                       tgp if has_gp else None)
    got = rows[:3] + ln_lora_tail_bwd_weights_plain(*rows[3:])
    for a, r, tr in zip(got, refs, (False, False, False, True, True)):
        r = np.asarray(r)
        _near_top(a, r.T if tr else r)


@pytest.mark.parametrize("has_gp,has_gd", [(True, True), (True, False),
                                           (False, True), (False, False)])
def test_split_matches_the_reference_with_port_masks(has_gp, has_gd):
    """Dropout on the LN input (hash stream 0) and ``d = dropout(y)``
    (stream 1), given to ``ln_lora_reference`` (exact erf); the VJP from
    the cotangents of y and of whichever of p and d are present."""
    params, (gy, gp, gd) = _inputs(seed=5)
    x, gamma, beta, w, b, A, B = params
    rate, scale = 0.3, 4.0
    tseed = torch.from_numpy(SEED)
    keep = dropout.keep_mask(tseed, 0, *x.shape, rate).numpy()
    keep2 = jnp.asarray(dropout.keep_mask(tseed, 1, x.shape[0], w.shape[1],
                                          rate).numpy())

    def f(x, g, be, A, B):
        y, p = ln_lora_reference(x, g, be, jnp.asarray(w), jnp.asarray(b),
                                 A, B, scale, keep_mask=jnp.asarray(keep),
                                 drop=rate, act=True)
        d = jnp.where(keep2, y / (1.0 - rate), 0.0)
        return (y,) + ((p,) if has_gp else ()) + ((d,) if has_gd else ())

    _, vjp = jax.vjp(f, *map(jnp.asarray, (x, gamma, beta, A, B)))
    refs = vjp(tuple(jnp.asarray(c) for c, on in
                     ((gy, True), (gp, has_gp), (gd, has_gd)) if on))
    args, (tgy, tgp, tgd) = _port_args(params, (gy, gp, gd))
    rows = ln_lora_tail_bwd_rows_plain(*args, tseed, scale, rate, tgy,
                                       tgp if has_gp else None,
                                       tgd if has_gd else None)
    got = rows[:3] + ln_lora_tail_bwd_weights_plain(*rows[3:])
    for a, r, tr in zip(got, refs, (False, False, False, True, True)):
        r = np.asarray(r)
        _near_top(a, r.T if tr else r)
