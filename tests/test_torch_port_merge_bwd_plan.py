"""Kernel 3b (the patch merge's backward) on the CPU: its launch plan and
its plain split.

The plan (``ops/ln_lora.py:merge_bwd_plan``) at the three merges of the
batch-32 step for the shared stream (L = 32) and the task streams the LN
route merges (L = 128), at the ragged rows of the batch-2 step, at path
B's merges at 224 px (Wh = 28, 14 and 7, odd) and at the merge shapes of
every YAML under ``configs/mtlora/``: rows per block, the blocks of a
cluster that split the merged rows' columns, the TMA ring's slots and
groups, shared memory against the H100's 232,448 bytes a block (and two
blocks an SM where the kernel's launch bounds ask for them), blocks with
the ragged one counted, and the scratch the wrapper allocates; the
constants of ``csrc/merge_ln_bwd.cu`` that the plan sizes shared memory
by; the refusals of shapes outside the kernel and of a CPU tensor on the
kernel route; the profile class of the row kernel.

The plain split: ``merge_ln_bwd_rows_plain`` (what the row kernel stores:
dx, dgamma, dbeta and the bf16(ln) rows) then
``merge_ln_bwd_weights_plain`` (dW from those rows and gy) is
``merge_ln_bwd_plain``, bit for bit, in fp32 and bf16; and the split
matches the JAX ``fused_merge_ln_linear`` VJP with ``train_w`` (the
interpret-mode kernel) at a shape with an odd Wh = 7 and rows that no
block of the kernel divides. Tolerance: fp32, 2e-5 of each output's
largest element (the order of fp32 sums).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlora_tpu.config import load_config
from mtlora_tpu.ops.pallas_ln_lora import fused_merge_ln_linear as jax_merge
from mtlora_tpu_torch.ops import _build, ln_lora
from mtlora_tpu_torch.ops.ln_lora import (
    merge_ln_bwd_plain,
    merge_ln_bwd_rows_plain,
    merge_ln_bwd_weights_plain,
)

torch.set_num_threads(2)
SMS = 132   # the H100's SMs
REL = 2e-5
YAMLS = sorted((Path(__file__).resolve().parents[1] / "configs" / "mtlora")
               .rglob("mtlora_*.yaml"))


def _merge(L, res, C):
    """(M, K, O, Wh) of the merge of x [L, res^2, C]."""
    return L * (res // 2) ** 2, 4 * C, 2 * C, res // 2


# the three merges of the flagship (Swin-T 448) at L = 32 (the shared
# stream) and 128 (the four task streams of the LN route)
FLAGSHIP = [_merge(L, 112 // 2 ** s, 96 * 2 ** s)
            for L in (32, 128) for s in range(3)]
# the batch-2 step's merges (phase 8), 392 rows at the last
RAGGED = [_merge(2, 112 // 2 ** s, 96 * 2 ** s) for s in range(3)]
# path B at 224 px, batch 32 and 8: Wh = 28, 14 and 7
PATH_B = [_merge(L, 56 // 2 ** s, 96 * 2 ** s) for L in (32, 8)
          for s in range(3)]
SHAPES = FLAGSHIP + RAGGED + PATH_B


def _check_plan(plan, M, K, O):
    """What every plan holds to."""
    wn = 8 // (plan.bm // 16)
    assert plan.bm in (64, 32) and plan.split in (1, 2, 4, 8)
    # the blocks of a cluster split K; a warp's share of a slot (64 / wn
    # columns) divides a block's columns
    assert plan.ks * plan.split == K and plan.ks % (64 // wn) == 0
    # dln (rows x a block's columns, fp32) at 48 registers a thread where
    # two blocks share an SM, at most 96 where one is alone
    regs = plan.bm * plan.ks // 256
    assert regs <= (48 if plan.per_sm == 2 else 96)
    # the TMA ring: groups of 4 slots (2 where fewer than 8 slots fit),
    # two groups at least, 16 slots at most
    assert plan.group == (4 if plan.stages >= 8 else 2)
    assert 2 * plan.group <= plan.stages <= ln_lora.MERGE_MAX_STAGES == 16
    assert plan.stages % plan.group == 0
    assert plan.smem <= ln_lora.SMEM_LIMIT == 232_448
    # two blocks an SM (228 KB, 1 KB reserved for each) where the launch
    # bounds ask for them
    assert plan.per_sm * (plan.smem + 1024) <= 228 * 1024
    # the dgamma/dbeta partials of the 16-row tiles fit in the ring
    assert plan.bm // 16 * 2 * plan.ks * 4 <= plan.stages * 2 * 64 * 64
    # the last row block masks its rows past M
    assert plan.blocks == -(-M // plan.bm)
    assert (plan.blocks - 1) * plan.bm < M <= plan.blocks * plan.bm
    assert plan.ctas == plan.blocks * plan.split
    # W's slots, each staged once per block: per hidden chunk its slices
    # of the block's columns
    assert plan.slice_bytes == (plan.ctas * -(-O // 64)
                                * -(-plan.ks // 64) * 2 * 64 * 64)
    assert 1 <= plan.sw <= -(-M // 64)


@pytest.mark.parametrize("M,K,O,Wh", SHAPES)
def test_plan_rows_split_ring_and_shared_memory(M, K, O, Wh):
    plan = ln_lora.merge_bwd_plan(M, K, O, Wh, SMS)
    _check_plan(plan, M, K, O)
    # 64 rows, two blocks an SM, in clusters of 2, 4, 8 at K = 384, 768,
    # 1536: a block's 192 columns, W's traffic from L2 M / 64 K O 2 bytes
    assert (plan.bm, plan.split, plan.per_sm) == (
        64, {384: 2, 768: 4, 1536: 8}[K], 2)


def test_plan_ragged_rows_take_one_more_block():
    """392 rows at the batch-2 step's last merge: six whole blocks of 64
    and one of 8."""
    plan = ln_lora.merge_bwd_plan(392, 1536, 768, 14, SMS)
    assert plan.bm == 64 and plan.blocks == 7 and 392 % plan.bm == 8
    assert plan.ctas == 7 * plan.split


@pytest.mark.parametrize("M,K,O,Wh", FLAGSHIP[:3] + RAGGED)
def test_plan_scratch_is_what_the_wrapper_allocates(M, K, O, Wh):
    plan = ln_lora.merge_bwd_plan(M, K, O, Wh, SMS)
    bf16, f32 = torch.bfloat16, torch.float32
    assert plan.scratch == {
        "lnd": ((M, K), bf16),
        "gb": ((plan.blocks, 2, K), f32),
        "part": ((plan.sw * O * K,), f32),
    }
    # no fp32 rows [M, K]: dln stays on the chip
    assert all(dt == bf16 or shape[0] != M
               for shape, dt in plan.scratch.values())
    # small rows allocate the same layout for real
    small = ln_lora.merge_bwd_plan(2 * Wh, K, O, Wh, SMS)
    got = ln_lora.merge_bwd_scratch(small, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (tuple(s), dt) for k, (s, dt) in small.scratch.items()}


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
    plan = ln_lora.merge_bwd_plan(M, K, O, Wh, SMS)
    _check_plan(plan, M, K, O)
    # Swin-B's last merge, [6272, 2048] -> 1024: 32 rows in clusters of 8,
    # 256 columns a block
    if K == 2048:
        assert (plan.bm, plan.split, plan.ks) == (32, 8, 256)


def test_plan_takes_twice_swin_b_widest_merge():
    """K = 4096 (C = 1024): one block an SM, dln at 64 registers."""
    plan = ln_lora.merge_bwd_plan(6272, 4096, 2048, 14, SMS)
    _check_plan(plan, 6272, 4096, 2048)
    assert (plan.bm, plan.split, plan.per_sm) == (32, 8, 1)


def test_plan_constants_match_the_cuda_source():
    src = (_build.CSRC / "merge_ln_bwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kS") == ln_lora.MERGE_CHUNK
    assert const("kWarps") == ln_lora.MERGE_WARPS
    assert const("kGroupMax") >= ln_lora.MERGE_GROUP
    assert const("kSplitMax") == max(ln_lora.MERGE_SPLITS)
    # the instances the C entry point dispatches to, and its refusals
    for bm, ncs in ln_lora.MERGE_INSTANCES.items():
        for n in ncs:
            assert f"launch_rows<{bm}, {n}>(p, blocks, smem, st)" in src
    assert "ncs > (bm == 64 ? 3 : 8)" in src
    assert "ks % (bm == 64 ? 32 : 16)" in src
    assert "C < 8 || C % 8 || O < 16 || O % 16" in src
    assert "stages % group || stages < 2 * group" in src
    # the launch bounds that the plan's per_sm reads
    assert "__launch_bounds__(kThreads, BM * NCS <= 192 ? 2 : 1)" in src
    # the plan's shared-memory layout: the ring's mbarrier and count a
    # group after the fp32 arrays
    assert "reinterpret_cast<int*>(bars + nbar)" in src


# (M, K, O, Wh): C % 8 != 0, O % 16 != 0, K past 4096, rows that are not
# whole rows of the merged grid
REFUSED = [(392, 4 * 12, 32, 14), (392, 1536, 776, 14),
           (392, 8192, 4096, 14), (390, 1536, 768, 14)]


@pytest.mark.parametrize("M,K,O,Wh", REFUSED)
def test_plan_refuses_shapes_outside_the_kernel(M, K, O, Wh):
    msg = (f"patch merge backward kernel: needs C % 8 == 0 and K = 4C <= "
           f"4096 ({K}), O % 16 == 0 ({O}) and whole rows of Wh = {Wh} "
           f"merged tokens ({M} rows)")
    with pytest.raises(ValueError) as err:
        ln_lora.merge_bwd_plan(M, K, O, Wh, SMS)
    assert str(err.value) == msg


def _merge_inputs(seed=0, L=3, H=14, W=14, C=8):
    rng = np.random.RandomState(seed)
    x = (rng.randn(L, H * W, C) + 0.3).astype(np.float32)
    gamma = rng.uniform(0.8, 1.2, 4 * C).astype(np.float32)
    beta = (0.1 * rng.randn(4 * C)).astype(np.float32)
    w = (rng.randn(4 * C, 2 * C) / np.sqrt(4 * C)).astype(np.float32)
    gy = rng.randn(L, H * W // 4, 2 * C).astype(np.float32)
    return x, gamma, beta, w, gy


def _port_args(x, gamma, beta, w, gy):
    return ([torch.from_numpy(np.array(a)) for a in (x, gamma, beta, w.T)],
            torch.from_numpy(gy))


@pytest.mark.parametrize("H,W", [(13, 14), (14, 13)])
def test_kernel_route_refuses_odd_h_or_w(H, W):
    x, gamma, beta, w, gy = _merge_inputs(H=14, W=14)
    args, tgy = _port_args(x, gamma, beta, w, gy)
    args[0] = torch.zeros(3, H * W, 8)
    with pytest.raises(ValueError, match=f"even H \\({H}\\), W \\({W}\\)"):
        ln_lora.merge_ln_bwd_kernel(*args, H, W, tgy)


def test_kernel_route_refuses_a_cpu_tensor():
    """The plain version runs only through ``merge_ln_bwd``'s CPU branch;
    the kernel route itself raises."""
    args, gy = _port_args(*_merge_inputs())
    with pytest.raises(ValueError, match="patch merge: no kernel for cpu"):
        ln_lora.merge_ln_bwd_kernel(*args, 14, 14, gy)


# ---------------------------------------------------------------------------
# The plain split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W", [(14, 14), (16, 8)])
def test_rows_then_weights_is_the_plain_backward(dtype, H, W):
    """The composition, with the bf16(ln) rows in the compute dtype as the
    kernel stores them, is ``merge_ln_bwd_plain`` bit for bit; the rows
    have the kernel's shape and dtype."""
    args, gy = _port_args(*_merge_inputs(seed=3, H=H, W=W))
    args, gy = [a.to(dtype) for a in args], gy.to(dtype)
    rows = merge_ln_bwd_rows_plain(*args, H, W, gy)
    M, K = 3 * (H // 2) * (W // 2), args[1].shape[0]
    assert (tuple(rows[3].shape), rows[3].dtype) == ((M, K), dtype)
    got = rows[:3] + (merge_ln_bwd_weights_plain(rows[3], gy),)
    want = merge_ln_bwd_plain(*args, H, W, gy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_split_matches_the_jax_kernel_at_an_odd_wh():
    """The ``train_w`` VJP of the interpret-mode kernel at H = W = 14 (Wh =
    7, odd), L = 3: 147 merged rows, which no 32- or 64-row block of the
    kernel divides."""
    x, gamma, beta, w, gy = _merge_inputs(seed=4)
    L, HW, C = x.shape
    H = W = 14
    R, Wh = L * H // 2, W // 2
    assert Wh % 2 and (L * Wh * Wh) % 32

    def f(x, g, be, k):
        y = jax_merge(x.reshape(R, 2, Wh, 2 * C), g, be, k, True, True)
        return y.reshape(L, Wh * Wh, 2 * C)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (x, gamma, beta, w)))
    refs = vjp(jnp.asarray(gy))
    args, tgy = _port_args(x, gamma, beta, w, gy)
    rows = merge_ln_bwd_rows_plain(*args, H, W, tgy)
    got = rows[:3] + (merge_ln_bwd_weights_plain(rows[3], tgy),)
    for a, ref, tr in zip(got, refs, (False, False, False, True)):
        ref = np.asarray(ref, np.float32)
        ref = ref.T if tr else ref
        np.testing.assert_allclose(a.detach().float().numpy(), ref, rtol=0,
                                   atol=REL * np.abs(ref).max())


def test_profile_class_names_the_row_kernel():
    from mtlora_tpu_torch.train.profile import classify

    pre = "void (anonymous namespace)::"
    for inst in ("<64, 3>", "<32, 6>", "<32, 8>"):
        assert classify(f"{pre}patch_merge_bwd_rows{inst}(Params)") == (
            "patch merge kernel 3b (bwd rows)")
    # 6b's row kernel keeps its own class
    assert classify(f"{pre}task_merge_bwd_rows<2>(Params)") == (
        "task-merge kernel 6b (bwd rows)")
