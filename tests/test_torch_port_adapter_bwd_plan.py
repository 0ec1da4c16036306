"""Kernel 5b (the adapter MLP-tail backward): its launch plan
``ops/adapter_mlp.py:bwd_plan``, the plan's constants against the CUDA
source, the wrapper's refusals, and a torch emulation of the fused pass's
arithmetic (``csrc/adapter_mlp_bwd.cu``).

The emulation follows the kernel's decomposition: blocks of a column chunk
and a row stripe, warps of ``BWD_PAIRS`` pairs of n8 tiles with the columns of
a pair permuted as the kernel reads p1, the rank products with task t's
(task, rank) entries masked out of one 16-deep operand, dz and bf16(h)
formed per task, dp1 summed in task order, dmid1 summed over a warp's
pairs, then over the warps in order, then over the chunks in order, dB1
and dA2T summed over a stripe's rows and then over the stripes in order.
It is held to ``adapter_mid_bwd_plain`` on the CPU in bf16 (the kernel's
only dtype): both round dz and h to bf16 at the same points, and the fp32
sums differ in order only, which can flip the last bit of a bf16 dz. So
dmid1T and dp1 lie within 2^-6 of their largest element (a flipped last
bit of a sum of up to four dz), dB1 and dA2T within 1e-4 relative RMS and
2^-8 of their largest element. At T = 3 with ranks (4, 2, 3) the
emulation is also held to the JAX ``fused_adapter_mid`` VJP in interpret
mode (the tanh form in bf16 as the JAX kernel takes it; its dB1 and dA2T
are rounded to bf16), every output within 2^-6 of its largest element.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlora_tpu.config import load_config
from mtlora_tpu.ops.pallas_adapter_mlp import fused_adapter_mid
from mtlora_tpu_torch.ops import _build, adapter_mlp
from mtlora_tpu_torch.ops.adapter_mlp import (
    BWD_MAX_H4,
    BWD_PAIRS,
    BWD_PER_SM,
    BWD_ROWS,
    BWD_WARPS,
    MAX_TASKS,
    RANK,
    adapter_mid_bwd,
    adapter_mid_bwd_plain,
    bwd_plan,
    bwd_smem,
)
from mtlora_tpu_torch.ops.ln_lora import SM_SMEM, SMEM_LIMIT, act_pair

torch.set_num_threads(2)
SMS = 132
SRC = (_build.CSRC / "adapter_mlp_bwd.cu").read_text()
BF16_REL = 2.0 ** -6
FP32_RMS = 1e-4
FP32_TOP = 2.0 ** -8


def _stages(embed, batch, res0=112):
    """(M, H4) of the four stage-tail MLPs."""
    return [(batch * (res0 >> s) ** 2, 4 * embed * 2 ** s) for s in range(4)]


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

# (M, H4) -> (chunks, stripes, tps) at T = 4 on 132 SMs: the
# flagship's four stages at batch 32 and batch 2, path B's (224 px) at
# batch 8 and 32
PINNED = {
    (401408, 384): (1, 262, 24), (100352, 768): (2, 131, 12),
    (25088, 1536): (4, 66, 6), (6272, 3072): (8, 33, 3),
    (25088, 384): (1, 196, 2), (6272, 768): (2, 98, 1),
    (1568, 1536): (4, 25, 1), (392, 3072): (8, 7, 1),
    (100352, 384): (1, 262, 6), (25088, 768): (2, 131, 3),
    (6272, 1536): (4, 49, 2), (1568, 3072): (8, 25, 1),
}
PATH_B = _stages(96, 8, 56) + _stages(96, 32, 56)


def test_the_pinned_shapes_are_the_flagship_and_path_b_stages():
    assert set(PINNED) == set(_stages(96, 32) + _stages(96, 2) + PATH_B)


@pytest.mark.parametrize("M,H4", sorted(PINNED))
def test_plan_is_pinned_at_the_flagship_and_path_b(M, H4):
    p = bwd_plan(M, H4, 4, SMS)
    assert (p.chunks, p.stripes, p.tps) == PINNED[(M, H4)]
    assert p.per_sm == BWD_PER_SM and p.smem == bwd_smem()


def _check_rules(p, M, H4, T):
    """Shared memory within a block's; every row and column covered once;
    the partial buffers sized for the sums the kernel writes."""
    assert p.smem <= SMEM_LIMIT
    assert p.cols == BWD_WARPS * 16 * BWD_PAIRS
    # BWD_PER_SM blocks an SM, each with 1 KB of the SM's shared memory
    # reserved
    assert BWD_PER_SM * (p.smem + 1024) <= SM_SMEM
    # the chunks cover [0, H4) once: whole pairs, the last chunk's pairs
    # past H4 skipped
    assert p.chunks == -(-H4 // p.cols) and (p.chunks - 1) * p.cols < H4
    assert H4 % 16 == 0
    # the stripes cover the row tiles once, none empty
    assert p.tiles == -(-M // BWD_ROWS)
    assert (p.stripes - 1) * p.tps < p.tiles <= p.stripes * p.tps
    assert p.blocks == p.chunks * p.stripes
    assert p.blocks <= max(p.per_sm * SMS, p.chunks)
    want = p.stripes * 2 * T * RANK * H4
    if p.chunks > 1:
        want += p.chunks * T * RANK * M
    assert p.part == want


YAMLS = sorted((Path(__file__).resolve().parents[1] / "configs" / "mtlora")
               .rglob("mtlora_*.yaml"))


def test_the_yamls_give_the_widths_the_plan_is_held_to():
    """Every YAML's stage-tail MLPs (Swin-T and -S: embed 96; Swin-B: 128),
    at 448 px."""
    got = set()
    for path in YAMLS:
        cfg = load_config(str(path))
        res0 = cfg.DATA.IMG_SIZE // cfg.MODEL.SWIN.PATCH_SIZE
        got |= {(res0 >> s, 4 * cfg.MODEL.SWIN.EMBED_DIM * 2 ** s)
                for s in range(len(cfg.MODEL.SWIN.DEPTHS))}
    assert got == {(112 >> s, 4 * e * 2 ** s) for e in (96, 128)
                   for s in range(4)}


@pytest.mark.parametrize("embed", [96, 128])
@pytest.mark.parametrize("T", [1, 2, 3, 4])
@pytest.mark.parametrize("batch", [1, 2, 8, 32])
def test_plan_rules_at_every_width_and_task_count(embed, T, batch):
    for M, H4 in _stages(embed, batch) + _stages(embed, batch, 56):
        _check_rules(bwd_plan(M, H4, T, SMS), M, H4, T)


@pytest.mark.parametrize("M,H4", [(1, 64), (7, 4096), (389, 768),
                                  (6272, 4096), (401408, 4096)])
@pytest.mark.parametrize("sms", [1, 78, 132])
def test_plan_rules_at_edges(M, H4, sms):
    for T in range(1, MAX_TASKS + 1):
        p = bwd_plan(M, H4, T, sms)
        assert p.smem <= SMEM_LIMIT
        assert (p.stripes - 1) * p.tps < p.tiles <= p.stripes * p.tps


@pytest.mark.parametrize("T,H4,bound", [
    (5, 384, "T <= 4"), (0, 384, "T <= 4"), (4, 400, "H4 % 64 == 0"),
    (4, 4160, "up to 4096"), (4, 32, "H4 % 64 == 0")])
def test_plan_refuses_what_the_kernel_does_not_take(T, H4, bound):
    with pytest.raises(ValueError, match=re.escape(bound)):
        bwd_plan(64, H4, T, SMS)


def test_the_kernel_route_refuses_rank_8_five_tasks_and_cpu_tensors():
    """A CPU tensor on the kernel route, rank 8 and five tasks raise, each
    naming its bound (the wrapper takes the plain version only through
    :func:`adapter_mid_bwd` on a CPU tensor)."""
    def args(T, r, M=32, H4=64):
        z = torch.zeros
        return (z(T, r, M, dtype=torch.bfloat16),
                z(M, H4, dtype=torch.bfloat16),
                z(T, r, H4, dtype=torch.bfloat16),
                z(T, r, H4, dtype=torch.bfloat16), (1.0,) * T,
                z(T, r, M, dtype=torch.bfloat16))

    launch = adapter_mlp._launch_bwd
    with pytest.raises(ValueError, match="no kernel for cpu"):
        launch("5b", adapter_mlp.KERNEL5B_ACT, *args(4, 4))
    for T, r, H4 in ((4, 8, 64), (5, 4, 64), (4, 4, 96)):
        with pytest.raises(ValueError, match=re.escape(
                "needs at most 4 tasks of rank 4 and 4C % 64 == 0")):
            launch("5b", adapter_mlp.KERNEL5B_ACT, *args(T, r, H4=H4))
    # CPU tensors through the public wrapper take the plain version
    out = adapter_mid_bwd(*args(3, 4))
    assert [tuple(o.shape) for o in out] == [(3, 4, 32), (32, 64), (3, 4, 64),
                                            (3, 4, 64)]


def test_plan_constants_match_the_cuda_source():
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", SRC)[1])

    assert const("kWarps") == BWD_WARPS
    assert const("kPerSm") == BWD_PER_SM
    assert const("kMaxH4") == BWD_MAX_H4
    assert const("kPairs") == BWD_PAIRS
    assert const("kRows") == BWD_ROWS
    assert "__launch_bounds__(kThreads, kPerSm)" in SRC
    # the shared-memory layout the plan sizes, and the trap on it
    assert ("return 2 * kWarps * 16 * kPairs * kTR * 2 + 2 * kTR * "
            "(kRows + 8) * 2 +\n         kWarps * kTR * kRows * 4 + kWarps * "
            "kPairs * 4 * 32 * 16;") in SRC
    assert "bwd_smem_bytes() > (int)dynamic_smem_bytes()" in SRC
    tr = MAX_TASKS * RANK
    assert bwd_smem() == (
        2 * BWD_WARPS * 16 * BWD_PAIRS * tr * 2
        + 2 * tr * (BWD_ROWS + 8) * 2 + BWD_WARPS * tr * BWD_ROWS * 4
        + BWD_WARPS * BWD_PAIRS * 4 * 32 * 16)
    # the entry's refusals and the partials' layout
    assert "H4 % 64 || H4 > kMaxH4" in SRC
    assert "constexpr int kCols = kWarps * 16 * kPairs;" in SRC
    assert "chunks != (H4 + kCols - 1) / kCols" in SRC
    assert "(long long)stripes * tps < tiles" in SRC
    assert "a.dmid_part = a.part + (size_t)stripes * 2 * T * R * H4;" in SRC
    # one fused body: the row and weight kernels of the first port are gone
    assert "adapter_mid_bwd_rows" not in SRC
    assert "adapter_mid_bwd_weights" not in SRC
    assert "weight_stripes" not in Path(adapter_mlp.__file__).read_text()


# ---------------------------------------------------------------------------
# The emulation of the fused pass
# ---------------------------------------------------------------------------

# logical column c of n8 tile j of a pair -> its column in the pair
PAIR_COLS = torch.tensor([4 * (c // 2) + 2 * j + c % 2 for j in range(2)
                          for c in range(8)])


def _bf(x):
    return x.to(torch.bfloat16).float()


def emulate_bwd(mid1T, p1, b1, a2T, scales, g, plan, warps=BWD_WARPS):
    """(dmid1T, dp1, dB1, dA2T) as the fused kernel forms them under
    ``plan``; bf16 inputs, fp32 arithmetic, bf16 where the kernel
    rounds."""
    f = torch.float32
    T, R, M = mid1T.shape
    H4, TR = p1.shape[1], MAX_TASKS * RANK
    mid = torch.zeros(M, TR)
    mid[:, :T * R] = mid1T.float().reshape(T * R, M).t()
    gg = torch.zeros(M, TR)
    gg[:, :T * R] = g.float().reshape(T * R, M).t()
    wb = torch.zeros(TR, H4)
    wb[:T * R] = b1.float().reshape(T * R, H4)
    wa = torch.zeros(TR, H4)
    wa[:T * R] = a2T.float().reshape(T * R, H4)
    st = torch.tensor([float(scales[tr // R]) if tr < T * R else 0.0
                       for tr in range(TR)], dtype=f)
    masks = [torch.tensor([1.0 if tr // R == t else 0.0 for tr in range(TR)])
             for t in range(T)]
    p1f = p1.float()
    dp1 = torch.zeros(M, H4)
    dmid_chunks = torch.zeros(plan.chunks, TR, M)
    part = torch.zeros(plan.stripes, 2, TR, H4)
    for chunk in range(plan.chunks):
        for stripe in range(plan.stripes):
            accb = torch.zeros(TR, H4)
            acca = torch.zeros(TR, H4)
            t0 = stripe * plan.tps
            for tile in range(t0, min(plan.tiles, t0 + plan.tps)):
                rows = torch.arange(tile * BWD_ROWS,
                                    min(M, (tile + 1) * BWD_ROWS))
                red = torch.zeros(warps, TR, len(rows))
                for w in range(warps):
                    for pp in range(BWD_PAIRS):
                        h0 = chunk * plan.cols + (w * BWD_PAIRS + pp) * 16
                        if h0 >= H4:
                            continue
                        cols = h0 + PAIR_COLS     # logical -> device column
                        p = p1f[rows][:, cols]
                        bb, ba = wb[:, cols], wa[:, cols]
                        dp = None
                        for t, mk in enumerate(masks):
                            u = (mid[rows] * mk) @ bb
                            dh = (gg[rows] * mk) @ ba
                            h, dg = act_pair(p + float(scales[t]) * u,
                                             "tanh")
                            dz = _bf(dh * dg)
                            dp = dz if dp is None else dp + dz
                            red[w] += (dz @ (bb * mk[:, None]).t()).t()
                            accb[:, cols] += (mid[rows] * mk).t() @ dz
                            acca[:, cols] += (gg[rows] * mk).t() @ _bf(h)
                        dp1[rows[:, None], cols[None, :]] = _bf(dp)
                dm = red[0]
                for w in range(1, warps):
                    dm = dm + red[w]
                dmid_chunks[chunk][:, rows] = dm
            part[stripe, 0] += st[:, None] * accb
            part[stripe, 1] += acca
    dmid = dmid_chunks[0]
    for c in range(1, plan.chunks):
        dmid = dmid + dmid_chunks[c]
    dw = part[0]
    for s in range(1, plan.stripes):
        dw = dw + part[s]
    dmid1 = (st[:, None] * dmid)[:T * R].reshape(T, R, M)
    return (dmid1.to(torch.bfloat16), dp1.to(torch.bfloat16),
            dw[0, :T * R].reshape(T, R, H4), dw[1, :T * R].reshape(T, R, H4))


def _inputs(seed, T, M, H4, ranks=None):
    """bf16 operands from numpy; a task of rank below 4 zero-padded in
    mid1T and A2T, as the layers pad it."""
    rng = np.random.RandomState(seed)
    ranks = ranks or (RANK,) * T
    live = (np.arange(RANK)[None, :] < np.asarray(ranks)[:, None])
    arrays = (0.5 * rng.randn(T, RANK, M) * live[..., None],
              rng.randn(M, H4), 0.1 * rng.randn(T, RANK, H4),
              H4 ** -0.5 * rng.randn(T, RANK, H4) * live[..., None],
              rng.randn(T, RANK, M))
    return [torch.from_numpy(a.astype(np.float32)).bfloat16()
            for a in arrays]


def _held(got, want, names=("dmid1T", "dp1", "dB1", "dA2T")):
    for i, (name, a, b) in enumerate(zip(names, got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        d = (a.float() - b.float())
        top = b.float().abs().max().item()
        if i < 2:
            assert d.abs().max().item() <= BF16_REL * top, name
        else:
            assert (d.norm() / b.float().norm()).item() <= FP32_RMS, name
            assert d.abs().max().item() <= FP32_TOP * top, name


# (T, H4, M, sms): each stage's H4 with three row tiles and a ragged tail,
# on few SMs so that the rows split into several stripes; one task and
# three; Swin-B's widest hidden
EMULATED = [(4, 384, 3 * 64 + 37, 2), (4, 768, 2 * 64 + 5, 2),
            (4, 1536, 2 * 64 + 19, 3), (4, 3072, 64 + 40, 4),
            (1, 384, 2 * 64 + 1, 2), (3, 768, 64 + 63, 1),
            (2, 4096, 40, 8)]


@pytest.mark.parametrize("T,H4,M,sms", EMULATED)
def test_emulation_matches_the_plain_backward(T, H4, M, sms):
    mid1T, p1, b1, a2T, g = _inputs(T * 1000 + H4, T, M, H4)
    scales = (4.0, 2.0, 1.0, 0.5)[:T]
    plan = bwd_plan(M, H4, T, sms)
    assert plan.tiles > 1 or plan.chunks > 1
    got = emulate_bwd(mid1T, p1, b1, a2T, scales, g, plan)
    _held(got, adapter_mid_bwd_plain(mid1T, p1, b1, a2T, scales, g))


def test_pair_columns_are_a_permutation_with_adjacent_lane_values():
    """The kernel's column order: a lane (q) holds logical columns 2q,
    2q + 1 of both tiles, which are the pair's columns 4q .. 4q + 3."""
    assert sorted(PAIR_COLS.tolist()) == list(range(16))
    for q in range(4):
        lane = [PAIR_COLS[8 * j + 2 * q + e].item() for j in range(2)
                for e in range(2)]
        assert lane == [4 * q, 4 * q + 1, 4 * q + 2, 4 * q + 3]
    assert "4 (c / 2) + 2 j + c % 2" in SRC


def test_emulation_matches_the_jax_vjp_at_lower_ranks():
    """T = 3, ranks (4, 2, 3): the emulation against the JAX kernel's VJP
    in interpret mode, from the same bf16 inputs."""
    T, M, H4, scales = 3, 96, 128, (4.0, 2.0, 1.0)
    mid1T, p1, b1, a2T, g = _inputs(7, T, M, H4, ranks=(4, 2, 3))
    j = [jnp.asarray(t.float().numpy(), jnp.bfloat16)
         for t in (mid1T, p1, b1, a2T, g)]
    _, vjp = jax.vjp(lambda *a: fused_adapter_mid(*a, scales, True), *j[:4])
    refs = [torch.from_numpy(np.array(r.astype(jnp.float32)))
            for r in vjp(j[4])]
    got = emulate_bwd(mid1T, p1, b1, a2T, scales, g,
                      bwd_plan(M, H4, T, 1))
    for name, a, b in zip(("dmid1T", "dp1", "dB1", "dA2T"), got, refs):
        d = (a.float() - b).abs().max().item()
        assert d <= BF16_REL * b.abs().max().item(), name
    # dB1 of the padded ranks is zero, as their rows of mid1T are
    assert got[2][1, 2:].abs().max() == 0 and got[2][2, 3:].abs().max() == 0


def test_profile_class_names_the_fused_kernel():
    """train/profile.py's class of kernel 5b is the fused pass's symbol
    (and its chunk sum), the fixed-order stripe sums the weight-gradient
    passes' class."""
    from mtlora_tpu_torch.train.profile import classify

    pre = "void (anonymous namespace)::"
    cls = "adapter MLP-tail kernel 5b (fused bwd, dmid1 chunk sums)"
    for inst in ("<4, (lnk::Act)1>", "<1, (lnk::Act)1>"):
        assert classify(f"{pre}adapter_mid_bwd_fused{inst}(BwdParams)") == cls
    assert classify(f"{pre}dmid_sum_kernel(float const*, int, int, int, "
                    f"BwdParams)") == cls
    assert classify("void lnk::sum_groups_kernel(float*, int, int, "
                    "unsigned long)").startswith("weight-gradient passes")
    assert classify(f"{pre}adapter_mid_fwd_kernel<4, (lnk::Act)1, 0>(Args)"
                    ) == "adapter MLP-tail kernel 5 (fwd)"
    assert "adapter_mid_bwd_fused" in SRC and "dmid_sum_kernel" in SRC
