"""Kernel 5 (the adapter MLP-tail forward): its launch plan
``ops/adapter_mlp.py:fwd_plan``, the plan's constants against the CUDA
source, the wrapper's refusals, and a torch emulation of the kernel's
arithmetic (``csrc/adapter_mlp_fwd.cu``).

The emulation follows the kernel's decomposition: chunks of ``cols``
columns, each walked in pairs of n8 tiles with the columns of a pair
permuted as the kernel reads p1; the rank products with task t's (task,
rank) entries masked out of one 16-deep operand, z and bf16(h) formed per
task, the projection summed over a warp's pairs in order (tasks 0-1 and
2-3 sharing an accumulator, each task's columns its own), then over the
chunks in order. A warp owns whole 16-row steps, so the steps need no
sum across warps; their walk (step s of a chunk to warp (s / stripes) %
warps of block s % stripes) is checked to cover every step once. The
emulation is held to ``adapter_mid_plain`` on the CPU in bf16 (the
kernel's only dtype): both round h to bf16 at the same point and the
result once, and the fp32 sums differ in order only, which can flip the
last bit of a bf16 h; so mid2T lies within 2^-6 of its largest element.
At T = 3 with ranks (4, 2, 3) the emulation is also held to the JAX
``fused_adapter_mid`` in interpret mode (the tanh form in bf16 as the JAX
kernel takes it), within 2^-6 of the largest element.
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
    FWD_MAX_COLS,
    FWD_MAX_H4,
    FWD_PER_SM,
    FWD_STG,
    FWD_WARPS,
    MAX_TASKS,
    RANK,
    adapter_mid_fwd,
    adapter_mid_plain,
    fwd_plan,
    fwd_smem,
)
from mtlora_tpu_torch.ops.ln_lora import SM_SMEM, SMEM_LIMIT, act_pair

torch.set_num_threads(2)
SMS = 132
SRC = (_build.CSRC / "adapter_mlp_fwd.cu").read_text()
HDR = (_build.CSRC / "adapter_mlp.cuh").read_text()
BF16_REL = 2.0 ** -6


def _stages(embed, batch, res0=112):
    """(M, H4) of the four stage-tail MLPs."""
    return [(batch * (res0 >> s) ** 2, 4 * embed * 2 ** s) for s in range(4)]


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

# (M, H4) -> (cols, chunks, stripes) at T = 4 on 132 SMs: the flagship's
# four stages at batch 32 and batch 2, path B's (224 px) at batch 8 and 32
PINNED = {
    (401408, 384): (384, 1, 264), (100352, 768): (384, 2, 132),
    (25088, 1536): (384, 4, 66), (6272, 3072): (384, 8, 33),
    (25088, 384): (384, 1, 264), (6272, 768): (384, 2, 132),
    (1568, 1536): (384, 4, 66), (392, 3072): (384, 8, 25),
    (100352, 384): (384, 1, 264), (25088, 768): (384, 2, 132),
    (6272, 1536): (384, 4, 66), (1568, 3072): (384, 8, 33),
}
PATH_B = _stages(96, 8, 56) + _stages(96, 32, 56)


def test_the_pinned_shapes_are_the_flagship_and_path_b_stages():
    assert set(PINNED) == set(_stages(96, 32) + _stages(96, 2) + PATH_B)


@pytest.mark.parametrize("M,H4", sorted(PINNED))
def test_plan_is_pinned_at_the_flagship_and_path_b(M, H4):
    p = fwd_plan(M, H4, 4, SMS)
    assert (p.cols, p.chunks, p.stripes) == PINNED[(M, H4)]
    assert p.per_sm == FWD_PER_SM and p.smem == fwd_smem()


def _check_rules(p, M, H4, T, sms=SMS):
    """Shared memory within a block's and the SM's; every column covered
    once in whole pairs; the steps spread, none past the rows; the
    partial buffer sized for the chunks the kernel writes."""
    assert p.smem <= SMEM_LIMIT
    assert FWD_PER_SM * (p.smem + 1024) <= SM_SMEM
    # the chunks cover [0, H4) once, in whole pairs, none empty
    assert p.cols % 16 == 0 and 16 <= p.cols <= FWD_MAX_COLS
    assert p.chunks == -(-H4 // p.cols) and (p.chunks - 1) * p.cols < H4
    assert p.chunks == -(-H4 // FWD_MAX_COLS)   # the fewest chunks
    # the last chunk falls short of the others by less than a pair a chunk
    assert p.cols - (H4 - (p.chunks - 1) * p.cols) < 16 * p.chunks
    assert p.steps == -(-M // 16)
    assert 1 <= p.stripes <= p.steps
    assert p.blocks == p.chunks * p.stripes
    assert p.blocks <= max(FWD_PER_SM * sms, p.chunks)
    assert p.part == (p.chunks * T * RANK * M if p.chunks > 1 else 0)


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
        _check_rules(fwd_plan(M, H4, T, SMS), M, H4, T)


@pytest.mark.parametrize("M,H4", [(1, 64), (7, 4096), (389, 768),
                                  (392, 3072), (6272, 4096), (401408, 4096)])
@pytest.mark.parametrize("sms", [1, 78, 132])
def test_plan_rules_at_edges(M, H4, sms):
    for T in range(1, MAX_TASKS + 1):
        _check_rules(fwd_plan(M, H4, T, sms), M, H4, T, sms)


@pytest.mark.parametrize("M,H4,sms", [(6272, 3072, 132), (1568, 3072, 132),
                                      (392, 3072, 132), (25088, 1536, 132),
                                      (389, 768, 3), (100, 4096, 1)])
def test_the_walk_covers_every_step_once(M, H4, sms):
    """Step s of a chunk goes to warp (s / stripes) % warps of block s %
    stripes, and each warp walks its steps V = stripes * warps apart from
    its first, warp * stripes + block: every step once, and no block
    carries more than one step beyond another's."""
    p = fwd_plan(M, H4, 4, sms)
    V = p.stripes * FWD_WARPS
    seen, per_block = [], [0] * p.stripes
    for b in range(p.stripes):
        for w in range(FWD_WARPS):
            got = list(range(w * p.stripes + b, p.steps, V))
            assert all((s // p.stripes) % FWD_WARPS == w
                       and s % p.stripes == b for s in got)
            seen += got
            per_block[b] += len(got)
    assert sorted(seen) == list(range(p.steps))
    assert max(per_block) - min(per_block) <= 1
    assert "int st = warp * a.stripes + blockIdx.x;" in SRC
    assert "const int steps = (M + 15) / 16, V = a.stripes * kWarps;" in SRC
    assert "for (; st < steps; st += V) {" in SRC


@pytest.mark.parametrize("T,H4,bound", [
    (5, 384, "T <= 4"), (0, 384, "T <= 4"), (4, 400, "H4 % 64 == 0"),
    (4, 4160, "up to 4096"), (4, 32, "H4 % 64 == 0")])
def test_plan_refuses_what_the_kernel_does_not_take(T, H4, bound):
    with pytest.raises(ValueError, match=re.escape(bound)):
        fwd_plan(64, H4, T, SMS)


def test_the_kernel_route_refuses_rank_8_five_tasks_and_cpu_tensors():
    """A CPU tensor on the kernel route, rank 8 and five tasks raise, each
    naming its bound (the wrapper takes the plain version only through
    :func:`adapter_mid_fwd` on a CPU tensor)."""
    def args(T, r, M=32, H4=64):
        z = torch.zeros
        return (z(T, r, M, dtype=torch.bfloat16),
                z(M, H4, dtype=torch.bfloat16),
                z(T, r, H4, dtype=torch.bfloat16),
                z(T, r, H4, dtype=torch.bfloat16), (1.0,) * T)

    launch = adapter_mlp._launch_fwd
    with pytest.raises(ValueError, match="no kernel for cpu"):
        launch(*args(4, 4))
    for T, r, H4 in ((4, 8, 64), (5, 4, 64), (4, 4, 96)):
        with pytest.raises(ValueError, match=re.escape(
                "needs at most 4 tasks of rank 4 and 4C % 64 == 0")):
            launch(*args(T, r, H4=H4))
    # CPU tensors through the public wrapper take the plain version
    assert tuple(adapter_mid_fwd(*args(3, 4)).shape) == (3, 4, 32)


def test_plan_constants_match_the_cuda_source():
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)", SRC)[1])

    assert const("kWarps") == FWD_WARPS
    assert const("kPerSm") == FWD_PER_SM
    assert const("kMaxCols") == FWD_MAX_COLS
    assert const("kMaxH4") == FWD_MAX_H4
    assert "constexpr int kStg = 16 + 4;" in SRC and FWD_STG == 16 + 4
    assert "__launch_bounds__(kThreads, kPerSm)" in SRC
    # the shared-memory layout the plan sizes, and the trap on it
    assert ("return 2 * kMaxCols * kTR * 2 + kWarps * kTR * kStg * 4;"
            in SRC)
    assert "fwd_smem_bytes() > (int)dynamic_smem_bytes()" in SRC
    assert fwd_smem() == (2 * FWD_MAX_COLS * MAX_TASKS * RANK * 2
                          + FWD_WARPS * MAX_TASKS * RANK * FWD_STG * 4)
    # the entry's refusals and the partials' layout
    assert "H4 % 64 || H4 > kMaxH4" in SRC
    assert "cols % 16 || cols > kMaxCols" in SRC
    assert "chunks != (H4 + cols - 1) / cols" in SRC
    assert "a.part + ((size_t)chunk * T * R + tr) * M + m" in SRC
    # kernel 5's entry is its own; the first port's serves the probes at
    # T = 4 only
    probe = (_build.CSRC / "adapter_mlp.cu").read_text()
    assert "if (T != kMaxT || M < 1 || H4 < 64 || H4 % 64)" in probe
    assert "adapter_mid_fwd_kernel<1," not in probe


def test_the_shared_pieces_live_in_the_header():
    """wt_off, load_p, the weight staging and the chunk sum are defined
    once, in ``adapter_mlp.cuh``, and both tensor-core kernels use them."""
    bwd = (_build.CSRC / "adapter_mlp_bwd.cu").read_text()
    for name in ("int wt_off(", "void load_p(", "void stage_weight_tiles(",
                 "float chunk_sum(", "uint32_t pack_bf16(",
                 "uint32_t of_half("):
        assert name in HDR and name not in SRC and name not in bwd, name
    for src in (SRC, bwd):
        assert "stage_weight_tiles<T>(" in src and "chunk_sum(" in src


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------

# logical column c of n8 tile j of a pair -> its column in the pair
PAIR_COLS = torch.tensor([4 * (c // 2) + 2 * j + c % 2 for j in range(2)
                          for c in range(8)])


def _bf(x):
    return x.to(torch.bfloat16).float()


def emulate_fwd(mid1T, p1, b1, a2T, scales, plan):
    """mid2T as kernel 5 forms it under ``plan``; bf16 inputs, fp32
    arithmetic, bf16 where the kernel rounds. A row's sums do not depend
    on which warp walks its step, so every row of a chunk is formed at
    once."""
    f = torch.float32
    T, R, M = mid1T.shape
    H4, TR = p1.shape[1], MAX_TASKS * RANK
    mid = torch.zeros(M, TR)
    mid[:, :T * R] = mid1T.float().reshape(T * R, M).t()
    wb = torch.zeros(TR, H4)
    wb[:T * R] = b1.float().reshape(T * R, H4)
    wa = torch.zeros(TR, H4)
    wa[:T * R] = a2T.float().reshape(T * R, H4)
    masks = [torch.tensor([1.0 if tr // R == t else 0.0 for tr in range(TR)],
                          dtype=f) for t in range(T)]
    p1f = p1.float()
    parts = torch.zeros(plan.chunks, M, TR)
    for chunk in range(plan.chunks):
        c0 = chunk * plan.cols
        mo = [torch.zeros(M, TR), torch.zeros(M, TR)]   # tasks 0-1, 2-3
        for pp in range(min(plan.cols, H4 - c0) // 16):
            cols = c0 + 16 * pp + PAIR_COLS   # logical -> device column
            p = p1f[:, cols]
            for t, mk in enumerate(masks):
                u = (mid * mk) @ wb[:, cols]
                h = _bf(act_pair(p + float(scales[t]) * u, "tanh")[0])
                mo[t // 2] += h @ (wa[:, cols] * mk[:, None]).t()
        parts[chunk] = mo[0] + mo[1]   # disjoint columns: exact
    out = parts[0]
    for c in range(1, plan.chunks):
        out = out + parts[c]
    return out[:, :T * R].t().reshape(T, R, M).to(torch.bfloat16)


def _inputs(seed, T, M, H4, ranks=None):
    """bf16 operands from numpy; a task of rank below 4 zero-padded in
    mid1T and A2T, as the layers pad it."""
    rng = np.random.RandomState(seed)
    ranks = ranks or (RANK,) * T
    live = (np.arange(RANK)[None, :] < np.asarray(ranks)[:, None])
    arrays = (0.5 * rng.randn(T, RANK, M) * live[..., None],
              rng.randn(M, H4), 0.1 * rng.randn(T, RANK, H4),
              H4 ** -0.5 * rng.randn(T, RANK, H4) * live[..., None])
    return [torch.from_numpy(a.astype(np.float32)).bfloat16()
            for a in arrays]


def _held(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    d = (got.float() - want.float()).abs().max().item()
    assert d <= BF16_REL * want.float().abs().max().item(), d


# (T, H4, M): each stage's H4 with ragged rows (one chunk at 384, two,
# four and eight at 768, 1536 and 3072); one task and three; Swin-B's
# widest hidden in eleven chunks, the last of 256 columns
EMULATED = [(4, 384, 3 * 16 + 5), (4, 768, 2 * 16 + 7), (4, 1536, 40),
            (4, 3072, 19), (1, 384, 33), (3, 768, 16), (2, 4096, 24),
            (3, 1536, 9)]


@pytest.mark.parametrize("T,H4,M", EMULATED)
def test_emulation_matches_the_plain_forward(T, H4, M):
    mid1T, p1, b1, a2T = _inputs(T * 1000 + H4, T, M, H4)
    scales = (4.0, 2.0, 1.0, 0.5)[:T]
    plan = fwd_plan(M, H4, T, SMS)
    assert plan.chunks == -(-H4 // FWD_MAX_COLS)
    _held(emulate_fwd(mid1T, p1, b1, a2T, scales, plan),
          adapter_mid_plain(mid1T, p1, b1, a2T, scales))


def test_pair_columns_are_a_permutation_with_adjacent_lane_values():
    """The kernel's column order: a lane (q) holds logical columns 2q,
    2q + 1 of both tiles, which are the pair's columns 4q .. 4q + 3."""
    assert sorted(PAIR_COLS.tolist()) == list(range(16))
    for q in range(4):
        lane = [PAIR_COLS[8 * j + 2 * q + e].item() for j in range(2)
                for e in range(2)]
        assert lane == [4 * q, 4 * q + 1, 4 * q + 2, 4 * q + 3]
    assert "4 (c / 2) + 2 j + c % 2" in HDR


def test_emulation_matches_the_jax_forward_at_lower_ranks():
    """T = 3, ranks (4, 2, 3): the emulation against the JAX kernel in
    interpret mode, from the same bf16 inputs."""
    T, M, H4, scales = 3, 96, 1536, (4.0, 2.0, 1.0)
    mid1T, p1, b1, a2T = _inputs(7, T, M, H4, ranks=(4, 2, 3))
    j = [jnp.asarray(t.float().numpy(), jnp.bfloat16)
         for t in (mid1T, p1, b1, a2T)]
    ref = torch.from_numpy(np.array(
        fused_adapter_mid(*j, scales, True).astype(jnp.float32)))
    plan = fwd_plan(M, H4, T, SMS)
    assert plan.chunks == 4
    got = emulate_fwd(mid1T, p1, b1, a2T, scales, plan)
    d = (got.float() - ref).abs().max().item()
    assert d <= BF16_REL * ref.abs().max().item()
    # the padded ranks' rows of the result are zero, as their rows of A2T
    assert got[1, 2:].abs().max() == 0 and got[2, 3:].abs().max() == 0


def test_profile_class_names_the_kernel_and_its_chunk_sum():
    """train/profile.py classes kernel 5's symbol and its chunk sum under
    kernel 5's class, and 5b's chunk sum under 5b's, not the other way."""
    from mtlora_tpu_torch.train.profile import classify

    pre = "void (anonymous namespace)::"
    fwd = "adapter MLP-tail kernel 5 (fwd)"
    bwd = "adapter MLP-tail kernel 5b (fused bwd, dmid1 chunk sums)"
    for T in (1, 4):
        assert classify(f"{pre}adapter_mid_fwd_fused<{T}>(FwdParams)") == fwd
    assert classify(f"{pre}mid2_sum_kernel(float const*, int, unsigned "
                    f"long, __nv_bfloat16*)") == fwd
    assert classify(f"{pre}dmid_sum_kernel(float const*, int, int, int, "
                    f"BwdParams)") == bwd
    assert "adapter_mid_fwd_fused" in SRC and "mid2_sum_kernel" in SRC


SASS = """
        Function : _Z3fooPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   FFMA R2, R3, R4, R5 ;
        /*0020*/                   MUFU.EX2 R2, R2 ;
        /*0030*/              @!P0 BRA 0x10 ;
        /*0040*/                   EXIT ;
        /*0050*/                   BRA 0x50;
        Function : _Z3barPf
        /*0000*/                   FMUL R2, R3, R4 ;
        /*0010*/               @P1 BRA 0x0 ;
"""


def test_sass_loops_counts_a_loop_by_opcode():
    """``tools/sass_loops.py`` reads a backward branch as a loop from its
    target to itself (not the branch to itself at a function's end), in
    the functions whose name holds the kernel's, by opcode."""
    from mtlora_tpu_torch.tools.sass_loops import loops

    got = loops(SASS, "foo")
    assert got == [{"kernel": "_Z3fooPf", "start": "0x10", "end": "0x30",
                    "instructions": 3,
                    "opcodes": {"FFMA": 1, "MUFU": 1, "BRA": 1}}]
    assert [r["kernel"] for r in loops(SASS, "Pf")] == ["_Z3fooPf",
                                                       "_Z3barPf"]
