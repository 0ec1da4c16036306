"""Kernel 6b (the factored per-task merge's backward) on the CPU: its launch
plan and its plain split.

The plan (``ops/task_merge.py:task_merge_bwd_plan``) at the three merges of
the batch-32 step, path B's merges at 224 px (Wh = 28, 14 and 7, odd: 49
merged rows a sample, so that 32-row blocks straddle samples), the ragged
rows of the batch-2 step, Swin-B's merges and the merge shapes of every
YAML under ``configs/mtlora/``, at T = 1, 4 and 6: rows per block, the
blocks of a cluster that split the merged rows' columns, whole or shared
runs of C, the tasks a group, the TMA ring's chunks and slots, shared
memory against the H100's 232,448 bytes a block (one block an SM),
blocks with the ragged one counted, and the
scratch the wrapper allocates (no fp32 rows [T, Mm, 4C], no dU), the
task groups and the W bytes they stream; the
constants of ``csrc/task_merge_bwd.cu`` that the plan sizes shared memory
by; the refusals of shapes outside the kernel and of a CPU tensor on the
kernel route; the profile class of the row kernel.

The plain split: ``task_merge_bwd_rows_plain`` (what the row kernel
stores: the shared gradients, the rank gradients, dgamma, dbeta and every
task's bf16(ln) rows) then ``task_merge_bwd_weights_plain`` (dW from those
rows and gy) is ``task_merge_bwd_plain``, bit for bit, in fp32 and bf16;
and the split matches the JAX VJP of ``task_merge_reference`` at an odd Wh
= 7 with rows that no block divides and blocks that straddle samples, and
of ``task_merge_down`` (the interpret-mode kernel, ``train_w``) at Wh = 8.
Tolerance: fp32, 2e-5 of each output's largest element (the order of fp32
sums).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlora_tpu.config import load_config
from mtlora_tpu.models.lora import FactoredTasks as JFactored
from mtlora_tpu.models.lora import TaskStream as JStream
from mtlora_tpu.ops.pallas_task_merge import (
    task_merge_down,
    task_merge_reference,
)
from mtlora_tpu_torch.ops import _build, ln_lora, task_merge
from mtlora_tpu_torch.ops.task_merge import (
    task_merge_bwd_plain,
    task_merge_bwd_rows_plain,
    task_merge_bwd_weights_plain,
)

torch.set_num_threads(2)
SMS = 132   # the H100's SMs
REL = 2e-5
YAMLS = sorted((Path(__file__).resolve().parents[1] / "configs" / "mtlora")
               .rglob("mtlora_*.yaml"))


def _merge(L, res, C):
    """(Mm, K, O, Wh, per_sample) of the merge of task streams [.., L,
    res^2, C]."""
    per = (res // 2) ** 2
    return L * per, 4 * C, 2 * C, res // 2, per


# the three merges of the flagship (Swin-T 448) at batch 32
FLAGSHIP = [_merge(32, 112 // 2 ** s, 96 * 2 ** s) for s in range(3)]
# the batch-2 step's merges (phase 8), 392 rows at the last
RAGGED = [_merge(2, 112 // 2 ** s, 96 * 2 ** s) for s in range(3)]
# path B at 224 px, batch 32 and 8: Wh = 28, 14 and 7
PATH_B = [_merge(L, 56 // 2 ** s, 96 * 2 ** s) for L in (32, 8)
          for s in range(3)]
# Swin-B (mtlora_base_448): C = 128, 256, 512
SWIN_B = [_merge(32, 112 // 2 ** s, 128 * 2 ** s) for s in range(3)]
SHAPES = FLAGSHIP + RAGGED + PATH_B + SWIN_B
TASKS = (1, 4, 6)


def _check_plan(plan, T, Mm, K, O):
    """What every plan holds to."""
    C = K // 4
    wn = 8 // (plan.bm // 16)
    ncs = -(-plan.ks // 64)
    assert plan.bm == task_merge.TM_BWD_ROWS == 32
    assert plan.split in task_merge.TM_BWD_SPLITS == (1, 2, 4, 8)
    # the blocks of a cluster split K; a warp's share of a slot (64 / wn
    # columns) divides a block's columns; a block holds whole runs of C or
    # an equal part of one
    assert plan.ks * plan.split == K and plan.ks % (64 // wn) == 0
    if plan.ks >= C:
        assert (plan.runs, plan.share) == (plan.ks // C, 1)
        assert plan.ks % C == 0
    else:
        assert (plan.runs, plan.share) == (1, C // plan.ks)
        assert C % plan.ks == 0 and plan.split % plan.share == 0
    # the tasks in balanced groups of an instance's TG: dln of TG tasks and
    # the three task sums at most 168 registers a thread
    assert plan.tg in task_merge.TM_BWD_INSTANCES[max(ncs, 2)]
    assert plan.groups == -(-T // plan.tg) and plan.tg <= T
    assert plan.groups * plan.tg - T < plan.groups
    assert (plan.tg + 3) * plan.bm * 64 * max(ncs, 2) // 256 <= 168
    # the TMA ring: whole chunks of the group's gy boxes (two tasks a box)
    # and the block's W slices, two chunks at least, four at most
    assert plan.per == -(-plan.tg // 2) + ncs <= 6
    assert plan.stages % plan.per == 0
    assert 2 <= plan.stages // plan.per <= 4
    assert plan.smem == task_merge.task_merge_bwd_smem(
        plan.ks, plan.runs, min(plan.ks, C), plan.tg, plan.stages, plan.per)
    # one block an SM (228 KB, 1 KB reserved)
    assert plan.smem <= ln_lora.SMEM_LIMIT == 232_448
    assert plan.smem + 1024 <= 228 * 1024
    # the last row block masks its rows past Mm
    assert plan.blocks == -(-Mm // plan.bm)
    assert (plan.blocks - 1) * plan.bm < Mm <= plan.blocks * plan.bm
    assert plan.ctas == plan.blocks * plan.split
    # W's slots, each staged once per block and task group: per hidden
    # chunk its slices of the block's columns
    assert plan.slice_bytes == (plan.ctas * plan.groups * -(-O // 64)
                                * ncs * 2 * 64 * 64)
    assert 1 <= plan.sw <= -(-T * Mm // 64)


@pytest.mark.parametrize("T", TASKS)
@pytest.mark.parametrize("Mm,K,O,Wh,per", SHAPES)
def test_plan_rows_split_ring_and_shared_memory(Mm, K, O, Wh, per, T):
    plan = task_merge.task_merge_bwd_plan(T, Mm, K, O, Wh, per, SMS)
    _check_plan(plan, T, Mm, K, O)
    if T != 4:
        return
    # four tasks: 96 columns a block in clusters of 4 and 8 at K = 384 and
    # 768 (one group of 4); in clusters of 8, 64 and 128 at Swin-B's first
    # two merges (groups of 4 and 2), 192 and 256 at K = 1536 and 2048 (2
    # and 1)
    assert (plan.split, plan.ks, plan.tg) == {
        384: (4, 96, 4), 768: (8, 96, 4), 1536: (8, 192, 2),
        512: (8, 64, 4), 1024: (8, 128, 2), 2048: (8, 256, 1)}[K]


def test_plan_six_tasks_take_two_groups_of_three():
    Mm, K, O, Wh, per = FLAGSHIP[0]
    plan = task_merge.task_merge_bwd_plan(6, Mm, K, O, Wh, per, SMS)
    assert (plan.tg, plan.groups) == (3, 2)


def test_plan_ragged_rows_take_one_more_block():
    """392 rows at the batch-2 step's last merge: twelve whole blocks of
    32 and one of 8."""
    plan = task_merge.task_merge_bwd_plan(4, 392, 1536, 768, 14, 196, SMS)
    assert plan.blocks == 13 and 392 % plan.bm == 8
    assert plan.ctas == 13 * plan.split


def test_plan_blocks_straddle_samples_at_an_odd_wh():
    """Path B's 14 -> 7 merge: 49 merged rows a sample, so that the
    coefficients change inside a block of 32 rows."""
    Mm, K, O, Wh, per = _merge(32, 14, 384)
    plan = task_merge.task_merge_bwd_plan(4, Mm, K, O, Wh, per, SMS)
    assert (per, Wh) == (49, 7) and per % plan.bm and Mm % plan.bm == 0
    assert any((b * plan.bm) // per != (b * plan.bm + plan.bm - 1) // per
               for b in range(plan.blocks))


@pytest.mark.parametrize("Mm,K,O,Wh,per", FLAGSHIP + RAGGED)
def test_plan_scratch_is_what_the_wrapper_allocates(Mm, K, O, Wh, per):
    T = 4
    plan = task_merge.task_merge_bwd_plan(T, Mm, K, O, Wh, per, SMS)
    bf16, f32 = torch.bfloat16, torch.float32
    assert plan.scratch == {
        "lnd": ((T * Mm, K), bf16),
        "gb": ((plan.blocks, 2, K), f32),
        "pbs": ((plan.blocks, T, K // 4, 8), f32),
        "part": ((plan.sw * O * K,), f32),
    }
    # no fp32 rows [T, Mm, K] and no dU [T, B*L, C]: dy stays on the
    # chip, and the row blocks' partials (32 rows each) are at most a
    # sixteenth of dU's elements; the weight product's stripes at most 64 MB
    assert all(np.prod(shape) <= T * plan.blocks * plan.bm * K // 16
               for name, (shape, dt) in plan.scratch.items()
               if name in ("gb", "pbs"))
    assert 4 * np.prod(plan.scratch["part"][0]) <= 64 << 20
    assert not {"work", "du", "stats", "dmid"} & set(plan.scratch)
    # small rows allocate the same layout for real
    small = task_merge.task_merge_bwd_plan(T, 2 * per, K, O, Wh, per, SMS)
    got = task_merge.task_merge_bwd_scratch(small, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (tuple(s), dt) for k, (s, dt) in small.scratch.items()}


def _yaml_merges():
    """(yaml, merge, L, res, C) of every merge of every YAML at batch 32
    and 2: the task streams [.., res^2, C] of the stage before each
    merge."""
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
    Mm, K, O, Wh, per = _merge(L, res, C)
    for T in TASKS:
        _check_plan(task_merge.task_merge_bwd_plan(T, Mm, K, O, Wh, per,
                                                   SMS), T, Mm, K, O)


def test_plan_constants_match_the_cuda_source():
    src = (_build.CSRC / "task_merge_bwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kBM") == task_merge.TM_BWD_ROWS
    assert const("kS") == task_merge.TM_BWD_CHUNK
    assert const("kWarps") == task_merge.TM_BWD_WARPS
    assert const("kSplitMax") == max(task_merge.TM_BWD_SPLITS)
    assert const("kChunkMax") == task_merge.TM_BWD_CHUNK_SLOTS
    # the instances the C entry point dispatches to, and its refusals
    for ncs, tgs in task_merge.TM_BWD_INSTANCES.items():
        for tg in tgs:
            assert f"launch_rows<{ncs}, {tg}>(p, blocks, smem, st)" in src
    assert "tg > (ncs <= 2 ? 4 : ncs == 3 ? 2 : 1)" in src
    assert "ks % 16 || ncs > 4" in src
    assert "(ks % C && C % ks)" in src
    assert "C < 16 ||\n      C % 16 || O < 16 || O % 16" in src
    assert ("stages % (ngy + ncs) || stages < 2 * (ngy + ncs)" in src)
    # K up to 8 blocks of the widest instance's 4 slices
    assert task_merge.TM_BWD_MAX_K == 8 * 4 * 64
    # one block an SM, as the plan sizes shared memory
    assert "__launch_bounds__(kThreads, 1)" in src
    # the plan's shared-memory layout: the ring's mbarrier and count a
    # chunk after the exchanged pairs
    assert "reinterpret_cast<int*>(bars + nbar)" in src
    assert "reinterpret_cast<uint64_t*>(xch + 2 * TG * BM)" in src
    # the old structure is gone: no combine or rank-row kernel, no fp32
    # scratch of dxhat, no transposed W, no row helpers of 16-row tiles
    py = Path(task_merge.__file__).read_text()
    for gone in ("task_merge_bwd_combine", "task_merge_bwd_dmid", "w_ko",
                 "work"):
        assert gone not in src and gone not in py
    common = (_build.CSRC / "ln_common.cuh").read_text()
    assert "block_tile_to_global" not in common
    assert "mma_rows" not in common


# (T, Mm, K, O, Wh, per): K past 2048, C % 16 != 0, O % 16 != 0, rows that
# are not whole samples, samples that are not whole rows of the merged
# grid, no task
REFUSED = [(4, 392, 4096, 2048, 14, 196), (4, 392, 4 * 24, 48, 14, 196),
           (4, 392, 1536, 776, 14, 196), (4, 390, 1536, 768, 14, 196),
           (4, 392, 1536, 768, 14, 98 + 3), (0, 392, 1536, 768, 14, 196)]


@pytest.mark.parametrize("T,Mm,K,O,Wh,per", REFUSED)
def test_plan_refuses_shapes_outside_the_kernel(T, Mm, K, O, Wh, per):
    msg = (f"task merge backward kernel: needs T >= 1 ({T}), C % 16 == 0 "
           f"and K = 4C <= 2048 ({K}), O % 16 == 0 ({O}) and whole samples "
           f"of {per} merged rows in rows of Wh = {Wh} ({Mm} rows)")
    with pytest.raises(ValueError) as err:
        task_merge.task_merge_bwd_plan(T, Mm, K, O, Wh, per, SMS)
    assert str(err.value) == msg


def _inputs(seed, H=14, T=3, B=3, C=16, coefs=True, dtype=np.float32):
    """The operands of ``task_merge_bwd_plain`` as numpy arrays (the JAX
    kernel's ``kernel`` [4C, O]) and the scales."""
    rng = np.random.RandomState(seed)
    L = H * H

    def f(*s):
        return (0.5 * rng.randn(*s)).astype(dtype)

    c1 = c2 = None
    if coefs:
        c1, c2 = ((rng.rand(T, B, 1) < 0.8).astype(dtype) / 0.8
                  for _ in range(2))
    d = dict(base=f(B, L, C), pre=f(B, L, C), p2=f(B, L, C),
             mid1T=f(T, 4, B * L), b1=f(T, 4, C), mid2T=f(T, 4, B * L),
             b2=f(T, 4, C), c1=c1, c2=c2,
             s1=tuple(rng.uniform(0.5, 2.0, T)),
             s2=tuple(rng.uniform(0.5, 2.0, T)),
             gamma=f(4 * C) + 1.0, beta=f(4 * C), kernel=f(4 * C, 2 * C),
             gy=rng.randn(T, B, L // 4, 2 * C).astype(dtype))
    return d


def _port_args(d, H, dtype=torch.float32):
    def t(k):
        return None if d[k] is None else torch.from_numpy(d[k]).to(dtype)

    return ([t(k) for k in ("base", "pre", "p2", "mid1T", "b1", "mid2T",
                            "b2", "c1", "c2")]
            + [d["s1"], d["s2"], t("gamma"), t("beta"),
               torch.from_numpy(np.ascontiguousarray(d["kernel"].T))
               .to(dtype), H, H], t("gy"))


def test_kernel_route_refuses_a_cpu_tensor():
    """The plain version runs only through ``task_merge_bwd``'s CPU
    branch; the kernel route itself raises."""
    args, gy = _port_args(_inputs(0), 14, torch.bfloat16)
    with pytest.raises(ValueError,
                       match="task merge backward: no kernel for cpu"):
        task_merge.task_merge_bwd_kernel(*args, gy)


# ---------------------------------------------------------------------------
# The plain split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,coefs", [(14, True), (16, False)])
def test_rows_then_weights_is_the_plain_backward(dtype, H, coefs):
    """The composition, with the bf16(ln) rows in the compute dtype as the
    kernel stores them, is ``task_merge_bwd_plain`` bit for bit; the rows
    have the kernel's shape and dtype."""
    d = _inputs(3, H=H, coefs=coefs)
    args, gy = _port_args(d, H, dtype)
    rows = task_merge_bwd_rows_plain(*args, gy)
    T, B = d["gy"].shape[:2]
    Mm, K = B * (H // 2) ** 2, d["kernel"].shape[0]
    assert (tuple(rows[9].shape), rows[9].dtype) == ((T * Mm, K), dtype)
    got = rows[:9] + (task_merge_bwd_weights_plain(rows[9], gy),)
    want = task_merge_bwd_plain(*args, gy)
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


DIFF = ("base", "pre", "p2", "mid1T", "b1", "mid2T", "b2", "gamma", "beta",
        "kernel")


def _jax_merge(d, H, fn):
    """``fn`` (task_merge_down or task_merge_reference) as a function of
    the differentiable operands."""
    def f(base, pre, p2, m1, b1, m2, b2, g, be, k):
        c = None if d["c1"] is None else jnp.asarray(d["c1"])
        c2 = None if d["c2"] is None else jnp.asarray(d["c2"])
        s = JStream(base=base, pre=pre, midT=m1, B=b1, scales=d["s1"],
                    coef=c)
        f2 = JFactored(pretrained=p2, midT=m2, B=b2, scales=d["s2"])
        if fn is task_merge_down:
            return fn(s, f2, c2, g, be, k, H, H, train_w=True,
                      interpret=True)
        return fn(s, f2, c2, g, be, k, H, H)
    return f


@pytest.mark.parametrize("oracle,H,B", [("reference", 14, 3),
                                        ("kernel", 16, 2)])
def test_split_matches_the_jax_vjp(oracle, H, B):
    """The split against the JAX VJP: of ``task_merge_reference`` at H = W
    = 14 (Wh = 7, odd), B = 3: 147 merged rows, which no 32-row block
    divides, in samples of 49 that the blocks straddle; of the
    interpret-mode kernel (``task_merge_down``, ``train_w``) at Wh = 8.
    Drop-path coefficients on."""
    d = _inputs(4, H=H, B=B)
    Wh, per = H // 2, (H // 2) ** 2
    Mm = B * per
    plan = task_merge.task_merge_bwd_plan(3, Mm, 64, 32, Wh, per, SMS)
    assert plan.tg == 3 and plan.runs == 4
    if oracle == "reference":
        assert Wh % 2 and Mm % plan.bm and per % plan.bm
    fn = task_merge_down if oracle == "kernel" else task_merge_reference
    _, vjp = jax.vjp(_jax_merge(d, H, fn),
                     *[jnp.asarray(d[k]) for k in DIFF])
    refs = vjp(jnp.asarray(d["gy"]))
    args, gy = _port_args(d, H)
    rows = task_merge_bwd_rows_plain(*args, gy)
    got = rows[:9] + (task_merge_bwd_weights_plain(rows[9], gy),)
    for name, a, ref in zip(DIFF, got, refs):
        ref = np.asarray(ref, np.float32)
        ref = ref.T if name == "kernel" else ref
        np.testing.assert_allclose(a.detach().float().numpy(), ref, rtol=0,
                                   atol=REL * np.abs(ref).max(),
                                   err_msg=name)


def test_profile_class_names_the_row_kernel():
    from mtlora_tpu_torch.train.profile import classify

    pre = "void (anonymous namespace)::"
    for inst in ("<2>", "<3>", "<4>"):
        assert classify(f"{pre}task_merge_bwd_rows{inst}(Params)") == (
            "task-merge kernel 6b (bwd rows)")
    assert "combine" not in classify(f"{pre}task_merge_bwd_rows<2>(Params)")
