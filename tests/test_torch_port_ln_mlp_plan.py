"""The launch plans of kernels 4 and 4b (``ops/ln_mlp.py:fwd_plan``,
``bwd_plan``) on the CPU, and kernel 4's order of summation.

At the four Swin-T 448 stage shapes of the batch-32 step, at the ragged
392 rows of stage 3 (the batch-2 step), and at the toy shape of
``tests/test_torch_port_ln.py`` (refused, as every shape outside the
kernel's range): rows per block, the hidden chunk width, the ring depth,
the kept W1 slices and the shared memory against the H100's 232,448 bytes
a block, the scratch that the wrapper allocates, and the constants of
``csrc/ln_mlp_bwd.cu`` that the plan sizes shared memory by (the plan
owns the launch: the C entry point takes its rows, kept slices and bytes,
and the kernel traps on the card if the bytes do not hold its layout).
The edits of the variant probe ``tools/ln_mlp_bwd_variants.py`` still
apply to the sources.

Kernel 4's plan at the same shapes: rows per block (128 / WN, WN warps
sharing a row group), blocks, the ring, the shared memory and the weight
slices streamed; the constants and instances of ``csrc/ln_mlp.cu``; the
refusals. Kernel 4's function in its own order (m1 over 64-column slices,
h from s1 u, then the W1 slices, then b1; the m2 shares of a row group's
warps summed in order; y over super-chunks of WN x 64 hidden columns)
with its cast points, emulated in plain torch on inputs drawn as
``chip_smoke.py`` draws them (numpy seeds), stays within the smoke's bf16
bound of ``ln_mlp_plain`` at the four stage shapes, at batch 1 and 2,
with dropout on and off.
"""

import re
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from mtlora_tpu_torch.ops import _build, dropout, ln_mlp
from mtlora_tpu_torch.ops.ln_lora import gelu_pair, layer_norm_parts
from mtlora_tpu_torch.tools import ln_mlp_bwd_variants

torch.set_num_threads(2)

SMS = 132   # the H100's SMs
R = 64
# (M, C): x rows and width of the no-task MLPs at batch 32, stages 0-3,
# and stage 3 at batch 2
SHAPES = [(401408, 96), (100352, 192), (25088, 384), (6272, 768),
          (392, 768)]


@pytest.mark.parametrize("M,C", SHAPES)
def test_plan_rows_ring_and_shared_memory(M, C):
    plan = ln_mlp.bwd_plan(M, C, 4 * C, R, SMS)
    assert plan.bm == (64 if C <= 384 else 32)
    assert plan.chunk == 64 and plan.stages >= 3
    # W1 kept where its slices fit beside the 64-row tiles, and C > 128
    assert plan.keep_w1 == (128 < C <= 384)
    assert plan.smem <= ln_mlp.SMEM_LIMIT == 232_448
    # the last block masks its rows past M
    assert plan.blocks == -(-M // plan.bm)
    assert (plan.blocks - 1) * plan.bm < M <= plan.blocks * plan.bm
    assert 1 <= plan.sa <= -(-M // 64) and 1 <= plan.sh <= -(-M // 64)


@pytest.mark.parametrize("M,C", SHAPES)
def test_plan_scratch_is_what_the_wrapper_allocates(M, C):
    plan = ln_mlp.bwd_plan(M, C, 4 * C, R, SMS)
    bf16, f32 = torch.bfloat16, torch.float32
    assert plan.scratch == {
        "lnd": ((M, C), bf16),
        "mbuf": ((4, M, R), bf16),
        "hbuf": ((2, M, 4 * C), bf16),
        "gb": ((plan.blocks * plan.bm // 16, 2, C), f32),
        "part": ((max(plan.sa * R * C, plan.sh * 4 * C * R),), f32),
    }
    # small rows allocate the same layout for real
    small = ln_mlp.bwd_plan(40, C, 4 * C, R, SMS)
    got = ln_mlp.bwd_scratch(small, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (tuple(s), dt) for k, (s, dt) in small.scratch.items()}


def test_plan_constants_match_the_cuda_source():
    src = (_build.CSRC / "ln_mlp_bwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kS") == ln_mlp.BWD_CHUNK
    assert const("kStages") == ln_mlp.BWD_STAGES
    assert const("kWarps") == ln_mlp.BWD_WARPS


@pytest.mark.parametrize("name", sorted(ln_mlp_bwd_variants.VARIANTS)
                         + sorted(ln_mlp_bwd_variants.PARTS))
def test_variant_probe_edits_apply_to_the_sources(name, tmp_path):
    edits = {**ln_mlp_bwd_variants.VARIANTS,
             **ln_mlp_bwd_variants.PARTS}[name]
    pkg = tmp_path / "mtlora_tpu_torch"
    shutil.copytree(ln_mlp_bwd_variants.ROOT / "mtlora_tpu_torch", pkg)
    ln_mlp_bwd_variants.apply_edits(pkg, edits)
    for rel, old, new in edits:
        text = (pkg / rel).read_text()
        assert old not in text and (new == "" or new in text)


# (C, H4, r): the toy shape of tests/test_torch_port_ln.py, then each bound
REFUSED = [(16, 64, 8), (96, 384, 32), (100, 400, 64), (800, 3200, 64),
           (96, 360, 64)]


@pytest.mark.parametrize("C,H4,r", REFUSED)
def test_plan_refuses_shapes_outside_the_kernel(C, H4, r):
    msg = (f"LN+MLP backward kernel: needs C % 32 == 0 and C <= 768 ({C}), "
           f"4C % 64 == 0 ({H4}) and r == 64 ({r})")
    with pytest.raises(ValueError) as err:
        ln_mlp.bwd_plan(64, C, H4, r, SMS)
    assert str(err.value) == msg


def test_wrapper_refuses_a_cpu_tensor_for_the_kernel():
    x = torch.zeros(4, 96)
    w1, a1 = torch.zeros(384, 96), torch.zeros(64, 96)
    with pytest.raises(ValueError, match="LN\\+MLP backward: no kernel for cpu"):
        ln_mlp._shapes(x, w1, a1, "LN+MLP backward")


# kernel 4: (rows a block, warps sharing a row group, blocks, bytes of
# shared memory) at SHAPES
FWD_PLANS = [(128, 1, 3136, 159_760), (128, 1, 784, 184_336),
             (64, 2, 392, 226_832), (32, 4, 196, 220_432),
             (32, 4, 13, 220_432)]


@pytest.mark.parametrize("shape,want", zip(SHAPES, FWD_PLANS))
def test_fwd_plan_rows_blocks_and_shared_memory(shape, want):
    M, C = shape
    plan = ln_mlp.fwd_plan(M, C, 4 * C, R)
    assert (plan.bm, plan.wn, plan.blocks, plan.smem) == want
    assert plan.smem <= ln_mlp.SMEM_LIMIT == 232_448
    assert plan.stages == 2 * plan.group == 16
    # the last block masks its rows past M
    assert (plan.blocks - 1) * plan.bm < M <= plan.blocks * plan.bm
    # A1 and B2, then per super-chunk B1, W1, A2 and W2: each weight once
    # a block, in 64 x 64 bf16 slices (C = 96 streams the last slices of
    # A1, W1, W2 and B2 half empty)
    ncs = -(-C // 64)
    per_block = 2 * (2 * 64 * 64 * ncs + 2 * 4 * C * 64 * (1 + ncs))
    assert plan.slice_bytes == plan.blocks * per_block


@pytest.mark.parametrize("C", [96, 128, 192, 256, 384, 512, 768])
def test_fwd_plan_fits_every_width_the_kernel_takes(C):
    plan = ln_mlp.fwd_plan(1000, C, 4 * C, R)
    assert plan.smem <= ln_mlp.SMEM_LIMIT
    # a warp's y tile, 16 x C / WN fp32, at most 96 registers a thread
    assert C // plan.wn // 2 <= 96
    assert plan.bm * plan.wn == 128


def test_fwd_plan_constants_match_the_cuda_source():
    src = (_build.CSRC / "ln_mlp.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kS") == ln_mlp.FWD_CHUNK
    assert const("kStages") == ln_mlp.FWD_STAGES
    assert const("kGroup") == ln_mlp.FWD_GROUP
    assert const("kWarps") == ln_mlp.FWD_WARPS
    # the C entry point takes the widths the plan does, and launches one
    # instance per width and row group
    widths = re.search(r"!\((cw == \d+(?: \|\| cw == \d+)*)\)", src)[1]
    assert tuple(int(w) for w in re.findall(r"\d+", widths)) == (
        ln_mlp.FWD_WIDTHS)
    launches = set(re.findall(r"launch<(\d+), (\d+)>\(a,", src))
    assert launches == {(str(c // wn), str(wn))
                        for c in (96, 128, 192, 256, 384, 512, 768)
                        for wn in [ln_mlp.fwd_plan(64, c, 4 * c, R).wn]}


# (C, H4, r): widths whose warps would own other than 96, 128 or 192 y
# columns, and a hidden that is not whole super-chunks
FWD_REFUSED = [(64, 256, 64), (160, 640, 64), (320, 1280, 64),
               (640, 2560, 64), (384, 1600, 64)]


@pytest.mark.parametrize("C,H4,r", FWD_REFUSED)
def test_fwd_plan_refuses_widths_outside_the_instances(C, H4, r):
    with pytest.raises(ValueError, match="LN\\+MLP forward kernel: needs "
                                         "C / WN in"):
        ln_mlp.fwd_plan(64, C, H4, r)


@pytest.mark.parametrize("C,H4,r", REFUSED)
def test_fwd_plan_refuses_shapes_outside_the_kernel(C, H4, r):
    msg = (f"LN+MLP forward kernel: needs C % 32 == 0 and C <= 768 ({C}), "
           f"4C % 64 == 0 ({H4}) and r == 64 ({r})")
    with pytest.raises(ValueError) as err:
        ln_mlp.fwd_plan(64, C, H4, r)
    assert str(err.value) == msg


def test_forward_wrapper_refuses_a_cpu_tensor_for_the_kernel():
    x = torch.zeros(4, 96)
    w1, a1 = torch.zeros(384, 96), torch.zeros(64, 96)
    with pytest.raises(ValueError, match="LN\\+MLP forward: no kernel for cpu"):
        ln_mlp._shapes(x, w1, a1, "LN+MLP forward")


def _kernel_order(x, gamma, beta, w1, bias1, a1, bb1, w2, bias2, a2, bb2,
                  seed, s1, s2, drop):
    """``ln_mlp_plain``'s function in kernel 4's order and cast points:
    m1 = bf16(sum over 64-column slices of bf16(drop1(ln)) A1^T); per warp
    chunk of 64 hidden columns h = (s1 m1 B1^T + sum over slices of
    bf16(ln) W1^T) + b1, g = gelu(h) (tanh form, fp32), m2 shares of
    bf16(drop2(g)) A2^T per warp column; y over the super-chunks of WN x
    64 columns; m2 = bf16(the shares summed in order); y = bf16((y + b2) +
    s2 bf16(m2) B2^T); fp32 sums."""
    M, C = x.shape
    H4 = w1.shape[0]
    wn = ln_mlp.fwd_plan(M, C, H4, a1.shape[0]).wn
    f = torch.float32
    w1, a1, bb1, w2, a2, bb2 = (t.to(f) for t in (w1, a1, bb1, w2, a2, bb2))
    ln, _, _ = layer_norm_parts(x, gamma, beta)
    lnc = ln.to(x.dtype).to(f)
    keep1 = (dropout.keep_mask(seed, 0, M, C, drop) if drop > 0.0 else None)
    keep2 = (dropout.keep_mask(seed, 1, M, H4, drop) if drop > 0.0
             else None)
    lnd = (ln if keep1 is None else dropout.apply(ln, keep1, drop))
    lnd = lnd.to(x.dtype).to(f)
    cols = [slice(c, min(c + 64, C)) for c in range(0, C, 64)]
    m1 = torch.zeros(M, 64)
    for cs in cols:
        m1 += lnd[:, cs] @ a1[:, cs].t()
    m1 = m1.to(x.dtype).to(f)
    y = torch.zeros(M, C)
    shares = [torch.zeros(M, 64) for _ in range(wn)]
    for hs in range(0, H4, 64 * wn):
        gcs = []
        for i in range(wn):
            hc = slice(hs + 64 * i, hs + 64 * (i + 1))
            h = s1 * (m1 @ bb1[hc].t())
            for cs in cols:
                h += lnc[:, cs] @ w1[hc, cs].t()
            gl, _ = gelu_pair(h + bias1[hc].to(f), x.dtype)
            gd = gl if keep2 is None else dropout.apply(gl, keep2[:, hc],
                                                        drop)
            shares[i] += gd.to(x.dtype).to(f) @ a2[:, hc].t()
            gcs.append(gl.to(x.dtype).to(f))
        for i, gc in enumerate(gcs):
            y += gc @ w2[:, hs + 64 * i:hs + 64 * (i + 1)].t()
    m2 = torch.zeros(M, 64)
    for sh in shares:
        m2 += sh
    m2 = m2.to(x.dtype).to(f)
    return ((y + bias2.to(f)) + s2 * (m2 @ bb2.t())).to(x.dtype)


def _operands(rng, M, C, drop):
    """Kernel 4's operands as ``chip_smoke.ln_mlp_operands`` draws them:
    rank 64, scales 4."""
    H4 = 4 * C

    def uniform(shape, bound):
        return torch.from_numpy(
            rng.uniform(-bound, bound, shape).astype(np.float32)).to(
                torch.bfloat16)

    x = torch.from_numpy(rng.standard_normal((M, C), np.float32)).to(
        torch.bfloat16)
    gamma = torch.from_numpy(
        (0.9 + 0.2 * rng.random(C)).astype(np.float32)).to(torch.bfloat16)
    beta = torch.from_numpy(
        (0.02 * rng.standard_normal(C)).astype(np.float32)).to(
            torch.bfloat16)
    seed = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, 2, dtype=np.int32))
    return (x, gamma, beta, uniform((H4, C), C ** -0.5),
            uniform((H4,), 0.02), uniform((R, C), C ** -0.5),
            uniform((H4, R), R ** -0.5), uniform((C, H4), H4 ** -0.5),
            uniform((C,), 0.02), uniform((R, H4), H4 ** -0.5),
            uniform((C, R), R ** -0.5), seed, 4.0, 4.0, drop)


@pytest.mark.parametrize("drop", [0.05, 0.0])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("stage", range(4))
def test_kernel_order_within_the_smoke_bound(stage, batch, drop):
    C = 96 * 2 ** stage
    M = batch * (112 // 2 ** stage) ** 2
    rng = np.random.default_rng(100 * stage + 10 * batch + int(drop > 0))
    args = _operands(rng, M, C, drop)
    got = _kernel_order(*args)
    want = ln_mlp.ln_mlp_plain(*args)
    assert got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    assert err <= chip_smoke.LN_BF16_REL * top, (err, top)


# nvcc's -Xptxas -v report of two of kernel 4's instances (C = 768 and 96)
FWD_PTXAS = """\
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__641d9647_9_ln_mlp_cu_b61452d217ln_mlp_fwd_kernelILi192ELi4EEEvNS_4WalkIXT_EXT0_EEE' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__641d9647_9_ln_mlp_cu_b61452d217ln_mlp_fwd_kernelILi192ELi4EEEvNS_4WalkIXT_EXT0_EEE
    80 bytes stack frame, 148 bytes spill stores, 152 bytes spill loads
ptxas info    : Used 255 registers, used 16 barriers, 80 bytes cumulative stack size
ptxas info    : Function properties for _ZN41_GLOBAL__N__641d9647_9_ln_mlp_cu_b61452d217ln_mlp_fwd_kernelILi96ELi1EEEvNS_4WalkIXT_EXT0_EEE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 243 registers, used 1 barriers
"""


def test_variant_probe_reports_kernel_4s_registers():
    """``tools/ln_mlp_bwd_variants.py`` reads the registers and spills of
    every instance of kernel 4 from nvcc's ptxas report, and its variants
    reach kernel 4's source and plan."""
    got = ln_mlp_bwd_variants._ptxas(FWD_PTXAS)
    assert list(got.values()) == [{"spill_stores": 148, "registers": 255},
                                  {"spill_stores": 0, "registers": 243}]
    assert all("ln_mlp_fwd_kernel" in k for k in got)
    assert any(rel == "ops/csrc/ln_mlp.cu"
               for edits in ln_mlp_bwd_variants.VARIANTS.values()
               for rel, _, _ in edits)
