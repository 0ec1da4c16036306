"""Kernel 7 (the HRNet head forward on Hopper) on the CPU: its launch plan,
refusals, profile class and cast points.

The plan (``ops/head.py:fwd_plan``) at the head's shapes (C = 270 inputs,
O = 1080 hidden) for the rows of the batch-32 step (100,352), path B's
25,088 and 6,272 and one 224-px image (784, not a multiple of the 128-row
tiles), at n in {1, 3, 7, 21} and at 64, the widest it takes: the tiles
with the ragged last one, the persistent blocks (one an SM), n padded for
Wp^T's slot, the ring's depth and the shared memory against the H100's
232,448 bytes a block, the bytes of the ring's stages and the scratch;
its constants and instances held to ``csrc/head_mlp_fwd.cu``; the
refusals, each naming its bound; the kernel route refusing a CPU tensor
(no fallback to the plain version).

The cast points: the kernel walks the hidden in chunks of 64 columns: h
over 17 k-steps of C padded to 272 (four 64-column slots and a 16-column
tail slot), hc = bf16(h + eb) from fp32, bf16(hc * bf16(mul)) +
bf16(add) in bf16, the ReLU, and bf16(z) multiplied into an fp32 output
that sums the chunks one after another; y = bf16(out + pb). That walk,
emulated in plain torch on numpy-seeded inputs at rows that leave a
ragged last tile and a ragged warpgroup, stays within
``chip_smoke.KERNEL_ATOL`` (the card's bound, two bf16 ulps at |y| = 4:
sums in another order can flip a rounding of hc or of y) of
``head_mlp_plain`` and of the JAX package's ``head_mlp_reference``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mtlora_tpu.ops.pallas_head import head_mlp_reference
from mtlora_tpu_torch.ops import _build, head
from mtlora_tpu_torch.tools import ln_mlp_bwd_variants
from mtlora_tpu_torch.train.profile import classify

torch.set_num_threads(2)
SMS = 132   # the H100's SMs
C, O = 270, 1080
ROWS = [100352, 25088, 6272, 784]
OUTS = [1, 3, 7, 21, 64]
SLOT = 64 * 64 * 2      # a 64 x 64 bf16 slot, bytes
TAIL = 16 * 64 * 2      # the 16-column tail slot of C = 272, bytes


@pytest.mark.parametrize("n", OUTS)
@pytest.mark.parametrize("M", ROWS)
def test_plan_tiles_blocks_ring_and_shared_memory(M, n):
    plan = head.fwd_plan(M, C, O, n, SMS)
    assert plan.rows == 128
    assert plan.np == 16 * -(-n // 16) and plan.np >= n
    # the last tile masks its rows past M
    assert plan.tiles == -(-M // 128)
    assert (plan.tiles - 1) * 128 < M <= plan.tiles * 128
    # persistent blocks, one an SM, never more than the tiles
    assert plan.blocks == min(plan.tiles, SMS)
    if M == 100352:
        assert (plan.tiles, plan.blocks) == (784, 132)
    if M == 784:
        assert (plan.tiles, plan.blocks) == (7, 7)
    # four hidden chunks in flight beside the x buffers up to n = 32,
    # three above (a fourth does not fit)
    assert plan.stages == (4 if n <= 32 else 3)
    stage = 4 * SLOT + TAIL + plan.np * 128 + 1024
    x_buffers = 2 * 64 * 2 * C
    assert plan.smem == (1024 + plan.stages * stage + x_buffers
                         + 8 * (2 * plan.stages + 4))
    assert plan.smem <= head.SMEM_LIMIT == 232_448
    if plan.stages < head.FWD_MAX_STAGES:
        assert head._fwd_smem(plan.stages + 1, plan.np, C) > head.SMEM_LIMIT
    # every block reads every stage of its tiles: We^T's four slots and
    # its 16-column tail, Wp^T's np rows of 64 columns, the chunk's 512
    # bytes of vectors
    assert plan.slot_bytes == plan.tiles * 17 * (
        4 * SLOT + TAIL + plan.np * 128 + 512)
    assert plan.scratch == {"wpad": ((O, 272), torch.bfloat16),
                            "vec": ((17 * 512,), torch.uint8)}


def test_plan_weights_traffic_halves_the_first_ports():
    """Each staged We^T byte serves 128 rows, where the first port read
    all of We^T again for every 64 rows."""
    plan = head.fwd_plan(100352, C, O, 21, SMS)
    first_port = 100352 // 64 * O * C * 2
    we_slots = plan.tiles * 17 * (4 * SLOT + TAIL)
    assert we_slots < 0.6 * first_port
    assert abs(we_slots / 1e9 - 0.464) < 1e-3


@pytest.mark.parametrize("M", [1, 63, 64, 200, 785, 100352])
def test_x_spans_are_aligned_bulk_copies(M):
    """A warpgroup's rows are one span from a 16-byte boundary (64 rows
    of 2 C bytes: 128 C, a multiple of 16); past the last multiple of 16
    of a ragged span at most 14 bytes are left to the producer's own
    stores, none past x's last row."""
    tiles = -(-M // 128)
    covered = 0
    for tile in range(tiles):
        for wg in range(2):
            r0 = tile * 128 + 64 * wg
            rows = max(0, min(64, M - r0))
            start, nbytes = 2 * r0 * C, 2 * rows * C
            main = nbytes & ~15
            assert start % 16 == 0 and main % 16 == 0
            assert 0 <= nbytes - main <= 14 and (nbytes - main) % 2 == 0
            assert nbytes <= 2 * 64 * C   # the warpgroup's buffer
            covered += nbytes
    assert covered == 2 * M * C


def test_plan_constants_match_the_cuda_source():
    src = (_build.CSRC / "head_mlp_fwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kTileRows") == head.FWD_ROWS
    assert const("kWgRows") == head.FWD_ROWS // 2
    assert const("kS") == head.FWD_CHUNK
    assert const("kKp") == head.MAX_C_BWD
    assert const("kNMax") == head.MAX_OUT
    assert const("kVecBytes") == head.FWD_VEC_BYTES
    assert const("kMaxStages") == head.FWD_MAX_STAGES
    assert const("kWarps") == 8
    assert "constexpr int kThreads = 32 * (kWarps + 4);" in src
    assert "constexpr int kSlices = kKp / kS;" in src
    assert head.MAX_C_BWD // head.FWD_CHUNK == head.FWD_SLICES
    assert "constexpr int kTail = kKp - kSlices * kS;" in src
    assert head.MAX_C_BWD % head.FWD_CHUNK == head.FWD_TAIL
    assert ("constexpr int kWpOff = 2 * kSlices * kSlot + 2 * kTail * kS;"
            in src)
    assert "return kWpOff + 2 * np * kS + 1024;" in src
    # the x buffers, two warpgroups' 64 rows of 2 C bytes, before the
    # mbarriers
    assert ("reinterpret_cast<uint64_t*>(xbuf + 4 * kWgRows * C);"
            in src)
    # the instances: n padded to 16, 32, 48, 64 (n-tiles of 8 in pairs)
    for nt in (2, 4, 6, 8):
        assert f"launch<{nt}>(p, blocks, smem, st)" in src
    # one C entry point, its arguments bound
    assert "extern \"C\" int mtlora_head_mlp_fwd(" in src
    assert len(_build.SIGNATURES["mtlora_head_mlp_fwd"]) == 18
    assert not (_build.CSRC / "head_mlp.cu").exists()


def _message(M, Cx, Ox, n):
    return (f"head MLP forward kernel: needs M >= 1 ({M}), even C <= 272 "
            f"({Cx}), O % 8 == 0 ({Ox}) and 1 <= n <= 64 ({n})")


# (M, C, O, n): C above 272, odd C, odd O, O not a multiple of 8, O of 0,
# n of 0 and of 65, no rows
REFUSED = [(784, 274, 1096, 21), (784, 269, 1076, 21), (784, 270, 1081, 21),
           (784, 270, 1084, 21), (784, 270, 0, 21), (784, 270, 1080, 0),
           (784, 270, 1080, 65), (0, 270, 1080, 21)]


@pytest.mark.parametrize("M,Cx,Ox,n", REFUSED)
def test_plan_refuses_shapes_outside_the_kernel(M, Cx, Ox, n):
    with pytest.raises(ValueError) as err:
        head.fwd_plan(M, Cx, Ox, n, SMS)
    assert str(err.value) == _message(M, Cx, Ox, n)


@pytest.mark.parametrize("M,Cx,Ox,n", [(1, 2, 8, 1), (785, 272, 1088, 64),
                                       (100, 16, 64, 17)])
def test_plan_takes_every_shape_of_the_backward(M, Cx, Ox, n):
    """Every shape kernel 7b's plan takes, kernel 7's takes too."""
    head.bwd_plan(M, Cx, Ox, n, SMS)
    plan = head.fwd_plan(M, Cx, Ox, n, SMS)
    assert plan.smem <= head.SMEM_LIMIT and plan.stages >= 2


def _operands(M, n, seed=0, Cx=C, Ox=O):
    """numpy-seeded operands at the kernel's dtypes: x, We [C, O] and
    Wp [O, n] bf16 (the conv layouts' transposed views), eb, mul, add,
    pb fp32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(M, Cx).astype(np.float32)
    ek = rng.uniform(-1, 1, (Ox, Cx)).astype(np.float32) * Cx ** -0.5
    eb = (0.02 * rng.randn(1, Ox)).astype(np.float32)
    mul = rng.uniform(0.5, 1.5, (1, Ox)).astype(np.float32)
    add = (0.1 * rng.randn(1, Ox)).astype(np.float32)
    pk = rng.uniform(-1, 1, (n, Ox)).astype(np.float32) * Ox ** -0.5
    pb = (0.02 * rng.randn(1, n)).astype(np.float32)
    b = torch.bfloat16
    return (torch.from_numpy(x).to(b), torch.from_numpy(ek).to(b).t(),
            torch.from_numpy(eb), torch.from_numpy(mul),
            torch.from_numpy(add), torch.from_numpy(pk).to(b).t(),
            torch.from_numpy(pb))


def _kernel_walk(x, ek, eb, mul, add, pk, pb):
    """The kernel's walk in plain torch: 128-row tiles (x zero past M and
    past C, C padded to 272), the hidden in chunks of 64 (We^T, the
    vectors and Wp^T zero past O), h over 17 k-steps of the four 64-column
    slots and the 16-column tail slot, the epilogue's roundings, bf16(z)
    into an fp32 output chunk by chunk."""
    M, Cx = x.shape
    Ox, n = ek.shape[1], pk.shape[1]
    tiles, chunks = -(-M // 128), -(-Ox // 64)
    b, f = torch.bfloat16, torch.float32
    xp = torch.zeros(tiles * 128, 272, dtype=b)
    xp[:M, :Cx] = x
    wpad = torch.zeros(chunks * 64, 272, dtype=b)
    wpad[:Ox, :Cx] = ek.t()
    vec = torch.zeros(3, chunks * 64)
    vec[:, :Ox] = torch.cat([eb, mul, add])
    mulb, addb = vec[1].to(b), vec[2].to(b)
    wp = torch.zeros(n, chunks * 64, dtype=b)
    wp[:, :Ox] = pk.t()
    out = torch.zeros(tiles * 128, n, dtype=f)
    for c in range(chunks):
        j = slice(64 * c, 64 * (c + 1))
        h = torch.zeros(tiles * 128, 64, dtype=f)
        slots = [wpad[j, 64 * s:64 * (s + 1)] for s in range(4)]
        slots.append(wpad[j, 256:272])
        for k in range(17):
            cols = slice(16 * (k % 4), 16 * (k % 4 + 1))
            w = slots[k // 4][:, cols]
            h += xp[:, 16 * k:16 * (k + 1)].to(f) @ w.to(f).t()
        hc = (h + vec[0, j]).to(b)
        z = torch.relu(hc * mulb[j] + addb[j])
        out += z.to(f) @ wp[:, j].to(f).t()
    return (out[:M] + pb).to(b)


@pytest.mark.parametrize("n", [1, 21])
@pytest.mark.parametrize("M", [200, 130])
def test_kernel_walk_matches_plain_and_jax(M, n):
    """At M = 200 the last tile holds 72 rows (its second warpgroup 8),
    at M = 130 two (the second warpgroup none)."""
    args = _operands(M, n, seed=M + n)
    got = _kernel_walk(*args)
    plain = head.head_mlp_plain(*args)
    jargs = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
             if a.dtype == torch.bfloat16 else jnp.asarray(a.numpy())
             for a in args]
    ref = torch.from_numpy(np.array(
        head_mlp_reference(*jargs).astype(jnp.float32)))
    assert got.shape == plain.shape == (M, n) and got.dtype == torch.bfloat16
    for want in (plain.float(), ref):
        err = (got.float() - want).abs().max().item()
        assert err <= chip_smoke.KERNEL_ATOL, err
        # most elements agree exactly: only a flipped rounding differs
        assert (got.float() == want).float().mean().item() >= 0.9


def test_kernel_walk_zeroes_the_hidden_past_o():
    """At O = 1080 the last chunk holds 56 units: with add > 0 the padded
    units would give z = bf16(add) > 0, but the walk's zero vectors and
    zero Wp^T columns keep them out."""
    args = list(_operands(130, 3, seed=5, Ox=1080))
    args[4] = args[4].abs() + 0.5   # add > 0
    got = _kernel_walk(*args)
    plain = head.head_mlp_plain(*args)
    assert (got.float() - plain.float()).abs().max().item() <= (
        chip_smoke.KERNEL_ATOL)


def _cpu_operands():
    b = torch.bfloat16
    return (torch.zeros(8, 6, dtype=b), torch.zeros(24, 6, dtype=b).t(),
            *[torch.zeros(1, 24) for _ in range(3)],
            torch.zeros(3, 24, dtype=b).t(), torch.zeros(1, 3))


def test_kernel_route_refuses_a_cpu_tensor():
    args = _cpu_operands()
    with pytest.raises(ValueError,
                       match="head MLP forward: no kernel for cpu"):
        head.head_mlp_fwd_kernel(*args)
    # the dispatcher takes the plain version for the same tensors
    assert head.head_mlp_fwd(*args).shape == (8, 3)


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::head_fwd_tiles<4>((anonymous namespace)"
     "::Params)", "HRNet head kernel (fwd)"),
    ("void (anonymous namespace)::head_fwd_tiles<2>((anonymous namespace)"
     "::Params)", "HRNet head kernel (fwd)"),
    ("void (anonymous namespace)::head_fwd_pad(__nv_bfloat16 const*, "
     "float const*, float const*, float const*, int, int, __nv_bfloat16*, "
     "unsigned char*)", "HRNet head kernel (fwd)"),
    ("void (anonymous namespace)::head_bwd_rows<4>((anonymous namespace)"
     "::Args)", "HRNet head kernel (bwd)")])
def test_profile_classes_match_the_kernel_symbols(name, cls):
    assert classify(name) == cls


PTXAS = """\
ptxas info    : Function properties for _ZN52_GLOBAL__N__1b2c3d4e_17_head_mlp_fwd_cu_0a1b2c3d14head_fwd_tilesILi4EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


def test_variant_probe_reports_the_kernels_registers():
    """``tools/ln_mlp_bwd_variants.py`` reads kernel 7's registers and
    spills from nvcc's ptxas report, and holds its variant."""
    got = ln_mlp_bwd_variants._ptxas(PTXAS)
    assert list(got.values()) == [{"spill_stores": 0, "registers": 168}]
    assert "head_fwd_tiles" in next(iter(got))
    assert "head-fwd-mma-sync" in ln_mlp_bwd_variants.VARIANTS


def test_smoke_covers_the_ragged_and_path_b_rows():
    assert chip_smoke.HEAD_COVERAGE == (
        ("one 224-px image", 784), ("path B batch 32", 25088),
        ("path B batch 8", 6272))
