"""The launch plan of kernel 4b (``ops/ln_mlp.py:bwd_plan``) on the CPU.

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
"""

import re
import shutil

import pytest
import torch

from mtlora_tpu_torch.ops import _build, ln_mlp
from mtlora_tpu_torch.tools import ln_mlp_bwd_variants

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


@pytest.mark.parametrize("name", sorted(ln_mlp_bwd_variants.VARIANTS))
def test_variant_probe_edits_apply_to_the_sources(name, tmp_path):
    pkg = tmp_path / "mtlora_tpu_torch"
    shutil.copytree(ln_mlp_bwd_variants.ROOT / "mtlora_tpu_torch", pkg)
    ln_mlp_bwd_variants.apply_edits(pkg, ln_mlp_bwd_variants.VARIANTS[name])
    for rel, old, new in ln_mlp_bwd_variants.VARIANTS[name]:
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
