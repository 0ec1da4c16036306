"""The launch plan of kernel 7b (``ops/head.py:bwd_plan``) on the CPU.

At the head's shapes (C = 270 inputs, O = 1080 hidden, n in {1, 3, 7, 21}
outputs) for the rows of the batch-32 step (100,352), path B's 25,088 and
6,272, and one 224-px image (784, not a multiple of the 64-row blocks):
the rows per block, the ring depth and the shared memory against the
H100's 232,448 bytes a block, the blocks with the ragged last one
counted, the scratch that the wrapper allocates, the constants of
``csrc/head_mlp_bwd.cu`` that the plan sizes shared memory by (the plan
owns the launch: the C entry point takes its ring depth and bytes, and
the kernel traps on the card if the bytes do not hold its layout), and
the wrapper's refusals.
"""

import re

import pytest
import torch

from mtlora_tpu_torch.ops import _build, head
from mtlora_tpu_torch.ops.ln_lora import stripes_for

SMS = 132   # the H100's SMs
C, O = 270, 1080
ROWS = [100352, 25088, 6272, 784]
OUTS = [1, 3, 7, 21]


@pytest.mark.parametrize("n", OUTS)
@pytest.mark.parametrize("M", ROWS)
def test_plan_rows_ring_and_shared_memory(M, n):
    plan = head.bwd_plan(M, C, O, n, SMS)
    assert plan.bm == 64 and plan.chunk == 64
    # four hidden chunks in flight fit beside the tiles at n <= 32
    assert plan.stages == 4
    assert plan.smem <= head.SMEM_LIMIT == 232_448
    assert plan.np == 16 * -(-n // 16)
    assert plan.ng == 8 * -(-n // 8)
    # the last block masks its rows past M
    assert plan.blocks == -(-M // 64)
    assert (plan.blocks - 1) * 64 < M <= plan.blocks * 64
    # two whole waves of lnk::wgrad's blocks, six to an SM
    assert plan.sw == stripes_for(SMS, M, O, C, 12)
    assert plan.sp == stripes_for(SMS, M, n, O, 12)
    if M == 100352:
        assert (plan.sw, plan.sp) == (18, 93)
    assert 1 <= plan.sw <= plan.blocks and 1 <= plan.sp <= plan.blocks


@pytest.mark.parametrize("n", OUTS)
@pytest.mark.parametrize("M", ROWS)
def test_plan_scratch_is_what_the_wrapper_allocates(M, n):
    plan = head.bwd_plan(M, C, O, n, SMS)
    bf16, f32 = torch.bfloat16, torch.float32
    assert plan.scratch == {
        "wpad": ((O, 272), bf16),
        "xpad": ((M, 272), bf16),
        "gypad": ((M, plan.ng), bf16),
        "dhc": ((M, O), bf16),
        "z": ((M, O), bf16),
        "cols": ((plan.blocks, 3 * O + n), f32),
        "part": ((max(plan.sw * O * C, plan.sp * n * O),), f32),
        "sums": ((O * C + n * O + 3 * O + n,), f32),
    }
    # small rows allocate the same layout for real
    small = head.bwd_plan(100, C, O, n, SMS)
    got = head.bwd_scratch(small, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (tuple(s), dt) for k, (s, dt) in small.scratch.items()}


def test_plan_falls_back_to_three_stages_where_four_do_not_fit():
    four = head.bwd_plan(784, C, O, 32, SMS)
    three = head.bwd_plan(784, C, O, 64, SMS)
    assert four.stages == 4 and three.stages == 3
    assert three.smem <= head.SMEM_LIMIT < head._row_smem(4, 64)


def test_plan_constants_match_the_cuda_source():
    src = (_build.CSRC / "head_mlp_bwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kBM") == head.BWD_ROWS
    assert const("kHC") == head.BWD_CHUNK
    assert const("kWarps") == head.BWD_WARPS
    assert const("kKp") == head.MAX_C_BWD
    assert const("kNMax") == head.MAX_OUT


def _message(Cx, Ox, n):
    return (f"head MLP backward kernel: needs even C <= 272 ({Cx}), O % 8 "
            f"== 0 ({Ox}) and 1 <= n <= 64 ({n})")


# (C, O, n): C above 272, odd C, odd O, O not a multiple of 8, n of 0 and
# of 65
REFUSED = [(274, 1096, 21), (269, 1076, 21), (270, 1081, 21),
           (270, 1084, 21), (270, 1080, 0), (270, 1080, 65)]


@pytest.mark.parametrize("Cx,Ox,n", REFUSED)
def test_plan_refuses_shapes_outside_the_kernel(Cx, Ox, n):
    with pytest.raises(ValueError) as err:
        head.bwd_plan(784, Cx, Ox, n, SMS)
    assert str(err.value) == _message(Cx, Ox, n)


def _head_operands(M=8, Cx=6, n=3):
    Ox = 4 * Cx
    x = torch.zeros(M, Cx, dtype=torch.bfloat16)
    ek = torch.zeros(Ox, Cx, dtype=torch.bfloat16).t()
    vec = [torch.zeros(1, Ox) for _ in range(3)]
    pk = torch.zeros(n, Ox, dtype=torch.bfloat16).t()
    return (x, ek, *vec, pk, torch.zeros(1, n)), torch.zeros(
        M, n, dtype=torch.bfloat16)


def test_kernel_route_refuses_a_cpu_tensor():
    args, gy = _head_operands()
    with pytest.raises(ValueError,
                       match="head MLP backward: no kernel for cpu"):
        head.head_mlp_bwd_kernel(*args, gy)
    # the dispatcher takes the plain version for the same tensors
    assert len(head.head_mlp_bwd(*args, gy)) == 7
