"""Port ops vs the JAX package: window layout, attention core, head MLP.

Inputs come from a numpy seed and go through both the JAX function
(Pallas kernels in interpret mode) and its port counterpart, in fp32 on
the CPU, where the port's kernel wrappers take their plain versions.
Tolerance 2e-5 (atol = rtol), as tests/test_pallas_wiring.py uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlora_tpu.models.heads import resize_bilinear as jax_resize
from mtlora_tpu.ops import attention as jattn
from mtlora_tpu.ops import window as jwin
from mtlora_tpu.ops.pallas_head import fused_head_mlp, head_mlp_reference
from mtlora_tpu.ops.pallas_window_attn import fused_window_attention_windowed
from mtlora_tpu_torch.models.heads import resize_bilinear
from mtlora_tpu_torch.ops import attention, window
from mtlora_tpu_torch.ops.adapter_mlp import fused_adapter_mid
from mtlora_tpu_torch.ops.head import head_mlp
from mtlora_tpu_torch.ops.ln_lora import (
    fused_ln_lora_linear,
    fused_merge_ln_linear,
)
from mtlora_tpu_torch.ops.ln_mlp import fused_ln_mlp
from mtlora_tpu_torch.ops.task_merge import fused_task_merge
from mtlora_tpu_torch.ops.window_attn import fused_window_attention

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("ws", [2, 4, 7])
def test_relative_position_index_matches_jax(ws):
    np.testing.assert_array_equal(attention.relative_position_index(ws),
                                  jattn.relative_position_index(ws))


@pytest.mark.parametrize("hw,ws,shift", [(14, 7, 3), (8, 4, 2), (28, 7, 3)])
def test_shift_mask_and_perm_match_jax(hw, ws, shift):
    np.testing.assert_array_equal(
        attention.shift_attention_mask(hw, hw, ws, shift),
        jattn.shift_attention_mask(hw, hw, ws, shift))
    for a, b in zip(window.shift_partition_perm(hw, hw, ws, shift),
                    jwin._shift_partition_perm(hw, hw, ws, shift)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shift", [0, 3])
def test_window_gather_matches_jax(shift):
    B, H, ws, C = 2, 14, 7, 5
    x = np.random.RandomState(0).randn(B, H * H, C).astype(np.float32)
    ref = jwin.shift_window_partition(jnp.asarray(x).reshape(B, H, H, C),
                                      ws, shift)
    xw = window.shift_window_partition(torch.from_numpy(x), H, H, ws, shift)
    np.testing.assert_array_equal(_np(xw),
                                  np.asarray(ref).reshape(-1, ws * ws, C))
    back = window.window_merge_unshift(xw, B, H, H, ws, shift)
    np.testing.assert_array_equal(_np(back), x)


def _attn_inputs(shift, seed=0):
    B, H, ws, nH, hd = 2, 14, 7, 2, 32
    N, C = ws * ws, nH * hd
    nW = (H // ws) ** 2
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B * nW, N, 3 * C).astype(np.float32)
    bias = (0.1 * rng.randn(nH, N, N)).astype(np.float32)
    mask = (attention.shift_attention_mask(H, H, ws, shift)
            if shift else None)
    return qkv, bias, mask, nH, nW, hd ** -0.5


@pytest.mark.parametrize("shift", [0, 3])
def test_window_attention_op_matches_jax(shift):
    """(a) N = 49, hd = 32, against the Pallas kernel (interpret) and the
    jnp attention core."""
    qkv, bias, mask, nH, nW, scale = _attn_inputs(shift)
    jmask = jnp.asarray(mask) if mask is not None else None
    k_ref = fused_window_attention_windowed(
        jnp.asarray(qkv), nH, jnp.asarray(bias), nW, jmask, scale=scale,
        interpret=True)
    j_ref = jattn.window_attention(jnp.asarray(qkv), nH, jnp.asarray(bias),
                                   jmask, scale=scale)
    out = fused_window_attention(
        torch.from_numpy(qkv), nH, torch.from_numpy(bias),
        torch.from_numpy(mask) if mask is not None else None, scale)
    np.testing.assert_allclose(_np(out), np.asarray(k_ref), **TOL)
    np.testing.assert_allclose(_np(out), np.asarray(j_ref), **TOL)


def test_window_attention_plain_bf16_cast_points():
    """The plain version rounds q*scale and P to bf16 and keeps scores
    and softmax in fp32: it agrees with the jnp core run in bf16."""
    qkv, bias, mask, nH, nW, scale = _attn_inputs(3, seed=1)
    q16 = torch.from_numpy(qkv).to(torch.bfloat16)
    out = attention.window_attention(q16, nH, torch.from_numpy(bias),
                                     torch.from_numpy(mask), scale)
    ref = jattn.window_attention(
        jnp.asarray(_np(q16.float()), jnp.bfloat16), nH, jnp.asarray(bias),
        jnp.asarray(mask), scale=scale)
    assert out.dtype == torch.bfloat16
    # one bf16 ulp of the output (|out| < 4 -> 2^-6) for sums taken in
    # another order before the final rounding
    np.testing.assert_allclose(_np(out.float()),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=2 ** -6, rtol=0)


def _head_inputs(n, seed=0, M=128, C=270):
    rng = np.random.RandomState(seed)
    O = 4 * C
    x = rng.randn(M, C).astype(np.float32)
    ek = (rng.randn(C, O) / np.sqrt(C)).astype(np.float32)
    eb = (0.1 * rng.randn(1, O)).astype(np.float32)
    mul = rng.uniform(0.5, 1.5, (1, O)).astype(np.float32)
    add = (0.1 * rng.randn(1, O)).astype(np.float32)
    pk = (rng.randn(O, n) / np.sqrt(O)).astype(np.float32)
    pb = (0.1 * rng.randn(1, n)).astype(np.float32)
    return x, ek, eb, mul, add, pk, pb


@pytest.mark.parametrize("n", [1, 3, 7, 21])
def test_head_mlp_op_matches_jax(n):
    """(b) against the Pallas head kernel (interpret) and its reference."""
    args = _head_inputs(n)
    jargs = [jnp.asarray(a) for a in args]
    k_ref = fused_head_mlp(*jargs, interpret=True)
    j_ref = head_mlp_reference(*jargs)
    out = head_mlp(*[torch.from_numpy(a) for a in args])
    np.testing.assert_allclose(_np(out), np.asarray(k_ref), **TOL)
    np.testing.assert_allclose(_np(out), np.asarray(j_ref), **TOL)


def _meta(*arrays):
    return [torch.zeros(a.shape, dtype=torch.float32, device="meta")
            for a in arrays]


@pytest.mark.parametrize("op", ["attention", "head", "ln_lora", "merge",
                                "ln_mlp", "ln_lora_tail", "adapter_mid",
                                "task_merge"])
def test_wrappers_refuse_devices_without_kernel(op):
    """A tensor that is neither on the CPU nor on a CUDA card gets an
    error, never the plain version."""
    seed = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        if op == "attention":
            qkv, bias, mask, nH, _, scale = _attn_inputs(0)
            fused_window_attention(torch.from_numpy(qkv).to("meta"), nH,
                                   torch.from_numpy(bias).to("meta"), None,
                                   scale)
        elif op == "head":
            head_mlp(*[torch.from_numpy(a).to("meta")
                       for a in _head_inputs(3)])
        elif op == "ln_lora":
            # x, gamma, beta, wt, bias, at, bt
            args = _meta(*[np.zeros(s) for s in ((98, 32), (32,), (32,),
                                                  (96, 32), (96,), (16, 32),
                                                  (96, 16))])
            fused_ln_lora_linear(*args, seed, 4.0, 0.0)
        elif op == "merge":
            args = _meta(*[np.zeros(s) for s in ((2, 256, 8), (32,), (32,),
                                                  (16, 32))])
            fused_merge_ln_linear(*args, 16, 16)
        elif op == "ln_mlp":
            # x, gamma, beta, fc1 (w, b, A, B), fc2 (w, b, A, B)
            C, H4, r = 32, 128, 64
            args = _meta(*[np.zeros(s) for s in (
                (64, C), (C,), (C,), (H4, C), (H4,), (r, C), (H4, r),
                (C, H4), (C,), (r, H4), (C, r))])
            fused_ln_mlp(*args, seed, 4.0, 4.0, 0.0)
        elif op == "ln_lora_tail":
            args = _meta(*[np.zeros(s) for s in ((98, 32), (32,), (32,),
                                                  (128, 32), (128,), (16, 32),
                                                  (128, 16))])
            fused_ln_lora_linear(*args, seed, 4.0, 0.0, out_p=True,
                                 out_act=True)
        elif op == "adapter_mid":
            # mid1T, p1, b1, a2T
            fused_adapter_mid(*_meta(*[np.zeros(s) for s in (
                (4, 4, 64), (64, 128), (4, 4, 128), (4, 4, 128))]),
                (4.0,) * 4)
        else:
            # base, pre, p2, mid1T, b1, mid2T, b2; gamma, beta, wt
            B, H, C, T = 2, 8, 16, 4
            t = _meta(*[np.zeros(s) for s in (
                (B, H * H, C), (B, H * H, C), (B, H * H, C),
                (T, 4, B * H * H), (T, 4, C), (T, 4, B * H * H), (T, 4, C),
                (4 * C,), (4 * C,), (2 * C, 4 * C))])
            fused_task_merge(*t[:7], None, None, (4.0,) * T, (4.0,) * T,
                             *t[7:], H, H)


@pytest.mark.parametrize("src,dst", [((8, 8), (16, 16)), ((2, 2), (8, 8)),
                                     ((4, 4), (64, 64)), ((8, 8), (8, 8))])
def test_resize_bilinear_matches_jax_upsampling(src, dst):
    x = np.random.RandomState(0).randn(2, *src, 5).astype(np.float32)
    ref = jax_resize(jnp.asarray(x), dst)
    out = resize_bilinear(torch.from_numpy(x), dst)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
