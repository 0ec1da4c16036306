"""Port backward ops vs the JAX package: window attention and the HRNet
head (the plain versions of kernels 1b and 7b), the BN batch moments, and
the two autograd Functions' CPU routes.

Inputs come from a numpy seed; the JAX side is ``jax.vjp`` of the Pallas
kernels in interpret mode. Tolerances: fp32 2e-5 (atol = rtol, as
tests/test_torch_port_ops.py), bf16 as stated where used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlora_tpu.ops.pallas_head import bn_stats_from_x as jax_bn_stats
from mtlora_tpu.ops.pallas_head import fused_head_mlp
from mtlora_tpu.ops.pallas_window_attn import fused_window_attention_windowed
from mtlora_tpu_torch.ops import attention
from mtlora_tpu_torch.ops.head import (
    HeadMLPFn,
    bn_stats_from_x,
    head_bwd_rows_plain,
    head_bwd_weights_plain,
    head_mlp_bwd_plain,
)
from mtlora_tpu_torch.ops.window_attn import (
    WindowAttentionFn,
    window_attention_bwd_plain,
)

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)


def _np(t):
    return t.detach().float().cpu().numpy()


def _attn_inputs(shift, seed=0, B=2, H=14, ws=7, nH=2, hd=32):
    N, C = ws * ws, nH * hd
    nW = (H // ws) ** 2
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B * nW, N, 3 * C).astype(np.float32)
    bias = (0.1 * rng.randn(nH, N, N)).astype(np.float32)
    do = rng.randn(B * nW, N, C).astype(np.float32)
    mask = (attention.shift_attention_mask(H, H, ws, shift)
            if shift else None)
    return qkv, bias, mask, do, nH, nW, hd ** -0.5


def _jax_attn_vjp(qkv, bias, mask, do, nH, nW, scale):
    jmask = jnp.asarray(mask) if mask is not None else None

    def f(q, b):
        return fused_window_attention_windowed(q, nH, b, nW, jmask,
                                               scale=scale, interpret=True)

    _, vjp = jax.vjp(f, qkv, jnp.asarray(bias))
    return vjp(do)


@pytest.mark.parametrize("shift", [0, 3])
def test_attention_bwd_plain_matches_jax_fp32(shift):
    """dqkv and dbias (summed over windows), N = 49, hd = 32, fp32."""
    qkv, bias, mask, do, nH, nW, scale = _attn_inputs(shift)
    dq_ref, db_ref = _jax_attn_vjp(jnp.asarray(qkv), bias, mask,
                                   jnp.asarray(do), nH, nW, scale)
    dq, db = window_attention_bwd_plain(
        torch.from_numpy(qkv), nH, torch.from_numpy(bias),
        torch.from_numpy(mask) if mask is not None else None, scale,
        torch.from_numpy(do))
    np.testing.assert_allclose(_np(dq), np.asarray(dq_ref), **TOL)
    np.testing.assert_allclose(_np(db), np.asarray(db_ref), **TOL)


@pytest.mark.parametrize("shift", [0, 3])
def test_attention_bwd_plain_matches_jax_bf16(shift):
    """bf16 qkv and dO: dqkv within one bf16 ulp of the element (2^-7
    relative: the last bit flips where fp32 sums taken in another order
    round the other way) plus 2^-14 of the largest element (values that
    cancel to near zero in fp32), differing on at most 0.1% of the
    elements; dbias (fp32) at 1e-4 relative to its largest element."""
    qkv, bias, mask, do, nH, nW, scale = _attn_inputs(shift, seed=1)
    q16 = jnp.asarray(qkv, jnp.bfloat16)
    d16 = jnp.asarray(do, jnp.bfloat16)
    dq_ref, db_ref = _jax_attn_vjp(q16, bias, mask, d16, nH, nW, scale)
    dq, db = window_attention_bwd_plain(
        torch.from_numpy(np.array(q16.astype(jnp.float32))).bfloat16(),
        nH, torch.from_numpy(bias),
        torch.from_numpy(mask) if mask is not None else None, scale,
        torch.from_numpy(np.array(d16.astype(jnp.float32))).bfloat16())
    assert dq.dtype == torch.bfloat16 and db.dtype == torch.float32
    ref = np.asarray(dq_ref.astype(jnp.float32))
    diff = np.abs(_np(dq) - ref)
    assert (diff <= np.abs(ref) * 2.0 ** -7
            + 2.0 ** -14 * np.abs(ref).max()).all()
    assert (diff > 0).mean() <= 1e-3
    db_ref = np.asarray(db_ref)
    np.testing.assert_allclose(_np(db), db_ref, rtol=0,
                               atol=1e-4 * np.abs(db_ref).max())


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
    gy = rng.randn(M, n).astype(np.float32)
    return [x, ek, eb, mul, add, pk, pb], gy


@pytest.mark.parametrize("n", [1, 3, 7, 21])
def test_head_bwd_plain_matches_jax(n):
    """All seven gradients against the Pallas head's VJP (interpret)."""
    args, gy = _head_inputs(n)
    _, vjp = jax.vjp(lambda *a: fused_head_mlp(*a, interpret=True),
                     *[jnp.asarray(a) for a in args])
    refs = vjp(jnp.asarray(gy))
    grads = head_mlp_bwd_plain(*[torch.from_numpy(a) for a in args],
                               torch.from_numpy(gy))
    names = ("dx", "dek", "deb", "dmul", "dadd", "dpk", "dpb")
    for name, g, ref in zip(names, grads, refs):
        assert g.shape == ref.shape, name
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(_np(g), np.asarray(ref), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def _head_bwd_formula(x, ek, eb, mul, add, pk, pb, gy):
    """The head backward as one formula (the plain version before it was
    split into its row pass and weight products)."""
    cdt, f = x.dtype, torch.float32
    hc = (torch.matmul(x.to(f), ek.to(f)) + eb.to(f)).to(cdt)
    zpre = hc * mul.to(cdt) + add.to(cdt)
    z = torch.relu(zpre)
    gyf = gy.to(f)
    gyc = gy.to(cdt).to(f)
    dpb = gyf.sum(0, keepdim=True)
    dpk = torch.matmul(z.to(f).t(), gyc)
    dz = torch.matmul(gyc, pk.to(f).t())
    dzp = torch.where(zpre.to(f) > 0, dz, torch.zeros_like(dz))
    dadd = dzp.sum(0, keepdim=True)
    dmul = (dzp * hc.to(f)).sum(0, keepdim=True)
    dh = dzp * mul.to(f)
    deb = dh.sum(0, keepdim=True)
    dhc = dh.to(cdt).to(f)
    dek = torch.matmul(x.to(f).t(), dhc)
    dx = torch.matmul(dhc, ek.to(f).t())
    return (dx.to(x.dtype), dek.to(ek.dtype), deb.to(eb.dtype),
            dmul.to(mul.dtype), dadd.to(add.dtype), dpk.to(pk.dtype),
            dpb.to(pb.dtype))


def _head_torch(args, gy, dtype):
    """The numpy inputs as torch: x, ek, pk and gy in ``dtype`` (the
    kernel's operands), eb, mul, add, pb fp32."""
    ts = [torch.from_numpy(a) for a in args]
    for i in (0, 1, 5):
        ts[i] = ts[i].to(dtype)
    return ts, torch.from_numpy(gy).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [128, 100])
@pytest.mark.parametrize("n", [1, 3, 7, 21])
def test_head_bwd_split_is_the_formula_bit_for_bit(n, M, dtype):
    """The row pass then the weight products give the one-formula
    backward's bits; the row pass's dhc and z are its rounded values."""
    ts, gy = _head_torch(*_head_inputs(n, seed=n, M=M), dtype)
    want = _head_bwd_formula(*ts, gy)
    for name, g, w in zip(("dx", "dek", "deb", "dmul", "dadd", "dpk", "dpb"),
                          head_mlp_bwd_plain(*ts, gy), want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    x, ek, eb, mul, add, pk, _ = ts
    dx, dhc, z, *_ = head_bwd_rows_plain(x, ek, eb, mul, add, pk, gy)
    assert dhc.dtype == z.dtype == dx.dtype == dtype
    assert dhc.shape == z.shape == (M, ek.shape[1])
    zpre = ((x.float() @ ek.float() + eb).to(dtype) * mul.to(dtype)
            + add.to(dtype))
    assert torch.equal(z, torch.relu(zpre))
    dek, dpk = head_bwd_weights_plain(x, gy, dhc, z)
    assert torch.equal(dek.to(dtype), want[1])
    assert torch.equal(dpk.to(dtype), want[5])


# the Pallas head takes M % 8 == 0: 104 rows, not a multiple of the
# kernel's 64-row blocks, is the ragged case
@pytest.mark.parametrize("M", [128, 104])
@pytest.mark.parametrize("n", [1, 3, 7, 21])
def test_head_bwd_split_matches_jax(n, M):
    """The row pass and the weight products against the Pallas head's VJP
    (interpret), fp32."""
    args, gy = _head_inputs(n, seed=10 + n, M=M)
    _, vjp = jax.vjp(lambda *a: fused_head_mlp(*a, interpret=True),
                     *[jnp.asarray(a) for a in args])
    refs = vjp(jnp.asarray(gy))
    x, ek, eb, mul, add, pk, _ = (torch.from_numpy(a) for a in args)
    g = torch.from_numpy(gy)
    dx, dhc, z, deb, dmul, dadd, dpb = head_bwd_rows_plain(x, ek, eb, mul,
                                                           add, pk, g)
    dek, dpk = head_bwd_weights_plain(x, g, dhc, z)
    names = ("dx", "dek", "deb", "dmul", "dadd", "dpk", "dpb")
    for name, t, ref in zip(names, (dx, dek, deb, dmul, dadd, dpk, dpb),
                            refs):
        assert t.shape == ref.shape, name
        np.testing.assert_allclose(_np(t), np.asarray(ref), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_bn_stats_from_x_matches_jax_with_grad():
    """Batch moments and their gradient through the covariance path."""
    rng = np.random.RandomState(5)
    M, C, O = 96, 12, 48
    x = rng.randn(M, C).astype(np.float32)
    ek = (rng.randn(C, O) / np.sqrt(C)).astype(np.float32)
    eb = (0.1 * rng.randn(O)).astype(np.float32)
    wm, wv = rng.randn(O).astype(np.float32), rng.randn(O).astype(np.float32)

    def jloss(x, ek, eb):
        mu, var = jax_bn_stats(x, ek, eb)
        return jnp.sum(mu * wm) + jnp.sum(var * wv), (mu, var)

    (_, (mu_ref, var_ref)), g_ref = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(ek), jnp.asarray(eb))
    tx, tek, teb = (torch.from_numpy(a).requires_grad_() for a in (x, ek, eb))
    mu, var = bn_stats_from_x(tx, tek, teb)
    ((mu * torch.from_numpy(wm)).sum()
     + (var * torch.from_numpy(wv)).sum()).backward()
    np.testing.assert_allclose(_np(mu), np.asarray(mu_ref), **TOL)
    np.testing.assert_allclose(_np(var), np.asarray(var_ref), atol=1e-4,
                               rtol=1e-4)
    for t, ref in zip((tx, tek, teb), g_ref):
        np.testing.assert_allclose(_np(t.grad), np.asarray(ref), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("shift", [0, 2])
def test_attention_fn_gradcheck_float64(shift):
    """The Function's CPU route (plain forward, plain backward) in fp64,
    qkv and the bias checked, the mask held constant."""
    qkv, bias, mask, _, nH, _, scale = _attn_inputs(
        shift, B=1, H=8, ws=4, nH=2, hd=8)
    q = torch.from_numpy(qkv).double().requires_grad_()
    b = torch.from_numpy(bias).double().requires_grad_()
    m = torch.from_numpy(mask).double() if mask is not None else None
    assert torch.autograd.gradcheck(
        lambda q, b: WindowAttentionFn.apply(q, b, m, nH, scale), (q, b))


def test_head_fn_gradcheck_float64():
    args, _ = _head_inputs(3, M=16, C=6)
    ts = [torch.from_numpy(a).double().requires_grad_() for a in args]
    # keep pre-activations away from the ReLU kink for finite differences
    with torch.no_grad():
        ts[4] += 0.5
    assert torch.autograd.gradcheck(HeadMLPFn.apply, tuple(ts))
