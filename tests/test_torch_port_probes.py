"""The port's GELU forms and its probe kernels vs the JAX package.

GELU: in bf16 the JAX kernels 2 (tail mode), 4 and 5 take the tanh form
(``_gelu_fwd``/``_gelu_pair`` with ``cheap``); the port's plain versions
(and kernels) follow the compute dtype the same way. The plain versions
are held to the JAX kernels in interpret mode at bf16 inputs, and, with
both packages made to take the tanh form in fp32, at 2e-5 of each
output's largest element (the bound of the fp32 kernel tests).

Probes: ``tools/attn_probe.py``, ``tools/attn_variants.py`` and
``tools/adapter_variants.py`` hold TPU kernel bodies that pass no
``interpret``; each body runs here through this file's own
``pl.pallas_call(..., interpret=True)`` at a small shape (two windows of
49 tokens with two heads; T = R = 4 tasks and ranks with M = 64 tokens
and H4 = 64 hidden columns) against the port's plain version. The probe
files are loaded by path and the ``JAX_COMPILATION_CACHE_DIR`` and
``sys.path`` changes that ``adapter_variants.py`` makes on import are
undone. Tolerances: fp32 within 2e-5 of the largest element (the JAX
bodies' Abramowitz-Stegun erf, 1.5e-7 from the exact erf, their
approximate reciprocal refined by a Newton step, and sums taken in other
orders); bf16 within 2^-6 of the largest element (the same cast points,
where fp32 sums in another order flip a bf16 rounding of an intermediate
and of the output).
"""

import functools
import importlib.util
import os
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mtlora_tpu.ops import pallas_adapter_mlp, pallas_ln_lora, pallas_ln_mlp
from mtlora_tpu.ops.pallas_adapter_mlp import (
    _gelu_fwd,
    _gelu_pair,
    fused_adapter_mid,
)
from mtlora_tpu.ops.pallas_ln_lora import fused_ln_lora_linear as jax_ln_lora
from mtlora_tpu.ops.pallas_ln_mlp import fused_ln_mlp as jax_ln_mlp
from mtlora_tpu_torch.ops import adapter_mlp as port_adapter_mlp
from mtlora_tpu_torch.ops import counters
from mtlora_tpu_torch.ops import ln_lora as port_ln_lora
from mtlora_tpu_torch.ops.adapter_mlp import (
    BWD_PROBES,
    FWD_PROBES,
    KERNEL5B_ACT,
    adapter_mid_bwd_plain,
    adapter_mid_bwd_probe,
    adapter_mid_plain,
    adapter_mid_probe,
)
from mtlora_tpu_torch.ops.ln_lora import (
    act_pair,
    gelu_form,
    ln_lora_tail_bwd_plain,
    ln_lora_tail_plain,
)
from mtlora_tpu_torch.ops.ln_mlp import ln_mlp_bwd_plain, ln_mlp_plain
from mtlora_tpu_torch.ops.quad_attn import quad_attention
from mtlora_tpu_torch.ops.window_attn import (
    PROBE_MODES,
    window_attention_probe,
)

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
BF16_REL = 2.0 ** -6
FP32_REL = 2e-5
# the sigmoid form's reciprocal on the TPU: an approximation refined by one
# Newton step, 2^-16 from the exact divide in interpret mode
SIG_RECIP_REL = 2.0 ** -16
T = R = 4
SCALES = (2.0, 1.0, 4.0, 0.5)


def _np(t):
    return t.detach().float().cpu().numpy()


def _near_top(got, want, rel):
    """Within ``rel`` of the largest element of ``want``."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got if isinstance(got, np.ndarray) else _np(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64)
                                  - np.asarray(b, np.float64)) ** 2)))


def _pair(arrays, dtype):
    """The same values as JAX arrays and torch tensors of ``dtype``."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    j = [jnp.asarray(a, jdt) for a in arrays]
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)
         for a in j]
    return j, t


def _load_probe(name):
    """``tools/<name>.py`` as a module, with the process environment and
    ``sys.path`` left as they were."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            f"_jax_probe_{name}", ROOT / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
        if env is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = env
    return mod


@pytest.fixture(scope="module")
def probes():
    return {name: _load_probe(name)
            for name in ("attn_probe", "attn_variants", "adapter_variants")}


# ---------------------------------------------------------------------------
# The GELU forms
# ---------------------------------------------------------------------------

def test_gelu_form_follows_the_compute_dtype():
    """The tanh form where the JAX kernels take it (bf16), exact erf in
    fp32 and fp64."""
    assert gelu_form(torch.bfloat16) == "tanh"
    assert gelu_form(torch.float32) == "erf"
    assert gelu_form(torch.float64) == "erf"


@pytest.mark.parametrize("cheap", [True, False])
def test_gelu_pair_matches_jax(cheap):
    """``act_pair`` against ``_gelu_fwd(z, cheap)`` and ``_gelu_pair(z,
    cheap)`` on z in [-8, 8], fp32: gelu within 1e-6 (two fp32 ulps at
    |z| = 4; the erf case also holds the A&S erf, 1.5e-7). gelu' within
    5e-6: XLA's fp32 tanh is up to 2.6e-7 (4 ulps) from the correctly
    rounded tanh that torch computes, and gelu' multiplies an error of th
    by |0.5 - th z (c + 3 c d z^2)|, up to 17.5 near |z| = 5."""
    z = np.linspace(-8.0, 8.0, 16001, dtype=np.float32)
    h, dg = act_pair(torch.from_numpy(z), "tanh" if cheap else "erf")
    h_ref = _gelu_fwd(jnp.asarray(z), cheap)
    h2_ref, dg_ref = _gelu_pair(jnp.asarray(z), cheap)
    for got, want, tol in ((h, h_ref, 1e-6), (h, h2_ref, 1e-6),
                           (dg, dg_ref, 5e-6)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=tol)


def test_sig_pair_matches_the_probe(probes):
    """The sigmoid form against ``_sig_gelu`` and ``sig_pair`` of
    ``tools/adapter_variants.py`` (their approximate reciprocal needs a
    kernel: an interpret-mode ``pallas_call``), fp32 on z in [-8, 8]. The
    port divides exactly where the probe refines an approximate
    reciprocal, so s = sigma(w) differs by up to 2^-16 of itself: h = z s
    is held within 2^-15 of each value, gelu' (which moves by s 2^-16
    |1 + z (1 - 2 s)(a + 3 b z^2)| <= 2^-16 (1 + |z| (a + 3 b z^2)))
    within twice that bound, each plus 1e-6."""
    adv = probes["adapter_variants"]
    z = np.linspace(-8.0, 8.0, 4096, dtype=np.float32).reshape(32, 128)

    def kern(z_ref, h_ref, h2_ref, dg_ref):
        h_ref[...] = adv._sig_gelu(z_ref[...])
        h2_ref[...], dg_ref[...] = adv.sig_pair(z_ref[...])

    shape = jax.ShapeDtypeStruct(z.shape, jnp.float32)
    refs = pl.pallas_call(kern, out_shape=(shape,) * 3, interpret=True)(
        jnp.asarray(z))
    h, dg = act_pair(torch.from_numpy(z), "sig")
    h_ref, h2_ref, dg_ref = (np.asarray(r) for r in refs)
    for want in (h_ref, h2_ref):
        assert np.all(np.abs(_np(h) - want)
                      <= 2 * SIG_RECIP_REL * np.abs(want) + 1e-6)
    gain = 1 + np.abs(z) * (port_ln_lora.SIG_A + 3 * port_ln_lora.SIG_B * z * z)
    assert np.all(np.abs(_np(dg) - dg_ref) <= 2 * SIG_RECIP_REL * gain + 1e-6)


# ---------------------------------------------------------------------------
# Kernels 2 (tail mode), 4 and 5 with the GELU of their compute dtype
# ---------------------------------------------------------------------------

def _mid_case(dtype, seed=0, M=96, H4=64):
    """Kernel 5: forward output and VJP of ``fused_adapter_mid``
    (interpret) and of the port's plain versions, as numpy pairs."""
    rng = np.random.RandomState(seed)
    Tm = 3
    arrays = [0.7 * rng.randn(Tm, R, M), 1.2 * rng.randn(M, H4),
              0.4 * rng.randn(Tm, R, H4), 0.3 * rng.randn(Tm, R, H4)]
    g = rng.randn(Tm, R, M)
    scales = SCALES[:Tm]
    j, t = _pair(arrays, dtype)
    (jg,), (tg,) = _pair([g], dtype)
    y_ref, vjp = jax.vjp(lambda *a: fused_adapter_mid(*a, scales, True), *j)
    refs = [y_ref, *vjp(jg)]
    got = [adapter_mid_plain(*t, scales),
           *adapter_mid_bwd_plain(*t, scales, tg)]
    return got, refs


def _tail_case(dtype, seed=1, M=64, K=32, O=128, r=16):
    """Kernel 2's tail mode (``out_p``, ``out_act``): y, p and the VJP
    from the cotangents of y and p, no dropout."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(M, K) * 2 + 0.5, rng.uniform(0.8, 1.2, K),
              0.1 * rng.randn(K), rng.randn(K, O) / np.sqrt(K),
              0.1 * rng.randn(O), rng.randn(K, r) / np.sqrt(K),
              0.3 * rng.randn(r, O)]
    j, t = _pair(arrays, dtype)
    (jgy, jgp), (tgy, tgp) = _pair([rng.randn(M, O), rng.randn(M, O)], dtype)
    seed_j = jnp.zeros((2,), jnp.int32)
    w, b = j[3], j[4]

    def f(x, g, be, A, B):
        return jax_ln_lora(x, g, be, w, b, A, B, seed_j, 4.0, 0.0, True,
                           True, False, interpret=True)

    (y_r, p_r), vjp = jax.vjp(f, j[0], j[1], j[2], j[5], j[6])
    dx, dg, db, dA, dB = vjp((jgy, jgp))
    refs = [y_r, p_r, dx, dg, db, dA.T, dB.T]
    args = [t[0], t[1], t[2], t[3].T.contiguous(), t[4],
            t[5].T.contiguous(), t[6].T.contiguous()]
    zs = torch.zeros(2, dtype=torch.int32)
    y, p, d = ln_lora_tail_plain(*args, zs, 4.0, 0.0)
    assert d is None
    got = [y, p, *ln_lora_tail_bwd_plain(*args, zs, 4.0, 0.0, tgy, tgp)]
    return got, refs


MLP_TRAINED = (0, 1, 2, 5, 6, 9, 10)   # x, gamma, beta, a1, br1, a2, br2


def _mlp_case(dtype, seed=2, M=64, C=32, r=8):
    """Kernel 4: y and the VJP for x, gamma, beta and the four adapter
    matrices, no dropout."""
    rng = np.random.RandomState(seed)
    H4 = 4 * C
    arrays = [rng.randn(M, C) * 1.5, rng.uniform(0.8, 1.2, C),
              0.1 * rng.randn(C), rng.randn(C, H4) / np.sqrt(C),
              0.3 * rng.randn(H4), rng.randn(C, r) / np.sqrt(C),
              0.3 * rng.randn(r, H4), rng.randn(H4, C) / np.sqrt(H4),
              0.1 * rng.randn(C), rng.randn(H4, r) / np.sqrt(H4),
              0.3 * rng.randn(r, C)]
    j, t = _pair(arrays, dtype)
    (jgy,), (tgy,) = _pair([rng.randn(M, C)], dtype)
    seed_j = jnp.zeros((2,), jnp.int32)

    def f(*tr):
        full = list(j)
        for i, v in zip(MLP_TRAINED, tr):
            full[i] = v
        return jax_ln_mlp(*full, seed_j, 4.0, 2.0, 0.0, interpret=True)

    y_r, vjp = jax.vjp(f, *[j[i] for i in MLP_TRAINED])
    grads = vjp(jgy)
    refs = [y_r] + [g.T if i >= 5 else g
                    for i, g in zip(MLP_TRAINED, grads)]
    args = [v.T.contiguous() if i in (3, 5, 6, 7, 9, 10) else v
            for i, v in enumerate(t)]
    zs = torch.zeros(2, dtype=torch.int32)
    got = [ln_mlp_plain(*args, zs, 4.0, 2.0, 0.0),
           *ln_mlp_bwd_plain(*args, zs, 4.0, 2.0, 0.0, tgy)]
    return got, refs


CASES = {"adapter_mid": _mid_case, "ln_lora_tail": _tail_case,
         "ln_mlp": _mlp_case}


def _port_form(monkeypatch, form):
    """The port's plain versions on ``form`` whatever the dtype (each
    module's own name of ``gelu_form``)."""
    for mod in (port_ln_lora, port_adapter_mlp):
        monkeypatch.setattr(mod, "gelu_form", lambda cdt: form)


@pytest.fixture
def tanh_everywhere(monkeypatch):
    """Both packages on the tanh form whatever the dtype: the JAX kernels'
    ``cheap`` forced on (each module's own imported names), the port's
    ``gelu_form``."""
    for mod in (pallas_adapter_mlp, pallas_ln_lora, pallas_ln_mlp):
        monkeypatch.setattr(mod, "_gelu_fwd",
                            lambda z, cheap: _gelu_fwd(z, True))
        monkeypatch.setattr(mod, "_gelu_pair",
                            lambda z, cheap: _gelu_pair(z, True))
    _port_form(monkeypatch, "tanh")


@pytest.mark.parametrize("kernel", list(CASES))
def test_plain_matches_jax_kernel_bf16(kernel):
    """bf16 inputs: forward and VJP of the JAX kernel (interpret; the tanh
    form, ``cheap``) against the port's plain versions, every output
    within 2^-6 of its largest element."""
    got, refs = CASES[kernel](torch.bfloat16)
    for a, r in zip(got, refs):
        _near_top(a, r, BF16_REL)


@pytest.mark.parametrize("kernel", list(CASES))
def test_plain_tanh_form_matches_jax_kernel_fp32(kernel, tanh_everywhere):
    """fp32 with the tanh form forced in both packages: forward and VJP
    within 2e-5 of each output's largest element, as the fp32 kernel
    tests hold the erf form."""
    got, refs = CASES[kernel](torch.float32)
    for a, r in zip(got, refs):
        _near_top(a, r, FP32_REL)


@pytest.mark.parametrize("kernel", list(CASES))
def test_bf16_plain_takes_the_tanh_form(kernel, monkeypatch):
    """At bf16 the plain version differs from its exact-erf form, and it
    is nearer the JAX bf16 kernel than the erf form is: the RMS distance
    of the first output (y) to the kernel's is under half the erf
    form's."""
    got, refs = CASES[kernel](torch.bfloat16)
    _port_form(monkeypatch, "erf")
    erf, _ = CASES[kernel](torch.bfloat16)
    y, y_erf = _np(got[0]), _np(erf[0])
    y_ref = np.asarray(refs[0].astype(jnp.float32))
    assert np.abs(y - y_erf).max() > 0
    assert _rms(y, y_ref) < 0.5 * _rms(y_erf, y_ref)


# ---------------------------------------------------------------------------
# The window-attention probes
# ---------------------------------------------------------------------------

N = 49


def _attn_inputs(dtype, seed=3, nH=2, hd=32, windows=2):
    rng = np.random.RandomState(seed)
    C = nH * hd
    qkv = 0.5 * rng.randn(windows, N, 3 * C)
    bias = (0.1 * rng.randn(nH, N, N)).astype(np.float32)
    mask = np.where(rng.rand(windows, N, N) < 0.3, -100.0, 0.0).astype(
        np.float32)
    (jq,), (tq,) = _pair([qkv], dtype)
    return jq, tq, bias, mask, nH, hd ** -0.5


def _jax_attn_probe(probes, mode, qkv, bias, mask, nH, scale):
    """The probe body on unpacked windows ``[B nW, 49, 3C]``, one
    invocation, the plain bias and mask."""
    Bw, _, C3 = qkv.shape
    out = jax.ShapeDtypeStruct((Bw, N, C3 // 3), qkv.dtype)
    if mode in ("dots_only", "softmax_only"):
        av = probes["attn_variants"]
        kern = av.kern_dots_only if mode == "dots_only" else \
            av.kern_softmax_only
        return pl.pallas_call(functools.partial(kern, nH=nH, scale=scale),
                              out_shape=out, interpret=True)(qkv, bias)
    has_mask = mask is not None
    mask_arg = (jnp.asarray(mask).reshape(1, Bw, N, N) if has_mask
                else jnp.zeros((1, 1), qkv.dtype))
    kern = functools.partial(probes["attn_probe"]._kern, num_heads=nH,
                             scale=scale, has_mask=has_mask, mode=mode)
    return pl.pallas_call(kern, out_shape=out, interpret=True)(
        qkv, jnp.asarray(bias), mask_arg)


ATTN_CASES = [(mode, masked) for mode in PROBE_MODES
              for masked in ((False,) if mode in ("dots_only",
                                                  "softmax_only")
                             else (False, True))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("mode,masked", ATTN_CASES)
def test_attention_probe_matches_jax_body(mode, masked, dtype, probes):
    """Each mode of kernel 1's probe (``_kern`` of ``attn_probe.py``,
    ``kern_dots_only`` and ``kern_softmax_only`` of ``attn_variants.py``)
    on two windows of 49 tokens, two heads of 32, with a mask of two
    windows where the body takes one."""
    jq, tq, bias, mask, nH, scale = _attn_inputs(dtype)
    m = mask if masked else None
    ref = _jax_attn_probe(probes, mode, jq, bias, m, nH, scale)
    got = window_attention_probe(tq, nH, torch.from_numpy(bias),
                                 None if m is None else torch.from_numpy(m),
                                 scale, mode)
    assert got.dtype == dtype
    _near_top(got, ref, BF16_REL if dtype == torch.bfloat16 else FP32_REL)


def test_attention_probe_modes_compute_other_functions():
    """The modes are five functions: no two agree on the same inputs."""
    _, tq, bias, _, nH, scale = _attn_inputs(torch.float32)
    outs = [_np(window_attention_probe(tq, nH, torch.from_numpy(bias), None,
                                       scale, mode)) for mode in PROBE_MODES]
    names = list(PROBE_MODES)
    for i in range(len(outs)):
        for k in range(i):
            assert np.abs(outs[i] - outs[k]).max() > 1e-3, \
                (names[i], names[k])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_quad_pre_matches_jax_body(dtype, probes):
    """``kern_quad_pre`` at its own row and key counts (392, 98), two
    blocks of two heads."""
    rng = np.random.RandomState(4)
    nq, nH = 2, 2
    j, t = _pair([0.5 * rng.randn(nq, nH, 392, 128),
                  0.5 * rng.randn(nq, nH, 2, 98, 128)], dtype)
    bias = (0.1 * rng.randn(nH, 392, 98)).astype(np.float32)
    kern = functools.partial(probes["attn_variants"].kern_quad_pre, nH=nH,
                             scale=0.17)
    ref = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((nq, 392, 32 * nH), j[0].dtype),
        interpret=True)(j[0], j[1], jnp.asarray(bias))
    got = quad_attention(t[0], t[1], torch.from_numpy(bias))
    assert got.dtype == dtype
    _near_top(got, ref, BF16_REL if dtype == torch.bfloat16 else FP32_REL)


# ---------------------------------------------------------------------------
# The adapter MLP-tail probes
# ---------------------------------------------------------------------------

M_PROBE, H4_PROBE = 64, 64


def _adapter_inputs(dtype, seed=5):
    rng = np.random.RandomState(seed)
    arrays = [0.5 * rng.randn(T, R, M_PROBE), 0.9 * rng.randn(M_PROBE,
                                                              H4_PROBE),
              0.4 * rng.randn(T, R, H4_PROBE),
              0.3 * rng.randn(T, R, H4_PROBE), 0.5 * rng.randn(T, R,
                                                               M_PROBE)]
    return _pair(arrays, dtype)


def _jax_fwd_body(adv, name):
    gelu, sig = adv._gelu, adv._sig_gelu
    return {"base": adv.make_fwd(gelu),
            "tanh": adv.make_fwd(adv._tanh_gelu),
            "sig": adv.make_fwd(sig),
            "noact": adv.make_fwd(None),
            "nodot1": adv.make_fwd(gelu, dot1=False),
            "vpu1sig": adv.make_fwd_vpu(sig),
            "vpu12sig": adv.make_fwd_vpu(sig, vpu_dot2=True),
            "vpu1noac": adv.make_fwd_vpu(None)}[name]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("name", list(FWD_PROBES))
def test_adapter_fwd_probe_matches_jax_body(name, dtype, probes):
    """Each forward probe (``make_fwd``, ``make_fwd_vpu``) in one
    invocation of 64 tokens; the vpu probes in the ``[T, M, r]``
    layout."""
    adv = probes["adapter_variants"]
    j, t = _adapter_inputs(dtype)
    vpu = name.startswith("vpu")
    if vpu:
        j[0] = jnp.swapaxes(j[0], 1, 2)
        t[0] = t[0].transpose(1, 2).contiguous()
    shape = (T, M_PROBE, R) if vpu else (T, R, M_PROBE)
    ref = pl.pallas_call(
        functools.partial(_jax_fwd_body(adv, name), scales=SCALES),
        out_shape=jax.ShapeDtypeStruct(shape, j[0].dtype),
        interpret=True)(*j[:4])
    got = adapter_mid_probe(*t[:4], SCALES, name)
    assert got.dtype == dtype
    _near_top(got, ref, BF16_REL if dtype == torch.bfloat16 else FP32_REL)


def test_nodot2_is_refused_where_the_block_is_not_h4_tokens(probes):
    """JAX refuses ``make_fwd(dot2=False)`` at the probe's own shape
    (blocks of 1024 tokens, H4 = 384): it stores ``h[:R]`` ([R, H4]) into
    an [R, 1024] output block. The port has no counterpart: the function
    is not defined where the probe runs."""
    adv = probes["adapter_variants"]
    M, H4, Mb = 1024, 384, 1024
    args = [jnp.zeros(s, jnp.float32) for s in
            ((T, R, M), (M, H4), (T, R, H4), (T, R, H4))]
    specs = [pl.BlockSpec((T, R, Mb), lambda i: (0, 0, i)),
             pl.BlockSpec((Mb, H4), lambda i: (i, 0)),
             pl.BlockSpec((T, R, H4), lambda i: (0, 0, 0)),
             pl.BlockSpec((T, R, H4), lambda i: (0, 0, 0))]
    with pytest.raises(ValueError, match="Invalid shape"):
        pl.pallas_call(
            functools.partial(adv.make_fwd(adv._gelu, dot2=False),
                              scales=SCALES),
            grid=(M // Mb,), in_specs=specs,
            out_specs=pl.BlockSpec((T, R, Mb), lambda i: (0, 0, i)),
            out_shape=jax.ShapeDtypeStruct((T, R, M), jnp.float32),
            interpret=True)(*args)


def _jax_bwd_pair(adv, name):
    return {"base": adv.erf_pair, "sig": adv.sig_pair,
            "tanh": lambda z: _gelu_pair(z, True)}[name]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("name", list(BWD_PROBES))
def test_adapter_bwd_probe_matches_jax_body(name, dtype, probes):
    """``make_bwd`` with ``erf_pair``, ``sig_pair`` and the kernels' tanh
    pair, one grid step: dmid1T, dp1, dB1, dA2T. ``sig`` in fp32 within
    2^-10 of the largest element: gelu' takes the reciprocal's 2^-16 times
    up to 1 + |z| (a + 3 b z^2) (see :func:`test_sig_pair_matches_the_probe`),
    and these inputs reach |z| = 6.8."""
    adv = probes["adapter_variants"]
    j, t = _adapter_inputs(dtype, seed=6)
    cdt = j[0].dtype
    shapes = [(T, R, M_PROBE), (M_PROBE, H4_PROBE), (T, R, H4_PROBE),
              (T, R, H4_PROBE), (T, R, M_PROBE)]
    full = [pl.BlockSpec(s, lambda i, n=len(s): (0,) * n) for s in shapes]
    refs = pl.pallas_call(
        functools.partial(adv.make_bwd(_jax_bwd_pair(adv, name)),
                          scales=SCALES),
        grid=(1,), in_specs=full,
        out_specs=(full[0], full[1], full[2], full[3]),
        out_shape=(jax.ShapeDtypeStruct(shapes[0], cdt),
                   jax.ShapeDtypeStruct(shapes[1], cdt),
                   jax.ShapeDtypeStruct(shapes[2], jnp.float32),
                   jax.ShapeDtypeStruct(shapes[3], jnp.float32)),
        interpret=True)(*j)
    got = adapter_mid_bwd_probe(*t[:4], SCALES, t[4], name)
    rel = (BF16_REL if dtype == torch.bfloat16
           else 2.0 ** -10 if name == "sig" else FP32_REL)
    for a, r in zip(got, refs):
        _near_top(a, r, rel)


def test_probe_wrappers_count_by_mode_and_not_on_the_cpu():
    """The probe counters read as ``<name>.<mode>``, one per mode, and the
    CPU route (the plain versions) counts nothing."""
    counters.reset()
    _, t = _adapter_inputs(torch.float32)
    adapter_mid_probe(*t[:4], SCALES, "sig")
    _, tq, bias, _, nH, scale = _attn_inputs(torch.float32)
    window_attention_probe(tq, nH, torch.from_numpy(bias), None, scale,
                           "nosmax")
    read = counters.read()
    for name, modes in (("window_attention_probe", PROBE_MODES),
                        ("adapter_mid_probe", FWD_PROBES),
                        ("adapter_mid_bwd_probe", BWD_PROBES)):
        for mode in modes:
            assert read[f"{name}.{mode}"] == 0
    assert read["quad_pre_attention"] == 0
    assert not any(read.values())


def _enum(source: str, name: str) -> dict:
    """``{constant: value}`` of the enum ``name`` of a CUDA source."""
    text = (ROOT / "mtlora_tpu_torch/ops/csrc" / source).read_text()
    body = re.search(r"enum %s \{(.*?)\};" % name, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return {k: int(v) for k, v in re.findall(r"(\w+) = (\d+)", body)}


@pytest.mark.parametrize("source,enum,table,names", [
    ("window_attn.cu", "Mode", PROBE_MODES,
     ["kFull", "kNoSmax", "kNoDots", "kDotsOnly", "kSoftmaxOnly"]),
    ("adapter_mlp.cu", "FwdId", {k: v[0] for k, v in FWD_PROBES.items()},
     ["kFwdBase", "kFwdTanh", "kFwdSig", "kFwdNoAct", "kFwdNoDot1",
      "kFwdVpu1Sig", "kFwdVpu12Sig", "kFwdVpu1NoAct"]),
    ("adapter_mlp_bwd.cu", "BwdId", {k: v[0] for k, v in BWD_PROBES.items()},
     ["kBwdErf", "kBwdTanh", "kBwdSig"]),
], ids=["attention", "adapter_fwd", "adapter_bwd"])
def test_variant_ids_match_the_cuda_sources(source, enum, table, names):
    """Each variant's id in the Python table is the value of the named
    constant in the CUDA source, and the main path's own variant (kernel
    5b's) is the one its wrapper passes; the ``tanh`` probe is kernel 5's
    function on the first port's body."""
    consts = _enum(source, enum)
    assert set(consts) == set(names) and len(table) == len(names)
    assert [consts[n] for n in names] == list(table.values())
    assert BWD_PROBES["tanh"][0] == KERNEL5B_ACT
    assert FWD_PROBES["tanh"][1] == BWD_PROBES["tanh"][1] == gelu_form(
        torch.bfloat16)
