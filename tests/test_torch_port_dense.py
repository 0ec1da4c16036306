"""Kernel 1c (``MTLORA_ATTN_DENSE``) of the port against the JAX package:
the dense-cell attention op forward and backward against
``_fused_windows_dense`` (``fused_window_attention`` in interpret mode
with the environment variable set), ``dense_applies`` against
``_maybe_packed``'s own decision, a toy backbone whose last stage has one
window per image, which takes kernel 1c exactly where the JAX model
does, and the configuration switches.

Inputs come from numpy seeds; on the CPU the port's wrappers take their
plain versions (kernel 1's, the same function).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlora_tpu.ops import pallas_window_attn as pwa
from mtlora_tpu.ops.attention import relative_position_index
from mtlora_tpu.ops.attention import shift_attention_mask
from mtlora_tpu_torch import config as port_config
from mtlora_tpu_torch.models import swin as port_swin
from mtlora_tpu_torch.ops.window import (
    shift_window_partition,
    window_merge_unshift,
)
from mtlora_tpu_torch.ops.window_attn import (
    dense_applies,
    dense_tiles,
    fused_window_attention_dense,
    window_attention_dense_bwd,
    window_attention_dense_fwd,
)

torch.set_num_threads(2)


def _np(t):
    return t.detach().float().numpy()


def _bf16_close(got, want):
    """bf16 outputs of the same cast points summed in other orders: within
    one bf16 ulp of the element (2^-7 relative: the last bit flips where
    an fp32 sum rounds the other way) plus 2^-8 of the largest element
    (where a bf16 rounding of P flips, an output moves by one ulp of P
    times |v|, which for an output that cancels to near zero is many of
    its own ulps: measured 2.4e-4 at a largest element of 1.67), on at
    most 1% of the elements (measured 0.02%)."""
    diff = np.abs(got - want)
    assert (diff <= np.abs(want) * 2.0 ** -7
            + 2.0 ** -8 * np.abs(want).max()).all(), diff.max()
    assert (diff > 0).mean() <= 1e-2


@pytest.fixture
def count_jax_dense(monkeypatch):
    """``MTLORA_ATTN_DENSE=1`` and the JAX package's dense-cell calls,
    counted."""
    monkeypatch.setenv("MTLORA_ATTN_DENSE", "1")
    calls = []
    real = pwa._fused_windows_dense

    def counting(qkv_d, *args):
        calls.append(tuple(qkv_d.shape))
        return real(qkv_d, *args)

    monkeypatch.setattr(pwa, "_fused_windows_dense", counting)
    return calls


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("geom", [
    (2, 28, 28, 24, 3),   # nw2 % 4 == 0: per-image mask periods
    (2, 14, 14, 16, 4),   # 4 % nw2 == 0: mask tiles across images
    (8, 14, 14, 16, 2),   # no-mask cells span images
], ids=["period", "tiles", "span"])
def test_dense_attention_matches_jax_dense_kernel(shift, geom,
                                                  count_jax_dense):
    """The geometries of ``test_dense_mode_matches_reference``: the output,
    dqkv (a vjp of the same bf16 cotangent) and dbias. Bounds: bf16
    outputs and dqkv at :func:`_bf16_close`; dbias, fp32 sums of dS over
    the windows in another order, within 1e-4 of its largest element."""
    B, H, W, C, nH = geom
    ws, N = 7, 49
    r = np.random.RandomState(11)
    qkv = jnp.asarray(r.randn(B, H, W, 3 * C), jnp.bfloat16)
    table = r.randn((2 * ws - 1) ** 2, nH).astype(np.float32) * 0.1
    bias = table[relative_position_index(ws).reshape(-1)].reshape(
        N, N, nH).transpose(2, 0, 1)
    mask = shift_attention_mask(H, W, ws, shift) if shift else None
    dout = jnp.asarray(r.randn(B, H, W, C), jnp.bfloat16)
    scale = (C // nH) ** -0.5

    def f(q, b):
        return pwa.fused_window_attention(
            q, nH, b, ws, shift, jnp.asarray(mask) if shift else None,
            scale, interpret=True)

    out_ref, vjp = jax.vjp(f, qkv, jnp.asarray(bias))
    dq_ref, db_ref = vjp(dout)
    # one dense call: its custom VJP runs the dense backward directly
    assert count_jax_dense == [(B * H * W // (8 * N), 8 * N, 3 * C)]

    def t(a):
        return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))

    tq = t(qkv).bfloat16().view(B, H * W, 3 * C).requires_grad_(True)
    tb = torch.from_numpy(bias.copy()).requires_grad_(True)
    tm = torch.from_numpy(mask) if shift else None
    qw = shift_window_partition(tq, H, W, ws, shift)
    assert dense_tiles(qw.shape[0], tm)
    assert dense_applies(qw.dtype, N, (H // ws) * (W // ws), B, tm)
    out = window_merge_unshift(
        fused_window_attention_dense(qw, nH, tb, tm, scale), B, H, W, ws,
        shift)
    out.backward(t(dout).bfloat16().view(B, H * W, C))
    _bf16_close(_np(out), np.asarray(out_ref, np.float32).reshape(
        B, H * W, C))
    _bf16_close(_np(tq.grad), np.asarray(dq_ref, np.float32).reshape(
        B, H * W, 3 * C))
    db_ref = np.asarray(db_ref)
    np.testing.assert_allclose(_np(tb.grad), db_ref, rtol=0,
                               atol=1e-4 * np.abs(db_ref).max())


def test_dense_attention_fn_gradcheck_float64():
    """Kernel 1c's autograd Function (its plain versions on the CPU) with
    a mask whose period (2 windows) tiles the 8-window cells."""
    rs = np.random.RandomState(5)
    nH, N, hd = 2, 9, 4
    qkv = torch.from_numpy(rs.randn(8, N, 3 * nH * hd)).requires_grad_(True)
    bias = torch.from_numpy(0.1 * rs.randn(nH, N, N)).requires_grad_(True)
    mask = torch.from_numpy(np.where(rs.rand(2, N, N) < 0.2, -100.0, 0.0))
    assert dense_tiles(8, mask)
    assert torch.autograd.gradcheck(
        lambda q, b: fused_window_attention_dense(q, nH, b, mask, 0.5),
        (qkv, bias))


def test_dense_tiles_cells_and_mask_periods():
    """Whole 8-window cells, and a mask period that is a multiple or a
    divisor of 8 (``_dense_mask``)."""
    def m(nw):
        return torch.zeros(nw, 4, 4)
    assert dense_tiles(16, None) and not dense_tiles(12, None)
    assert all(dense_tiles(64, m(nw)) for nw in (1, 2, 4, 8, 16, 64))
    assert not any(dense_tiles(48, m(nw)) for nw in (6, 12, 3))


def test_dense_wrappers_refuse_devices_without_kernel():
    """A tensor that is neither on the CPU nor on a CUDA card gets an
    error, never the plain version."""
    qkv = torch.zeros(8, 49, 96, device="meta", dtype=torch.bfloat16)
    bias = torch.zeros(1, 49, 49, device="meta")
    for fn in (window_attention_dense_fwd, fused_window_attention_dense):
        with pytest.raises(ValueError, match="no kernel"):
            fn(qkv, 1, bias, None, 0.2)
    with pytest.raises(ValueError, match="no kernel"):
        window_attention_dense_bwd(qkv, 1, bias, None, 0.2,
                                   torch.zeros(8, 49, 32, device="meta"))


# ---------------------------------------------------------------------------
# dense_applies against _maybe_packed
# ---------------------------------------------------------------------------

def _jax_decision(nw, batch, masked, dtype, N):
    """Which kernel ``_maybe_packed`` calls, with the two kernels replaced
    by stubs that record the choice and return zeros."""
    chosen = []

    def stub(name):
        def run(qkv, *args):
            chosen.append(name)
            return jnp.zeros(qkv.shape[:-1] + (qkv.shape[-1] // 3,),
                             qkv.dtype)
        return run

    saved = pwa._fused_windows_dense, pwa._fused_windows
    pwa._fused_windows_dense = stub("dense")
    pwa._fused_windows = stub("plain")
    try:
        qkv = jnp.zeros((batch * nw, N, 6), dtype)
        mask = jnp.zeros((nw, N, N), jnp.float32) if masked else None
        pwa._maybe_packed(qkv, jnp.zeros((1, N, N), jnp.float32), mask, 1,
                          nw, 1.0, True)
    finally:
        pwa._fused_windows_dense, pwa._fused_windows = saved
    assert len(chosen) == 1
    return chosen[0] == "dense"


def test_dense_applies_matches_maybe_packed(monkeypatch):
    """Over a grid of window counts, batches, masks and dtypes at ws = 7,
    and a few cases at ws = 4 (packs, not 49 rows) and ws = 9 (does not
    pack), the port takes kernel 1c exactly where ``_maybe_packed`` takes
    ``_fused_windows_dense``."""
    monkeypatch.setenv("MTLORA_ATTN_DENSE", "1")
    dtypes = ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32))
    grid = [(49, nw, batch) for nw in (1, 2, 3, 4, 6, 8, 16)
            for batch in (1, 2, 3, 4, 8, 16)]
    grid += [(N, nw, batch) for N in (16, 81) for nw in (1, 2, 8)
             for batch in (2, 8)]
    seen = set()
    for N, nw, batch in grid:
        for masked in (False, True):
            for jdt, tdt in dtypes:
                want = _jax_decision(nw, batch, masked, jdt, N)
                mask = torch.zeros(nw, N, N) if masked else None
                got = dense_applies(tdt, N, nw, batch, mask)
                assert got == want, (N, nw, batch, masked, tdt)
                seen.add(want)
    assert seen == {True, False}


# ---------------------------------------------------------------------------
# A toy backbone with one window per image in its last stage
# ---------------------------------------------------------------------------

def _toy(batch, dense):
    """JAX and port backbones on the same numpy weights, bf16: image 56,
    patch 4 (14x14 tokens), window 7, depths (1, 1): stage 0 has 4 windows
    per image (the pack-2 route), stage 1 one window (7x7 tokens)."""
    from mtlora_tpu.models.lora import LoRASpec, MTLoRASpec
    from mtlora_tpu.models.swin import SwinTransformerMTLoRA as JaxSwin
    from mtlora_tpu_torch.ckpt.convert import from_jax_variables
    from mtlora_tpu_torch.config import ModelConfig, StageLoRA
    spec = LoRASpec(r_shared=8, r_tasks=(4, 4), shared_scale=4.0,
                    task_scales=(4.0, 4.0))
    mt = MTLoRASpec(enabled=True, tasks=("a", "b"), stage_specs=(spec,) * 2,
                    freeze_pretrained=True)
    jmod = JaxSwin(img_size=56, embed_dim=32, depths=(1, 1),
                   num_heads=(1, 2), window_size=7, mtlora=mt,
                   drop_path_rate=0.0, use_pallas=True, dtype=jnp.bfloat16)
    x = np.random.RandomState(0).randn(batch, 56, 56, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x))
    rng = np.random.RandomState(1)
    variables = jax.tree.map(
        lambda s: rng.uniform(-0.1, 0.1, s.shape).astype(np.float32),
        shapes)
    st = StageLoRA(8, (4, 4), 4.0, (4.0, 4.0))
    cfg = ModelConfig(tasks=("a", "b"), num_outputs=(3, 1), img_size=56,
                      stages=(st,) * 2, embed_dim=32, depths=(1, 1),
                      num_heads=(1, 2), window_size=7,
                      compute_dtype="bfloat16", attn_dense=dense)
    port = port_swin.SwinTransformerMTLoRA(cfg).eval()
    port.load_state_dict(from_jax_variables(variables, ("a", "b")),
                         strict=True)
    return jmod, variables, port, x


@pytest.mark.parametrize("batch,dense,calls", [
    (8, True, 1),     # 8 windows: one cell
    (2, True, 0),     # one pair: no cell
    (8, False, 0),    # dense off
])
def test_toy_backbone_takes_dense_where_jax_does(batch, dense, calls,
                                                 monkeypatch):
    """The last stage (nw = 1, no shift: the window clamps) takes kernel
    1c in both packages at batch 8 and in neither at batch 2 or with the
    switch off; stage 0 takes the pack-2 route (kernel 1). Both stages'
    outputs agree at bf16: 2^-5 of the largest element (two bf16 ulps,
    through a block of bf16 GEMMs, LayerNorms and the attention)."""
    if dense:
        monkeypatch.setenv("MTLORA_ATTN_DENSE", "1")
    else:
        monkeypatch.delenv("MTLORA_ATTN_DENSE", raising=False)
    jcalls, pcalls = [], []
    real_j, real_p = pwa._fused_windows_dense, port_swin.\
        fused_window_attention_dense
    monkeypatch.setattr(pwa, "_fused_windows_dense",
                        lambda *a: jcalls.append(1) or real_j(*a))
    monkeypatch.setattr(port_swin, "fused_window_attention_dense",
                        lambda *a: pcalls.append(1) or real_p(*a))
    jmod, variables, port, x = _toy(batch, dense)
    jcalls.clear()
    ref = jax.jit(jmod.apply)(variables, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        out = port(torch.from_numpy(x).bfloat16())
    assert len(jcalls) == calls and len(pcalls) == calls
    for (y, t), (y_ref, t_ref) in zip(out, ref):
        for got, want in ((y, y_ref), (t, t_ref)):
            want = np.asarray(want, np.float32)
            got = _np(got)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2.0 ** -5 * np.abs(want).max())


def test_attn_dense_read_from_the_environment(monkeypatch):
    """``from_config`` reads ``MTLORA_ATTN_DENSE`` as ``_dense_enabled``:
    unset or "0" is off, anything else on."""
    from mtlora_tpu.config import load_config
    import test_torch_port_slice as ts
    cfg = load_config(ts.CFG, tasks=ts.TASKS, img_size=224)
    for value, want in ((None, False), ("0", False), ("1", True),
                        ("yes", True)):
        if value is None:
            monkeypatch.delenv("MTLORA_ATTN_DENSE", raising=False)
        else:
            monkeypatch.setenv("MTLORA_ATTN_DENSE", value)
        assert pwa._dense_enabled() == want
        pcfg = port_config.from_config(cfg)
        assert pcfg.attn_dense == want
        assert pcfg == dataclasses.replace(
            port_config.tiny_448_r64_pertask(), img_size=224,
            attn_dense=want)
