"""The ``TPU.USE_PALLAS_ADAPTER`` route of the port (the JAX package's
default) vs the JAX package: kernel 2's tail mode, kernel 5 (adapter MLP
tail) and kernel 6 (factored task merge), forward and backward; the
factored-stream algebra; the block, the stage, the model and one training
step on that route.

Inputs come from numpy seeds. The JAX kernels run in interpret mode, as
tests/test_pallas_adapter_mlp.py and tests/test_pallas_task_merge.py run
them, and the JAX modules are built with ``use_pallas``, ``use_pallas_ln``
and ``use_pallas_adapter`` on; the port runs its plain versions. Mosaic's
PRNG has no interpreter, so the dropout case compares against
``ln_lora_reference`` given the port's hash masks. Tolerances: fp32 at
1e-5 (ops) and 1e-4 (modules, the model); against the JAX fp32 kernels,
whose GELU takes an Abramowitz-Stegun erf (error 1.5e-7) where the port
takes the exact erf, 2e-5 of each output's largest element; bf16 cast
points one bf16 ulp of the largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlora_tpu.models.lora import FactoredTasks as JFactored
from mtlora_tpu.models.lora import TaskStream as JStream
from mtlora_tpu.models.lora import (
    expand_factored_tasks as jax_expand_factored,
    expand_task_streams as jax_expand,
    fold_task_ln_project as jax_fold,
)
from mtlora_tpu.ops import pallas_task_merge
from mtlora_tpu.ops.pallas_adapter_mlp import (
    adapter_mid_reference,
    fused_adapter_mid,
)
from mtlora_tpu.ops.pallas_ln_lora import (
    fused_ln_lora_linear as jax_ln_lora,
    ln_lora_reference,
)
from mtlora_tpu.ops.pallas_task_merge import (
    task_merge_down,
    task_merge_reference,
)
from mtlora_tpu_torch.models.lora import (
    FactoredTasks,
    TaskStream,
    droppath_coef,
    expand_factored_tasks,
    expand_task_streams,
    fold_task_ln_project,
)
from mtlora_tpu_torch.ops import dropout
from mtlora_tpu_torch.ops.adapter_mlp import (
    AdapterMidFn,
    adapter_mid_bwd_plain,
    adapter_mid_plain,
)
from mtlora_tpu_torch.ops.ln_lora import (
    LNLoRATailFn,
    fused_ln_lora_linear,
    ln_lora_tail_bwd_plain,
    ln_lora_tail_plain,
)
from mtlora_tpu_torch.ops.task_merge import (
    TaskMergeFn,
    task_merge_bwd_plain,
    task_merge_plain,
)

torch.set_num_threads(2)
FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=2e-5, rtol=2e-5)
MOD = dict(atol=1e-4, rtol=1e-4)
SEED = np.array([123, 456], np.int32)


def _np(t):
    return t.detach().float().cpu().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _near_top(got, want, rel=2e-5):
    """Within ``rel`` of the largest element of ``want``."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _ulp_close(got, want):
    """Within one bf16 ulp of the largest element."""
    want = np.asarray(want, np.float32)
    top = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    np.testing.assert_allclose(_np(got), want, atol=ulp, rtol=0)


# ---------------------------------------------------------------------------
# Kernel 5: the adapter MLP tail
# ---------------------------------------------------------------------------

def _mid_inputs(seed=0, T=3, M=96, H4=64, ranks=(4, 4, 4)):
    """Task t's rank ``ranks[t]`` padded to 4, as the layers pad it: the
    padded rows of mid1T (from the masked A of fc1) and of A2 are zero."""
    rng = np.random.RandomState(seed)
    r = 4
    live = (np.arange(r)[None, :] < np.asarray(ranks)[:, None])
    mid1T = rng.randn(T, r, M).astype(np.float32) * live[..., None]
    p1 = rng.randn(M, H4).astype(np.float32)
    b1 = (0.3 * rng.randn(T, r, H4)).astype(np.float32)
    a2T = (0.3 * rng.randn(T, r, H4) * live[..., None]).astype(np.float32)
    g = rng.randn(T, r, M).astype(np.float32)
    scales = (4.0, 2.0, 1.0)[:T]
    return mid1T, p1, b1, a2T, g, scales


@pytest.mark.parametrize("ranks", [(4, 4, 4), (4, 2, 3)])
def test_adapter_mid_matches_jax_kernel(ranks):
    """Forward and VJP of ``fused_adapter_mid`` (interpret) against the
    port's plain forward and backward, with every task at r_max and with
    ranks below it; 2e-5 of the largest element (the kernel's fp32
    A&S erf)."""
    mid1T, p1, b1, a2T, g, scales = _mid_inputs(ranks=ranks)
    y_ref, vjp = jax.vjp(lambda *a: fused_adapter_mid(*a, scales, True),
                         *map(jnp.asarray, (mid1T, p1, b1, a2T)))
    refs = vjp(jnp.asarray(g))
    args = [_t(a) for a in (mid1T, p1, b1, a2T)]
    _near_top(adapter_mid_plain(*args, scales), y_ref)
    got = adapter_mid_bwd_plain(*args, scales, _t(g))
    for a, r in zip(got, refs):
        _near_top(a, r)


def test_adapter_mid_matches_reference_exact_erf():
    """Against ``adapter_mid_reference`` (exact erf) and its VJP: 1e-5."""
    mid1T, p1, b1, a2T, g, scales = _mid_inputs(seed=1)
    y_ref, vjp = jax.vjp(lambda *a: adapter_mid_reference(*a, scales),
                         *map(jnp.asarray, (mid1T, p1, b1, a2T)))
    args = [_t(a) for a in (mid1T, p1, b1, a2T)]
    np.testing.assert_allclose(_np(adapter_mid_plain(*args, scales)),
                               np.asarray(y_ref), **FWD)
    for a, r in zip(adapter_mid_bwd_plain(*args, scales, _t(g)),
                    vjp(jnp.asarray(g))):
        np.testing.assert_allclose(_np(a), np.asarray(r), **GRAD)


def test_adapter_mid_bf16_cast_points():
    """bf16 inputs: h rounded before the A2 product, the output rounded
    once; one bf16 ulp of the largest element of
    ``adapter_mid_reference``."""
    mid1T, p1, b1, a2T, _, scales = _mid_inputs(seed=2)
    j16 = [jnp.asarray(a, jnp.bfloat16) for a in (mid1T, p1, b1, a2T)]
    y_ref = adapter_mid_reference(*j16, scales)
    args = [_t(np.asarray(a.astype(jnp.float32))).bfloat16() for a in j16]
    y = adapter_mid_plain(*args, scales)
    assert y.dtype == torch.bfloat16
    _ulp_close(y, y_ref.astype(jnp.float32))


def test_adapter_mid_fn_gradcheck_float64():
    mid1T, p1, b1, a2T, _, scales = _mid_inputs(seed=3, T=2, M=5, H4=6,
                                                ranks=(4, 2))
    assert torch.autograd.gradcheck(
        lambda *a: AdapterMidFn.apply(*a, scales),
        tuple(_t(a).double().requires_grad_() for a in (mid1T, p1, b1,
                                                         a2T)))


# ---------------------------------------------------------------------------
# Kernel 6: the factored task merge
# ---------------------------------------------------------------------------

TM_T, TM_B, TM_C = 3, 2, 8


def _merge_inputs(seed, coefs, H=16, T=TM_T, B=TM_B, C=TM_C, r1=4, r2=4):
    rng = np.random.RandomState(seed)
    L = H * H

    def f(*s):
        return (0.5 * rng.randn(*s)).astype(np.float32)

    c1 = c2 = None
    if coefs:
        c1, c2 = ((rng.rand(T, B, 1) < 0.8).astype(np.float32) / 0.8
                  for _ in range(2))
    d = dict(base=f(B, L, C), pre=f(B, L, C), p2=f(B, L, C),
             mid1T=f(T, r1, B * L), b1=f(T, r1, C), mid2T=f(T, r2, B * L),
             b2=f(T, r2, C), c1=c1, c2=c2,
             s1=tuple(rng.uniform(0.5, 2.0, T)), s2=tuple(rng.uniform(0.5,
                                                                 2.0, T)),
             gamma=f(4 * C) + 1.0, beta=f(4 * C), kernel=f(4 * C, 2 * C),
             gy=rng.randn(T, B, L // 4, 2 * C).astype(np.float32))
    return d, H


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


def _port_merge_args(d, H):
    c = [None if d[k] is None else _t(d[k]) for k in ("c1", "c2")]
    return ([_t(d[k]) for k in ("base", "pre", "p2", "mid1T", "b1",
                                 "mid2T", "b2")] + c
            + [d["s1"], d["s2"], _t(d["gamma"]), _t(d["beta"]),
               _t(d["kernel"].T), H, H])


@pytest.mark.parametrize("oracle", ["kernel", "reference"])
@pytest.mark.parametrize("coefs", [False, True])
def test_task_merge_matches_jax(coefs, oracle):
    """Forward and VJP (``train_w``: the reduction trains) against
    ``task_merge_down`` in interpret mode and against
    ``task_merge_reference``, drop-path coefficients off and on; 1e-4 (the
    JAX kernel's merged-row LN sums in another order)."""
    d, H = _merge_inputs(0, coefs)
    fn = task_merge_down if oracle == "kernel" else task_merge_reference
    y_ref, vjp = jax.vjp(_jax_merge(d, H, fn),
                         *[jnp.asarray(d[k]) for k in DIFF])
    refs = vjp(jnp.asarray(d["gy"]))
    args = _port_merge_args(d, H)
    np.testing.assert_allclose(_np(task_merge_plain(*args)),
                               np.asarray(y_ref), **MOD)
    got = task_merge_bwd_plain(*args, _t(d["gy"]))
    for name, a, r in zip(DIFF, got, refs):
        r = np.asarray(r)
        np.testing.assert_allclose(_np(a), r.T if name == "kernel" else r,
                                   err_msg=name, **MOD)


def test_task_merge_fn_gradcheck_float64():
    d, H = _merge_inputs(1, True, H=4, T=2, B=2, C=2, r1=2, r2=1)
    args = _port_merge_args(d, H)
    consts = {7: args[7], 8: args[8]}

    def f(base, pre, p2, m1, b1, m2, b2, g, be, wt):
        return TaskMergeFn.apply(base, pre, p2, m1, b1, m2, b2,
                                 consts[7].double(), consts[8].double(), g,
                                 be, wt, d["s1"], d["s2"], H, H)

    leaves = [args[i] for i in (0, 1, 2, 3, 4, 5, 6, 11, 12, 13)]
    assert torch.autograd.gradcheck(
        f, tuple(a.double().requires_grad_() for a in leaves))


# ---------------------------------------------------------------------------
# Kernel 2's tail mode: GELU on y, the outputs p and dropout(y)
# ---------------------------------------------------------------------------

def _tail_inputs(seed=0, M=64, K=16, O=64, r=16):
    rng = np.random.RandomState(seed)
    x = (rng.randn(M, K) * 2 + 0.5).astype(np.float32)
    gamma = rng.uniform(0.8, 1.2, K).astype(np.float32)
    beta = (0.1 * rng.randn(K)).astype(np.float32)
    w = (rng.randn(K, O) / np.sqrt(K)).astype(np.float32)
    b = (0.1 * rng.randn(O)).astype(np.float32)
    A = (rng.randn(K, r) / np.sqrt(K)).astype(np.float32)
    B = (0.1 * rng.randn(r, O)).astype(np.float32)
    gs = [rng.randn(M, O).astype(np.float32) for _ in range(3)]
    return (x, gamma, beta, w, b, A, B), gs


def _port_tail_args(x, gamma, beta, w, b, A, B):
    return [_t(a) for a in (x, gamma, beta, w.T, b, A.T, B.T)]


# (K, O, r): the first shape, then ranks 16 and 32 at widths that are not
# a multiple of 64 (kernel 2-tail's half slices)
TAIL_SHAPES = [(16, 64, 16), (96, 384, 16), (160, 640, 32)]


@pytest.mark.parametrize("K,O,r", TAIL_SHAPES)
def test_ln_lora_tail_matches_jax_kernel(K, O, r):
    """``out_p`` and ``out_act``: forward (y, p) and the VJP (dx, dgamma,
    dbeta, dA, dB) from the cotangents of y and p, against the
    interpret-mode kernel, no dropout; 2e-5 of the largest element (its
    fp32 GELU takes the A&S erf)."""
    (x, gamma, beta, w, b, A, B), (gy, gp, _) = _tail_inputs(K=K, O=O, r=r)
    seed = jnp.zeros((2,), jnp.int32)

    def f(x, g, be, A, B):
        return jax_ln_lora(x, g, be, jnp.asarray(w), jnp.asarray(b), A, B,
                           seed, 4.0, 0.0, True, True, False,
                           interpret=True)

    (y_r, p_r), vjp = jax.vjp(f, *map(jnp.asarray, (x, gamma, beta, A, B)))
    refs = vjp((jnp.asarray(gy), jnp.asarray(gp)))
    args = _port_tail_args(x, gamma, beta, w, b, A, B)
    zs = torch.zeros(2, dtype=torch.int32)
    y, p, d = ln_lora_tail_plain(*args, zs, 4.0, 0.0)
    assert d is None
    _near_top(y, y_r)
    np.testing.assert_allclose(_np(p), np.asarray(p_r), **FWD)
    got = ln_lora_tail_bwd_plain(*args, zs, 4.0, 0.0, _t(gy), _t(gp))
    for a, r, tr in zip(got, refs, (False, False, False, True, True)):
        r = np.asarray(r)
        _near_top(a, r.T if tr else r)


def test_ln_lora_tail_dropout_matches_reference_with_port_masks():
    """``out_drop`` in training: dropout on the LN input (hash stream 0)
    and ``d = dropout(y)`` (stream 1), given to ``ln_lora_reference``
    (exact erf); forward and the VJP from the cotangents of y, p and d."""
    (x, gamma, beta, w, b, A, B), (gy, gp, gd) = _tail_inputs(seed=1)
    rate, scale = 0.3, 4.0
    keep = dropout.keep_mask(_t(SEED), 0, *x.shape, rate).numpy()
    keep2 = jnp.asarray(dropout.keep_mask(_t(SEED), 1, x.shape[0],
                                          w.shape[1], rate).numpy())

    def f(x, g, be, A, B):
        y, p = ln_lora_reference(x, g, be, jnp.asarray(w), jnp.asarray(b),
                                 A, B, scale, keep_mask=jnp.asarray(keep),
                                 drop=rate, act=True)
        return y, p, jnp.where(keep2, y / (1.0 - rate), 0.0)

    outs, vjp = jax.vjp(f, *map(jnp.asarray, (x, gamma, beta, A, B)))
    refs = vjp(tuple(map(jnp.asarray, (gy, gp, gd))))
    args = _port_tail_args(x, gamma, beta, w, b, A, B)
    got = ln_lora_tail_plain(*args, _t(SEED), scale, rate, True, True)
    for a, r in zip(got, outs):
        np.testing.assert_allclose(_np(a), np.asarray(r), **FWD)
    grads = ln_lora_tail_bwd_plain(*args, _t(SEED), scale, rate, _t(gy),
                                   _t(gp), _t(gd))
    for a, r, tr in zip(grads, refs, (False, False, False, True, True)):
        r = np.asarray(r)
        np.testing.assert_allclose(_np(a), r.T if tr else r, **GRAD)


def test_fused_ln_lora_linear_tail_outputs():
    """The public entry returns ``(y, p[, d])`` as the JAX function does,
    and refuses ``train_w`` naming kernel 3."""
    (x, gamma, beta, w, b, A, B), _ = _tail_inputs(seed=2)
    args = _port_tail_args(x, gamma, beta, w, b, A, B)
    y, p, d = fused_ln_lora_linear(*args, _t(SEED), 4.0, 0.3, out_p=True,
                                   out_act=True, out_drop=True)
    ry, rp, rd = ln_lora_tail_plain(*args, _t(SEED), 4.0, 0.3, True, True)
    for a, r in ((y, ry), (p, rp), (d, rd)):
        assert torch.equal(a, r)
    with pytest.raises(NotImplementedError, match="kernel 3"):
        fused_ln_lora_linear(*args, _t(SEED), 4.0, 0.0, train_w=True)


@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_ln_lora_tail_fn_gradcheck_float64(drop):
    (x, gamma, beta, w, b, A, B), _ = _tail_inputs(seed=5, M=6, K=8, O=24,
                                                   r=4)
    wt, bias = _t(w.T).double(), _t(b).double()
    seed = _t(SEED)
    leaves = tuple(_t(a).double().requires_grad_()
                   for a in (x, gamma, beta, A.T, B.T))
    assert torch.autograd.gradcheck(
        lambda x, g, be, at, bt: LNLoRATailFn.apply(
            x, g, be, wt, bias, at, bt, seed, 4.0, drop, True, drop > 0),
        leaves)


# ---------------------------------------------------------------------------
# The factored-stream algebra
# ---------------------------------------------------------------------------

def _stream_inputs(seed, coef, T=3, B=2, L=10, C=8, r=4, r1=4):
    rng = np.random.RandomState(seed)

    def f(*s):
        return (0.5 * rng.randn(*s)).astype(np.float32)

    c = ((rng.rand(T, B, 1) < 0.7).astype(np.float32) / 0.7 if coef
         else None)
    scales = tuple(rng.uniform(0.5, 2.0, T))
    parts = dict(base=f(B, L, C) + 0.3, pre=f(B, L, C), midT=f(T, r, B * L),
                 B=f(T, r, C), coef=c, scales=scales)
    extra = dict(gamma=f(C) + 1.0, beta=f(C), A=f(T, C, r1),
                 p2=f(B, L, C), mid2=f(T, r, B * L), B2=f(T, r, C),
                 coef2=c if c is None else c[::-1].copy(),
                 s2=tuple(rng.uniform(0.5, 2.0, T)))
    return parts, extra


def _streams(parts):
    j = JStream(**{k: (v if k in ("scales",) or v is None
                       else jnp.asarray(v)) for k, v in parts.items()})
    p = TaskStream(**{k: (v if k in ("scales",) or v is None else _t(v))
                      for k, v in parts.items()})
    return j, p


@pytest.mark.parametrize("coef", [False, True])
def test_fold_task_ln_project_matches_jax(coef):
    """LN of the implicit streams projected to rank space, value and
    gradient (through every input), against the JAX function; and against
    LN of the expanded streams times A."""
    parts, ex = _stream_inputs(0, coef)
    js, ps = _streams(parts)

    def jf(base, pre, mid, Bm, g, be, A):
        s = js._replace(base=base, pre=pre, midT=mid, B=Bm)
        return jax_fold(s, g, be, A)

    ins = [parts["base"], parts["pre"], parts["midT"], parts["B"],
           ex["gamma"], ex["beta"], ex["A"]]
    y_ref, vjp = jax.vjp(jf, *map(jnp.asarray, ins))
    g = np.random.RandomState(9).randn(*y_ref.shape).astype(np.float32)
    refs = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_() for a in ins]
    leaves[6] = _t(ex["A"].transpose(0, 2, 1)).requires_grad_()
    s = ps._replace(base=leaves[0], pre=leaves[1], midT=leaves[2],
                    B=leaves[3])
    y = fold_task_ln_project(s, leaves[4], leaves[5], leaves[6])
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), **FWD)
    grads = torch.autograd.grad(y, leaves, _t(g))
    for i, (a, r) in enumerate(zip(grads, refs)):
        r = np.asarray(r)
        np.testing.assert_allclose(
            _np(a), r.transpose(0, 2, 1) if i == 6 else r, atol=1e-4,
            rtol=1e-4)
    # the algebra: LN of the expanded streams, projected
    ys = expand_task_streams(s, None).detach().double()
    mu = ys.mean(-1, keepdim=True)
    ln = ((ys - mu) / torch.sqrt(ys.var(-1, unbiased=False, keepdim=True)
                                 + 1e-5) * leaves[4].double()
          + leaves[5].double())
    want = torch.einsum("tblc,tqc->tqbl", ln, leaves[6].double())
    np.testing.assert_allclose(_np(y), _np(want.reshape(y.shape)),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("coef", [False, True])
def test_expand_task_streams_matches_jax(coef):
    parts, ex = _stream_inputs(1, coef)
    js, ps = _streams(parts)
    jf2 = JFactored(pretrained=jnp.asarray(ex["p2"]),
                    midT=jnp.asarray(ex["mid2"]), B=jnp.asarray(ex["B2"]),
                    scales=ex["s2"])
    pf2 = FactoredTasks(_t(ex["p2"]), _t(ex["mid2"]), _t(ex["B2"]),
                        ex["s2"])
    c2 = ex["coef2"]
    for f2j, f2p in ((None, None), (jf2, pf2)):
        want = jax_expand(js, f2j, None if c2 is None else jnp.asarray(c2))
        got = expand_task_streams(ps, f2p, None if c2 is None else _t(c2))
        np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)


@pytest.mark.parametrize("with_base", [False, True])
def test_expand_factored_tasks_matches_jax(with_base):
    """No drop-path: ``base + pretrained + s mid^T B`` (or without the
    residual); with drop-path, each (task, sample) slice is the undropped
    one times a coefficient in {0, 1/keep}."""
    parts, ex = _stream_inputs(2, False)
    B, L, C = parts["base"].shape
    jf = JFactored(pretrained=jnp.asarray(ex["p2"]),
                   midT=jnp.asarray(ex["mid2"]), B=jnp.asarray(ex["B2"]),
                   scales=ex["s2"])
    pf = FactoredTasks(_t(ex["p2"]), _t(ex["mid2"]), _t(ex["B2"]), ex["s2"])
    base = parts["base"] if with_base else None
    want = jax_expand_factored(jf, (B, L), base=None if base is None
                               else jnp.asarray(base))
    got = expand_factored_tasks(pf, (B, L), base=None if base is None
                                else _t(base))
    np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
    plain = expand_factored_tasks(pf, (B, L))
    dropped = expand_factored_tasks(pf, (B, L), 0.5,
                                    torch.Generator().manual_seed(0))
    ratio = dropped / plain
    vals = set(np.unique(np.round(_np(ratio), 5)).tolist())
    assert vals <= {0.0, 2.0} and len(vals) == 2
    assert torch.equal(ratio, ratio[..., :1, :1].expand_as(ratio))


def test_droppath_coef_rate_and_shape():
    """One coefficient per (task, sample), ``[T, B, 1]`` fp32 in {0,
    1/keep}; the keep rate over 8000 draws; the same generator seed gives
    the same draw; rate 0 draws nothing."""
    rate = 0.2
    c = droppath_coef(rate, 4, 2000, torch.Generator().manual_seed(0), "cpu")
    assert c.shape == (4, 2000, 1) and c.dtype == torch.float32
    assert set(np.unique(c.numpy()).tolist()) <= {
        0.0, float(np.float32(1 / 0.8))}
    # std of the rate over 8000 draws 4.5e-3; 5 sigma
    assert abs((c != 0).float().mean().item() - 0.8) < 2.3e-2
    assert torch.equal(c, droppath_coef(rate, 4, 2000,
                                        torch.Generator().manual_seed(0),
                                        "cpu"))
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    assert droppath_coef(0.0, 4, 2, gen, "cpu") is None
    assert torch.equal(gen.get_state(), state)
    with pytest.raises(ValueError, match="Generator"):
        droppath_coef(rate, 4, 2, None, "cpu")


# ---------------------------------------------------------------------------
# Modules on the adapter route against the JAX modules (use_pallas,
# use_pallas_ln and use_pallas_adapter on), fp32, 1e-4
# ---------------------------------------------------------------------------

def _numpy_variables(module, seed, *args):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        if path[-1].key == "scale":
            return rng.uniform(0.9, 1.1, s.shape).astype(np.float32)
        return rng.uniform(-0.08, 0.08, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _specs():
    from mtlora_tpu.models.lora import LoRASpec, MTLoRASpec
    spec = LoRASpec(r_shared=16, r_tasks=(4, 4), shared_scale=4.0,
                    task_scales=(4.0, 2.0))
    return spec, MTLoRASpec(enabled=True, tasks=("a", "b"),
                            stage_specs=(spec,) * 4)


def _port_cfg():
    from mtlora_tpu_torch.config import ModelConfig, StageLoRA
    st = StageLoRA(16, (4, 4), 4.0, (4.0, 2.0))
    return ModelConfig(tasks=("a", "b"), num_outputs=(3, 1), img_size=64,
                       stages=(st,) * 4, embed_dim=16, window_size=4,
                       depths=(2, 2, 2, 2), num_heads=(2, 2, 2, 2),
                       compute_dtype="float32", use_pallas_ln=True,
                       use_pallas_adapter=True)


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_adapter_route_matches_jax(shift):
    """A stage-tail block: proj's factored task output, fc1 in kernel 2's
    tail mode with the folded projection, kernel 5, the streams expanded
    once."""
    from mtlora_tpu.models.swin import SwinBlock as JaxBlock
    from mtlora_tpu_torch.ckpt.convert import from_jax_variables
    from mtlora_tpu_torch.models.swin import SwinBlock
    C, H = 16, 8
    spec, mt = _specs()
    jmod = JaxBlock(dim=C, input_resolution=(H, H), num_heads=2, spec=spec,
                    mtlora=mt, produce_tasks=True, window_size=4,
                    shift_size=shift, use_pallas=True, use_pallas_ln=True,
                    use_pallas_adapter=True)
    x = np.random.RandomState(1).randn(2, H * H, C).astype(np.float32)
    variables = _numpy_variables(jmod, 2, x)
    y_ref, t_ref = jmod.apply(variables, x)
    cfg = _port_cfg()
    port = SwinBlock(cfg, C, H, 2, cfg.stages[0], True, shift)
    assert port.factored and not port.defer_expand
    port.load_state_dict(from_jax_variables(variables, ("a", "b")),
                         strict=True)
    with torch.no_grad():
        y, t = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), **MOD)
    np.testing.assert_allclose(_np(t), np.asarray(t_ref), **MOD)


@pytest.fixture
def count_jax_task_merge(monkeypatch):
    """Counts the JAX package's calls of its kernel 6 (``task_merge_down``,
    imported where PatchMerging calls it)."""
    calls = []
    real = pallas_task_merge.task_merge_down

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pallas_task_merge, "task_merge_down", counted)
    return calls


@pytest.mark.parametrize("stage", [0, 1])
def test_basic_layer_adapter_route_matches_jax(stage, count_jax_task_merge):
    """A stage with its merge, forward and the gradients of every
    parameter and of the input: at stage 0 (16 -> 8, Wh 8) the JAX package
    takes kernel 6, at stage 1 (8 -> 4, Wh 4) it expands the streams and
    takes its patch-merge fallback; the port takes kernel 6 at both."""
    from mtlora_tpu.models.swin import BasicLayer as JaxLayer
    from mtlora_tpu_torch.ckpt.convert import from_jax_variables
    from mtlora_tpu_torch.models.swin import BasicLayer
    cfg = _port_cfg()
    spec, mt = _specs()
    C, H = 16 * 2 ** stage, 16 // 2 ** stage
    jmod = JaxLayer(dim=C, input_resolution=(H, H), depth=2, num_heads=2,
                    spec=spec, mtlora=mt, window_size=4, drop_path=(0.0, 0.0),
                    has_downsample=True, use_pallas=True, use_pallas_ln=True,
                    use_pallas_adapter=True)
    rng = np.random.RandomState(4)
    x = rng.randn(2, H * H, C).astype(np.float32)
    variables = _numpy_variables(jmod, 5, x)
    count_jax_task_merge.clear()      # init traced the forward too
    (y_ref, t_ref), vjp = jax.vjp(lambda v, x: jmod.apply(v, x), variables,
                                  jnp.asarray(x))
    assert len(count_jax_task_merge) == (1 if stage == 0 else 0)
    gy = rng.randn(*y_ref.shape).astype(np.float32)
    gt = rng.randn(*t_ref.shape).astype(np.float32)
    dvars, dx_ref = vjp((jnp.asarray(gy), jnp.asarray(gt)))
    port = BasicLayer(cfg, stage, (0.0, 0.0))
    port.load_state_dict(from_jax_variables(variables, ("a", "b")),
                         strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    y, t = port.eval()(xt)
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), **MOD)
    np.testing.assert_allclose(_np(t), np.asarray(t_ref), **MOD)
    torch.autograd.backward((y, t), (_t(gy), _t(gt)))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(dx_ref), **MOD)
    want = from_jax_variables(dvars, ("a", "b"))
    for name, p in port.named_parameters():
        if not p.requires_grad:
            continue
        w = _np(want[name])
        np.testing.assert_allclose(_np(p.grad), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("H", [16, 8])
def test_task_merge_output_dtype_matches_both_jax_routes(H):
    """One output dtype, the compute dtype, on both JAX routes of the
    deferred merge (ROADMAP Queue 3, item 3): bf16 streams through the
    JAX PatchMerging at bf16, kernel 6 at Wh 8 and the expand-then-fold
    fallback at Wh 4, against the port's kernel 6: bf16 on all three, and
    the values within 2^-6 of the largest element (bf16 rounding on both
    sides; the fallback folds LN into the reduction)."""
    from mtlora_tpu.models.lora import DeferredTasks as JDeferred
    from mtlora_tpu.models.lora import LoRASpec
    from mtlora_tpu.models.swin import PatchMerging as JaxMerge
    from mtlora_tpu_torch.ckpt.convert import from_jax_variables
    from mtlora_tpu_torch.models.lora import DeferredTasks
    from mtlora_tpu_torch.models.swin import PatchMerging
    d, _ = _merge_inputs(7, True, H=H)
    bf = jnp.bfloat16
    jmod = JaxMerge(input_resolution=(H, H), dim=TM_C,
                    spec=LoRASpec(r_shared=0), use_pallas=True,
                    use_pallas_ln=True, dtype=bf)
    j = {k: (jnp.asarray(v, bf) if isinstance(v, np.ndarray) else v)
         for k, v in d.items()}
    jd = JDeferred(JStream(base=j["base"], pre=j["pre"], midT=j["mid1T"],
                           B=j["b1"], scales=d["s1"],
                           coef=jnp.asarray(d["c1"])),
                   JFactored(pretrained=j["p2"], midT=j["mid2T"], B=j["b2"],
                             scales=d["s2"]),
                   jnp.asarray(d["c2"]))
    variables = _numpy_variables(jmod, 8, j["base"], None)
    _, t_ref = jmod.apply(variables, j["base"], jd)
    assert t_ref.dtype == bf
    port = PatchMerging(H, TM_C, use_pallas_ln=True)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    p = {k: (_t(np.asarray(v.astype(jnp.float32))).bfloat16()
             if isinstance(v, jax.Array) else v) for k, v in j.items()}
    pd = DeferredTasks(
        TaskStream(p["base"], p["pre"], p["mid1T"], p["b1"], d["s1"],
                   _t(d["c1"])),
        FactoredTasks(p["p2"], p["mid2T"], p["b2"], d["s2"]), _t(d["c2"]))
    with torch.no_grad():
        _, t = port(p["base"], pd)
    assert t.dtype == torch.bfloat16
    want = np.asarray(t_ref.astype(jnp.float32))
    np.testing.assert_allclose(_np(t), want, rtol=0,
                               atol=2.0 ** -6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# The whole model and one training step on the adapter route
# ---------------------------------------------------------------------------

def test_multitask_forward_adapter_route_matches_jax():
    """All four tasks' fp32 logits at the toy shape, 1e-4, the JAX model
    asserted to be on the adapter route."""
    import test_torch_port_slice as ts
    toy = ts.make_toy([])
    jmodel, port = toy[1], toy[3]
    assert jmodel.use_pallas_adapter and jmodel.use_pallas_ln
    assert port.cfg.use_pallas_adapter and port.cfg.use_pallas_ln
    ts._check_forward(toy)


def test_flagship_adapter_preset_equals_yaml_config():
    """The default preset is the YAML as it stands: ``TPU.USE_PALLAS_LN``
    and ``TPU.USE_PALLAS_ADAPTER`` on."""
    import test_torch_port_slice as ts
    from mtlora_tpu.config import load_config
    from mtlora_tpu_torch import config as port_config
    cfg = load_config(ts.CFG, tasks=ts.TASKS)
    assert bool(cfg.TPU.USE_PALLAS_ADAPTER) and bool(cfg.TPU.USE_PALLAS_LN)
    pcfg = port_config.from_config(cfg)
    assert pcfg.use_pallas_adapter and pcfg.use_pallas_ln
    assert pcfg == port_config.tiny_448_r64_pertask()
    assert pcfg == port_config.tiny_448_r64_pertask(use_pallas_ln=True,
                                                    use_pallas_adapter=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_config.tiny_448_r64_pertask(use_pallas_ln=False,
                                         use_pallas_adapter=True)


@pytest.fixture(scope="module")
def adapter_step():
    """tests/test_torch_port_train.py's parity weights and batch, one step
    of both packages on the YAML's route, the adapter route (dropout and
    drop-path off; the JAX kernels in interpret mode, with the exact erf:
    ``exact_erf``)."""
    import test_torch_port_train as tt
    par = tt.make_parity([])
    jmodel = par[1]
    assert jmodel.use_pallas_adapter and jmodel.use_pallas_ln
    assert tt.port_config.from_config(par[0]).use_pallas_adapter
    return tt.run_steps(par, 1)


def test_adapter_route_step_metrics_match_jax(adapter_step):
    """loss, the per-task losses and the pre-clip grad norm, 1e-4
    relative."""
    got, want = adapter_step["port_metrics"][0], adapter_step["jax_metrics"][0]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_adapter_route_step_gradients_match_jax(adapter_step):
    """Every trainable gradient of the first step at the bounds of
    ``test_step_gradients_match_jax``: the stage-tail adapters now take
    their gradients from kernels 2b (tail), 5b and 6b; the saliency
    prediction bias at its rounding bound (``KERNEL_ROUTE_ROUNDING``:
    measured 1.63e-4)."""
    import test_torch_port_train as tt
    tt.check_first_grads(adapter_step, tt.KERNEL_ROUTE_ROUNDING)
