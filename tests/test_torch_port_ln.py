"""The ``TPU.USE_PALLAS_LN`` route of the port vs the JAX package: kernels
2, 3 and 4 (LN + GEMM + LoRA, patch merge, whole MLP), forward and
backward, the in-kernel dropout hash, and the modules and model on that
route.

Inputs come from numpy seeds. The JAX kernels run in interpret mode, as
tests/test_pallas_ln_lora.py and tests/test_pallas_ln_mlp.py run them;
Mosaic's PRNG has no interpreter, so the dropout cases compare against
``ln_lora_reference`` / ``ln_mlp_reference`` given the port's keep masks,
and against their ``jax.vjp``. Tolerances: fp32 forward atol = rtol =
1e-5; fp32 gradients 2e-5; bf16 cast points one bf16 ulp of the largest
element; modules and the whole model 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlora_tpu.ops.pallas_ln_lora import (
    fused_ln_lora_linear as jax_ln_lora,
    fused_merge_ln_linear as jax_merge,
    ln_lora_reference,
    merge_ln_reference,
)
from mtlora_tpu.ops.pallas_ln_mlp import fused_ln_mlp as jax_ln_mlp
from mtlora_tpu.ops.pallas_ln_mlp import ln_mlp_reference
from mtlora_tpu_torch.ops import dropout
from mtlora_tpu_torch.ops.ln_lora import (
    LNLoRAFn,
    MergeLNFn,
    fused_ln_lora_linear,
    ln_lora_bwd_plain,
    ln_lora_plain,
    merge_ln_bwd_plain,
    merge_ln_plain,
)
from mtlora_tpu_torch.ops.ln_mlp import (
    LNMLPFn,
    ln_mlp_bwd_plain,
    ln_mlp_plain,
)

torch.set_num_threads(2)
FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=2e-5, rtol=2e-5)
SEED = np.array([123, 456], np.int32)


def _np(t):
    return t.detach().float().cpu().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _ulp_close(got, want):
    """Within one bf16 ulp of the largest element."""
    want = np.asarray(want, np.float32)
    top = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    np.testing.assert_allclose(_np(got), want, atol=ulp, rtol=0)


# ---------------------------------------------------------------------------
# Kernel 2: LN + frozen GEMM + shared LoRA
# ---------------------------------------------------------------------------

def _ln_lora_inputs(seed=0, M=98, K=32, O=96, r=16):
    """qkv-shaped: O = 3K."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(M, K) * 2 + 0.5).astype(np.float32)
    gamma = rng.uniform(0.8, 1.2, K).astype(np.float32)
    beta = (0.1 * rng.randn(K)).astype(np.float32)
    w = (rng.randn(K, O) / np.sqrt(K)).astype(np.float32)
    b = (0.1 * rng.randn(O)).astype(np.float32)
    A = (rng.randn(K, r) / np.sqrt(K)).astype(np.float32)
    B = (0.1 * rng.randn(r, O)).astype(np.float32)
    gy = rng.randn(M, O).astype(np.float32)
    return x, gamma, beta, w, b, A, B, gy


def _port_ln_lora_args(x, gamma, beta, w, b, A, B, dtype=torch.float32):
    return [_t(a).to(dtype) for a in (x, gamma, beta, w.T, b, A.T, B.T)]


@pytest.mark.parametrize("scale", [4.0, 0.0])
def test_ln_lora_matches_jax_kernel(scale):
    """Forward and VJP (dx, dgamma, dbeta, dA, dB) at a qkv shape against
    the interpret-mode kernel, no dropout."""
    x, gamma, beta, w, b, A, B, gy = _ln_lora_inputs()
    seed = jnp.zeros((2,), jnp.int32)

    def f(x, g, be, A, B):
        return jax_ln_lora(x, g, be, jnp.asarray(w), jnp.asarray(b), A, B,
                           seed, scale, 0.0, False, interpret=True)

    y_ref, vjp = jax.vjp(f, *map(jnp.asarray, (x, gamma, beta, A, B)))
    dx_r, dg_r, db_r, dA_r, dB_r = vjp(jnp.asarray(gy))
    args = _port_ln_lora_args(x, gamma, beta, w, b, A, B)
    zs = torch.zeros(2, dtype=torch.int32)
    y = ln_lora_plain(*args, zs, scale, 0.0)
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), **FWD)
    dx, dg, db, dat, dbt = ln_lora_bwd_plain(*args, zs, scale, 0.0, _t(gy))
    np.testing.assert_allclose(_np(dx), np.asarray(dx_r), **GRAD)
    np.testing.assert_allclose(_np(dg), np.asarray(dg_r), **GRAD)
    np.testing.assert_allclose(_np(db), np.asarray(db_r), **GRAD)
    np.testing.assert_allclose(_np(dat), np.asarray(dA_r).T, **GRAD)
    np.testing.assert_allclose(_np(dbt), np.asarray(dB_r).T, **GRAD)


def test_ln_lora_dropout_matches_reference_with_port_mask():
    """Dropout on: the port's hash mask given to ``ln_lora_reference``;
    forward and the VJP of the reference."""
    x, gamma, beta, w, b, A, B, gy = _ln_lora_inputs(seed=1)
    p, scale = 0.3, 4.0
    keep = dropout.keep_mask(_t(SEED), 0, *x.shape, p).numpy()

    def f(x, g, be, A, B):
        return ln_lora_reference(x, g, be, jnp.asarray(w), jnp.asarray(b),
                                 A, B, scale, keep_mask=jnp.asarray(keep),
                                 drop=p)[0]

    y_ref, vjp = jax.vjp(f, *map(jnp.asarray, (x, gamma, beta, A, B)))
    refs = vjp(jnp.asarray(gy))
    args = _port_ln_lora_args(x, gamma, beta, w, b, A, B)
    y = ln_lora_plain(*args, _t(SEED), scale, p)
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), **FWD)
    got = ln_lora_bwd_plain(*args, _t(SEED), scale, p, _t(gy))
    for g, r, tr in zip(got, refs, (False, False, False, True, True)):
        r = np.asarray(r)
        np.testing.assert_allclose(_np(g), r.T if tr else r, **GRAD)


def test_ln_lora_bf16_cast_points():
    """bf16 inputs: the plain version agrees with the interpret-mode kernel
    to one bf16 ulp of the largest output."""
    x, gamma, beta, w, b, A, B, _ = _ln_lora_inputs(seed=2)
    j16 = [jnp.asarray(a, jnp.bfloat16) for a in (x, gamma, beta, w, b, A, B)]
    y_ref = jax_ln_lora(*j16, jnp.zeros((2,), jnp.int32), 4.0, 0.0, False,
                        interpret=True)
    args = [_t(np.asarray(a.astype(jnp.float32))).bfloat16() for a in j16]
    y = ln_lora_plain(args[0], args[1], args[2], args[3].t().contiguous(),
                      args[4], args[5].t().contiguous(),
                      args[6].t().contiguous(), torch.zeros(2, dtype=torch.int32),
                      4.0, 0.0)
    assert y.dtype == torch.bfloat16
    _ulp_close(y, y_ref.astype(jnp.float32))


def test_ln_lora_other_modes_raise():
    """Of kernel 2's other modes only ``train_w`` raises, naming kernel 3
    and ROADMAP; ``out_p``, ``out_act`` and ``out_drop`` (the stage-tail
    mode, tests/test_torch_port_adapter.py) return y and the outputs they
    ask for, as ``fused_ln_lora_linear`` does."""
    args = _port_ln_lora_args(*_ln_lora_inputs()[:7])
    seed = _t(SEED)
    M, O = args[0].shape[0], args[3].shape[0]
    for mode, n in (("out_p", 2), ("out_act", 1), ("out_drop", 2)):
        out = fused_ln_lora_linear(*args, seed, 4.0, 0.1, **{mode: True})
        outs = out if isinstance(out, tuple) else (out,)
        assert len(outs) == n, mode
        assert all(o.shape == (M, O) for o in outs), mode
    with pytest.raises(NotImplementedError, match="ROADMAP.*|kernel 3"):
        fused_ln_lora_linear(*args, seed, 4.0, 0.0, train_w=True)


# ---------------------------------------------------------------------------
# Kernel 3: patch merge
# ---------------------------------------------------------------------------

def _merge_inputs(seed, L=2, H=16, W=16, C=8):
    rng = np.random.RandomState(seed)
    x = (rng.randn(L, H * W, C) + 0.3).astype(np.float32)
    gamma = rng.uniform(0.8, 1.2, 4 * C).astype(np.float32)
    beta = (0.1 * rng.randn(4 * C)).astype(np.float32)
    w = (rng.randn(4 * C, 2 * C) / np.sqrt(4 * C)).astype(np.float32)
    gy = rng.randn(L, H * W // 4, 2 * C).astype(np.float32)
    return x, gamma, beta, w, gy


@pytest.mark.parametrize("H", [16, 8])
def test_merge_matches_jax(H):
    """Forward and VJP with ``train_w``: at Wh = 8 against
    ``fused_merge_ln_linear`` (interpret), at Wh = 4 (no in-VMEM kernel on
    the TPU) against ``merge_ln_reference``."""
    x, gamma, beta, w, gy = _merge_inputs(3, H=H, W=H)
    L, _, C = x.shape
    R, Wh = L * H // 2, H // 2

    def f(x, g, be, k):
        xv = x.reshape(R, 2, Wh, 2 * C)
        if H == 16:
            y = jax_merge(xv, g, be, k, True, True)
        else:
            y = merge_ln_reference(xv, g, be, k)
        return y.reshape(L, Wh * Wh, 2 * C)

    y_ref, vjp = jax.vjp(f, *map(jnp.asarray, (x, gamma, beta, w)))
    refs = vjp(jnp.asarray(gy))
    args = [_t(x), _t(gamma), _t(beta), _t(w.T)]
    y = merge_ln_plain(*args, H, H)
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), **FWD)
    got = merge_ln_bwd_plain(*args, H, H, _t(gy))
    for g, r, tr in zip(got, refs, (False, False, False, True)):
        r = np.asarray(r)
        np.testing.assert_allclose(_np(g), r.T if tr else r, **GRAD)


# ---------------------------------------------------------------------------
# Kernel 4: LN + whole MLP
# ---------------------------------------------------------------------------

def _mlp_inputs(seed=0, M=64, C=16, r=8):
    rng = np.random.RandomState(seed)
    H4 = 4 * C
    x = (rng.randn(M, C) * 1.5).astype(np.float32)
    gamma = rng.uniform(0.8, 1.2, C).astype(np.float32)
    beta = (0.1 * rng.randn(C)).astype(np.float32)
    w1 = (rng.randn(C, H4) / np.sqrt(C)).astype(np.float32)
    b1 = (0.1 * rng.randn(H4)).astype(np.float32)
    a1 = (rng.randn(C, r) / np.sqrt(C)).astype(np.float32)
    br1 = (0.1 * rng.randn(r, H4)).astype(np.float32)
    w2 = (rng.randn(H4, C) / np.sqrt(H4)).astype(np.float32)
    b2 = (0.1 * rng.randn(C)).astype(np.float32)
    a2 = (rng.randn(H4, r) / np.sqrt(H4)).astype(np.float32)
    br2 = (0.1 * rng.randn(r, C)).astype(np.float32)
    gy = rng.randn(M, C).astype(np.float32)
    return [x, gamma, beta, w1, b1, a1, br1, w2, b2, a2, br2], gy


def _port_mlp_args(a, dtype=torch.float32):
    x, gamma, beta, w1, b1, a1, br1, w2, b2, a2, br2 = a
    return [_t(v).to(dtype) for v in (x, gamma, beta, w1.T, b1, a1.T, br1.T,
                                      w2.T, b2, a2.T, br2.T)]


TRAINED = (0, 1, 2, 5, 6, 9, 10)   # x, gamma, beta, a1, br1, a2, br2
T_LAYOUT = (False, False, False, True, True, True, True)


def test_ln_mlp_matches_jax_kernel():
    """Forward and VJP against ``ln_mlp_reference`` (exact-erf GELU) at
    2e-5, and against the interpret-mode kernel at 2e-5 of each output's
    largest element: the kernel's fp32 GELU takes the Abramowitz-Stegun
    erf (``pallas_adapter_mlp.py:49``, error 1.5e-7), which moves the
    gradients by 1.5e-5 of their largest element."""
    a, gy = _mlp_inputs()
    seed = jnp.zeros((2,), jnp.int32)
    ja = [jnp.asarray(v) for v in a]
    args = _port_mlp_args(a)
    zs = torch.zeros(2, dtype=torch.int32)
    y = ln_mlp_plain(*args, zs, 4.0, 2.0, 0.0)
    got = ln_mlp_bwd_plain(*args, zs, 4.0, 2.0, 0.0, _t(gy))
    for exact, fn in (
            (True, lambda *f: ln_mlp_reference(*f, 4.0, 2.0)),
            (False, lambda *f: jax_ln_mlp(*f, seed, 4.0, 2.0, 0.0,
                                          interpret=True))):
        def f(*tr, fn=fn):
            full = list(ja)
            for i, v in zip(TRAINED, tr):
                full[i] = v
            return fn(*full)

        y_ref, vjp = jax.vjp(f, *[ja[i] for i in TRAINED])
        refs = [np.asarray(r) for r in vjp(jnp.asarray(gy))]
        np.testing.assert_allclose(_np(y), np.asarray(y_ref), **FWD)
        for g, r, tr in zip(got, refs, T_LAYOUT):
            r = r.T if tr else r
            tol = GRAD if exact else dict(atol=2e-5 * np.abs(r).max(),
                                          rtol=0)
            np.testing.assert_allclose(_np(g), r, **tol)


def test_ln_mlp_dropout_matches_reference_with_port_masks():
    a, gy = _mlp_inputs(seed=1)
    p = 0.25
    M, C = a[0].shape
    keep1 = jnp.asarray(dropout.keep_mask(_t(SEED), 0, M, C, p).numpy())
    keep2 = jnp.asarray(dropout.keep_mask(_t(SEED), 1, M, 4 * C, p).numpy())
    ja = [jnp.asarray(v) for v in a]

    def f(*tr):
        full = list(ja)
        for i, v in zip(TRAINED, tr):
            full[i] = v
        return ln_mlp_reference(*full, 4.0, 2.0, keep1=keep1, keep2=keep2,
                                drop=p)

    y_ref, vjp = jax.vjp(f, *[ja[i] for i in TRAINED])
    refs = vjp(jnp.asarray(gy))
    args = _port_mlp_args(a)
    y = ln_mlp_plain(*args, _t(SEED), 4.0, 2.0, p)
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), **FWD)
    got = ln_mlp_bwd_plain(*args, _t(SEED), 4.0, 2.0, p, _t(gy))
    for g, r, tr in zip(got, refs, T_LAYOUT):
        r = np.asarray(r)
        np.testing.assert_allclose(_np(g), r.T if tr else r, **GRAD)


# ---------------------------------------------------------------------------
# The dropout hash
# ---------------------------------------------------------------------------

def test_hash_mask_rate_scale_and_seeds():
    """Keep rate 1 - p over 400k elements within binomial bounds, the
    1/(1-p) scale, a different mask for another seed or stream, and the
    same mask from the same seed."""
    p = 0.05
    s = _t(SEED)
    keep = dropout.keep_mask(s, 0, 400, 1000, p)
    # binomial std of the rate: sqrt(p (1 - p) / n) = 3.4e-4; 5 sigma
    assert abs(keep.float().mean().item() - (1 - p)) < 1.7e-3
    assert torch.equal(keep, dropout.keep_mask(s.clone(), 0, 400, 1000, p))
    other = dropout.keep_mask(_t(np.array([124, 456], np.int32)), 0, 400,
                              1000, p)
    stream1 = dropout.keep_mask(s, 1, 400, 1000, p)
    for k in (other, stream1):
        agree = (k == keep).float().mean().item()
        # independent masks agree on p^2 + (1-p)^2 = 0.905 of the elements
        assert abs(agree - 0.905) < 3e-3
    y = dropout.apply(torch.full((400, 1000), 3.0), keep, p)
    np.testing.assert_allclose(y[keep].numpy(), 3.0 / 0.95, rtol=1e-6)
    assert not y[~keep].any()
    with pytest.raises(ValueError, match="Generator"):
        dropout.draw_seed(None, torch.device("cpu"))


def test_hash_mask_is_the_same_in_forward_and_backward():
    """The backward redraws the forward's masks: autograd through the plain
    forward (fp64, dropout at 0.5 on both MLP streams) gives the plain
    backward's gradients."""
    a, gy = _mlp_inputs(seed=4, M=32, C=8, r=4)
    ts = [t.double() for t in _port_mlp_args(a)]
    leaves = [ts[i].requires_grad_() for i in TRAINED]
    seed = _t(SEED)
    y = ln_mlp_plain(*ts, seed, 4.0, 2.0, 0.5)
    auto = torch.autograd.grad(y, leaves, _t(gy).double())
    got = ln_mlp_bwd_plain(*[t.detach() for t in ts], seed, 4.0, 2.0, 0.5,
                           _t(gy).double())
    for g, r in zip(got, auto):
        np.testing.assert_allclose(_np(g), _np(r), atol=1e-10, rtol=1e-10)


# ---------------------------------------------------------------------------
# gradcheck of the three Functions' plain route
# ---------------------------------------------------------------------------

def _d(a):
    return _t(a).double().requires_grad_()


@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_ln_lora_fn_gradcheck_float64(drop):
    x, gamma, beta, w, b, A, B, _ = _ln_lora_inputs(seed=5, M=6, K=8, O=24,
                                                    r=4)
    wt, bias = _t(w.T).double(), _t(b).double()
    seed = _t(SEED)
    assert torch.autograd.gradcheck(
        lambda x, g, be, at, bt: LNLoRAFn.apply(x, g, be, wt, bias, at, bt,
                                                seed, 4.0, drop),
        (_d(x), _d(gamma), _d(beta), _d(A.T), _d(B.T)))


def test_merge_fn_gradcheck_float64():
    x, gamma, beta, w, _ = _merge_inputs(6, L=1, H=4, W=4, C=2)
    assert torch.autograd.gradcheck(
        lambda x, g, be, wt: MergeLNFn.apply(x, g, be, wt, 4, 4),
        (_d(x), _d(gamma), _d(beta), _d(w.T)))


def test_ln_mlp_fn_gradcheck_float64():
    a, _ = _mlp_inputs(seed=7, M=5, C=4, r=2)
    ts = [t.double() for t in _port_mlp_args(a)]
    seed = _t(SEED)

    def f(*tr):
        full = list(ts)
        for i, v in zip(TRAINED, tr):
            full[i] = v
        return LNMLPFn.apply(*full, seed, 4.0, 2.0, 0.3)

    assert torch.autograd.gradcheck(
        f, tuple(ts[i].clone().requires_grad_() for i in TRAINED))


# ---------------------------------------------------------------------------
# Modules on the LN route against the JAX modules (use_pallas and
# use_pallas_ln on: the Pallas kernels in interpret mode), fp32, 1e-4
# ---------------------------------------------------------------------------

MOD = dict(atol=1e-4, rtol=1e-4)


def _numpy_variables(module, seed, *args):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        if path[-1].key == "scale":
            return rng.uniform(0.9, 1.1, s.shape).astype(np.float32)
        return rng.uniform(-0.08, 0.08, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_cfg(**kw):
    from mtlora_tpu_torch.config import ModelConfig, StageLoRA
    st = StageLoRA(8, (4, 4), 4.0, (4.0, 4.0))
    return ModelConfig(tasks=("a", "b"), num_outputs=(3, 1), img_size=64,
                       stages=(st,) * 4, embed_dim=16, window_size=4,
                       compute_dtype="float32", use_pallas_ln=True, **kw)


@pytest.mark.parametrize("produce_tasks", [False, True])
@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_ln_route_matches_jax(produce_tasks, shift):
    """A no-task block (kernels 2 and 4) and a stage-tail block (kernel 2,
    then layer_norm and the module path with task streams)."""
    from mtlora_tpu.models.lora import LoRASpec, MTLoRASpec
    from mtlora_tpu.models.swin import SwinBlock as JaxBlock
    from mtlora_tpu_torch.ckpt.convert import from_jax_variables
    from mtlora_tpu_torch.models.swin import SwinBlock
    C, H, nH = 16, 8, 2
    spec = LoRASpec(r_shared=8, r_tasks=(4, 4), shared_scale=4.0,
                    task_scales=(4.0, 4.0))
    jmod = JaxBlock(dim=C, input_resolution=(H, H), num_heads=nH, spec=spec,
                    mtlora=MTLoRASpec(enabled=True, tasks=("a", "b"),
                                      stage_specs=(spec,)),
                    produce_tasks=produce_tasks, window_size=4,
                    shift_size=shift, use_pallas=True, use_pallas_ln=True)
    x = np.random.RandomState(1).randn(2, H * H, C).astype(np.float32)
    variables = _numpy_variables(jmod, 2, x)
    y_ref, t_ref = jmod.apply(variables, x)
    cfg = _port_cfg()
    port = SwinBlock(cfg, C, H, nH, cfg.stages[0], produce_tasks, shift)
    port.load_state_dict(from_jax_variables(variables, ("a", "b")),
                         strict=True)
    with torch.no_grad():
        y, t = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), **MOD)
    assert (t is None) == (t_ref is None)
    if t is not None:
        np.testing.assert_allclose(_np(t), np.asarray(t_ref), **MOD)


@pytest.mark.parametrize("H", [16, 8])
def test_patch_merging_ln_route_matches_jax(H):
    """Shared and task streams through kernel 3, forward and backward; at
    H = 8 the JAX package takes its kernel-2 fallback (``Wh % 8``):
    ``fused_ln_lora_linear(train_w=True)`` on ``merge2x2_cat`` rows, whose
    reduction-weight gradient, dgamma and dbeta (interpret-mode VJP) the
    port's kernel 3 matches as well: kernel 2's ``train_w`` mode is covered
    by kernel 3."""
    from mtlora_tpu.models.lora import LoRASpec
    from mtlora_tpu.models.swin import PatchMerging as JaxMerge
    from mtlora_tpu_torch.ckpt.convert import from_jax_variables
    from mtlora_tpu_torch.models.swin import PatchMerging
    C = 8
    jmod = JaxMerge(input_resolution=(H, H), dim=C,
                    spec=LoRASpec(r_shared=0), use_pallas=True,
                    use_pallas_ln=True)
    assert not jmod.freeze_pretrained        # train_w: the reduction trains
    rng = np.random.RandomState(3)
    x = rng.randn(2, H * H, C).astype(np.float32)
    xt = rng.randn(2, 2, H * H, C).astype(np.float32)
    variables = _numpy_variables(jmod, 4, x, xt)
    (y_ref, t_ref), vjp = jax.vjp(lambda v, x, xt: jmod.apply(v, x, xt),
                                  variables, jnp.asarray(x), jnp.asarray(xt))
    gy = rng.randn(*y_ref.shape).astype(np.float32)
    gt = rng.randn(*t_ref.shape).astype(np.float32)
    dvars, dx_ref, dxt_ref = vjp((jnp.asarray(gy), jnp.asarray(gt)))
    port = PatchMerging(H, C, use_pallas_ln=True)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    xs, xts = (torch.from_numpy(a).requires_grad_() for a in (x, xt))
    y, t = port(xs, xts)
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), **MOD)
    np.testing.assert_allclose(_np(t), np.asarray(t_ref), **MOD)
    torch.autograd.backward((y, t), (_t(gy), _t(gt)))
    np.testing.assert_allclose(_np(xs.grad), np.asarray(dx_ref), **MOD)
    np.testing.assert_allclose(_np(xts.grad), np.asarray(dxt_ref), **MOD)
    want = from_jax_variables(dvars)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(_np(p.grad), _np(want[name]), err_msg=name,
                                   **MOD)


# ---------------------------------------------------------------------------
# The whole LN route: one training step against make_train_step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ln_step():
    """tests/test_torch_port_train.py's parity weights and batch, one step
    of the port on the TPU.USE_PALLAS_LN route against the JAX package's
    LN-outside route, which computes the same function (dropout and
    drop-path off); the comparison against the JAX LN route's own kernels
    is :func:`ln_kernel_step`."""
    import test_torch_port_train as tt
    par = tt.make_parity(["TPU.USE_PALLAS_ADAPTER", "False"],
                         jax_route=(False, False))
    jmodel = par[1]
    assert not jmodel.use_pallas_ln and not jmodel.use_pallas_adapter
    pcfg = tt.port_config.from_config(par[0])
    assert pcfg.use_pallas_ln and not pcfg.use_pallas_adapter
    return tt.run_steps(par, 1)


def test_ln_route_step_metrics_match_jax(ln_step):
    """loss, the per-task losses and the pre-clip grad norm, 1e-4
    relative, as on the LN-outside route."""
    got, want = ln_step["port_metrics"][0], ln_step["jax_metrics"][0]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_ln_route_step_gradients_match_jax(ln_step):
    """Every trainable gradient of the first step at the bounds of
    ``test_step_gradients_match_jax``: the LN affines, shared adapters and
    reduction weights now come from kernels 2b, 3b, 4b."""
    import test_torch_port_train as tt
    tt.check_first_grads(ln_step)


@pytest.fixture(scope="module")
def ln_kernel_step():
    """The same step against the JAX package on its own TPU.USE_PALLAS_LN
    route, kernels 2, 3 and 4 in interpret mode (``make_parity`` clones
    the JAX model with the config's route flags, asserted here)."""
    import test_torch_port_train as tt
    par = tt.make_parity(["TPU.USE_PALLAS_ADAPTER", "False"])
    jmodel = par[1]
    assert jmodel.use_pallas_ln and not jmodel.use_pallas_adapter
    return tt.run_steps(par, 1)


def test_ln_route_step_metrics_match_jax_kernels(ln_kernel_step):
    """loss, the per-task losses and the pre-clip grad norm against the
    JAX LN route, 1e-4 relative."""
    got, want = (ln_kernel_step["port_metrics"][0],
                 ln_kernel_step["jax_metrics"][0])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_ln_route_step_gradients_match_jax_kernels(ln_kernel_step):
    """Every trainable gradient of the first step against the JAX LN
    route at the bounds of ``test_step_gradients_match_jax``, and the
    saliency prediction bias at its rounding bound
    (``KERNEL_ROUTE_ROUNDING``: measured 1.31e-4)."""
    import test_torch_port_train as tt
    tt.check_first_grads(ln_kernel_step, tt.KERNEL_ROUTE_ROUNDING)
