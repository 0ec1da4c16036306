"""Kernel 8 (``TPU.USE_PALLAS_LORA_GEMM``) of the port against the JAX
package: the LoRA GEMM op forward and backward against
``lora_matmul_2d`` / ``lora_matmul`` in interpret mode, ``MTLoRALinear``
and ``SwinBlock`` on the GEMM route against the JAX modules with
``use_pallas`` and ``use_pallas_gemm`` on, and one training step.

Inputs come from numpy seeds, fp32 on the CPU, where the port's wrappers
take their plain versions. The JAX layer calls ``lora_matmul`` without
``interpret`` (``lora.py:448``), so the module tests swap in a wrapper that
runs it in interpret mode, as ``tests/test_pallas_wiring.py`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtlora_tpu.ops.pallas_lora_matmul as plm
from mtlora_tpu.models.lora import LoRASpec, MTLoRASpec
from mtlora_tpu.models.lora import MTLoRALinear as JaxLinear
from mtlora_tpu_torch.ckpt.convert import from_jax_variables
from mtlora_tpu_torch.models import lora as port_lora
from mtlora_tpu_torch.models.lora import MTLoRALinear
from mtlora_tpu_torch.ops.lora_matmul import (
    fused_lora_matmul,
    lora_matmul_dx,
    lora_matmul_dx_plain,
    lora_matmul_fwd,
)

torch.set_num_threads(2)
# fp32 on both sides, sums in other orders: 1e-4 as the JAX kernel's own
# tests bound its interpret-mode gradients (2e-4)
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(t):
    return t.detach().float().numpy()


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _case(seed, M=70, K=96, N=160, r=8):
    """JAX layouts: x [2, M, K], x_drop, w [K, N], a [K, r], b [r, N]."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(2, M, K) * 0.5).astype(np.float32)
    xd = (x * (rs.rand(*x.shape) > 0.1) / 0.9).astype(np.float32)
    w = (rs.randn(K, N) * 0.1).astype(np.float32)
    a = (rs.randn(K, r) * 0.1).astype(np.float32)
    b = (rs.randn(r, N) * 0.1).astype(np.float32)
    return x, xd, w, a, b


# the aligned shape of tests/test_pallas_lora_matmul.py and the unaligned
# one of its test_unaligned_shapes
SHAPES = {"aligned": dict(M=70, K=96, N=160, r=8),
          "unaligned": dict(M=35, K=50, N=70, r=4)}


@pytest.mark.parametrize("same", [True, False], ids=["one-input",
                                                     "two-input"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_lora_matmul_forward_matches_jax_kernel(same, shape):
    x, xd, w, a, b = _case(0, **SHAPES[shape])
    K = x.shape[-1]
    x2, xd2 = x.reshape(-1, K), xd.reshape(-1, K)
    want = plm.lora_matmul_2d(x2, x2 if same else xd2, w, a, b, 2.0,
                              interpret=True, same_input=same)
    got = lora_matmul_fwd(_t(x2), None if same else _t(xd2), _t(w.T),
                          _t(a.T), _t(b.T), 2.0)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_lora_matmul_dx_matches_jax_kernel(shape):
    """The dx layout against ``_bwd``'s call of the one-input kernel with
    swapped operands (:167-170)."""
    x, _, w, a, b = _case(1, **SHAPES[shape])
    dy = np.random.RandomState(2).randn(x.shape[1] * 2, w.shape[1]).astype(
        np.float32)
    want = plm.lora_matmul_2d(dy, dy, w.T, b.T, a.T, 1.5, interpret=True,
                              same_input=True)
    got = lora_matmul_dx(_t(dy), _t(w.T), _t(a.T), _t(b.T), 1.5)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        _np(lora_matmul_dx_plain(_t(dy), _t(w.T), _t(a.T), _t(b.T), 1.5)),
        np.asarray(want), **TOL)


@pytest.mark.parametrize("same", [True, False], ids=["one-input",
                                                     "two-input"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_lora_matmul_gradients_match_jax(same, shape):
    """Gradients of x, x_drop, A and B through ``lora_matmul``'s custom VJP
    (interpret mode) and through the port's autograd Function."""
    x, xd, w, a, b = _case(3, **SHAPES[shape])
    scale = 1.5 if same else 0.7

    def lf(x, xd, a, b):
        y = plm.lora_matmul(x, x if same else xd, w, a, b, scale, same,
                            True)
        return jnp.sum(jnp.sin(y))

    gx, gxd, ga, gb = jax.grad(lf, argnums=(0, 1, 2, 3))(x, xd, a, b)
    K = x.shape[-1]
    tx = _t(x.reshape(-1, K)).requires_grad_(True)
    txd = _t(xd.reshape(-1, K)).requires_grad_(True)
    ta, tb = _t(a.T).requires_grad_(True), _t(b.T).requires_grad_(True)
    y = fused_lora_matmul(tx, None if same else txd, _t(w.T), ta, tb, scale)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(_np(tx.grad).reshape(x.shape),
                               np.asarray(gx), **TOL)
    if same:
        assert txd.grad is None
    else:
        np.testing.assert_allclose(_np(txd.grad).reshape(x.shape),
                                   np.asarray(gxd), **TOL)
    np.testing.assert_allclose(_np(ta.grad), np.asarray(ga).T, **TOL)
    np.testing.assert_allclose(_np(tb.grad), np.asarray(gb).T, **TOL)


@pytest.mark.parametrize("same", [True, False], ids=["one-input",
                                                     "two-input"])
def test_lora_matmul_fn_gradcheck_float64(same):
    rs = np.random.RandomState(4)

    def d(*shape):
        return torch.from_numpy(rs.randn(*shape) * 0.3).requires_grad_(True)

    x, xd, a, b = d(12, 16), d(12, 16), d(4, 16), d(24, 4)
    w = torch.from_numpy(rs.randn(24, 16) * 0.3)
    if same:
        assert torch.autograd.gradcheck(
            lambda x, a, b: fused_lora_matmul(x, None, w, a, b, 1.5),
            (x, a, b))
    else:
        assert torch.autograd.gradcheck(
            lambda x, xd, a, b: fused_lora_matmul(x, xd, w, a, b, 0.7),
            (x, xd, a, b))


def test_lora_matmul_bf16_cast_points():
    """In bf16 the plain version rounds u before its product with B and
    the output once: against an fp64 recomputation with those roundings,
    within one bf16 ulp of the output."""
    x, xd, w, a, b = _case(5)
    bf = [torch.from_numpy(v).to(torch.bfloat16)
          for v in (x.reshape(-1, 96), xd.reshape(-1, 96), w.T.copy(),
                    a.T.copy(), b.T.copy())]
    got = lora_matmul_fwd(bf[0], bf[1], bf[2], bf[3], bf[4], 4.0)
    d = [t.double() for t in bf]
    u = (d[1] @ d[3].t()).float().to(torch.bfloat16).double()
    want = (d[0] @ d[2].t()) + 4.0 * (u @ d[4].t())
    assert got.dtype == torch.bfloat16
    err = (got.double() - want).abs()
    assert bool((err <= 2.0 ** -8 * want.abs() + 1e-6).all())


def test_lora_gemm_wrappers_refuse_devices_without_kernel():
    """A tensor that is neither on the CPU nor on a CUDA card gets an
    error, never the plain version."""
    m = dict(device="meta")
    x, w = torch.zeros(64, 32, **m), torch.zeros(48, 32, **m)
    a, b = torch.zeros(16, 32, **m), torch.zeros(48, 16, **m)
    with pytest.raises(ValueError, match="no kernel"):
        fused_lora_matmul(x, None, w, a, b, 4.0)
    with pytest.raises(ValueError, match="no kernel"):
        lora_matmul_fwd(x, x, w, a, b, 4.0)
    with pytest.raises(ValueError, match="no kernel"):
        lora_matmul_dx(torch.zeros(64, 48, **m), w, a, b, 4.0)


# ---------------------------------------------------------------------------
# Modules on the GEMM route against the JAX modules
# ---------------------------------------------------------------------------

@pytest.fixture
def count_jax_gemm(monkeypatch):
    """The JAX package's kernel 8 in interpret mode, counted."""
    calls = []
    real = plm.lora_matmul

    def counting(x, x_drop, w, a, b, scale, same_input=True,
                 interpret=False):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return real(x, x_drop, w, a, b, scale, same_input, True)

    monkeypatch.setattr(plm, "lora_matmul", counting)
    return calls


@pytest.fixture
def count_port_gemm(monkeypatch):
    """The port's kernel-8 calls from ``MTLoRALinear``."""
    calls = []
    real = port_lora.fused_lora_matmul

    def counting(x, x_drop, *args):
        calls.append((tuple(x.shape), x_drop is None))
        return real(x, x_drop, *args)

    monkeypatch.setattr(port_lora, "fused_lora_matmul", counting)
    return calls


def _numpy_variables(module, seed, *args):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        if path[-1].key == "scale":
            return rng.uniform(0.9, 1.1, s.shape).astype(np.float32)
        return rng.uniform(-0.08, 0.08, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _grads(jmod, variables, args, loss):
    """d loss / d (the shared adapter and x) of a JAX module."""
    def f(params, x):
        out = jmod.apply({**variables, "params": params}, x, *args[1:])
        return loss(out[0])
    return jax.grad(f, argnums=(0, 1))(variables["params"], args[0])


@pytest.mark.parametrize("bias", [True, False])
def test_mtlora_linear_gemm_route_matches_jax(bias, count_jax_gemm,
                                              count_port_gemm):
    """A layer with a shared adapter and no task branch: y and the
    gradients of x, A and B, the frozen W and bias with none; one call of
    kernel 8 in each package."""
    spec = LoRASpec(r_shared=8, r_tasks=(), shared_scale=4.0)
    x = np.random.RandomState(3).randn(2, 5, 16).astype(np.float32)
    jmod = JaxLinear(16, 24, spec=spec, has_tasks=False, use_bias=bias,
                     freeze_pretrained=True, use_pallas=True)
    variables = _numpy_variables(jmod, 0, x)
    count_jax_gemm.clear()
    y_ref, _ = jmod.apply(variables, x)
    assert len(count_jax_gemm) == 1
    gp, gx = _grads(jmod, variables, (x,), lambda y: jnp.sum(jnp.sin(y)))
    port = MTLoRALinear(16, 24, r_shared=8, shared_scale=4.0, bias=bias,
                        use_pallas_gemm=True)
    port.load_state_dict(from_jax_variables(variables, ()), strict=True)
    tx = _t(x).requires_grad_(True)
    y, t = port(tx)
    assert t is None
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), **TOL)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), np.asarray(gx), **TOL)
    np.testing.assert_allclose(_np(port.lora_shared_A.grad),
                               np.asarray(gp["lora_shared_A"]).T, **TOL)
    np.testing.assert_allclose(_np(port.lora_shared_B.grad),
                               np.asarray(gp["lora_shared_B"]).T, **TOL)
    assert port.linear.weight.grad is None
    assert count_port_gemm == [((10, 16), True)]


def test_mtlora_linear_gemm_route_dropout_two_inputs(count_port_gemm):
    """In training the layer hands kernel 8 its dropped input as the second
    operand, drawn from the generator exactly as on the module path: the
    two routes give the same output and gradients."""
    x = _t(np.random.RandomState(4).randn(3, 7, 16))
    outs = []
    for gemm in (True, False):
        torch.manual_seed(0)
        layer = MTLoRALinear(16, 32, r_shared=16, shared_scale=4.0,
                             dropout=0.3, use_pallas_gemm=gemm)
        with torch.no_grad():
            for p in layer.parameters():
                p.copy_(torch.from_numpy(np.random.RandomState(p.numel())
                                         .uniform(-0.1, 0.1, p.shape)))
        layer.train()
        tx = x.clone().requires_grad_(True)
        y, _ = layer(tx, None, torch.Generator().manual_seed(7))
        torch.sin(y).sum().backward()
        outs.append((y.detach(), tx.grad, layer.lora_shared_A.grad,
                     layer.lora_shared_B.grad))
    assert count_port_gemm == [((21, 16), False)]
    for a, b in zip(*outs):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


def _port_cfg(**kw):
    from mtlora_tpu_torch.config import ModelConfig, StageLoRA
    st = StageLoRA(8, (4, 4), 4.0, (4.0, 4.0))
    return ModelConfig(tasks=("a", "b"), num_outputs=(3, 1), img_size=64,
                       stages=(st,) * 4, embed_dim=16, window_size=4,
                       compute_dtype="float32", use_pallas_lora_gemm=True,
                       **kw)


@pytest.mark.parametrize("route", ["ln-outside", "ln"])
@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_gemm_route_matches_jax(route, shift, count_jax_gemm,
                                           count_port_gemm):
    """A block with no task streams on the GEMM route. LN outside the
    GEMMs: the port runs qkv, proj, fc1 and fc2 through kernel 8 at the
    JAX package's gated sites (``swin.py:194,199,377,384``); the JAX
    SwinBlock builds its Mlp with the flag in ``use_pallas``, not
    ``use_pallas_gemm`` (``swin.py:584-588``), so its fc1 and fc2 never
    reach the kernel (ROADMAP Queue 3): 2 JAX calls to the port's 4, the
    same function. On the LN route kernel 2 takes qkv and kernel 4 the MLP,
    and proj alone is left to kernel 8, in both packages."""
    from mtlora_tpu.models.swin import SwinBlock as JaxBlock
    from mtlora_tpu_torch.models.swin import SwinBlock
    C, H, nH = 16, 8, 2
    ln = route == "ln"
    spec = LoRASpec(r_shared=8, r_tasks=(4, 4), shared_scale=4.0,
                    task_scales=(4.0, 4.0))
    jmod = JaxBlock(dim=C, input_resolution=(H, H), num_heads=nH, spec=spec,
                    mtlora=MTLoRASpec(enabled=True, tasks=("a", "b"),
                                      stage_specs=(spec,),
                                      freeze_pretrained=True),
                    produce_tasks=False, window_size=4, shift_size=shift,
                    use_pallas=True, use_pallas_gemm=True, use_pallas_ln=ln)
    x = np.random.RandomState(1).randn(2, H * H, C).astype(np.float32)
    variables = _numpy_variables(jmod, 2, x)
    count_jax_gemm.clear()
    y_ref, t_ref = jmod.apply(variables, x)
    assert t_ref is None
    cfg = _port_cfg(use_pallas_ln=ln)
    port = SwinBlock(cfg, C, H, nH, cfg.stages[0], False, shift)
    port.load_state_dict(from_jax_variables(variables, ("a", "b")),
                         strict=True)
    with torch.no_grad():
        y, t = port.eval()(_t(x))
    assert t is None
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), **TOL)
    assert len(count_jax_gemm) == (1 if ln else 2)
    assert len(count_port_gemm) == (1 if ln else 4)
    assert all(same for _, same in count_port_gemm)


# ---------------------------------------------------------------------------
# One training step on the GEMM route
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemm_step():
    """tests/test_torch_port_train.py's parity weights and batch (dropout
    and drop-path off), one step of both packages with
    ``TPU.USE_PALLAS_LORA_GEMM`` on and LayerNorm outside the GEMMs, the
    route with the most kernel-8 sites; the JAX kernels in interpret
    mode. Without dropout the port's backward takes kernel 8's dx
    layout."""
    import test_torch_port_train as tt
    real = plm.lora_matmul

    def interp(x, x_drop, w, a, b, scale, same_input=True, interpret=False):
        return real(x, x_drop, w, a, b, scale, same_input, True)

    par = tt.make_parity(["TPU.USE_PALLAS_LN", "False",
                          "TPU.USE_PALLAS_ADAPTER", "False",
                          "TPU.USE_PALLAS_LORA_GEMM", "True"])
    cfg, jmodel, variables, batch = par
    assert tt.port_config.from_config(cfg).use_pallas_lora_gemm
    jmodel = jmodel.clone(use_pallas_gemm=True)
    plm.lora_matmul = interp
    try:
        return tt.run_steps((cfg, jmodel, variables, batch), 1)
    finally:
        plm.lora_matmul = real


def test_gemm_route_step_metrics_match_jax(gemm_step):
    """loss, the per-task losses and the pre-clip grad norm, 1e-4
    relative."""
    got, want = gemm_step["port_metrics"][0], gemm_step["jax_metrics"][0]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


# The last block's proj task adapter B: at the parity weights the JAX
# package's own GEMM route and its module route give its gradient 5.9e-5
# apart (rel. largest error), and the port lies 5.2e-5 from the module
# route; against the JAX GEMM route it measured 1.01e-4. Two fp32 runs
# through different kernel routes are held to the sum of those spreads,
# 1.1e-4, at 2e-4; every other tensor measured <= 9.1e-5.
GEMM_ROUTE_ROUNDING = {
    "backbone.layers.3.blocks.1.attn.proj.lora_tasks_B": 2e-4}


def test_gemm_route_step_gradients_match_jax(gemm_step):
    """Every trainable gradient of the first step at the bounds of
    ``test_step_gradients_match_jax``: the shared adapters of qkv, proj,
    fc1 and fc2 now take their gradients from kernel 8's backward; the
    saliency prediction bias and one task adapter at their rounding
    bounds (``KERNEL_ROUTE_ROUNDING``, :data:`GEMM_ROUTE_ROUNDING`)."""
    import test_torch_port_train as tt
    tt.check_first_grads(gemm_step, {**tt.KERNEL_ROUTE_ROUNDING,
                                     **GEMM_ROUTE_ROUNDING})
