"""Port modules vs the JAX modules: MTLoRALinear, WindowAttention, the
HRNet head. Every weight is drawn from a numpy seed (the JAX init gives
only the tree's shapes; LoRA B and the BN running statistics are random
too) and reaches the port through ``ckpt.convert.from_jax_variables``.
The JAX modules run their Pallas kernels in interpret mode
(``use_pallas=True`` on the CPU). fp32, atol = rtol = 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtlora_tpu.models.heads import HighResolutionHead as JaxHead
from mtlora_tpu.models.lora import LoRASpec
from mtlora_tpu.models.lora import MTLoRALinear as JaxLinear
from mtlora_tpu.models.swin import WindowAttention as JaxAttention
from mtlora_tpu.ops.attention import shift_attention_mask
from mtlora_tpu_torch.ckpt.convert import from_jax_variables
from mtlora_tpu_torch.config import StageLoRA
from mtlora_tpu_torch.models.heads import HighResolutionHead
from mtlora_tpu_torch.models.lora import MTLoRALinear
from mtlora_tpu_torch.models.swin import WindowAttention

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)


def numpy_variables(module, seed, *args, **kwargs):
    """The module's variable tree with every leaf drawn from numpy."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if name == "mean":
            return rng.uniform(-0.05, 0.05, s.shape).astype(np.float32)
        return rng.uniform(-0.08, 0.08, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port(module, variables, tasks=()):
    module.load_state_dict(from_jax_variables(variables, tasks), strict=True)
    return module.eval()


def _np(t):
    return t.detach().float().cpu().numpy()


def _close(a, b):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("with_tasks", [False, True])
@pytest.mark.parametrize("task_inputs", [False, True])
def test_mtlora_linear_matches_jax(with_tasks, task_inputs):
    """(d) shared + per-task adapters; ranks (2, 4, 3) pad to 4 under the
    rank mask (the padded A slots hold nonzero values here)."""
    spec = LoRASpec(r_shared=8, r_tasks=(2, 4, 3), shared_scale=4.0,
                    task_scales=(4.0, 2.0, 1.0))
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 16).astype(np.float32)
    xt = rng.randn(3, 2, 5, 16).astype(np.float32) if task_inputs else None
    jmod = JaxLinear(16, 24, spec=spec, has_tasks=with_tasks)
    args = (x,) if xt is None else (x, xt)
    variables = numpy_variables(jmod, 0, *args)
    y_ref, t_ref = jmod.apply(variables, *args)
    port = _port(MTLoRALinear(16, 24, r_shared=8, shared_scale=4.0,
                              tasks=("a", "b", "c") if with_tasks else (),
                              r_tasks=spec.r_tasks,
                              task_scales=spec.task_scales), variables)
    y, t = port(torch.from_numpy(x),
                torch.from_numpy(xt) if xt is not None else None)
    _close(y, y_ref)
    assert (t is None) == (t_ref is None)
    if t is not None:
        _close(t, t_ref)


@pytest.mark.parametrize("shift", [0, 3])
def test_window_attention_module_matches_jax(shift):
    """(c) window 7 on a 14x14 map: the JAX module takes the padded
    pack-2 (pad-104) kernel route, the port the plain window order."""
    C, nH, H = 64, 2, 14
    spec = LoRASpec(r_shared=8, r_tasks=(4, 4), shared_scale=4.0,
                    task_scales=(4.0, 4.0))
    jmod = JaxAttention(dim=C, window_size=7, num_heads=nH, spec=spec,
                        qkv_lora=True, proj_lora=True, proj_tasks=True,
                        use_pallas=True)
    x = np.random.RandomState(1).randn(2, H * H, C).astype(np.float32)
    mask = shift_attention_mask(H, H, 7, shift) if shift else None
    jmask = jnp.asarray(mask) if mask is not None else None
    variables = numpy_variables(jmod, 1, x, (H, H), shift, jmask)
    y_ref, t_ref = jmod.apply(variables, x, (H, H), shift, jmask)
    lora = StageLoRA(8, (4, 4), 4.0, (4.0, 4.0))
    port = _port(WindowAttention(C, 7, nH, lora, ("a", "b"),
                                 proj_tasks=True), variables)
    y, t = port(torch.from_numpy(x), H, H, shift,
                torch.from_numpy(mask) if mask is not None else None)
    _close(y, y_ref)
    _close(t, t_ref)


@pytest.mark.parametrize("n", [1, 3, 7, 21])
def test_hrnet_head_module_matches_jax(n):
    """(c) upcat + fused head, eval BN from the running statistics."""
    rng = np.random.RandomState(n)
    xs = [rng.randn(2, r, r, c).astype(np.float32)
          for r, c in ((8, 18), (4, 36), (2, 72), (2, 144))]
    jmod = JaxHead(num_outputs=n, use_pallas=True)
    variables = numpy_variables(jmod, n, xs, train=False)
    ref = jmod.apply(variables, xs, train=False)
    port = _port(HighResolutionHead(270, n), variables)
    out = port([torch.from_numpy(a) for a in xs])
    _close(out, ref)


def test_hrnet_head_refuses_training_mode():
    """The head in training mode: it normalises with the batch moments of
    ``bn_stats_from_x``, and its logits, updated running
    statistics (0.9 old + 0.1 batch, biased variance) and parameter
    gradients match the JAX head with ``train=True`` (fused kernel in
    interpret mode). fp32, 1e-4 (atol = rtol)."""
    n = 7
    rng = np.random.RandomState(11)
    xs = [rng.randn(2, r, r, c).astype(np.float32)
          for r, c in ((8, 18), (4, 36), (2, 72), (2, 144))]
    gy = rng.randn(2, 8, 8, n).astype(np.float32)
    jmod = JaxHead(num_outputs=n, use_pallas=True)
    shapes = jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), xs, train=False))
    vrng = np.random.RandomState(12)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, s: (vrng.uniform(0.8, 1.2, s.shape) if p[-1].key == "var"
                      else vrng.uniform(-0.08, 0.08, s.shape)
                      ).astype(np.float32), shapes)

    def jloss(params):
        y, upd = jmod.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            xs, train=True, mutable=["batch_stats"])
        return jnp.sum(y * gy), (y, upd)

    (_, (y_ref, upd)), g_ref = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])
    port = HighResolutionHead(270, n)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    port.train()
    y = port([torch.from_numpy(a) for a in xs])
    (y * torch.from_numpy(gy)).sum().backward()
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), **tol)
    want = from_jax_variables({"batch_stats": upd["batch_stats"]})
    got = port.state_dict()
    for k in ("last_layer.1.running_mean", "last_layer.1.running_var"):
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **tol,
                                   err_msg=k)
    g_port = {k: p.grad for k, p in port.named_parameters()}
    g_want = from_jax_variables({"params": g_ref})
    assert set(g_port) == set(g_want)
    for k, g in g_port.items():
        np.testing.assert_allclose(_np(g), _np(g_want[k]), **tol, err_msg=k)
