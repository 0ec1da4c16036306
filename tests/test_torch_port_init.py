"""The port's init (``mtlora_tpu_torch/models/init.py``) against the JAX
package's ``model.init`` at the toy shape of
``tests/test_end_to_end.py:33-41``.

Each family of initializers (the truncated normal of the frozen kernels,
reductions and relative position tables; the patch-embed conv's
``lecun_normal``; LoRA A; the downsampler's task-stacked fan-in; the
HRNet heads) is compared in groups of parameters that share a
distribution: the same family and fan-in, pooled so that each group's
extremes reach its bound. The port's draw and the JAX draw (carried
across by ``ckpt/convert.py:from_jax_variables``) have the same bound
within 2%, the port's largest |x| is at least 0.9 of it, and their
standard deviations agree within 5%. LoRA B, the biases outside the heads
and the BatchNorm statistics are exactly the JAX values (zeros, ones).
With LoRA B at zero the port's forward equals, bit for bit, the same
model with every LoRA A zeroed, on each route.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_slice as ts
from mtlora_tpu.config import load_config
from mtlora_tpu.models.mtl import build_mtl_model as jax_build
from mtlora_tpu_torch import config as port_config
from mtlora_tpu_torch.ckpt.convert import from_jax_variables
from mtlora_tpu_torch.models.init import init_weights_
from mtlora_tpu_torch.models.mtl import build_mtl_model

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def draws():
    """(JAX init as a port state dict, the port's init, the port model)
    on the LN-outside route (the parameter tree is the same on every
    route)."""
    cfg = load_config(ts.CFG, tasks=ts.TASKS, img_size=64,
                      opts=ts.TOY + ts.SLICE_FLAGS)
    jmodel = jax_build(cfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((2, 64, 64, 3)))
    jsd = from_jax_variables(jax.tree.map(np.asarray, variables), ts.TASKS)
    port = build_mtl_model(port_config.from_config(cfg), device="cpu")
    init_weights_(port, torch.Generator().manual_seed(0))
    return jsd, port.state_dict(), port


def group_of(key: str, t: torch.Tensor):
    """(family, fan-in) of a drawn parameter, or None for a constant."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf in ("lora_shared_A", "lora_tasks_A"):
        return "LoRA A", t.shape[-1]
    if key.endswith(".linear.weight") or key.endswith("reduction.weight") \
            or leaf == "relative_position_bias_table":
        return "truncated normal 0.02", None
    if key.startswith("backbone.patch_embed.proj.weight"):
        return "patch embed lecun_normal", None
    if key.startswith("downsampler."):
        return "downsampler", t.shape[1]
    if key.startswith("decoders.") and leaf in ("weight", "bias") and (
            ".last_layer.0." in key or ".last_layer.3." in key):
        # a conv's bias shares its kernel's distribution: pooled by layer
        return "head conv", key.split(".last_layer.")[1][0]
    return None


def pooled(sd):
    groups = collections.defaultdict(list)
    for k, t in sd.items():
        g = group_of(k, t)
        if g is not None:
            groups[g].append(t.flatten().double())
    return {g: torch.cat(v) for g, v in groups.items()}


def test_every_family_draws_like_the_jax_init(draws):
    jsd, psd, _ = draws
    jp, pp = pooled(jsd), pooled(psd)
    assert set(jp) == set(pp)
    families = {g[0] for g in jp}
    assert families == {"LoRA A", "truncated normal 0.02",
                        "patch embed lecun_normal", "downsampler",
                        "head conv"}
    for g in jp:
        j, p = jp[g], pp[g]
        assert j.numel() == p.numel() > 1000, (g, j.numel(), p.numel())
        bj, bp = float(j.abs().max()), float(p.abs().max())
        sj, sp = float(j.std()), float(p.std())
        assert abs(bp - bj) <= 0.02 * bj, (g, bp, bj)
        assert bp >= 0.9 * bj, (g, bp, bj)
        assert abs(sp - sj) <= 0.05 * sj, (g, sp, sj)


def test_the_traps_of_the_flax_initializers(draws):
    """The bounds that differ from timm and torch: 0.02 * N(0, 1) cut at
    +-2 (bound 0.04, std 0.0176), lecun_normal's rescaled cut (std
    1/sqrt(48)) and the downsampler's fan-in T * dim."""
    _, psd, _ = draws
    pp = pooled(psd)
    t = pp["truncated normal 0.02", None]
    assert float(t.abs().max()) <= 0.04
    assert abs(float(t.std()) - 0.02 * 0.8796) < 5e-4
    pe = pp["patch embed lecun_normal", None]
    assert float(pe.abs().max()) <= 2 * 48 ** -0.5 / 0.87962566103423978
    assert abs(float(pe.std()) - 48 ** -0.5) < 0.05 * 48 ** -0.5
    d = pp["downsampler", 192]          # stage 3 of the toy, 4 tasks
    assert 0.98 * (4 * 192) ** -0.5 <= float(d.abs().max()) \
        <= (4 * 192) ** -0.5


def test_constants_equal_the_jax_init(draws):
    """LoRA B and every bias outside the heads zero, LayerNorm and
    BatchNorm scales one, running mean 0 and variance 1: equal to the JAX
    values."""
    jsd, psd, _ = draws
    assert set(jsd) == set(psd)
    # num_batches_tracked is torch's alone (from_jax_variables adds it)
    constants = [k for k, t in psd.items() if group_of(k, t) is None
                 and not k.endswith("num_batches_tracked")]
    assert any(k.endswith("lora_tasks_B") for k in constants)
    assert any(k.endswith("running_var") for k in constants)
    for k in constants:
        assert torch.equal(psd[k], jsd[k]), k
    for k in constants:
        if k.endswith(("_B", "bias", "running_mean")):
            assert not bool(psd[k].any()), k


@pytest.mark.parametrize("flags", [ts.SLICE_FLAGS, ts.LN_FLAGS, []],
                         ids=["ln_outside", "ln_route", "adapter_route"])
def test_zero_lora_b_leaves_the_frozen_model(flags):
    """With LoRA B at zero (the init), zeroing every LoRA A changes no bit
    of the fp32 forward on the CPU."""
    cfg = load_config(ts.CFG, tasks=ts.TASKS, img_size=64,
                      opts=ts.TOY + flags)
    model = build_mtl_model(port_config.from_config(cfg), device="cpu")
    init_weights_(model, torch.Generator().manual_seed(1))
    x = torch.from_numpy(
        np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32))
    with torch.inference_mode():
        out = model(x)
    zeroed = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("lora_shared_A", "lora_tasks_A")):
                assert bool(p.any()), name
                p.zero_()
                zeroed += 1
    assert zeroed
    with torch.inference_mode():
        frozen = model(x)
    for task in ts.TASKS:
        assert torch.equal(out[task], frozen[task]), task
