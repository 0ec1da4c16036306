"""The JAX package's initializers, drawn for the port's parameters.

:func:`init_weights_` gives each parameter the distribution that
``model.init`` gives the same variable in ``mtlora_tpu`` (the port follows
flax here, not timm or torch's module defaults):

  - the frozen kernels of every ``MTLoRALinear``, the merges' reduction and
    the relative position bias table: ``nn.initializers.truncated_normal(
    0.02, lower=-2, upper=2)`` (``swin.py:366,658,1037``,
    ``lora.py:222,335,375``), 0.02 times a standard normal cut at +-2, so
    bounded by +-0.04 with a standard deviation of 0.0176; their biases 0;
  - the patch-embed conv: flax's default ``nn.Conv`` kernel init,
    ``lecun_normal`` (``swin.py:967-970``): variance scaling 1 over the
    fan-in k * k * 3, a normal cut at +-2 rescaled by 1 / 0.8796 so that
    the standard deviation is 1 / sqrt(fan_in); its bias 0;
  - LayerNorm scales 1 and biases 0 (``swin.py:645-647``);
  - LoRA A, shared ``[r, in]`` and task-stacked ``[T, r_max, in]``:
    ``_kaiming_uniform_rows``, U(+-1 / sqrt(in)) over the whole stack
    (``lora.py:160-166,229,272``); LoRA B 0 (``lora.py:231,274``);
  - the downsampler's 1x1 convs: ``variance_scaling(1/3, "fan_in",
    "uniform")`` on the task-stacked ``scale_{s} [T, dim, ch]``
    (``mtl.py:50-53``). Flax counts the stacked axis T into the fan-in, so
    the bound is 1 / sqrt(T * dim), not a single conv's 1 / sqrt(dim)
    (0.0361 against 0.0722 at T = 4, dim = 192); the port keeps that;
  - the HRNet heads (``heads.py:27-37,70-71,110-112,263-270``): conv
    kernels and biases U(+-1 / sqrt(fan_in)), BatchNorm scale 1 and bias
    0, running mean 0 and variance 1.

Every draw comes from a CPU ``torch.Generator`` and is then copied, so the
CPU and the card get the same weights from the same seed.
"""

from __future__ import annotations

import math

import torch
from torch import nn

TRUNC_STD = 0.02
# the standard deviation of a unit normal cut at +-2 (flax's
# variance_scaling "truncated_normal" divides by it)
TRUNC_UNIT_STD = 0.87962566103423978


def _trunc_normal(shape, std, generator):
    return nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2 * std,
                                 2 * std, generator=generator)


def _uniform(shape, bound, generator):
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def _draw(name: str, p: torch.Tensor, owner: nn.Module, num_tasks: int,
          generator: torch.Generator) -> torch.Tensor:
    """The init of parameter ``name`` (a leaf of module ``owner``)."""
    leaf = name.rsplit(".", 1)[-1]
    shape = p.shape
    if leaf in ("lora_shared_B", "lora_tasks_B"):
        return torch.zeros(shape)
    if leaf in ("lora_shared_A", "lora_tasks_A"):
        return _uniform(shape, shape[-1] ** -0.5, generator)
    if leaf == "relative_position_bias_table":
        return _trunc_normal(shape, TRUNC_STD, generator)
    if isinstance(owner, (nn.LayerNorm, nn.BatchNorm2d)):
        return torch.ones(shape) if leaf == "weight" else torch.zeros(shape)
    if isinstance(owner, nn.Linear):
        # MTLoRALinear's frozen linear, the merges' reduction
        return (_trunc_normal(shape, TRUNC_STD, generator)
                if leaf == "weight" else torch.zeros(shape))
    if isinstance(owner, nn.Conv2d):
        fan_in = owner.in_channels * math.prod(owner.kernel_size)
        if name.startswith("backbone."):            # patch embed
            if leaf == "bias":
                return torch.zeros(shape)
            return _trunc_normal(shape, fan_in ** -0.5 / TRUNC_UNIT_STD,
                                 generator)
        if name.startswith("downsampler."):
            return _uniform(shape, (num_tasks * fan_in) ** -0.5, generator)
        if name.startswith("decoders."):
            return _uniform(shape, fan_in ** -0.5, generator)
    raise KeyError(f"init_weights_: no initializer for {name}")


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of a ``MultiTaskSwin`` as the JAX package's
    ``model.init`` draws it (module docstring), and set the BatchNorm
    running statistics to mean 0 and variance 1; in place, returns the
    model."""
    modules = dict(model.named_modules())
    num_tasks = len(model.cfg.tasks)
    for name, p in model.named_parameters():
        owner = modules[name.rpartition(".")[0]]
        p.copy_(_draw(name, p, owner, num_tasks, generator))
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_running_stats()
    return model

