"""JAX variables -> port state dict, and port -> reference torch keys.

:func:`from_jax_variables` takes the ``{"params", "batch_stats"}`` tree of
``mtlora_tpu`` (nested dicts of numpy arrays, e.g.
``jax.tree.map(np.asarray, variables)``) of the whole model or of one of
its modules, and returns the port's state dict. Layouts translated:

  - flax dense kernels ``[in, out]`` -> ``weight [out, in]``;
  - the conv kernels HWIO -> OIHW;
  - LayerNorm / BatchNorm ``scale, bias, mean, var`` -> ``weight, bias,
    running_mean, running_var`` (+ ``num_batches_tracked``);
  - shared adapters ``[in, r]`` / ``[r, out]`` -> ``[r, in]`` / ``[out, r]``;
    task stacks ``[T, in, r_max]`` / ``[T, r_max, out]`` ->
    ``[T, r_max, in]`` / ``[T, out, r_max]``;
  - the task-stacked downsampler ``scale_{s} [T, dim, ch]`` -> one conv
    per task, which is why the task names are an argument.

:func:`to_reference_state_dict` writes the port's weights under the
reference torch keys (per-task adapters as ``lora_tasks_A.{task}`` at
their own rank), the layout ``mtlora_tpu/ckpt/torch_convert.py`` reads.
"""

from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mtlora_tpu_torch.models.lora import MTLoRALinear

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}
_HEAD_LAYER = {"expand/conv": "0", "expand/bn": "1", "pred": "3"}


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _segments(path: Tuple[str, ...]):
    out = []
    for seg in path:
        m = re.fullmatch(r"(layers|blocks)_(\d+)", seg)
        if m:
            out += [m.group(1), m.group(2)]
        elif seg.startswith("decoder_"):
            out += ["decoders", seg[len("decoder_"):]]
        else:
            out.append(seg)
    return out


def _port_entries(path, value, tasks):
    """Yield (port key, array) for one flax leaf."""
    segs = _segments(path)
    leaf, parents = segs[-1], segs[:-1]
    tail2 = "/".join(parents[-2:])
    tail1 = parents[-1] if parents else ""
    if tail2 in _HEAD_LAYER or tail1 in _HEAD_LAYER:
        # HRNet head: expand/conv, expand/bn, pred -> last_layer.{0,1,3}
        n = 2 if tail2 in _HEAD_LAYER else 1
        base = parents[:-n] + ["last_layer", _HEAD_LAYER["/".join(
            parents[-n:])]]
        if leaf == "kernel":
            yield base + ["weight"], value.transpose(3, 2, 0, 1)
        elif n == 2 and tail2 == "expand/bn":
            yield base + [_BN[leaf]], value
            if leaf == "mean":
                yield base + ["num_batches_tracked"], np.zeros((), np.int64)
        else:
            yield base + [leaf], value
        return
    if tail1 == "downsampler" and leaf.startswith("scale_"):
        s = leaf[len("scale_"):]
        if len(tasks) != value.shape[0]:
            raise ValueError(f"downsampler {leaf} stacks {value.shape[0]} "
                             f"tasks, got names {tuple(tasks)}")
        for t, task in enumerate(tasks):
            yield (parents + [task, f"downsample_{s}", "weight"],
                   value[t].T[:, :, None, None])
        return
    if leaf == "kernel":
        if value.ndim == 4:                       # patch-embed conv
            yield parents + ["weight"], value.transpose(3, 2, 0, 1)
        elif tail1 == "reduction":
            yield parents + ["weight"], value.T
        else:                                     # MTLoRALinear
            yield parents + ["linear", "weight"], value.T
        return
    if leaf == "scale":                           # LayerNorm
        yield parents + ["weight"], value
        return
    if leaf == "bias":
        linear = not (tail1.startswith("norm") or parents[-2:] == [
            "patch_embed", "proj"])
        yield parents + (["linear", "bias"] if linear else ["bias"]), value
        return
    if leaf in ("lora_shared_A", "lora_shared_B"):
        yield parents + [leaf], value.T
        return
    if leaf in ("lora_tasks_A", "lora_tasks_B"):
        yield parents + [leaf], value.transpose(0, 2, 1)
        return
    if leaf == "relative_position_bias_table":
        yield parents + [leaf], value
        return
    raise KeyError(f"no port parameter for JAX variable {'/'.join(path)}")


def from_jax_variables(variables, tasks: Sequence[str] = ()
                       ) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` tree -> port state dict."""
    flat = _flatten(variables.get("params", {}))
    for path, v in _flatten(variables.get("batch_stats", {})).items():
        flat[path] = v
    sd = {}
    for path, value in flat.items():
        for key, arr in _port_entries(path, np.asarray(value), tasks):
            sd[".".join(key)] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def to_reference_state_dict(model: nn.Module) -> Dict[str, np.ndarray]:
    """The port's weights under the reference torch keys, as numpy."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    for name, mod in model.named_modules():
        if not (isinstance(mod, MTLoRALinear) and mod.tasks):
            continue
        pre = f"{name}." if name else ""
        A = sd.pop(pre + "lora_tasks_A")
        B = sd.pop(pre + "lora_tasks_B")
        for t, (task, r) in enumerate(zip(mod.tasks, mod.r_tasks)):
            sd[f"{pre}lora_tasks_A.{task}"] = A[t, :r]
            sd[f"{pre}lora_tasks_B.{task}"] = B[t, :, :r]
    return sd
