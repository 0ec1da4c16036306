"""Reference torch checkpoints -> the port's state dict, and loading them.

The port's own copy of ``mtlora_tpu/ckpt/torch_convert.py``, with torch
and numpy only. :func:`convert_torch_state_dict` turns a reference
``state_dict`` into the port's keys: the reference keys with ``.linear.``
at the ``MTLoRALinear`` sites (qkv, proj, fc1, fc2), the layout of
``ckpt/convert.py``. It

  - drops ``attn_mask``, ``relative_position_index``,
    ``num_batches_tracked`` and ``avgpool`` (the port builds them);
  - accepts both a plain ``qkv.weight`` (official Swin) and a LoRA-wrapped
    ``qkv.linear.weight``;
  - adds the ``backbone.`` prefix to a backbone-only file;
  - drops the classification head when ``num_classes`` is 0, and keeps,
    maps from 22K classes or zeroes it otherwise;
  - drops ``decoders.*`` and ``downsampler.*`` under ``skip_decoder``, and
    reads ``decoders.decoders.{task}`` as ``decoders.{task}``;
  - stacks ``lora_tasks_{A,B}.{task}`` into ``[T, r_max, in]`` and
    ``[T, out, r_max]``, zero-padded to ``r_max``;
  - resizes relative position tables to ``target_window_size`` and the
    absolute position embedding to ``target_num_patches``.

:func:`load_converted_` is the counterpart of ``merge_converted``: it
copies a converted dict into a model, bicubic-resizes a relative position
table to the block's own (window clamping), raises on any other shape
mismatch, and counts loaded, missing and unexpected tensors in the JAX
package's units (a downsampler scale is one tensor for all tasks there).

Bicubic resizing is ``jax.image.resize(..., "bicubic")``: Keys' cubic
with a = -0.5, antialiased when it shrinks. ``F.interpolate`` with
``antialias=True`` computes that (a = -0.5 in both directions); without
it, it takes a = -0.75.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_SKIP_PATTERNS = (
    re.compile(r"\battn_mask$"),
    re.compile(r"relative_position_index$"),
    re.compile(r"num_batches_tracked$"),
    re.compile(r"\bavgpool"),
)

# the reference's data/map22kto1k.txt: the 1000 IN-22K class indices of
# the IN-1K classes, one per line
DEFAULT_MAP22K = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "data",
    "map22kto1k.txt")

_LINEAR_SITES = ("qkv", "proj", "fc1", "fc2")


def _bicubic(grid: torch.Tensor, size: int) -> torch.Tensor:
    """[S1, S1, C] -> [size, size, C], in fp32 on the CPU."""
    x = grid.detach().to("cpu", torch.float32).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(size, size), mode="bicubic",
                      align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0)


def resize_rel_pos_bias_table(table: torch.Tensor,
                              new_len: int) -> torch.Tensor:
    """Bicubic-resize a ``[(2w1-1)^2, nH]`` table to ``[(2w2-1)^2, nH]``
    (reference utils.py:203-221)."""
    L1, nH = table.shape
    if L1 == new_len:
        return table
    S1, S2 = round(L1 ** 0.5), round(new_len ** 0.5)
    return _bicubic(table.reshape(S1, S1, nH), S2).reshape(S2 * S2, nH)


def resize_abs_pos_embed(pe: torch.Tensor, new_len: int) -> torch.Tensor:
    """Bicubic-resize ``[1, L1, C]`` absolute positions to ``[1, L2, C]``
    (reference utils.py:223-248)."""
    _, L1, C = pe.shape
    if L1 == new_len:
        return pe
    S1, S2 = round(L1 ** 0.5), round(new_len ** 0.5)
    return _bicubic(pe.reshape(S1, S1, C), S2).reshape(1, S2 * S2, C)


def _read_map(map_file: str):
    with open(map_file) as f:
        return [int(line.strip()) for line in f if line.strip()]


def remap_22k_to_1k_head(weight: torch.Tensor, bias: torch.Tensor,
                         map_file: str = DEFAULT_MAP22K):
    """The 1K-class rows of a 22K classification head ``weight [N, in]``,
    ``bias [N]``, by a map file of 1000 class indices, one per line (-1 ->
    a zero row) — reference utils.py:250-269 + data/map22kto1k.txt."""
    idx = _read_map(map_file)
    out_w = weight.new_zeros((len(idx), weight.shape[1]))
    out_b = bias.new_zeros((len(idx),))
    for j, i in enumerate(idx):
        if i >= 0:
            out_w[j] = weight[i]
            out_b[j] = bias[i]
    return out_w, out_b


def _port_backbone_key(key: str) -> Optional[str]:
    """A backbone key (``backbone.`` prefixed) in the port's layout, or
    None where the reference layout has no such tensor."""
    parts = key.split(".")
    leaf, parent = parts[-1], parts[-2]
    if "patch_embed" in parts:
        return key if parent in ("proj", "norm") and leaf in (
            "weight", "bias") else None
    if parent == "linear" and leaf in ("weight", "bias"):
        return key
    if parent in _LINEAR_SITES and leaf in ("weight", "bias"):
        return ".".join(parts[:-1] + ["linear", leaf])
    if (parent == "reduction" and leaf == "weight") or (
            (parent.startswith("norm") or parent == "lora_norm")
            and leaf in ("weight", "bias")):
        return key
    if leaf in ("relative_position_bias_table", "absolute_pos_embed",
                "lora_shared_A", "lora_shared_B", "lora_shared_scale"):
        return key
    return None


def _decoder_key(key: str) -> Optional[str]:
    """``decoders.[decoders.]{task}.last_layer.{0,1,3}.{leaf}`` (the HRNet
    head, seg_hrnet.py:502-515) -> ``decoders.{task}.last_layer...``."""
    m = re.match(r"decoders\.(?:decoders\.)?([^.]+)\.last_layer\.(\d)\.(.+)$",
                 key)
    if not m:
        return None
    task, idx, leaf = m.groups()
    leaves = {"0": ("weight", "bias"), "3": ("weight", "bias"),
              "1": ("weight", "bias", "running_mean", "running_var")}
    if leaf not in leaves.get(idx, ()):
        return None
    return f"decoders.{task}.last_layer.{idx}.{leaf}"


def _stack_tasks(leaf: str, stack: Dict[str, torch.Tensor], tasks):
    mats = [stack[t] for t in tasks if t in stack]
    if leaf == "lora_task_scale":
        return torch.stack([m.reshape(()) for m in mats])
    rank_dim = 0 if leaf == "lora_tasks_A" else 1
    r_max = max(m.shape[rank_dim] for m in mats)
    pad = [(0, 0, 0, r_max - m.shape[0]) if rank_dim == 0
           else (0, r_max - m.shape[1]) for m in mats]
    return torch.stack([F.pad(m, p) for m, p in zip(mats, pad)])


def convert_torch_state_dict(
    state_dict,
    tasks: Sequence[str] = (),
    *,
    target_window_size: Optional[int] = None,
    target_num_patches: Optional[int] = None,
    skip_decoder: bool = False,
    num_classes: int = 0,
    map22k_path: str = DEFAULT_MAP22K,
) -> Dict[str, torch.Tensor]:
    """A reference ``state_dict`` (tensors or numpy arrays) -> the port's
    state dict (module docstring); prints the keys it cannot place.
    ``skip_decoder`` is ``--skip_decoder`` (reference utils.py:54-57)."""
    tasks = list(tasks)
    out: Dict[str, torch.Tensor] = {}
    task_stacks: Dict[tuple, Dict[str, torch.Tensor]] = {}
    head: Dict[str, torch.Tensor] = {}
    unmapped = []
    add_prefix = not any(k.startswith(("backbone.", "decoders.",
                                       "downsampler."))
                         for k in state_dict)
    for key, raw in state_dict.items():
        if any(p.search(key) for p in _SKIP_PATTERNS):
            continue
        val = (raw.detach().cpu() if isinstance(raw, torch.Tensor)
               else torch.as_tensor(np.asarray(raw)))
        k = ("backbone." + key) if add_prefix else key
        if re.search(r"(^|\.)head\.(weight|bias)$", k):
            # the classification head: dropped in MTL mode (reference
            # config.py:412), kept / remapped / zeroed for classification
            if num_classes > 0:
                head[k.rsplit(".", 1)[-1]] = val
            continue
        if skip_decoder and k.startswith(("decoders.", "downsampler.")):
            continue
        if k.startswith("decoders."):
            dest = _decoder_key(k)
        elif k.startswith("downsampler."):
            m = re.match(r"downsampler\.([^.]+)\.downsample_\d\.weight$", k)
            if m and m.group(1) not in tasks:
                continue        # the JAX stack takes the model's tasks only
            dest = k if m else None
        else:
            m = re.match(r"(.+)\.(lora_tasks_A|lora_tasks_B|lora_task_scale)"
                         r"\.([^.]+)$", k)
            if m:
                task_stacks.setdefault(m.group(1, 2), {})[m.group(3)] = val
                continue
            dest = _port_backbone_key(k)
            leaf = k.rsplit(".", 1)[-1]
            if leaf == "relative_position_bias_table" and \
                    target_window_size is not None:
                val = resize_rel_pos_bias_table(
                    val, (2 * target_window_size - 1) ** 2)
            if leaf == "absolute_pos_embed" and \
                    target_num_patches is not None:
                val = resize_abs_pos_embed(val, target_num_patches)
        if dest is None:
            unmapped.append(key)
            continue
        out[dest] = val

    if num_classes > 0 and "weight" in head:
        # head surgery (reference utils.py:250-269): kept on a class-count
        # match; the 1K rows of a 22K head; otherwise zeros (the
        # reference's constant_(0.) fallback)
        w, b = head["weight"], head.get("bias")
        if w.shape[0] == num_classes:
            pass
        elif w.shape[0] == 21841 and num_classes == 1000:
            idx = _read_map(map22k_path)
            w, b = w[idx], (b[idx] if b is not None else None)
        else:
            print(f"[torch_convert] head {w.shape[0]} != {num_classes}: "
                  "re-initialized to zero (utils.py:264-269)")
            w = w.new_zeros((num_classes, w.shape[1]))
            b = w.new_zeros((num_classes,))
        out["backbone.head.weight"] = w
        if b is not None:
            out["backbone.head.bias"] = b

    for (prefix, leaf), stack in task_stacks.items():
        out[f"{prefix}.{leaf}"] = _stack_tasks(leaf, stack, tasks)
    if unmapped:
        print(f"[torch_convert] unmapped keys: {unmapped}")
    return out


def _skipped(key: str) -> bool:
    return any(p.search(key) for p in _SKIP_PATTERNS)


def load_unit(key: str) -> str:
    """The JAX variable a port key belongs to: the per-task downsampler
    convs of one scale are one task-stacked ``scale_{s}`` there."""
    return re.sub(r"^downsampler\.[^.]+\.", "downsampler.", key)


@torch.no_grad()
def load_converted_(model: nn.Module, sd: Dict[str, torch.Tensor], *,
                    strict: bool = False) -> Dict:
    """Copy a converted state dict into ``model`` (``merge_converted``,
    reference utils.py:150-159). A relative position table (or absolute
    position embedding) whose shape differs is bicubic-resized to the
    model's; any other shape mismatch raises, and with ``strict`` so does
    any missing or unexpected tensor, before anything is copied. Returns
    ``{"loaded": n, "missing": [...], "unexpected": [...]}`` in the JAX
    package's units (:func:`load_unit`) and prints the counts."""
    target = {k: t for k, t in model.state_dict(keep_vars=True).items()
              if not _skipped(k)}
    units = {}
    for k in target:
        units.setdefault(load_unit(k), []).append(k)
    pending, unexpected = {}, []
    for k, v in sd.items():
        t = target.get(k)
        if t is None:
            if load_unit(k) not in unexpected:
                unexpected.append(load_unit(k))
            continue
        if t.shape != v.shape:
            leaf = k.rsplit(".", 1)[-1]
            if leaf == "relative_position_bias_table":
                # per-block window clamping (swin_transformer_mtlora.py:
                # 279-282): resized to the block's own table
                v = resize_rel_pos_bias_table(v, t.shape[0])
            elif leaf == "absolute_pos_embed":
                v = resize_abs_pos_embed(v, t.shape[1])
            else:
                raise ValueError(f"shape mismatch at {k}: model "
                                 f"{tuple(t.shape)} vs checkpoint "
                                 f"{tuple(v.shape)}")
        pending[k] = v
    missing, loaded = [], 0
    for unit, keys in units.items():
        have = [k in pending for k in keys]
        if all(have):
            loaded += 1
        elif any(have):
            raise ValueError(f"shape mismatch at {unit}: the checkpoint has "
                             f"{sum(have)} of its {len(keys)} task tensors")
        else:
            missing.append(unit)
    print(f"[torch_convert] loaded {loaded} tensors; {len(missing)} "
          f"missing (kept init), {len(unexpected)} unexpected (dropped)")
    if strict and (missing or unexpected):
        raise ValueError(f"missing={missing}, unexpected={unexpected}")
    for k, v in pending.items():
        target[k].copy_(v.to(target[k].dtype))
    return {"loaded": loaded, "missing": missing, "unexpected": unexpected}


def strip_backbone_prefix(converted: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """Re-root a converted dict at its ``backbone.`` keys, for a bare
    backbone (classification mode has no ``backbone`` wrapper); a dict with
    no such key is returned as it is."""
    pre = "backbone."
    if not any(k.startswith(pre) for k in converted):
        return dict(converted)
    return {k[len(pre):]: v for k, v in converted.items()
            if k.startswith(pre)}


def load_torch_checkpoint(path: str, tasks: Sequence[str] = (), **kw):
    """Read a ``.pth`` file and convert it. Takes a raw state_dict or a
    training checkpoint's ``model`` entry (reference utils.py:64-69,
    save_checkpoint:280-294). Foreign files are read with
    ``weights_only=False``, as the JAX package reads them: the reference's
    own checkpoints pickle a config node."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return convert_torch_state_dict(sd, tasks, **kw)
