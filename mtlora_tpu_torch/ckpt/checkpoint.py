"""Checkpoints of a training run, and the start of one from a ``.pth``.

Counterpart of ``mtlora_tpu/ckpt/checkpoint.py`` (reference
``utils.py:280-321``) written with ``torch.save``. A checkpoint is
``<output>/ckpt_epoch_<N>.pth``, a dict of

  - ``model``: the weights under the reference torch keys
    (``ckpt/convert.py:to_reference_state_dict``), the layout the JAX
    package's ``load_torch_checkpoint`` reads;
  - ``optimizer``: its ``state_dict``; its param groups carry ``updates``,
    the schedule's index (``train/optim.py:build_optimizer``);
  - ``generator``: the state of the generator the steps draw dropout and
    drop-path from, and ``generators``, every rank's, in rank order,
    where several processes trained (``parallel.distributed``: rank r's
    generator is its own stream);
  - ``epoch``, ``max_accuracy``, and ``FORMAT_KEY``, which marks the file
    as the port's.

:func:`resume_from` and :func:`load_pretrained_` start a run as JAX
``main.py:212-243`` does: a ``.pth`` without ``FORMAT_KEY`` is a reference
checkpoint, whose weights only are loaded (at epoch 0); one with it
resumes the whole state at the next epoch. Under several processes
every rank calls :func:`save_checkpoint` (the generators are gathered)
and rank 0 alone writes the file, then the ranks meet at a barrier; the
model saved is the module itself, whose keys are the reference's (the
port's data parallelism wraps nothing). ``config_dump`` also writes the
run's config as ``config.yaml`` beside the checkpoints, as the JAX
package does.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import torch
from torch import nn

from mtlora_tpu_torch.ckpt.convert import to_reference_state_dict
from mtlora_tpu_torch.ckpt.torch_convert import (
    convert_torch_state_dict,
    load_converted_,
    load_torch_checkpoint,
)
from mtlora_tpu_torch.parallel.distributed import (
    barrier,
    gather_generator_states,
    rank,
    world,
)

FORMAT_KEY = "mtlora_tpu_torch_checkpoint"
FORMAT_VERSION = 1


def _list_ckpts(output_dir: str):
    return glob.glob(os.path.join(glob.escape(output_dir),
                                  "ckpt_epoch_*.pth"))


def save_checkpoint(output_dir: str, epoch: int, model: nn.Module,
                    optimizer: torch.optim.Optimizer,
                    generator: torch.Generator, max_accuracy: float = 0.0,
                    keep: int = 0, config_dump: Optional[str] = None) -> str:
    """Write ``ckpt_epoch_{epoch}.pth`` (reference save_checkpoint
    utils.py:280-294) and, with ``config_dump``, ``config.yaml``; with
    ``keep`` > 0, only the ``keep`` highest epochs stay. Every rank calls
    it; rank 0 writes. Returns the path."""
    path = os.path.abspath(os.path.join(output_dir,
                                        f"ckpt_epoch_{epoch}.pth"))
    generators = gather_generator_states(generator)
    if rank() == 0:
        os.makedirs(output_dir, exist_ok=True)
        payload = {
            FORMAT_KEY: FORMAT_VERSION,
            "model": {k: torch.from_numpy(v).clone()
                      for k, v in to_reference_state_dict(model).items()},
            "optimizer": optimizer.state_dict(),
            "generator": generators[0],
            "epoch": int(epoch),
            "max_accuracy": float(max_accuracy),
        }
        if len(generators) > 1:
            payload["generators"] = generators
        torch.save(payload, path)
        if config_dump:
            with open(os.path.join(output_dir, "config.yaml"), "w") as f:
                f.write(config_dump)
        if keep > 0:
            ckpts = sorted(_list_ckpts(output_dir),
                           key=lambda p: int(os.path.basename(p)[
                               len("ckpt_epoch_"):-len(".pth")]))
            for old in ckpts[:-keep]:
                os.remove(old)
    barrier()
    return path


def auto_resume_helper(output_dir: str) -> Optional[str]:
    """The most recently modified ``ckpt_epoch_*.pth`` of ``output_dir``,
    or None (reference utils.py:310-321)."""
    ckpts = _list_ckpts(output_dir)
    return max(ckpts, key=os.path.getmtime) if ckpts else None


def _restore(ckpt: Dict, model: nn.Module,
             optimizer: Optional[torch.optim.Optimizer],
             generator: Optional[torch.Generator]) -> Dict:
    sd = convert_torch_state_dict(ckpt["model"], model.cfg.tasks)
    load_converted_(model, sd, strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
    if generator is not None:
        generator.set_state(_generator_state(ckpt, generator))
    return {"epoch": ckpt["epoch"], "max_accuracy": ckpt["max_accuracy"]}


def _generator_state(ckpt: Dict, generator: torch.Generator):
    """This rank's state: its own where the file holds one a rank of this
    run's world; otherwise rank 0 takes the file's ``generator`` and any
    other rank keeps the stream it was seeded with."""
    states = ckpt.get("generators")
    if states is not None and len(states) == world():
        return states[rank()]
    return ckpt["generator"] if rank() == 0 else generator.get_state()


def load_checkpoint(path: str, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    generator: Optional[torch.Generator] = None) -> Dict:
    """Restore a checkpoint of :func:`save_checkpoint` into ``model`` (all
    of it, strictly), ``optimizer`` and ``generator`` (each skipped when
    None); read with ``weights_only=True``. Returns ``{"epoch",
    "max_accuracy"}``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(ckpt, dict) and FORMAT_KEY in ckpt):
        raise ValueError(f"{path}: not a checkpoint of the port "
                         f"(no {FORMAT_KEY!r} key)")
    return _restore(ckpt, model, optimizer, generator)


def resume_from(path: str, model: nn.Module,
                optimizer: Optional[torch.optim.Optimizer] = None,
                generator: Optional[torch.Generator] = None, *,
                skip_decoder: bool = False) -> Dict:
    """``--resume PATH`` (JAX ``main.py:212-230``): a checkpoint of the
    port restores the model, ``optimizer`` and ``generator`` and the run
    starts at its epoch + 1; any other ``.pth`` is a reference checkpoint
    whose weights are loaded (non-strict, ``skip_decoder`` as asked, the
    relative position tables resized to the model's window) and the run
    starts at epoch 0. Reads with ``weights_only=False`` (a reference
    checkpoint pickles a config node). Returns ``{"start_epoch",
    "max_accuracy"}``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and FORMAT_KEY in ckpt:
        out = _restore(ckpt, model, optimizer, generator)
        return {"start_epoch": out["epoch"] + 1,
                "max_accuracy": out["max_accuracy"]}
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    load_converted_(model, convert_torch_state_dict(
        sd, model.cfg.tasks, target_window_size=model.cfg.window_size,
        skip_decoder=skip_decoder))
    return {"start_epoch": 0, "max_accuracy": 0.0}


def load_pretrained_(model: nn.Module, path: str) -> Dict:
    """``--pretrained PATH`` (JAX ``main.py:231-243``): the weights of a
    reference ``.pth`` (an ImageNet Swin backbone, typically), the
    relative position tables resized to the model's window and the
    absolute positions to ``(img // 4)^2`` patches, decoders and
    downsamplers skipped, non-strict. Returns :func:`load_converted_`'s
    counts."""
    cfg = model.cfg
    sd = load_torch_checkpoint(
        path, cfg.tasks, target_window_size=cfg.window_size,
        target_num_patches=(cfg.img_size // 4) ** 2, skip_decoder=True)
    return load_converted_(model, sd)
