"""Data parallelism over several processes, one global batch.

Counterpart of ``mtlora_tpu/parallel/distributed.py``. The JAX package
runs one SPMD program over the global batch, so every sum the step takes
runs over all ranks' rows. The port keeps that meaning with explicit
collectives on the default process group, each a no-op in a single
process that has none:

  - :func:`global_sum`, a differentiable all-reduce: the heads' BatchNorm
    moment sums (``models/heads.py``) and every loss normaliser
    (``train/losses.py``: the valid-pixel counts of the CE, normals and
    depth losses, the element count and ``num_pos`` of the balanced BCE)
    are summed over the ranks before they are used, so each rank's loss
    is its share of the global loss;
  - :func:`allreduce_grads_` sums the shares' gradients over the ranks,
    which gives every rank the global gradient; the global norm and the
    clip are taken after it (``train/step.py``). ``DistributedDataParallel``
    would average per-rank means instead, another number wherever the
    ranks' normalisers differ;
  - :func:`allreduce_tree` sums meter states and loss sums before they are
    read (``train/loop.py``).

The ranks start from the same weights (:func:`broadcast_module_`) and
apply the same reduced gradients, so they stay identical;
:func:`replicas_identical` checks that bit for bit.

Randomness: augmentation is a function of (seed, epoch, sample index),
so it does not depend on the rank. Dropout and drop-path are not: rank
``r`` draws them from a generator seeded ``SEED + r`` (:func:`step_seed`),
so the ranks draw different masks for their different rows; a checkpoint
keeps every rank's generator state (:func:`gather_generator_states`).

:func:`initialize` starts the group from ``torchrun``'s environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) or from ``main.py``'s ``--coordinator host:port``,
``--num-processes`` and ``--process-id``: NCCL for a CUDA device, gloo on
the CPU.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist


def is_distributed() -> bool:
    """A process group is up (also at world size 1, under ``torchrun``)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world() -> int:
    return dist.get_world_size() if is_distributed() else 1


def backend() -> Optional[str]:
    """The process group's backend ("nccl", "gloo"), or None."""
    return dist.get_backend() if is_distributed() else None


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str = "cuda") -> Dict:
    """Join the process group, if the run has one, and pick this process's
    device. ``torchrun``'s environment wins over the three flags; with
    neither (or ``num_processes`` 1) the run is one process and no group
    starts. ``device`` is ``"cuda"`` (the card of ``LOCAL_RANK``, NCCL) or
    ``"cpu"`` (gloo). Returns ``{"rank", "world", "local_rank",
    "device"}``."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        n, r = int(env["WORLD_SIZE"]), int(env["RANK"])
        local = int(env.get("LOCAL_RANK", 0))
        init_method = "env://"
    elif num_processes and num_processes > 1:
        if coordinator is None or process_id is None:
            raise ValueError("--num-processes > 1 needs --coordinator "
                             "host:port and --process-id")
        n, r = int(num_processes), int(process_id)
        count = torch.cuda.device_count() if device == "cuda" else 1
        local = r % max(count, 1)
        init_method = f"tcp://{coordinator}"
    else:
        n, r, local, init_method = 1, 0, 0, None
    dev = torch.device("cuda", local) if device == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if init_method is not None and not is_distributed():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init_method, world_size=n,
                                rank=r)
    return {"rank": r, "world": n, "local_rank": local, "device": dev}


def shutdown():
    """Leave the process group, if there is one."""
    if is_distributed():
        dist.destroy_process_group()


def barrier():
    """Every rank waits for the others (nothing in one process)."""
    if not is_distributed():
        return
    if backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def step_seed(seed: int) -> int:
    """The seed of this rank's dropout and drop-path generator."""
    return int(seed) + rank()


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks, on every rank; the gradient of
    each rank's x is the sum of the ranks' gradients of y, since every
    rank's loss share reads y."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, differentiable; ``t`` itself in one
    process."""
    if not is_distributed():
        return t
    return _AllReduceSum.apply(t)


def _flat_allreduce_(tensors: List[torch.Tensor]):
    """Sum the tensors over the ranks in place, one collective per
    dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        i = 0
        for t in group:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()


def allreduce_grads_(grads: List[torch.Tensor]):
    """Each rank's gradients of its loss share, summed over the ranks in
    place: the gradient of the global loss."""
    if is_distributed() and grads:
        _flat_allreduce_(grads)


def allreduce_tree(tree: Dict) -> Dict:
    """A nested dict of tensors summed over the ranks (a new tree; the
    input itself in one process): meter states and loss sums, as
    ``allreduce_meter_states`` (:76) sums the meters'."""
    if not is_distributed():
        return tree
    leaves: List[torch.Tensor] = []

    def copy(node):
        if isinstance(node, dict):
            return {k: copy(v) for k, v in node.items()}
        t = torch.as_tensor(node).clone()
        leaves.append(t)
        return t

    out = copy(tree)
    _flat_allreduce_(leaves)
    return out


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module):
    """Every rank takes rank 0's parameters and buffers."""
    if not is_distributed():
        return
    for t in (*module.parameters(), *module.buffers()):
        dist.broadcast(t.data, src=0)


@torch.no_grad()
def replicas_identical(tensors: List[torch.Tensor]) -> bool:
    """Whether every rank holds rank 0's tensors bit for bit (True in one
    process). Every rank must call it."""
    if not is_distributed():
        return True
    mine = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = mine.clone()
    dist.broadcast(ref, src=0)
    same = torch.tensor([1.0 if torch.equal(mine, ref) else 0.0],
                        device=mine.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same.item() == 1.0)


def gather_generator_states(generator: torch.Generator) -> List:
    """Every rank's generator state, in rank order (on every rank)."""
    state = generator.get_state()
    if not is_distributed():
        return [state]
    out: List = [None] * dist.get_world_size()
    dist.all_gather_object(out, state)
    return out
