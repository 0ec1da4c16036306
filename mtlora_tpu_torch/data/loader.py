"""Batching and host-to-device feeding of the MTL datasets.

Counterpart of ``mtlora_tpu/data/loader.py:30-284``. The index stream is
the JAX package's: every process draws the same (seed, epoch)-keyed
permutation and takes its row block of every global batch, so the global
batch across ``world`` processes is the single-process batch; a padded
loader (``pad_last``) fills the ragged last global batch with pad rows
and gives every batch a ``"_valid"`` row weight.

The batches are made by a ``torch.utils.data.DataLoader`` with worker
processes (started by ``spawn``: the parent holds threads and a CUDA
context), each batch one item: its sampler yields ``(epoch, chunk)``, the
chunk being the JAX loader's list of sample indices with ``-1`` marking a
pad row. A batch is built whole in one worker, because its pad rows are
made from one of its own samples. The epoch travels with each chunk, so
persistent workers see it, and every sample's augmentation is drawn from
its (seed, epoch, index)-pure stream (``transforms.sample_rng``): batches
do not depend on the number of workers. Batches come in order, as
tensors (``meta`` stays a list of dicts), in pinned memory where the
loader is for a CUDA device, so that copying them to the card does not
wait for the stream.
"""

from __future__ import annotations

import itertools
import types
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from mtlora_tpu_torch.data import native

# DATA.NUM_WORKERS's default (mtlora_tpu/config.py:171)
NUM_WORKERS = 4


def collate(samples: Sequence[Dict]) -> Dict:
    """Stack dict-of-array samples into a batch (reference collate_mil):
    each array key becomes one tensor [B, ...]; ``meta`` stays a list of
    the samples' dicts (``default_collate`` would turn its ``im_size``
    tuples into tensors)."""
    out: Dict = {}
    for key in samples[0]:
        if "meta" in key:
            out[key] = [s[key] for s in samples]
        else:
            out[key] = torch.from_numpy(np.stack([s[key] for s in samples]))
    return out


def ignore_fill_sample(sample: Dict) -> Dict:
    """Pad-row fill: every target gets the 255 ignore sentinel (all
    meters and losses mask 255; what they do not mask is excluded by the
    ``"_valid"`` row weight the loader attaches)."""
    for k, v in sample.items():
        if k != "image" and "meta" not in k:
            sample[k] = np.full_like(v, 255)
    return sample


def make_pad(template: Dict, pad_fill: Optional[Callable]) -> Dict:
    """A pad row built from a sample already fetched
    (``mtlora_tpu/data/loader.py:165-180``): zero image (the row weight
    masks it anyway) and the targets copied, then ``pad_fill`` (which
    should overwrite them with their ignore sentinels); no extra dataset
    call and no augmentation draw."""
    pad = {}
    for k, v in template.items():
        if "meta" in k:
            pad[k] = v
        elif k == "image":
            pad[k] = np.zeros_like(v)
        else:
            pad[k] = np.array(v, copy=True)
    if pad_fill is not None:
        pad = pad_fill(pad)
    return pad


class _Batches:
    """The dataset seen batch by batch: item ``(epoch, chunk)`` is the
    collated batch of the chunk's samples at that epoch."""

    def __init__(self, dataset, seed: int, pad_last: bool,
                 pad_fill: Optional[Callable]):
        self.dataset = dataset
        self.seed = seed
        self.pad_last = pad_last
        self.pad_fill = pad_fill

    def __getitem__(self, key) -> Dict:
        epoch, chunk = key
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch, self.seed)
        samples: List = [self.dataset[i] if i >= 0 else None for i in chunk]
        if any(s is None for s in samples):
            template = next((s for s in samples if s is not None), None)
            if template is None:  # all-pad batch (tiny datasets)
                template = self.dataset[0]
            pad = make_pad(template, self.pad_fill)
            samples = [pad if s is None else s for s in samples]
        batch = collate(samples)
        if self.pad_last:
            batch["_valid"] = torch.from_numpy(
                (np.asarray(chunk) >= 0).astype(np.float32))
        return batch


class _Chunks:
    """The index stream of ``mtlora_tpu/data/loader.py:98-135``, and the
    sampler of the torch loader: iterated, the chunks of epoch ``epoch``,
    each with the epoch (the parent sets ``epoch`` before an epoch's
    iteration)."""

    def __init__(self, n: int, batch_size: int, shuffle: bool,
                 drop_last: bool, seed: int, rank: int, world: int,
                 pad_last: bool):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.rank = rank
        self.world = world
        self.pad_last = pad_last
        self.local_batch_size = batch_size // world
        self.epoch = 0

    def __len__(self):
        if self.pad_last:
            return -(-self.n // self.batch_size)
        if self.drop_last or self.world > 1:
            # several processes without padding: every process must run
            # the same number of steps -> ragged final batch dropped
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.RandomState(
                np.array([self.seed, epoch], np.uint32)).shuffle(idx)
        if self.pad_last:
            # pad the ragged tail to a full global batch with -1 markers
            total = len(self) * self.batch_size
            idx = np.concatenate(
                [idx, np.full(total - len(idx), -1, idx.dtype)])
        if self.world > 1:
            nb = len(self)
            lbs = self.local_batch_size
            idx = idx[: nb * self.batch_size]
            # row block `rank` of every global batch, so that shard r of
            # the reassembled global batch holds the single-process rows
            idx = idx.reshape(nb, self.world, lbs)
            return idx[:, self.rank, :].reshape(-1)
        if self.drop_last:
            idx = idx[: len(self) * self.batch_size]
        return idx

    def chunks(self, epoch: int) -> List[List[int]]:
        idx = [int(i) for i in self.epoch_indices(epoch)]
        bs = self.local_batch_size
        out = [idx[i:i + bs] for i in range(0, len(idx), bs)]
        if self.drop_last or self.world > 1:
            out = [b for b in out if len(b) == bs]
        return out

    def __iter__(self):
        epoch = self.epoch
        for chunk in self.chunks(epoch):
            yield epoch, chunk


def _as_is(batch):
    return batch


class DataLoader:
    """Shuffling, dropping-last, sharded batch loader over worker
    processes."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 2,
                 seed: int = 0, rank: int = 0, world: int = 1,
                 pad_last: bool = False,
                 pad_fill: Optional[Callable] = None,
                 pin_memory: bool = False,
                 persistent_workers: bool = False):
        """``batch_size`` is the GLOBAL batch; with ``world`` > 1 each
        process loads its ``batch_size / world`` rows of every global
        batch (row block ``rank``).

        ``pad_last`` (requires ``drop_last=False``): pad the ragged final
        global batch to full size instead of shrinking it (one process)
        or dropping it (several). Pad rows are made by :func:`make_pad`
        with ``pad_fill``, and every batch gains a ``"_valid"`` float32
        [local batch] row weight, which the eval path threads through
        meters and losses so that padding contributes exactly nothing.

        ``num_workers`` 0 builds the batches in this process; workers
        start by ``spawn``, which imports the main module again, so a
        script that iterates a loader with workers does so under
        ``if __name__ == "__main__":``. ``pin_memory`` puts the batches in
        page-locked memory.
        ``persistent_workers`` keeps the workers from one epoch to the
        next; they stop when the loader is dropped."""
        if pad_last and drop_last:
            raise ValueError("pad_last needs drop_last=False")
        if batch_size % world:
            raise ValueError(f"global batch {batch_size} must divide "
                             f"across {world} processes")
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        self.dataset = dataset
        self.batch_size = batch_size
        self._chunks = _Chunks(len(dataset), batch_size, shuffle, drop_last,
                               seed, rank, world, pad_last)
        if num_workers:
            # build the image ops here, once, rather than in every worker
            native.library()
        workers = dict(multiprocessing_context="spawn",
                       persistent_workers=persistent_workers
                       ) if num_workers else {}
        self._loader = torch.utils.data.DataLoader(
            _Batches(dataset, seed, pad_last, pad_fill), batch_size=None,
            sampler=self._chunks, collate_fn=_as_is,
            num_workers=num_workers, pin_memory=pin_memory, **workers)

    def __len__(self):
        return len(self._chunks)

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """This process's sample indices for ``epoch``, ``-1`` for a pad
        row. The permutation is a pure function of (seed, epoch),
        identical on every process and every call."""
        return self._chunks.epoch_indices(epoch)

    def chunks(self, epoch: int) -> List[List[int]]:
        """The sample indices of each of this process's batches of
        ``epoch``, in order."""
        return self._chunks.chunks(epoch)

    def __iter__(self) -> Iterator[Dict]:
        return self.iter_epoch(0)

    def iter_epoch(self, epoch: int) -> Iterator[Dict]:
        """The batches of ``epoch``, in order."""
        self._chunks.epoch = int(epoch)
        return iter(self._loader)


def build_loader(config, rank: int = 0, world: int = 1, device="cuda"):
    """Dataset and loader dispatch (reference data/build.py): returns
    (ds_train, ds_val, loader_train, loader_val, mixup_fn=None).

    ``config`` is a reference-schema config node read by attribute, as
    ``config.from_config`` reads it: ``DATA.DBNAME``, ``DATA.DATA_PATH``,
    ``DATA.BATCH_SIZE``, ``DATA.NUM_WORKERS``, ``DATA.IMG_SIZE``,
    ``TASKS`` and ``SEED``; the tasks' configuration is computed here
    (``TASKS_CONFIG`` is not read). ``rank`` and ``world`` shard the
    batches across processes; the batches are pinned for a CUDA
    ``device``."""
    from mtlora_tpu_torch.data.task_config import get_tasks_config
    from mtlora_tpu_torch.data.transforms import get_transformations

    db = config.DATA.DBNAME
    tasks = list(config.TASKS)
    tasks_cfg, _ = get_tasks_config(db, tasks, config.DATA.IMG_SIZE)
    tr_train, tr_val = get_transformations(db, tasks_cfg)
    if db == "PASCALContext":
        from mtlora_tpu_torch.data.pascal import PASCALContext as DS

        flags = dict(do_edge="edge" in tasks, do_semseg="semseg" in tasks,
                     do_normals="normals" in tasks, do_sal="sal" in tasks,
                     do_human_parts="human_parts" in tasks)
    elif db == "NYUD":
        from mtlora_tpu_torch.data.nyud import NYUD_MT as DS

        flags = dict(do_edge="edge" in tasks, do_semseg="semseg" in tasks,
                     do_normals="normals" in tasks,
                     do_depth="depth" in tasks)
    else:
        raise NotImplementedError(db)
    root = config.DATA.DATA_PATH
    ds_train = DS(root, split="train", transform=tr_train, **flags)
    ds_val = DS(root, split="val", transform=tr_val, **flags)
    workers = int(config.DATA.NUM_WORKERS)
    common = dict(num_workers=workers, rank=rank, world=world,
                  pin_memory=torch.device(device).type == "cuda",
                  persistent_workers=workers > 0)
    loader_train = DataLoader(ds_train, int(config.DATA.BATCH_SIZE),
                              shuffle=True, drop_last=True,
                              seed=int(config.SEED), **common)
    loader_val = DataLoader(ds_val, int(config.DATA.BATCH_SIZE),
                            shuffle=False, drop_last=False, pad_last=True,
                            pad_fill=ignore_fill_sample, **common)
    return ds_train, ds_val, loader_train, loader_val, None


def data_node(db: str, root: str, tasks: Sequence[str], img_size: int,
              batch_size: int, seed: int, num_workers: int = NUM_WORKERS):
    """A config node holding what :func:`build_loader` reads, for the entry
    points, which load no YAML."""
    data = types.SimpleNamespace(DBNAME=db, DATA_PATH=root,
                                 BATCH_SIZE=batch_size,
                                 NUM_WORKERS=num_workers, IMG_SIZE=img_size)
    return types.SimpleNamespace(DATA=data, TASKS=list(tasks), SEED=seed)


def epochs(loader: DataLoader, start: int = 0) -> Iterator[Dict]:
    """The loader's batches, epoch after epoch, without end."""
    if not len(loader):
        raise ValueError(f"the loader has no batch: {len(loader.dataset)} "
                         f"samples, batches of {loader.batch_size}")
    for epoch in itertools.count(start):
        yield from loader.iter_epoch(epoch)
