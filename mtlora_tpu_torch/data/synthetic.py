"""Synthetic multi-task dataset for benchmarks and smoke tests.

Counterpart of ``mtlora_tpu/data/synthetic.py:17-130``. Shapes, dtypes
and value ranges (the 255 ignore bands included) match the real datasets,
so the train and eval paths run the same code. The reference's closest
analogue is its overfit=64-images mode (data/mtl_ds.py:160-164).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from mtlora_tpu_torch.data import native
from mtlora_tpu_torch.data.task_config import get_tasks_config
from mtlora_tpu_torch.data.transforms import apply_transform


class SyntheticMTL:
    """``structured=False`` (default): per-pixel random labels, the right
    shapes and ignore bands for pipeline tests but unlearnable.
    ``structured=True``: smooth random images with labels derived from the
    image (class = quantized intensity, normals from intensity gradients,
    saliency and edge thresholds): geometric augmentations warp image and
    labels alike, so the mapping is learnable."""

    def __init__(self, tasks: Sequence[str], img_size: int = 448,
                 length: int = 64, db_name: str = "PASCALContext",
                 seed: int = 0, transform=None, structured: bool = False):
        self.tasks = list(tasks)
        self.img_size = img_size
        self.length = length
        self.seed = seed
        self.transform = transform
        self._epoch = None
        self._aug_seed = 0
        self.structured = structured
        cfg, _ = get_tasks_config(db_name, self.tasks, img_size)
        self.num_output = cfg["NUM_OUTPUT"]

    def __len__(self):
        return self.length

    def _structured_sample(self, r, s) -> Dict:
        base = r.rand(8, 8, 3).astype(np.float32)
        img = native.resize(base, (s, s), native.CUBIC)
        img = np.clip(img, 0.0, 1.0)
        gray = img.mean(-1)
        sample: Dict = {"image": (img * 255.0).astype(float)}
        gy, gx = np.gradient(gray)
        for t in self.tasks:
            if t in ("semseg", "human_parts"):
                k = self.num_output[t]
                lab = np.clip((gray * k).astype(int), 0, k - 1).astype(float)
                lab[: s // 8] = 255.0
                sample[t] = lab
            elif t == "normals":
                n = np.stack([gx * 40.0, gy * 40.0,
                              np.full_like(gray, 0.5)], axis=-1)
                n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
                sample[t] = n
            elif t == "sal":
                sample[t] = (gray > 0.55).astype(float)
            elif t == "edge":
                mag = np.abs(gx) + np.abs(gy)
                sample[t] = (mag > np.percentile(mag, 85)).astype(float)
            elif t == "depth":
                d = gray * 10.0 + 0.5
                d[: s // 8] = 255.0
                sample[t] = d
        return sample

    def set_epoch(self, epoch: int, seed: int = 0):
        """Pin the augmentation epoch and seed: stochastic transforms draw
        (seed, epoch, index)-pure streams."""
        self._epoch, self._aug_seed = int(epoch), int(seed)

    def __getitem__(self, index: int) -> Dict:
        r = np.random.RandomState(self.seed * 100003 + index)
        s = self.img_size
        if self.structured:
            sample = self._structured_sample(r, s)
        else:
            sample = {"image": r.randint(0, 256, (s, s, 3)).astype(float)}
            for t in self.tasks:
                if t in ("semseg", "human_parts"):
                    lab = r.randint(0, self.num_output[t],
                                    (s, s)).astype(float)
                    lab[: s // 8] = 255.0
                    sample[t] = lab
                elif t == "normals":
                    n = r.randn(s, s, 3)
                    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
                    sample[t] = n
                elif t in ("sal", "edge"):
                    sample[t] = (r.rand(s, s) > 0.7).astype(float)
                elif t == "depth":
                    d = r.rand(s, s) * 10.0 + 0.5
                    d[: s // 8] = 255.0
                    sample[t] = d
        sample["meta"] = {"image": f"synthetic_{index}", "im_size": (s, s)}
        return apply_transform(self.transform, sample, self._epoch,
                               self._aug_seed, index)


def synthetic_batch(tasks: Sequence[str], batch_size: int = 8,
                    img_size: int = 448, seed: int = 0,
                    db_name: str = "PASCALContext") -> Dict:
    """One collated NHWC batch through the eval transforms."""
    from mtlora_tpu_torch.data.loader import collate
    from mtlora_tpu_torch.data.transforms import get_transformations

    cfg, _ = get_tasks_config(db_name, list(tasks), img_size)
    _, tr_val = get_transformations(db_name, cfg,
                                    rng=np.random.RandomState(seed))
    ds = SyntheticMTL(tasks, img_size, batch_size, db_name, seed,
                      transform=tr_val)
    batch = collate([ds[i] for i in range(batch_size)])
    batch.pop("meta", None)
    return batch
