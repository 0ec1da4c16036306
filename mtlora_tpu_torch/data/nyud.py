"""NYUD-v2 multi-task dataset (NYUD_MT layout).

Counterpart of ``mtlora_tpu/data/nyud.py:21-101`` (reference
``data/mtl_ds.py:53-242``): layout images/*.jpg, edge/*.npy,
segmentation/*.png, normals/*.npy, depth/*.npy, gt_sets/{train,val}.txt.
Semseg labels shift 0->255 then -1 (background ignored;
mtl_ds.py:229-233). Label maps smaller than the image are resized to it by
the port's image ops; PIL is imported only where a file is decoded.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from mtlora_tpu_torch.data import native
from mtlora_tpu_torch.data.pascal import read_image
from mtlora_tpu_torch.data.transforms import apply_transform


class NYUD_MT:
    def __init__(self, root: str, split="val", transform=None,
                 retname: bool = True, overfit: bool = False,
                 do_edge: bool = False, do_semseg: bool = False,
                 do_normals: bool = False, do_depth: bool = False):
        self.root = root
        self.transform = transform
        self._epoch = None
        self._aug_seed = 0
        self.split = [split] if isinstance(split, str) else sorted(split)
        self.retname = retname
        self.do_edge = do_edge
        self.do_semseg = do_semseg
        self.do_normals = do_normals
        self.do_depth = do_depth

        self.im_ids: List[str] = []
        self.images: List[str] = []
        self.edges: List[str] = []
        self.semsegs: List[str] = []
        self.normals: List[str] = []
        self.depths: List[str] = []
        for splt in self.split:
            with open(os.path.join(root, "gt_sets", splt + ".txt")) as f:
                lines = f.read().splitlines()
            for line in lines:
                self.im_ids.append(line.rstrip("\n"))
                self.images.append(
                    os.path.join(root, "images", line + ".jpg"))
                self.edges.append(os.path.join(root, "edge", line + ".npy"))
                self.semsegs.append(
                    os.path.join(root, "segmentation", line + ".png"))
                self.normals.append(
                    os.path.join(root, "normals", line + ".npy"))
                self.depths.append(
                    os.path.join(root, "depth", line + ".npy"))
        if overfit:
            self.images = self.images[:64]
            self.im_ids = self.im_ids[:64]

    def __len__(self):
        return len(self.images)

    def set_epoch(self, epoch: int, seed: int = 0):
        """Pin the augmentation epoch and seed: stochastic transforms draw
        (seed, epoch, index)-pure streams."""
        self._epoch, self._aug_seed = int(epoch), int(seed)

    def __getitem__(self, index: int) -> Dict:
        sample: Dict = {}
        img = read_image(self.images[index], rgb=True)
        sample["image"] = img
        hw = img.shape[:2]

        def fit(arr, interp):
            if arr.shape[:2] != hw:
                arr = native.resize(arr, hw[::-1], interp)
            return arr

        if self.do_edge:
            sample["edge"] = fit(np.load(self.edges[index]).astype(float),
                                 native.NEAREST)
        if self.do_semseg:
            sem = read_image(self.semsegs[index])
            sem[sem == 0] = 256
            sem = sem - 1
            sample["semseg"] = fit(sem, native.NEAREST)
        if self.do_normals:
            sample["normals"] = fit(np.load(self.normals[index]),
                                    native.CUBIC)
        if self.do_depth:
            sample["depth"] = fit(np.load(self.depths[index]),
                                  native.NEAREST)
        if self.retname:
            sample["meta"] = {"image": self.im_ids[index], "im_size": hw}
        return apply_transform(self.transform, sample, self._epoch,
                               self._aug_seed, index)
