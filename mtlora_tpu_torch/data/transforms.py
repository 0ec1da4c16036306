"""Host-side augmentation pipeline (numpy and the port's image ops).

Counterpart of ``mtlora_tpu/data/transforms.py:51-292`` (reference
``data/custom_transforms.py`` and the assembly in ``data/mtl_ds.py:
833-872``). Samples are dicts of float ndarrays keyed by 'image' and task
names, and the output is NHWC float32. Resize, warpAffine and flip go
through ``data/native`` (the C++ copy of the JAX package's native
backend), so every transform is bit-equal to the JAX package's with its
native backend switched on; against its default cv2 path it is close
(the tests state the bounds). ``rotation_matrix`` is
``cv2.getRotationMatrix2D`` in numpy. Every random draw comes in the JAX
package's order from the same ``np.random.RandomState``.

Semantics per transform (reference file:line):
  - RandomHorizontalFlip (:192-212): flip + normals x-negation
  - ScaleNRotate (:24-91): warpAffine around center, normals in-plane
    rotation BEFORE the warp, depth divided by scale
  - FixedResize (:94-156): per-task interp flags, normals renormalized
  - AddIgnoreRegions (:266-295): normals zero-norm->255, empty human
    parts->255, depth zero->255
  - ToArrays (ToTensor + Normalize, :316-344): image -> uint8 -> /255
    then ImageNet mean/std
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np

from mtlora_tpu_torch.data import native
from mtlora_tpu_torch.data.native import CUBIC, NEAREST

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def rotation_matrix(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: the 2x3 float64
    matrix that rotates by ``angle`` degrees (counter-clockwise) about
    ``center`` and scales by ``scale``. Computed in double on Python
    floats in cv2's order (``angle *= CV_PI / 180``; the center is cv2's
    ``Point2f``), so the result is bit-equal to cv2's."""
    cx = float(np.float32(center[0]))
    cy = float(np.float32(center[1]))
    a = float(angle) * (math.pi / 180)
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]],
                    np.float64)


def _stream(rng, own):
    """The random stream a stochastic transform draws from: the
    per-sample ``rng``, else its own, else numpy's global one (looked up
    at the call, so that the transform pickles into worker processes)."""
    if rng is not None:
        return rng
    return own if own is not None else np.random


def fixed_resize(sample: np.ndarray, resolution, flagval=None) -> np.ndarray:
    """Aspect-aware resize (reference data/helpers.py:60-85)."""
    if flagval is None:
        flagval = (NEAREST if ((sample == 0) | (sample == 1)).all()
                   else CUBIC)
    if isinstance(resolution, int):
        tmp = [resolution, resolution]
        tmp[int(np.argmax(sample.shape[:2]))] = int(round(
            float(resolution) / np.min(sample.shape[:2])
            * np.max(sample.shape[:2])))
        resolution = tuple(tmp)
    if sample.ndim == 2 or (sample.ndim == 3 and sample.shape[2] == 3):
        return native.resize(sample, resolution[::-1], flagval)
    out = np.zeros(np.append(resolution, sample.shape[2]), dtype=float)
    for ii in range(sample.shape[2]):
        out[:, :, ii] = native.resize(sample[:, :, ii], resolution[::-1],
                                      flagval)
    return out


class RandomHorizontalFlip:
    stochastic = True

    def __init__(self, rng: Optional[np.random.RandomState] = None):
        self.rng = rng

    def __call__(self, sample: Dict, rng=None) -> Dict:
        r = _stream(rng, self.rng)
        if r.random_sample() < 0.5:
            for k in list(sample.keys()):
                if "meta" in k:
                    continue
                sample[k] = native.hflip(sample[k])
                if k == "normals":
                    sample[k][:, :, 0] *= -1
        return sample


class ScaleNRotate:
    stochastic = True

    def __init__(self, rots=(-20, 20), scales=(0.75, 1.25), flagvals=None,
                 rng: Optional[np.random.RandomState] = None):
        if not isinstance(rots, type(scales)):
            raise TypeError("rots and scales must both be tuples (ranges) "
                            "or both lists (choices)")
        self.rots = rots
        self.scales = scales
        self.flagvals = flagvals
        self.rng = rng

    def __call__(self, sample: Dict, rng=None) -> Dict:
        r = _stream(rng, self.rng)
        if isinstance(self.rots, tuple):
            # continuous range centered at 0 rotation / 1.0 scale
            rot = ((self.rots[1] - self.rots[0]) * r.random_sample()
                   - (self.rots[1] - self.rots[0]) / 2)
            sc = ((self.scales[1] - self.scales[0])
                  * r.random_sample()
                  - (self.scales[1] - self.scales[0]) / 2 + 1)
        else:  # fixed lists
            rot = self.rots[r.randint(0, len(self.rots))]
            sc = self.scales[r.randint(0, len(self.scales))]

        for k in list(sample.keys()):
            if "meta" in k:
                continue
            tmp = sample[k]
            h, w = tmp.shape[:2]
            center = (w / 2, h / 2)
            M = rotation_matrix(center, rot, sc)
            if self.flagvals is None:
                if ((tmp == 0) | (tmp == 1)).all():
                    flagval = NEAREST
                else:
                    flagval = CUBIC
            else:
                flagval = self.flagvals[k]
            if k == "normals":
                # rotate the normal vectors' in-plane component to match
                in_plane = np.arctan2(tmp[:, :, 0], tmp[:, :, 1])
                nrm0 = np.sqrt(tmp[:, :, 0] ** 2 + tmp[:, :, 1] ** 2)
                rot_rad = rot * 2 * math.pi / 360
                tmp[:, :, 0] = np.sin(in_plane + rot_rad) * nrm0
                tmp[:, :, 1] = np.cos(in_plane + rot_rad) * nrm0
            tmp = native.warp_affine(tmp, M, (w, h), flagval)
            if k == "depth":
                tmp = tmp / sc
            sample[k] = tmp
        return sample


class FixedResize:
    def __init__(self, resolutions=None, flagvals=None):
        self.resolutions = resolutions
        self.flagvals = flagvals
        if flagvals is not None and len(resolutions) != len(flagvals):
            raise ValueError("one flag per resolution")

    def __call__(self, sample: Dict) -> Dict:
        if self.resolutions is None:
            return sample
        for k in list(sample.keys()):
            if "meta" in k or "bbox" in k:
                continue
            if k not in self.resolutions:
                del sample[k]
                continue
            if self.resolutions[k] is None:
                continue
            flag = None if self.flagvals is None else self.flagvals[k]
            sample[k] = fixed_resize(sample[k], self.resolutions[k], flag)
            if k == "normals":
                n = sample[k]
                nn = np.sqrt((n ** 2).sum(axis=2)) + np.finfo(float).eps
                sample[k] = n / nn[:, :, None]
        return sample


class AddIgnoreRegions:
    def __call__(self, sample: Dict) -> Dict:
        for k in list(sample.keys()):
            tmp = sample[k]
            if k == "normals":
                nn = np.sqrt((tmp ** 2).sum(axis=2))
                tmp[nn == 0, :] = 255.0
                sample[k] = tmp
            elif k == "human_parts":
                if (tmp == 0).all():
                    sample[k] = 255.0 * np.ones_like(tmp)
            elif k == "depth":
                tmp[tmp == 0] = 255.0
                sample[k] = tmp
        return sample


class ToArrays:
    """Finalize to NHWC float32 (reference ToTensor + Normalize: image ->
    uint8 -> /255 -> ImageNet normalize; labels keep [H, W, C])."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, sample: Dict) -> Dict:
        for k in list(sample.keys()):
            if "meta" in k:
                continue
            tmp = sample[k]
            if tmp.ndim == 2:
                tmp = tmp[:, :, None]
            if k == "image":
                # cast through uint8 like reference ToTensor:316-319
                tmp = tmp.astype(np.uint8).astype(np.float32) / 255.0
                tmp = (tmp - self.mean) / self.std
            sample[k] = np.ascontiguousarray(tmp, np.float32)
        return sample


class Compose:
    """``rng``: an optional per-sample RandomState threaded into the
    stochastic transforms (``stochastic = True``) only. Datasets derive
    it from (seed, epoch, index), see :func:`sample_rng`, so augmentation
    is a pure function of those three: identical batches under any
    worker or process layout, and exact resume replay (without an rng the
    transforms draw from their own state, as the reference's do)."""

    accepts_rng = True

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample, rng=None):
        for t in self.transforms:
            if rng is not None and getattr(t, "stochastic", False):
                sample = t(sample, rng=rng)
            else:
                sample = t(sample)
        return sample


def sample_rng(seed: int, epoch: int, index: int) -> np.random.RandomState:
    """The (seed, epoch, index)-pure augmentation stream."""
    return np.random.RandomState(
        np.array([seed & 0xFFFFFFFF, epoch, index], np.uint32))


def apply_transform(transform, sample, epoch, seed, index):
    """Dataset-side transform application: when the dataset was given an
    epoch (``set_epoch``) and the transform accepts an rng (Compose),
    augmentation draws from the (seed, epoch, index)-pure stream;
    otherwise from the transforms' own state."""
    if transform is None:
        return sample
    if epoch is not None and getattr(transform, "accepts_rng", False):
        return transform(sample, rng=sample_rng(seed, epoch, index))
    return transform(sample)


def get_transformations(db_name: str, tasks_config: Dict,
                        rng: Optional[np.random.RandomState] = None):
    """Train/eval transform assembly (reference mtl_ds.py:833-872)."""
    flagvals = dict(tasks_config["ALL_TASKS"]["FLAGVALS"])
    if db_name == "NYUD":
        train = [RandomHorizontalFlip(rng),
                 ScaleNRotate(rots=[0], scales=[1.0, 1.2, 1.5],
                              flagvals=flagvals, rng=rng)]
    elif db_name == "PASCALContext":
        train = [RandomHorizontalFlip(rng),
                 ScaleNRotate(rots=(-20, 20), scales=(0.75, 1.25),
                              flagvals=flagvals, rng=rng)]
    else:
        raise ValueError(f"Invalid db name {db_name}")
    scale_tr = {x: tuple(tasks_config["TRAIN"]["SCALE"]) for x in flagvals}
    train += [FixedResize(resolutions=scale_tr, flagvals=flagvals),
              AddIgnoreRegions(), ToArrays()]

    eval_flags = dict(tasks_config["FLAGVALS"])
    scale_ts = {x: tuple(tasks_config["TEST"]["SCALE"]) for x in eval_flags}
    test = [FixedResize(resolutions=scale_ts, flagvals=eval_flags),
            AddIgnoreRegions(), ToArrays()]
    return Compose(train), Compose(test)
