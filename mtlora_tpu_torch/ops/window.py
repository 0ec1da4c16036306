"""Cyclic shift + window partition, and its inverse, as token gathers.

Counterpart of ``mtlora_tpu/ops/window.py:59-70,207-243``. Both
directions are ONE ``index_select`` on the token axis: the permutation
folds ``roll(-shift, -shift)`` and the window partition together, and the
merge uses its inverse. Windows come out in the reference order, row-major
over (H/ws, W/ws) per image, tokens row-major inside a window. The TPU's
padded pack-2 order (pairs of windows padded to 104 rows) fits its 8x128
tiles and is not carried over.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def shift_partition_perm(H: int, W: int, ws: int, shift: int):
    """(perm, inverse): windowed slot -> source token, and back."""
    src_h = (np.arange(H) + shift) % H
    src_w = (np.arange(W) + shift) % W
    src = src_h[:, None] * W + src_w[None, :]
    perm = src.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3)
    perm = perm.reshape(-1)
    return perm, np.argsort(perm)


@functools.lru_cache(maxsize=None)
def _index(H: int, W: int, ws: int, shift: int, inverse: bool,
           device: torch.device) -> torch.Tensor:
    perm, inv = shift_partition_perm(H, W, ws, shift)
    # a normal tensor even when first built under inference_mode (serving),
    # so that a later training step can save it for backward
    with torch.inference_mode(False):
        return torch.from_numpy(inv if inverse else perm).to(device)


def shift_window_partition(x: torch.Tensor, H: int, W: int, ws: int,
                           shift: int) -> torch.Tensor:
    """[B, H*W, C] tokens -> [B*nW, ws*ws, C] windows."""
    B, L, C = x.shape
    idx = _index(H, W, ws, shift, False, x.device)
    return x.index_select(1, idx).view(B * (L // (ws * ws)), ws * ws, C)


def window_merge_unshift(xw: torch.Tensor, B: int, H: int, W: int, ws: int,
                         shift: int) -> torch.Tensor:
    """[B*nW, ws*ws, C] windows -> [B, H*W, C] tokens (inverse gather)."""
    C = xw.shape[-1]
    idx = _index(H, W, ws, shift, True, xw.device)
    return xw.reshape(B, H * W, C).index_select(1, idx)
