"""Counter-based adapter dropout shared by the LN kernels and their plain
versions.

The JAX kernels draw their masks inside the kernel from the Mosaic PRNG
and redraw the same masks in the backward from ``seed[0]`` and
``seed[1]`` (``pallas_ln_lora.py:88,147``, ``pallas_ln_mlp.py:68,88``).
The port hashes (seed, stream, global element index) with a 32-bit
integer mixer instead, the same function in ``csrc/dropout.cuh`` and here
in int64 torch ops, bit for bit: an element is kept where the hash is
``>= rate * 2**32`` and a kept value is multiplied by ``1 / (1 - rate)``
rounded to fp32. The stream differs from the TPU's (ROADMAP Queue 3,
"Random streams differ"); the distribution is the same.

Element ``(row, col)`` of an ``[M, N]`` stream has index ``row * N + col``
taken mod 2**32. Stream 0 is the layer's LN output, stream 1 the whole
MLP's GELU output; stream ``s`` is keyed by ``seed[s]``.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def threshold(rate: float) -> int:
    """The uint32 keep threshold of ``_drop_mask`` (``pallas_ln_lora.py:70``)."""
    return int(rate * (2 ** 32))


def inv_keep(rate: float) -> float:
    """``1 / (1 - rate)`` rounded to fp32, the scale of a kept value."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32), no int64
    overflow: split ``a`` in 16-bit halves."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_bits(seed: torch.Tensor, stream: int, rows: int,
              cols: int) -> torch.Tensor:
    """uint32 hash (as int64) of every element of an ``[rows, cols]``
    stream; ``seed`` is the int32 ``[2]`` tensor of the call."""
    s = seed[stream].to(torch.int64) & M32
    key = _fmix32((s + GOLDEN * (stream + 1)) & M32)
    idx = (torch.arange(rows, dtype=torch.int64, device=seed.device)[:, None]
           * cols
           + torch.arange(cols, dtype=torch.int64, device=seed.device)) & M32
    return _fmix32((_fmix32(idx ^ key) + key) & M32)


def keep_mask(seed: torch.Tensor, stream: int, rows: int, cols: int,
              rate: float) -> torch.Tensor:
    """bool ``[rows, cols]``: True where the element is kept."""
    return hash_bits(seed, stream, rows, cols) >= threshold(rate)


def apply(v: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """``where(keep, v / (1 - rate), 0)`` with the fp32 reciprocal, in v's
    dtype (the kernels apply it to fp32 values before their bf16 cast)."""
    return torch.where(keep, v * inv_keep(rate), torch.zeros_like(v))


def draw_seed(generator: torch.Generator | None,
              device: torch.device) -> torch.Tensor:
    """The two int32 seeds of one call, drawn on ``device`` from the
    explicit generator (``_drop_seed``, ``swin.py:144-150``): no host
    sync, the kernel reads them from device memory."""
    if generator is None:
        raise ValueError("dropout in training needs an explicit "
                         "torch.Generator")
    return torch.randint(0, 2 ** 31 - 1, (2,), generator=generator,
                         device=device, dtype=torch.int32)
