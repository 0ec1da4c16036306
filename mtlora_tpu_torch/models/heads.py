"""HRNet decode head and the bilinear resize it uses.

Counterpart of ``mtlora_tpu/models/heads.py:39-52,80-144``: upsample the
scales 1..3 to scale 0 and concatenate (18+36+72+144 = 270 channels), then
1x1 expand (4x) + BatchNorm + ReLU + 1x1 predict in the fused kernel of
``ops/head.py``. BatchNorm is folded into a per-channel affine outside the
kernel (``heads.py:134-139``): from the running statistics at eval, and in
training from the batch moments of ``ops.head.bn_stats_from_x``, through
which the BN gradient flows; training also updates the running statistics
as ``0.9 * old + 0.1 * batch`` with the BIASED batch variance
(``heads.py:127-133``), which is why ``nn.BatchNorm2d``'s own update (with
the unbiased one) is not used.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mtlora_tpu_torch.ops.head import bn_stats_from_x, head_mlp

BN_MOMENTUM = 0.9


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize with half-pixel centres (align_corners=False,
    no antialiasing) -- ``jax.image.resize(..., "bilinear")`` for the
    upsampling this path does."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def upcat(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    size = xs[0].shape[1:3]
    return torch.cat([xs[0]] + [resize_bilinear(x, size) for x in xs[1:]],
                     dim=-1)


class HighResolutionHead(nn.Module):
    """``last_layer`` = [conv 1x1 C->4C, BatchNorm, ReLU, conv 1x1 4C->n],
    the reference module (seg_hrnet.py:498-526), whose parameters the
    fused kernel reads in place."""

    def __init__(self, in_channels: int, num_outputs: int,
                 kernel: bool = True):
        super().__init__()
        self.kernel = kernel        # TPU.USE_PALLAS: kernel 7 or plain
        c4 = 4 * in_channels
        self.last_layer = nn.Sequential(
            nn.Conv2d(in_channels, c4, 1), nn.BatchNorm2d(c4, eps=1e-5),
            nn.ReLU(), nn.Conv2d(c4, num_outputs, 1))

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """xs: 4 NHWC maps -> [B, H0, W0, n] logits at scale 0."""
        x = upcat(xs)
        B, H, W, c = x.shape
        dt = x.dtype
        expand, bn, _, pred = self.last_layer
        x2 = x.reshape(B * H * W, c)
        # ek [C, 4C] and pk [4C, n] as transposed views of the conv weights
        ek = expand.weight.view(4 * c, c).to(dt).t()
        pk = pred.weight.view(pred.out_channels, 4 * c).to(dt).t()
        if self.training:
            mu, var = bn_stats_from_x(x2, ek, expand.bias)
            with torch.no_grad():
                for stat, batch in ((bn.running_mean, mu),
                                    (bn.running_var, var)):
                    stat.copy_(BN_MOMENTUM * stat
                               + (1 - BN_MOMENTUM) * batch)
                bn.num_batches_tracked += 1
        else:
            mu, var = bn.running_mean, bn.running_var
        inv = torch.rsqrt(var + bn.eps)
        mul = (inv * bn.weight)[None]
        add = (bn.bias - mu * inv * bn.weight)[None]
        y = head_mlp(x2, ek, expand.bias[None], mul, add, pk,
                     pred.bias[None], kernel=self.kernel)
        return y.view(B, H, W, -1)
