"""Running averages of host numbers.

Counterpart of ``mtlora_tpu/utils/logger.py:AverageMeter`` (:48), which
``train/loop.py:validate`` keeps for its per-batch loss series.
"""

from __future__ import annotations


class AverageMeter:
    """Running average (the reference's timm AverageMeter usage)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)
