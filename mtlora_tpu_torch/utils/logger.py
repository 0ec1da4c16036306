"""Process-aware logging and running averages of host numbers.

Counterpart of ``mtlora_tpu/utils/logger.py``: :func:`create_logger`
(:12-44, reference logger.py:16-44) writes to the console on rank 0 only,
colored where ``termcolor`` imports, and every process to its own
``log_rank<r>.txt``; :class:`AverageMeter` (:48) is what
``train/loop.py`` keeps for its host-side series.
"""

from __future__ import annotations

import logging
import os
import sys

_FMT = ("[%(asctime)s %(name)s] "
        "(%(filename)s %(lineno)d): %(levelname)s %(message)s")
_DATEFMT = "%Y-%m-%d %H:%M:%S"


def create_logger(output_dir: str = "", dist_rank: int = 0,
                  name: str = "") -> logging.Logger:
    """The logger ``name``, its handlers replaced: the console (stdout) on
    rank 0, and ``output_dir/log_rank<dist_rank>.txt`` (appended to) where
    ``output_dir`` is given. A second call for the same name, as a second
    run in one process makes, closes the first call's handlers."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    if dist_rank == 0:
        console = logging.StreamHandler(sys.stdout)
        console.setLevel(logging.DEBUG)
        try:
            from termcolor import colored

            color_fmt = (colored("[%(asctime)s %(name)s]", "green")
                         + colored("(%(filename)s %(lineno)d)", "yellow")
                         + ": %(levelname)s %(message)s")
        except ImportError:
            color_fmt = _FMT
        console.setFormatter(logging.Formatter(fmt=color_fmt,
                                               datefmt=_DATEFMT))
        logger.addHandler(console)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(
            os.path.join(output_dir, f"log_rank{dist_rank}.txt"), mode="a")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(fmt=_FMT, datefmt=_DATEFMT))
        logger.addHandler(fh)
    return logger


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
