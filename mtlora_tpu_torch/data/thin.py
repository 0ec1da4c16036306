"""Morphological thinning (skeletonization) for edge ground truth.

The port's copy of ``mtlora_tpu/data/thin.py`` (pure numpy). The
reference thins the Laplacian of the PASCAL-Context label map with
``skimage.morphology.thin`` (data/mtl_ds.py:34,526). skimage is not a
dependency, so this module reimplements the EXACT algorithm
skimage's ``thin`` performs: the Guo-Hall two-subiteration thinning as
described in Lam, Lee & Suen, "Thinning Methodologies — A Comprehensive
Survey" (IEEE TPAMI 14(9), 1992), section 8.2 — the same reference
skimage cites. skimage drives it with two 256-entry neighborhood
lookup tables (G123_LUT / G123P_LUT); here the tables are GENERATED
from the published conditions rather than vendored:

With 8-neighbors x1..x8 numbered counterclockwise from the east
(x1=E, x2=NE, x3=N, x4=NW, x5=W, x6=SW, x7=S, x8=SE), a foreground
pixel is deleted in the odd sub-iteration iff G1 and G2 and G3, and in
the even sub-iteration iff G1 and G2 and G3', where

  G1:  X_H(p) == 1, X_H = sum_{i=1..4} b_i,
       b_i = (not x_{2i-1}) and (x_{2i} or x_{2i+1})       [x9 = x1]
  G2:  2 <= min(n1, n2) <= 3,
       n1 = sum_{k=1..4} (x_{2k-1} or x_{2k}),
       n2 = sum_{k=1..4} (x_{2k} or x_{2k+1})
  G3:  ((x2 or x3 or not x8) and x1) == 0
  G3': ((x6 or x7 or not x4) and x5) == 0

The neighborhood index uses skimage's correlation mask
[[8, 4, 2], [16, 0, 1], [32, 64, 128]] (NW=8, N=4, NE=2, W=16, E=1,
SW=32, S=64, SE=128), one iteration = both sub-iterations (each seeing
the previous sub-iteration's deletions), and iteration stops when a
full iteration deletes nothing or ``max_num_iter`` is reached —
matching skimage's loop semantics.

Provenance note: bit-identity against skimage itself is not verified
(skimage is not installed where this was written); what is implemented
is the exact published condition set of
skimage's cited reference (Lam-Lee-Suen section 8.2, i.e. Guo-Hall
1989), not Zhang-Suen, which is a different algorithm with different
skeletons. Key behaviors: single-pixel lines are fixed points (no
endpoint erosion), idempotence, 4-connected-background preservation
(tests/test_data_loader.py::test_thinning_guo_hall_semantics holds the
JAX package's copy to them; tests/test_torch_port_data.py holds this one
to that copy).
"""

from __future__ import annotations

import numpy as np


def _neighbors_from_index(n: int):
    """Unpack the 8-bit neighborhood index into x1..x8 (E, NE, N, NW,
    W, SW, S, SE) under skimage's mask weights."""
    nw = (n >> 3) & 1
    no = (n >> 2) & 1
    ne = (n >> 1) & 1
    ea = n & 1
    we = (n >> 4) & 1
    sw = (n >> 5) & 1
    so = (n >> 6) & 1
    se = (n >> 7) & 1
    return (ea, ne, no, nw, we, sw, so, se)  # x1..x8


def _make_luts():
    lut_odd = np.zeros(256, bool)
    lut_even = np.zeros(256, bool)
    for n in range(256):
        x = _neighbors_from_index(n)  # x[0]=x1 .. x[7]=x8

        def xi(i):  # 1-based, x9 == x1
            return x[(i - 1) % 8]

        xh = sum((1 - xi(2 * i - 1)) * max(xi(2 * i), xi(2 * i + 1))
                 for i in range(1, 5))
        g1 = xh == 1
        n1 = sum(max(xi(2 * k - 1), xi(2 * k)) for k in range(1, 5))
        n2 = sum(max(xi(2 * k), xi(2 * k + 1)) for k in range(1, 5))
        g2 = 2 <= min(n1, n2) <= 3
        g3 = (max(xi(2), xi(3), 1 - xi(8)) * xi(1)) == 0
        g3p = (max(xi(6), xi(7), 1 - xi(4)) * xi(5)) == 0
        lut_odd[n] = g1 and g2 and g3
        lut_even[n] = g1 and g2 and g3p
    return lut_odd, lut_even


_LUT_ODD, _LUT_EVEN = _make_luts()


def _neighborhood_index(img: np.ndarray) -> np.ndarray:
    """Correlate with [[8,4,2],[16,0,1],[32,64,128]], zero-padded."""
    p = np.pad(img, 1)
    return (8 * p[:-2, :-2] + 4 * p[:-2, 1:-1] + 2 * p[:-2, 2:]
            + 16 * p[1:-1, :-2] + 1 * p[1:-1, 2:]
            + 32 * p[2:, :-2] + 64 * p[2:, 1:-1] + 128 * p[2:, 2:])


def thin(image: np.ndarray, max_num_iter: int | None = None) -> np.ndarray:
    """Guo-Hall / Lam-Lee-Suen thinning (skimage.morphology.thin
    semantics) of a binary image; returns a bool skeleton."""
    skel = (np.asarray(image) != 0).astype(np.uint8)
    max_iter = np.inf if max_num_iter is None else max_num_iter
    n_old, n_new = np.inf, int(skel.sum())
    num_iter = 0
    while n_old != n_new and num_iter < max_iter:
        n_old = n_new
        for lut in (_LUT_ODD, _LUT_EVEN):
            n_idx = _neighborhood_index(skel)
            skel[lut[n_idx]] = 0
        n_new = int(skel.sum())
        num_iter += 1
    return skel.astype(bool)
