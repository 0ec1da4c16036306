"""The port's data pipeline (``mtlora_tpu_torch.data``) vs the JAX
package's (``mtlora_tpu.data``), on the CPU.

Bit-exact against the JAX package: the task configuration, thinning, the
rotation matrix (against cv2 itself), the Laplacian edge maps, the image
ops (against the JAX package's native library, built from the same C++),
every transform and the composed pipelines with the JAX transforms' native
backend switched on (``_USE_NATIVE``, ``_native`` and ``_NATIVE_INTERP``
set by ``monkeypatch``), the loader's index streams and batches, and
``collate`` / ``ignore_fill_sample``.

Against the JAX package's default cv2 path, within the bounds stated
where they are used: the PASCAL and NYUD fixture trees of
``tests/fixtures_mtl.py`` read raw and through ``build_loader`` at 64 px,
one eval batch at 448, and the train pipeline on smooth synthetic samples
at 448. cv2's ``warpAffine`` and ``resize`` compute their source
coordinates and interpolation weights in fixed point (1/32 px for the
weights, 1/1024 px for the nearest coordinates); the port's image ops, as
the JAX package's native ones, compute them in floating point.
"""

import copy
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from mtlora_tpu.config import load_config
from mtlora_tpu.data import loader as jloader
from mtlora_tpu.data import thin as jthin
from mtlora_tpu.data import transforms as jtransforms
from mtlora_tpu.data.native import native as jnative
from mtlora_tpu.data.nyud import NYUD_MT as JNYUD
from mtlora_tpu.data.pascal import PASCALContext as JPASCAL
from mtlora_tpu.data.synthetic import SyntheticMTL as JSynthetic
from mtlora_tpu.data.task_config import get_tasks_config as jget_tasks_config
from mtlora_tpu_torch.data import native, task_config, thin, transforms
from mtlora_tpu_torch.data.loader import (
    DataLoader,
    build_loader,
    collate,
    data_node,
    ignore_fill_sample,
)
from mtlora_tpu_torch.data.nyud import NYUD_MT
from mtlora_tpu_torch.data.pascal import PASCALContext, laplacian
from mtlora_tpu_torch.data.synthetic import SyntheticMTL

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures_mtl import make_nyud_fixture, make_pascal_fixture  # noqa: E402

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG = os.path.join(ROOT, "configs/mtlora/tiny_448/"
                   "mtlora_tiny_448_r64_scale4_pertask.yaml")
PASCAL = ["semseg", "normals", "sal", "human_parts", "edge"]
NYUD = ["semseg", "normals", "edge", "depth"]
FLAGS = {"image": native.CUBIC, "semseg": native.NEAREST,
         "human_parts": native.NEAREST, "sal": native.NEAREST,
         "normals": native.CUBIC, "edge": native.NEAREST,
         "depth": native.NEAREST}


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX transforms with their native backend switched on."""
    assert jnative.available()
    monkeypatch.setattr(jtransforms, "_USE_NATIVE", True)
    monkeypatch.setattr(jtransforms, "_native", jnative, raising=False)
    monkeypatch.setattr(jtransforms, "_NATIVE_INTERP", {
        cv2.INTER_NEAREST: 0, cv2.INTER_LINEAR: 1, cv2.INTER_CUBIC: 2})


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The PASCAL and NYUD fixture trees; the JAX datasets write the
    parts index of each PASCAL split first."""
    root = tmp_path_factory.mktemp("data")
    pascal, nyud = str(root / "pascal"), str(root / "nyud")
    return {"PASCALContext": (pascal, make_pascal_fixture(pascal)),
            "NYUD": (nyud, make_nyud_fixture(nyud))}


def assert_same(got, want, what=""):
    """A port sample or batch equals the JAX one bit for bit: the same
    keys, arrays of the same dtype and values (tensors read as numpy),
    meta equal."""
    assert set(got) == set(want), what
    for k, v in want.items():
        g = got[k]
        if "meta" in k:
            assert g == v, (what, k)
            continue
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == np.asarray(v).dtype, (what, k, g.dtype)
        np.testing.assert_array_equal(g, v, err_msg=f"{what} {k}")


def raw_sample(seed, h=40, w=52, tasks=PASCAL + ["depth"]):
    """A sample dict as the datasets give it, before any transform: a
    non-square image, label maps with an ignore band and a zero region,
    unit normals with a zero patch, depth with zeros."""
    r = np.random.RandomState(seed)
    s = {"image": r.randint(0, 256, (h, w, 3)).astype(float)}
    for t in tasks:
        if t in ("semseg", "human_parts"):
            lab = r.randint(0, 7, (h, w)).astype(float)
            lab[: h // 8] = 255.0
            s[t] = lab
        elif t == "normals":
            n = r.randn(h, w, 3)
            n /= np.linalg.norm(n, axis=-1, keepdims=True)
            n[-6:, -6:] = 0.0
            s[t] = n
        elif t in ("sal", "edge"):
            s[t] = (r.rand(h, w) > 0.7).astype(float)
        else:
            d = r.rand(h, w) * 9.0 + 0.5
            d[:3, :3] = 0.0
            s[t] = d
    s["meta"] = {"image": f"raw_{seed}", "im_size": (h, w)}
    return s


def both(fn_port, fn_jax, sample):
    """Each side's result on its own copy of ``sample``."""
    return fn_port(copy.deepcopy(sample)), fn_jax(copy.deepcopy(sample))


# ---------------------------------------------------------------------------
# Bit-exact against the JAX package
# ---------------------------------------------------------------------------

def _task_sets(tasks):
    return [[t for i, t in enumerate(tasks) if m >> i & 1]
            for m in range(1, 1 << len(tasks))]


@pytest.mark.parametrize("db,tasks", [
    ("PASCALContext", PASCAL), ("NYUD", ["semseg", "normals", "edge",
                                        "depth"])])
def test_tasks_config_matches_jax(db, tasks):
    """``get_tasks_config`` equals the JAX package's for every task set of
    the database, at a square and a rectangular size; the flags are cv2's
    ``INTER_*`` values; one copy of ``LOSS_WEIGHTS``."""
    assert (native.NEAREST, native.LINEAR, native.CUBIC) == (
        cv2.INTER_NEAREST, cv2.INTER_LINEAR, cv2.INTER_CUBIC)
    for ts in _task_sets(tasks):
        for size in (448, (320, 416)):
            got = task_config.get_tasks_config(db, ts, size)
            assert got == jget_tasks_config(db, ts, size), (ts, size)
    from mtlora_tpu.data.task_config import LOSS_WEIGHTS
    from mtlora_tpu_torch.train import losses
    assert losses.LOSS_WEIGHTS is task_config.LOSS_WEIGHTS
    assert task_config.LOSS_WEIGHTS == LOSS_WEIGHTS
    with pytest.raises(ValueError, match="human_parts"):
        task_config.get_tasks_config("NYUD", ["human_parts"], 64)


@pytest.mark.parametrize("shape", [(9, 11), (40, 52), (64, 80)])
def test_thin_matches_jax(shape):
    """Random blobs, bars and the edge maps of blocky label maps."""
    r = np.random.RandomState(sum(shape))
    for img in (r.rand(*shape) > 0.5,
                np.kron(r.rand(shape[0] // 4 + 1, shape[1] // 4 + 1) > 0.4,
                        np.ones((4, 4)))[: shape[0], : shape[1]],
                np.abs(laplacian(np.kron(r.randint(0, 4, (8, 8)),
                                         np.ones((8, 8)))[: shape[0],
                                                          : shape[1]])) > 0):
        np.testing.assert_array_equal(thin.thin(img), jthin.thin(img))
        np.testing.assert_array_equal(thin.thin(img, 1),
                                      jthin.thin(img, 1))


def test_rotation_matrix_matches_cv2():
    """``rotation_matrix`` is ``cv2.getRotationMatrix2D`` bit for bit over
    a grid of angles (the train ranges, their ends, whole and random
    degrees) and scales, at odd and even centers."""
    r = np.random.RandomState(0)
    angles = list(np.linspace(-20, 20, 81)) + [0, 0.0, 90, -45, 137.5,
                                                 1e-9] + list(
        r.uniform(-20, 20, 50))
    scales = list(np.linspace(0.75, 1.25, 11)) + [1.0, 1.2, 1.5] + list(
        r.uniform(0.75, 1.25, 10))
    for center in ((224.0, 224.0), (40.0, 32.0), (26.5, 20.0), (0.5, 7.0)):
        for a in angles:
            for s in scales:
                got = transforms.rotation_matrix(center, a, s)
                want = cv2.getRotationMatrix2D(center, a, s)
                assert got.dtype == want.dtype == np.float64
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{center} {a} {s}")


def test_laplacian_edges_match_jax(trees):
    """The numpy Laplacian equals ``cv2.Laplacian(.., CV_64F)`` (border
    reflect-101) on random label maps, and the PASCAL edge maps equal
    ``PASCALContext._load_edge`` on every fixture image."""
    r = np.random.RandomState(1)
    for shape in ((5, 7), (33, 20), (64, 80)):
        labels = r.randint(0, 460, shape).astype(np.uint16)
        want = cv2.Laplacian(labels, cv2.CV_64F)
        got = laplacian(labels)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    root, _ = trees["PASCALContext"]
    for split in ("train", "val"):
        port = PASCALContext(root, split=split, do_edge=True)
        ref = JPASCAL(root, split=split, do_edge=True)
        for i in range(len(ref)):
            np.testing.assert_array_equal(port._load_edge(i),
                                          ref._load_edge(i))


@pytest.mark.parametrize("channels", [1, 3])
def test_image_ops_match_jax_native(channels):
    """resize (nearest, linear, cubic; up and down, non-square), warpAffine
    (nearest, linear, cubic, at the train pipeline's matrices) and hflip
    equal the JAX package's native library bit for bit; all float32."""
    r = np.random.RandomState(channels)
    shape = (37, 53) if channels == 1 else (37, 53, 3)
    img = (r.rand(*shape) * 255).astype(np.float32)
    for interp in (native.NEAREST, native.LINEAR, native.CUBIC):
        for dsize in ((64, 48), (30, 20), (53, 37), (448, 448)):
            got = native.resize(img, dsize, interp)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(
                got, jnative.resize(img, dsize, interp))
        for angle, sc in ((13.0, 1.1), (-20.0, 0.75), (0.0, 1.5),
                          (7.3, 1.0)):
            m = transforms.rotation_matrix((26.5, 18.5), angle, sc)
            np.testing.assert_array_equal(
                native.warp_affine(img, m, (53, 37), interp),
                jnative.warp_affine(img, m, (53, 37), interp))
    np.testing.assert_array_equal(native.hflip(img), jnative.hflip(img))
    with pytest.raises(ValueError, match="NEAREST"):
        native.resize(img, (8, 8), 4)


def _flip(rng_seed):
    return (lambda s: transforms.RandomHorizontalFlip()(
                s, rng=np.random.RandomState(rng_seed)),
            lambda s: jtransforms.RandomHorizontalFlip()(
                s, rng=np.random.RandomState(rng_seed)))


def _scale_rotate(rots, scales, flagvals, seed):
    return (lambda s: transforms.ScaleNRotate(rots, scales, flagvals)(
                s, rng=np.random.RandomState(seed)),
            lambda s: jtransforms.ScaleNRotate(rots, scales, flagvals)(
                s, rng=np.random.RandomState(seed)))


def _fixed_resize(resolution, flagvals):
    res = {k: resolution for k in FLAGS}
    return (transforms.FixedResize(res, flagvals),
            jtransforms.FixedResize(res, flagvals))


TRANSFORMS = {
    "flip-yes": lambda: _flip(1),      # first draw 0.417: flips
    "flip-no": lambda: _flip(0),       # first draw 0.549: does not
    "scale-rotate-ranges": lambda: _scale_rotate((-20, 20), (0.75, 1.25),
                                                 FLAGS, 3),
    "scale-rotate-choices": lambda: _scale_rotate([0], [1.0, 1.2, 1.5],
                                                  FLAGS, 4),
    "scale-rotate-auto-flags": lambda: _scale_rotate((-20, 20),
                                                     (0.75, 1.25), None, 5),
    "fixed-resize": lambda: _fixed_resize((48, 64), FLAGS),
    "fixed-resize-aspect": lambda: _fixed_resize(30, None),
    "ignore-regions": lambda: (transforms.AddIgnoreRegions(),
                               jtransforms.AddIgnoreRegions()),
    "to-arrays": lambda: (transforms.ToArrays(), jtransforms.ToArrays()),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_matches_jax_native(name, jax_native):
    """Each transform on the same raw sample (an all-zero human_parts map
    for the ignore regions) equals the JAX one with its native backend."""
    port, ref = TRANSFORMS[name]()
    for seed in range(2):
        sample = raw_sample(seed)
        if name == "ignore-regions":
            sample["human_parts"][:] = 0.0
        got, want = both(port, ref, sample)
        assert_same(got, want, f"{name} {seed}")


@pytest.mark.parametrize("db", ["PASCALContext", "NYUD"])
def test_pipelines_match_jax_native(db, jax_native):
    """The composed train and eval pipelines of ``get_transformations``
    through ``apply_transform`` with the (seed, epoch, index) stream, and
    the transforms' own stream when no epoch is set, equal the JAX ones."""
    tasks = PASCAL if db == "PASCALContext" else NYUD
    cfg, _ = task_config.get_tasks_config(db, tasks, 48)
    port = transforms.get_transformations(db, cfg, np.random.RandomState(7))
    ref = jtransforms.get_transformations(db, cfg, np.random.RandomState(7))
    for i in range(4):
        sample = raw_sample(10 + i, tasks=tasks)
        for p, r in zip(port, ref):
            for epoch in (0, 1, None):
                got, want = both(
                    lambda s: transforms.apply_transform(p, s, epoch, 5, i),
                    lambda s: jtransforms.apply_transform(r, s, epoch, 5,
                                                          i), sample)
                assert_same(got, want, f"{db} {i} {epoch}")
    a = transforms.sample_rng(-3, 2, 9).random_sample(4)
    np.testing.assert_array_equal(
        a, jtransforms.sample_rng(-3, 2, 9).random_sample(4))


LOADER_MODES = {"drop-last": dict(drop_last=True),
                "ragged": dict(drop_last=False),
                "pad-last": dict(drop_last=False, pad_last=True)}


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("mode", list(LOADER_MODES))
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_matches_jax(shuffle, mode, rank, world, jax_native):
    """``epoch_indices``, ``len`` and every batch of epochs 0 and 1 equal
    the JAX loader's (its threads, the port's in-process loader) over the
    synthetic set through the train transforms: 7 samples in global
    batches of 4, so a ragged or padded last batch; padded batches carry
    ``_valid`` and ignore-filled pad rows."""
    kw = dict(LOADER_MODES[mode])
    tasks = PASCAL
    cfg, _ = task_config.get_tasks_config("PASCALContext", tasks, 16)
    ds = SyntheticMTL(tasks, 16, length=7, seed=2,
                      transform=transforms.get_transformations(
                          "PASCALContext", cfg)[0])
    jds = JSynthetic(tasks, 16, length=7, seed=2,
                     transform=jtransforms.get_transformations(
                         "PASCALContext", cfg)[0])
    port = DataLoader(ds, 4, shuffle=shuffle, num_workers=0, seed=11,
                      rank=rank, world=world,
                      pad_fill=ignore_fill_sample if kw.get("pad_last")
                      else None, **kw)
    ref = jloader.DataLoader(jds, 4, shuffle=shuffle, num_workers=2,
                             seed=11, process_index=rank,
                             process_count=world,
                             pad_fill=jloader.ignore_fill_sample
                             if kw.get("pad_last") else None, **kw)
    assert len(port) == len(ref)
    for epoch in (0, 1):
        np.testing.assert_array_equal(port.epoch_indices(epoch),
                                      ref.epoch_indices(epoch))
        got, want = list(port.iter_epoch(epoch)), list(ref.iter_epoch(epoch))
        assert len(got) == len(want) == len(port.chunks(epoch))
        for b, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"epoch {epoch} batch {b}")
    if shuffle:
        assert not np.array_equal(port.epoch_indices(0),
                                  port.epoch_indices(1))


def test_loader_all_pad_batch_matches_jax(jax_native):
    """One sample, global batch 4 over 2 processes, padded: rank 1's only
    batch is all pad rows, made from sample 0 as the JAX loader makes
    them, with ``_valid`` all 0."""
    cfg, _ = task_config.get_tasks_config("PASCALContext", PASCAL, 16)
    for rank in (0, 1):
        port = DataLoader(SyntheticMTL(PASCAL, 16, length=1), 4,
                          shuffle=False, drop_last=False, pad_last=True,
                          pad_fill=ignore_fill_sample, num_workers=0,
                          rank=rank, world=2)
        ref = jloader.DataLoader(JSynthetic(PASCAL, 16, length=1), 4,
                                 shuffle=False, drop_last=False,
                                 pad_last=True,
                                 pad_fill=jloader.ignore_fill_sample,
                                 process_index=rank, process_count=2)
        (g,), (w,) = list(port.iter_epoch(0)), list(ref.iter_epoch(0))
        assert_same(g, w, f"rank {rank}")
    assert g["_valid"].tolist() == [0.0, 0.0]
    assert bool((g["semseg"] == 255).all()) and not g["image"].any()


def test_collate_and_ignore_fill_match_jax():
    """``collate`` stacks what the JAX one stacks (as tensors) and keeps
    meta a list of dicts; ``ignore_fill_sample`` fills every target and
    keeps the image and meta."""
    samples = [raw_sample(i, 8, 10) for i in range(3)]
    got = collate(copy.deepcopy(samples))
    want = jloader.collate(copy.deepcopy(samples))
    assert all(isinstance(v, torch.Tensor) for k, v in got.items()
               if k != "meta")
    assert got["meta"] == want["meta"] and got["meta"][1]["im_size"] == (8, 10)
    assert_same(got, want)
    got = ignore_fill_sample(copy.deepcopy(samples[0]))
    want = jloader.ignore_fill_sample(copy.deepcopy(samples[0]))
    assert_same(got, want)
    assert (got["normals"] == 255).all() and got["image"].max() > 0


# ---------------------------------------------------------------------------
# Against the JAX package's default cv2 path
# ---------------------------------------------------------------------------

def u8_steps(got, want) -> np.ndarray:
    """The distance in uint8 steps between two normalized images: the
    values back in 0..255 (``ToArrays`` casts through uint8 before it
    normalizes), the difference taken modulo 256. A cubic overshoot past
    255 wraps in the uint8 cast on both sides (``ToArrays`` keeps the
    reference's cast), so 255.9 on one side and 256.1 on the other give
    255 and 0: one step apart modulo 256, 255 steps apart otherwise."""
    mean, std = transforms.IMAGENET_MEAN, transforms.IMAGENET_STD
    a = np.round((np.asarray(got) * std + mean) * 255).astype(np.int64)
    b = np.round((np.asarray(want) * std + mean) * 255).astype(np.int64)
    d = np.abs(a - b) % 256
    return np.minimum(d, 256 - d)


# the image: at most 2% of the elements differ, by at most 2 uint8 steps
# (cv2's fixed-point weights move a value by up to ~1.2, which the cast
# can turn into 2 steps; measured: 1e-4 of the elements, 1 step)
IMAGE_SHARE, IMAGE_STEPS = 0.02, 2
# normals: within 1e-3 (measured 1e-4 after resize, 7.7e-5 after the warp
# of smooth normals); the 255 band of AddIgnoreRegions counted apart
NORMALS_ATOL = 1e-3
# nearest-interpolated labels after the warp, on smooth label maps (the
# synthetic set's): a pixel differs where cv2's 1/1024-px coordinates
# round to the other neighbour across a label boundary (measured 1e-4 at
# most per image, 4e-5 on average)
LABEL_SHARE = 1e-4
# the fixture trees' label maps are per-pixel noise, so every such
# rounding shows, not only those at a boundary, and NYUD's pure scalings
# (rotation 0, scale 1.2 or 1.5) put many source coordinates on exact
# half-pixel ties: measured up to 7.8e-3 of the pixels
NOISE_LABEL_SHARE = 2e-2


def check_image(got, want, what):
    d = u8_steps(got, want)
    assert d.max() <= IMAGE_STEPS, (what, d.max())
    assert (d > 0).mean() <= IMAGE_SHARE, (what, (d > 0).mean())


def _grow(mask, r):
    """``mask`` [..., H, W] grown by ``r`` pixels (a square window)."""
    out = mask.copy()
    p = np.pad(mask, [(0, 0)] * (mask.ndim - 2) + [(r, r), (r, r)])
    h, w = mask.shape[-2:]
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            out |= p[..., dy:dy + h, dx:dx + w]
    return out


def check_normals(got, want, what, border_share=None):
    """Within ``NORMALS_ATOL`` away from the 255 band of AddIgnoreRegions.
    Without ``border_share`` the band is the same on both sides. With it
    (after a warp) the band's rim is counted apart: the warp fades the
    normals into its constant 0 border, and the renormalization of
    FixedResize turns a vector a round-off away from 0 into a unit vector
    of any direction; the pixels within 2 px of the band on either side
    that differ by more than the bound, or are in the band on one side
    only, are at most ``border_share`` of the pixels."""
    got, want = np.asarray(got), np.asarray(want)
    bg, bw = (got == 255).all(-1), (want == 255).all(-1)
    if border_share is None:
        np.testing.assert_array_equal(bg, bw, err_msg=what)
        rim = bg
    else:
        rim = _grow(bg | bw, 2)
    off = np.abs(got - want).max(-1) > NORMALS_ATOL
    assert not (off & ~rim).any(), (what, np.abs(got - want)[~rim].max())
    if border_share is not None:
        share = ((off | (bg != bw)) & rim).mean()
        assert share <= border_share, (what, share)


def check_labels(got, want, share, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert (got != want).mean() <= share, (what, (got != want).mean())


def test_dataset_samples_close_to_cv2_path(trees):
    """Raw samples (no transform) of both fixture trees, every split:
    images, label maps and NYUD's arrays equal; PASCAL's half-size maps of
    image 2, resized to the image, equal where nearest (labels, edges) and
    within 1e-3 where cubic (normals; cv2 resizes the float64 maps in
    float64, the port in float32); meta equal."""
    for db, (root, info) in trees.items():
        if db == "PASCALContext":
            flags = dict(do_edge=True, do_human_parts=True, do_semseg=True,
                         do_normals=True, do_sal=True)
            port_cls, ref_cls = PASCALContext, JPASCAL
        else:
            flags = dict(do_edge=True, do_semseg=True, do_normals=True,
                         do_depth=True)
            port_cls, ref_cls = NYUD_MT, JNYUD
        for split in ("train", "val"):
            port, ref = port_cls(root, split, **flags), ref_cls(root, split,
                                                               **flags)
            assert port.im_ids == ref.im_ids and len(port) == len(ref)
            for i in range(len(ref)):
                got, want = port[i], ref[i]
                assert set(got) == set(want)
                assert got["meta"] == want["meta"]
                for k, v in want.items():
                    if k == "meta":
                        continue
                    if k == "normals":
                        np.testing.assert_allclose(got[k], v, rtol=0,
                                                   atol=NORMALS_ATOL)
                    else:
                        np.testing.assert_array_equal(got[k], v,
                                                      err_msg=f"{db} {k}")


@pytest.mark.parametrize("db", ["PASCALContext", "NYUD"])
def test_build_loader_close_to_cv2_path(db, trees):
    """``build_loader`` on a fixture tree at 64 px against the JAX
    ``build_loader`` from the flagship YAML: the same lengths, splits and
    batch shapes; every train batch of epoch 0 (flip, scale and rotate,
    resize) with the image within the image bound, the nearest-warped
    labels and depth (float32 here, float64 there: 1e-6 relative) within
    the noise-label share, normals unit vectors or the 255 band on both
    sides; every padded val batch with the image bound, labels and depth
    equal, normals within 1e-3, ``_valid`` equal."""
    root, _ = trees[db]
    tasks = PASCAL if db == "PASCALContext" else NYUD
    cfg = load_config(CFG, tasks=tasks, db_name=db, img_size=64,
                      **{"DATA.DATA_PATH": root, "DATA.BATCH_SIZE": 2,
                         "DATA.NUM_WORKERS": 1})
    ref = jloader.build_loader(cfg)
    port = build_loader(data_node(db, root, tasks, 64, 2, int(cfg.SEED),
                                  num_workers=0), device="cpu")
    assert port[4] is None and not port[2]._loader.pin_memory
    for p, r in zip(port[:4], ref[:4]):
        assert len(p) == len(r)
    for split, pl, rl in (("train", port[2], ref[2]),
                          ("val", port[3], ref[3])):
        share = NOISE_LABEL_SHARE if split == "train" else 0.0
        got, want = list(pl.iter_epoch(0)), list(rl.iter_epoch(0))
        assert len(got) == len(want) > 0
        for b, (g, w) in enumerate(zip(got, want)):
            what = f"{db} {split} batch {b}"
            assert set(g) == set(w) and g["meta"] == w["meta"], what
            check_image(g["image"], w["image"], what)
            for t in tasks:
                assert g[t].shape == w[t].shape, (what, t)
                gt, wt = g[t].numpy(), w[t]
                if t == "normals" and split == "val":
                    check_normals(gt, wt, what)
                elif t == "normals":
                    band = (gt == 255).all(-1)
                    norm = np.linalg.norm(gt, axis=-1)
                    assert np.allclose(norm[~band], 1.0, atol=1e-5), what
                elif t == "depth":
                    close = np.isclose(gt, wt, rtol=1e-6, atol=0)
                    assert (~close).mean() <= share, (what, t)
                else:
                    check_labels(gt, wt, share, f"{what} {t}")
            if split == "val":
                np.testing.assert_array_equal(g["_valid"].numpy(),
                                              w["_valid"])


def test_eval_batch_at_448_close_to_cv2_path(trees):
    """The PASCAL val split at the flagship's 448 px through the eval
    pipeline, one padded batch of 4 (2 samples): labels equal, normals
    within 1e-3 with the 255 band equal, the image within its bound."""
    root, _ = trees["PASCALContext"]
    cfg = load_config(CFG, tasks=PASCAL, db_name="PASCALContext",
                      img_size=448, **{"DATA.DATA_PATH": root,
                                       "DATA.BATCH_SIZE": 4,
                                       "DATA.NUM_WORKERS": 1})
    (w,) = list(jloader.build_loader(cfg)[3].iter_epoch(0))
    (g,) = list(build_loader(data_node("PASCALContext", root, PASCAL, 448,
                                       4, 0, num_workers=0),
                             device="cpu")[3].iter_epoch(0))
    assert g["image"].shape == (4, 448, 448, 3)
    assert g["_valid"].tolist() == w["_valid"].tolist() == [1, 1, 0, 0]
    check_image(g["image"], w["image"], "image")
    check_normals(g["normals"], w["normals"], "normals")
    for t in ("semseg", "sal", "human_parts", "edge"):
        np.testing.assert_array_equal(g[t].numpy(), w[t], err_msg=t)


def test_train_pipeline_on_smooth_samples_close_to_cv2_path():
    """The PASCAL train pipeline at 448 on the structured synthetic set
    (smooth images, labels and normals, as real ones are), the same raw
    samples and (seed, epoch, index) streams on both sides: over 6
    samples, nearest-warped labels differ on at most 1e-4 of the pixels,
    normals within 1e-3 (the 255 band of the warp border counted apart: at
    most 1e-4 of the pixels differ there), the image within its bound."""
    cfg, _ = task_config.get_tasks_config("PASCALContext", PASCAL, 448)
    port = transforms.get_transformations("PASCALContext", cfg)[0]
    ref = jtransforms.get_transformations("PASCALContext", cfg)[0]
    ds = SyntheticMTL(PASCAL, 448, structured=True, seed=3)
    got, want = [], []
    for i in range(6):
        sample = ds[i]
        g, w = both(lambda s: transforms.apply_transform(port, s, 0, 1, i),
                    lambda s: jtransforms.apply_transform(ref, s, 0, 1, i),
                    sample)
        got.append(g)
        want.append(w)
    g, w = collate(got), jloader.collate(want)
    check_image(g["image"], w["image"], "image")
    check_normals(g["normals"], w["normals"], "normals", border_share=1e-4)
    for t in ("semseg", "sal", "human_parts", "edge"):
        check_labels(g[t], w[t], LABEL_SHARE, t)


# ---------------------------------------------------------------------------
# Worker processes
# ---------------------------------------------------------------------------

def test_batches_do_not_depend_on_workers():
    """The padded train-transform loader over the synthetic set gives the
    same batches with 0 workers, 2 workers started for each epoch and 2
    persistent workers, in epochs 0 and 1 (the epoch reaches persistent
    workers with each chunk), and epoch 1 differs from epoch 0."""
    cfg, _ = task_config.get_tasks_config("PASCALContext", PASCAL, 24)
    ds = SyntheticMTL(PASCAL, 24, length=9, seed=4,
                      transform=transforms.get_transformations(
                          "PASCALContext", cfg)[0])
    kw = dict(shuffle=True, drop_last=False, pad_last=True,
              pad_fill=ignore_fill_sample, seed=6)
    runs = []
    for workers, persistent in ((0, False), (2, False), (2, True)):
        loader = DataLoader(ds, 4, num_workers=workers,
                            persistent_workers=persistent, **kw)
        runs.append([list(loader.iter_epoch(e)) for e in (0, 1)])
        del loader
    base = runs[0]
    assert len(base[0]) == 3 and base[0][-1]["_valid"].tolist() == [1, 0, 0,
                                                                     0]
    for run in runs[1:]:
        for e in (0, 1):
            assert len(run[e]) == len(base[e])
            for g, w in zip(run[e], base[e]):
                assert g["meta"] == w["meta"]
                for k in w:
                    if k != "meta":
                        assert torch.equal(g[k], w[k]), (e, k)
    assert not torch.equal(base[0][0]["image"], base[1][0]["image"])
