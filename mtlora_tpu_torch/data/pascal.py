"""PASCAL-Context multi-task dataset (PASCAL_MT layout).

Counterpart of ``mtlora_tpu/data/pascal.py:85-257`` (reference
``data/mtl_ds.py:245-648``): the same on-disk layout (JPEGImages/,
pascal-context/trainval/*.mat, human_parts/*.mat, normals_distill/*.png,
sal_distill/*.png, semseg/{VOC12,pascal-context}/*.png,
ImageSets/{Context,Parts}) and label semantics:
  - edge: thinned |Laplacian| of the context label map (the Laplacian in
    numpy: cv2's 3x3 kernel with its default border, reflect-101)
  - human parts: 6-part merge of the part annotations (only the
    person-category table is used; the reference loads pascal_part.json
    but overwrites entry "15" with its built-in table, mtl_ds.py:333-335)
  - normals: distilled normals masked to NYU-compatible context classes
  - saliency: distilled, binarized at 0.5
Label maps smaller than the image are resized to it by the port's image
ops. Images are decoded with PIL, imported only where a file is read: the
package imports, and the synthetic set runs, without it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from mtlora_tpu_torch.data import native
from mtlora_tpu_torch.data.thin import thin
from mtlora_tpu_torch.data.transforms import apply_transform

# Merge table for 6 human parts (+bg); reference HUMAN_PART[6]
# (mtl_ds.py:252-270). part-name -> merged label id.
HUMAN_PART_6 = {
    "hair": 1, "head": 1, "lear": 1, "lebrow": 1, "leye": 1, "mouth": 1,
    "nose": 1, "rear": 1, "rebrow": 1, "reye": 1,
    "neck": 2, "torso": 2,
    "luarm": 3, "ruarm": 3,
    "lhand": 4, "llarm": 4, "rhand": 4, "rlarm": 4,
    "luleg": 5, "ruleg": 5,
    "lfoot": 6, "llleg": 6, "rfoot": 6, "rlleg": 6,
}

# Context label ids whose distilled normals are valid: NYU classes that
# exist in PASCAL-Context (+ tvmonitor). Precomputed from the db_info
# jsons the reference ships (see module docstring).
NORMALS_VALID_CLASSES = [
    3, 4, 6, 9, 10, 11, 13, 15, 17, 18, 22, 23, 29, 30, 33, 34, 36, 37,
    38, 39, 41, 43, 46, 49, 50, 51, 53, 55, 56, 59, 61, 62, 65, 66, 68,
    69, 72, 73, 78, 83, 84, 85, 87, 88, 95, 96, 101, 104, 105, 107, 111,
    113, 115, 122, 124, 135, 141, 142, 143, 146, 150, 154, 157, 158, 159,
    165, 172, 174, 181, 183, 184, 191, 193, 195, 197, 199, 202, 213, 215,
    216, 219, 220, 223, 225, 228, 230, 232, 233, 238, 239, 242, 243, 246,
    250, 251, 252, 255, 260, 261, 263, 269, 272, 273, 275, 281, 283, 284,
    285, 286, 287, 288, 290, 291, 292, 293, 295, 304, 307, 309, 310, 314,
    315, 319, 323, 329, 330, 331, 336, 342, 345, 349, 350, 351, 352, 355,
    357, 368, 370, 371, 374, 379, 380, 383, 384, 397, 401, 403, 405, 407,
    408, 411, 412, 413, 414, 417, 419, 421, 423, 429, 430, 432, 440, 441,
    442, 443, 444, 446, 454, 457, 427,
]

VOC_CATEGORY_NAMES = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
    "tvmonitor"]

HUMAN_PARTS_CATEGORY = 15  # person



def read_image(path: str, rgb: bool = False) -> np.ndarray:
    """The image file at ``path`` as a float64 array (RGB with ``rgb``),
    decoded by PIL; raises if PIL is missing."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading the dataset's JPEG and PNG files needs "
                          "PIL (the Pillow package), which is not "
                          "installed") from e
    with Image.open(path) as im:
        return np.array(im.convert("RGB") if rgb else im).astype(float)


def laplacian(labels: np.ndarray) -> np.ndarray:
    """``cv2.Laplacian(labels, cv2.CV_64F)``: the 3x3 kernel
    [[0, 1, 0], [1, -4, 1], [0, 1, 0]] in float64 with cv2's default
    border, BORDER_REFLECT_101 (``np.pad`` mode "reflect")."""
    p = np.pad(np.asarray(labels, np.float64), 1, mode="reflect")
    return (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
            - 4.0 * p[1:-1, 1:-1])


class PASCALContext:
    def __init__(self, root: str, split="val", transform=None,
                 area_thres: int = 0, retname: bool = True,
                 overfit: bool = False, do_edge: bool = False,
                 do_human_parts: bool = False, do_semseg: bool = False,
                 do_normals: bool = False, do_sal: bool = False):
        self.root = root
        self.transform = transform
        self._epoch = None
        self._aug_seed = 0
        self.split = [split] if isinstance(split, str) else sorted(split)
        self.area_thres = area_thres
        self.retname = retname
        self.do_edge = do_edge
        self.do_human_parts = do_human_parts
        self.do_semseg = do_semseg
        self.do_normals = do_normals
        self.do_sal = do_sal

        image_dir = os.path.join(root, "JPEGImages")
        self.edge_gt_dir = os.path.join(root, "pascal-context", "trainval")
        part_gt_dir = os.path.join(root, "human_parts")
        normal_dir = os.path.join(root, "normals_distill")
        sal_dir = os.path.join(root, "sal_distill")
        splits_dir = os.path.join(root, "ImageSets", "Context")
        self.parts_file = os.path.join(root, "ImageSets", "Parts",
                                       "".join(self.split) + ".txt")

        self.im_ids: List[str] = []
        self.images: List[str] = []
        self.edges: List[str] = []
        self.semsegs: List[str] = []
        self.parts: List[str] = []
        self.normals: List[str] = []
        self.sals: List[str] = []
        for splt in self.split:
            with open(os.path.join(splits_dir, splt + ".txt")) as f:
                lines = f.read().splitlines()
            for line in lines:
                self.im_ids.append(line.rstrip("\n"))
                self.images.append(os.path.join(image_dir, line + ".jpg"))
                self.edges.append(
                    os.path.join(self.edge_gt_dir, line + ".mat"))
                self.semsegs.append(self._semseg_fname(line))
                self.parts.append(os.path.join(part_gt_dir, line + ".mat"))
                self.normals.append(os.path.join(normal_dir, line + ".png"))
                self.sals.append(os.path.join(sal_dir, line + ".png"))

        if not self._load_parts_index():
            self._build_parts_index()
        if self.do_human_parts:
            self.has_human_parts = [
                1 if HUMAN_PARTS_CATEGORY in self.part_obj_dict[i] else 0
                for i in self.im_ids]
            only_parts = not (do_edge or do_semseg or do_sal or do_normals)
            if only_parts:
                keep = [i for i, h in enumerate(self.has_human_parts) if h]
                for attr in ("im_ids", "images", "parts",
                             "has_human_parts"):
                    setattr(self, attr,
                            [getattr(self, attr)[i] for i in keep])

        if overfit:
            n = 64
            for attr in ("im_ids", "images", "edges", "semsegs", "parts",
                         "normals", "sals"):
                setattr(self, attr, getattr(self, attr)[:n])

    # -- index ------------------------------------------------------------
    def _semseg_fname(self, name: str) -> str:
        for sub in ("VOC12", "pascal-context"):
            f = os.path.join(self.root, "semseg", sub, name + ".png")
            if os.path.isfile(f):
                return f
        return os.path.join(self.root, "semseg", "VOC12", name + ".png")

    def _load_parts_index(self) -> bool:
        if not os.path.isfile(self.parts_file):
            return False
        with open(self.parts_file) as f:
            self.part_obj_dict = json.load(f)
        return (sorted(map(str, self.part_obj_dict)) ==
                sorted(self.im_ids))

    def _build_parts_index(self):
        """One-time scan of the part .mat files recording object
        categories per image (reference _preprocess_parts:604-645)."""
        import scipy.io as sio

        self.part_obj_dict = {}
        for im_id in self.im_ids:
            mat = sio.loadmat(
                os.path.join(self.root, "human_parts", f"{im_id}.mat"))
            objs = mat["anno"][0][0][1][0]
            cats = []
            for obj in objs:
                area = np.sum(obj[2])
                cats.append(int(obj[1][0][0]) if area > self.area_thres
                            else -1)
            self.part_obj_dict[im_id] = cats
        os.makedirs(os.path.dirname(self.parts_file), exist_ok=True)
        with open(self.parts_file, "w") as f:
            json.dump(self.part_obj_dict, f, indent=1)

    # -- loading ----------------------------------------------------------
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
            sample["edge"] = fit(self._load_edge(index), native.NEAREST)
        if self.do_human_parts:
            sample["human_parts"] = fit(self._load_human_parts(index),
                                        native.NEAREST)
        if self.do_semseg:
            sample["semseg"] = fit(read_image(self.semsegs[index]),
                                   native.NEAREST)
        if self.do_normals:
            sample["normals"] = fit(self._load_normals(index),
                                    native.CUBIC)
        if self.do_sal:
            sal = read_image(self.sals[index]) / 255
            sample["sal"] = fit((sal > 0.5).astype(float), native.NEAREST)
        if self.retname:
            sample["meta"] = {"image": self.im_ids[index], "im_size": hw}
        return apply_transform(self.transform, sample, self._epoch,
                               self._aug_seed, index)

    def _load_edge(self, index):
        import scipy.io as sio

        labels = sio.loadmat(self.edges[index])["LabelMap"]
        return thin(np.abs(laplacian(labels)) > 0).astype(float)

    def _load_human_parts(self, index):
        if not self.has_human_parts[index]:
            return np.zeros((512, 512), dtype=float)
        import scipy.io as sio

        objs = sio.loadmat(self.parts[index])["anno"][0][0][1][0]
        target = None
        for obj in objs:
            is_human = obj[1][0][0] == HUMAN_PARTS_CATEGORY
            has_parts = len(obj[3]) != 0
            if is_human and has_parts:
                if target is None:
                    target = np.zeros(obj[2].shape, dtype=float)
                for part in obj[3][0]:
                    name = str(part[0][0])
                    target[part[1].astype(bool)] = HUMAN_PART_6[name]
        return target if target is not None else np.zeros((512, 512),
                                                          dtype=float)

    def _load_normals(self, index):
        import scipy.io as sio

        raw = read_image(self.normals[index])
        raw = 2.0 * raw / 255.0 - 1.0
        labels = sio.loadmat(os.path.join(
            self.edge_gt_dir, self.im_ids[index] + ".mat"))["LabelMap"]
        out = np.zeros(raw.shape, dtype=float)
        valid = np.isin(labels, NORMALS_VALID_CLASSES)
        out[valid, :] = raw[valid, :]
        return out
