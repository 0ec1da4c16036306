"""Per-task dataset configuration.

Counterpart of ``mtlora_tpu/data/task_config.py:20-85`` (reference
``data/mtl_ds.py:731-825``, ``get_tasks_config``): number of output
channels, interpolation flags for augmentation (FLAGVALS) and for resizing
predictions at inference (INFER_FLAGVALS), and train/test scales, per
task. The flags are the port's own constants with cv2's ``INTER_*``
values, so the dicts equal the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from mtlora_tpu_torch.data.native import CUBIC, LINEAR, NEAREST

# Tasks supported per database (reference mtl_ds.py asserts)
PASCAL_TASKS = ("semseg", "human_parts", "sal", "normals", "edge")
NYUD_TASKS = ("semseg", "normals", "edge", "depth")

# Fixed multi-task loss weights (reference main.py:192-199; not
# configurable there); ``train/losses.py`` takes them from here.
LOSS_WEIGHTS = {
    "depth": 1.0,
    "semseg": 1.0,
    "human_parts": 2.0,
    "sal": 5.0,
    "edge": 50.0,
    "normals": 10.0,
}


def get_tasks_config(db_name: str, task_list: List[str], img_size
                     ) -> Tuple[Dict, Dict]:
    """Return (task_cfg, other_args) describing each requested task.

    task_cfg keys: NAMES, NUM_OUTPUT, FLAGVALS, INFER_FLAGVALS, ALL_TASKS,
    TRAIN, TEST, as the reference's edict has them."""
    cfg: Dict = {
        "NAMES": [],
        "NUM_OUTPUT": {},
        "FLAGVALS": {"image": CUBIC},
        "INFER_FLAGVALS": {},
    }
    other: Dict = {}

    def add(task, num_output, flagval, infer_flagval):
        cfg["NAMES"].append(task)
        cfg["NUM_OUTPUT"][task] = num_output
        cfg["FLAGVALS"][task] = flagval
        cfg["INFER_FLAGVALS"][task] = infer_flagval

    def need(ok, task):
        if not ok:
            raise ValueError(f"task {task!r} is not a task of {db_name!r}")

    if "semseg" in task_list:
        if db_name == "PASCALContext":
            n_cls = 21
        elif db_name == "NYUD":
            n_cls = 40
        else:
            raise NotImplementedError(db_name)
        add("semseg", n_cls, NEAREST, NEAREST)

    if "human_parts" in task_list:
        need(db_name == "PASCALContext", "human_parts")
        add("human_parts", 7, NEAREST, NEAREST)

    if "sal" in task_list:
        need(db_name == "PASCALContext", "sal")
        add("sal", 1, NEAREST, LINEAR)

    if "normals" in task_list:
        need(db_name in ("PASCALContext", "NYUD"), "normals")
        add("normals", 3, CUBIC, LINEAR)
        other["normloss"] = 1  # L1 loss on normals

    if "edge" in task_list:
        need(db_name in ("PASCALContext", "NYUD"), "edge")
        add("edge", 1, NEAREST, LINEAR)
        other["edge_w"] = 0.95
        other["eval_edge"] = False

    if "depth" in task_list:
        need(db_name == "NYUD", "depth")
        add("depth", 1, NEAREST, LINEAR)
        other["depthloss"] = "l1"

    cfg["ALL_TASKS"] = {
        "NAMES": list(cfg["NAMES"]),
        "NUM_OUTPUT": dict(cfg["NUM_OUTPUT"]),
        "FLAGVALS": {"image": CUBIC,
                     **{k: cfg["FLAGVALS"][k] for k in cfg["NAMES"]}},
        "INFER_FLAGVALS": dict(cfg["INFER_FLAGVALS"]),
    }
    if isinstance(img_size, (tuple, list)):
        scale = tuple(img_size)
    else:
        scale = (img_size, img_size)
    cfg["TRAIN"] = {"SCALE": scale}
    cfg["TEST"] = {"SCALE": scale}
    return cfg, other
