"""Configuration of the port: the config tree read from the YAML files,
and the model settings drawn from it.

Counterpart of ``mtlora_tpu/config.py`` plus ``MTLoRASpec.from_config``
(``mtlora_tpu/models/lora.py:49-128``):

  - :class:`ConfigNode`, :func:`default_config`, :func:`update_config`,
    :func:`get_config` and :func:`load_config`: the same schema, ``BASE``
    chains, ``--opts`` coercion and MTLoRA rank/scale normalization, read
    by the port's own YAML subset (``utils/yaml_subset.py``), since the
    machine that runs the port has no ``yaml``;
  - :func:`from_config`: the :class:`ModelConfig` of a loaded node (the
    port's or any with the reference schema's attributes), and
    :func:`tiny_448_r64_pertask`, the flagship written out as a literal.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from mtlora_tpu_torch.utils import yaml_subset


class ConfigNode(dict):
    """A dict with attribute access, freezing, and recursive merge
    (``mtlora_tpu/config.py:20-131``, the subset of ``yacs.CfgNode`` the
    reference relies on)."""

    IMMUTABLE = "__immutable__"
    NEW_ALLOWED = "__new_allowed__"

    def __init__(self, init: Optional[Dict] = None, new_allowed: bool = True):
        super().__init__()
        object.__setattr__(self, ConfigNode.IMMUTABLE, False)
        object.__setattr__(self, ConfigNode.NEW_ALLOWED, new_allowed)
        if init:
            for k, v in init.items():
                self[k] = self._convert(v)

    @classmethod
    def _convert(cls, v):
        if isinstance(v, ConfigNode):
            return v
        if isinstance(v, dict):
            return cls(v, new_allowed=True)
        return v

    def __getattr__(self, name):
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no attribute '{name}'")

    def __setattr__(self, name, value):
        self[name] = value

    def __setitem__(self, name, value):
        if object.__getattribute__(self, ConfigNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set '{name}' on a frozen config")
        super().__setitem__(name, self._convert(value))

    def freeze(self):
        self._set_immutable(True)

    def defrost(self):
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, ConfigNode.IMMUTABLE)

    def _set_immutable(self, value: bool):
        object.__setattr__(self, ConfigNode.IMMUTABLE, value)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v._set_immutable(value)

    def set_new_allowed(self, value: bool):
        object.__setattr__(self, ConfigNode.NEW_ALLOWED, value)

    def merge_from_dict(self, other: Dict):
        for k, v in other.items():
            if (k in self and isinstance(self[k], ConfigNode)
                    and isinstance(v, dict)):
                self[k].merge_from_dict(v)
            else:
                allowed = (k in self or object.__getattribute__(
                    self, ConfigNode.NEW_ALLOWED))
                if not allowed:
                    raise KeyError(f"Unknown config key during merge: {k}")
                super().__setitem__(k, self._convert(v))

    def merge_from_file(self, cfg_file: str):
        loaded = yaml_subset.load(cfg_file) or {}
        loaded.pop("BASE", None)
        self.merge_from_dict(loaded)

    def merge_from_list(self, opts: List[str]):
        assert len(opts) % 2 == 0, "--opts must come in KEY VALUE pairs"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            old = node.get(parts[-1], None)
            node[parts[-1]] = _coerce(value, old)

    def clone(self) -> "ConfigNode":
        node = copy.deepcopy(self)
        node._set_immutable(False)
        return node

    def to_dict(self) -> Dict:
        return {k: v.to_dict() if isinstance(v, ConfigNode) else v
                for k, v in self.items()}

    def dump(self) -> str:
        """YAML text with sorted keys, as ``yaml.safe_dump`` writes it in
        the JAX package; :func:`yaml_subset.loads` reads it back equal to
        :meth:`to_dict` (tuples as lists)."""
        return yaml_subset.dumps(self.to_dict(), sort_keys=True)

    def __deepcopy__(self, memo):
        node = ConfigNode(new_allowed=True)
        for k, v in self.items():
            dict.__setitem__(node, k, copy.deepcopy(v, memo))
        object.__setattr__(node, ConfigNode.NEW_ALLOWED,
                           object.__getattribute__(self,
                                                   ConfigNode.NEW_ALLOWED))
        return node

    def __repr__(self):
        return self.dump()


def _coerce(value: str, old: Any):
    """A CLI string override coerced to the type of the value it replaces
    (``mtlora_tpu/config.py:134-150``); a list, dict or None old value
    takes the YAML reading of the string."""
    if isinstance(old, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(old, int) and not isinstance(old, bool):
        try:
            return int(value)
        except ValueError:
            return float(value)
    if isinstance(old, float):
        return float(value)
    if isinstance(old, (list, tuple, dict)) or old is None:
        try:
            return yaml_subset.loads(value)
        except Exception:
            return value
    return value


def default_config() -> ConfigNode:
    """The default tree (``mtlora_tpu/config.py:157-335``, schema parity
    with the reference's ``config.py:24-326``)."""
    C = ConfigNode(new_allowed=True)
    C.BASE = [""]

    C.DATA = ConfigNode(new_allowed=True)
    C.DATA.BATCH_SIZE = 128
    C.DATA.DATA_PATH = ""
    C.DATA.DATASET = "nyud"
    C.DATA.IMG_SIZE = 224
    C.DATA.INTERPOLATION = "bicubic"
    C.DATA.ZIP_MODE = False
    C.DATA.CACHE_MODE = "part"
    C.DATA.PIN_MEMORY = True
    C.DATA.NUM_WORKERS = 4
    C.DATA.MASK_PATCH_SIZE = 32
    C.DATA.MASK_RATIO = 0.6

    C.MODEL = ConfigNode(new_allowed=True)
    C.MODEL.TYPE = "swin"
    C.MODEL.NAME = "swin_tiny_patch4_window7_224"
    C.MODEL.PRETRAINED = ""
    C.MODEL.RESUME = ""
    C.MODEL.NUM_CLASSES = 1000
    C.MODEL.DROP_RATE = 0.0
    C.MODEL.DROP_PATH_RATE = 0.1
    C.MODEL.LABEL_SMOOTHING = 0.1

    C.MODEL.SWIN = ConfigNode(new_allowed=True)
    C.MODEL.SWIN.PATCH_SIZE = 4
    C.MODEL.SWIN.IN_CHANS = 3
    C.MODEL.SWIN.EMBED_DIM = 96
    C.MODEL.SWIN.DEPTHS = [2, 2, 6, 2]
    C.MODEL.SWIN.NUM_HEADS = [3, 6, 12, 24]
    C.MODEL.SWIN.WINDOW_SIZE = 7
    C.MODEL.SWIN.MLP_RATIO = 4.0
    C.MODEL.SWIN.QKV_BIAS = True
    C.MODEL.SWIN.QK_SCALE = None
    C.MODEL.SWIN.APE = False
    C.MODEL.SWIN.PATCH_NORM = True
    C.MODEL.SWIN.DECODER_DIM = 256
    C.MODEL.SWIN.DECODER_PATCH_RES = [7, 7, 14, 28]

    C.MODEL.DECODER_HEAD = ConfigNode(new_allowed=True)
    for task in ("semseg", "normals", "sal", "human_parts", "edge", "depth"):
        C.MODEL.DECODER_HEAD[task] = "hrnet"
    C.MODEL.DECODER_CHANNELS = [18, 36, 72, 144]
    C.MODEL.SEGFORMER_CHANNELS = 256
    C.MODEL.DECODER_DOWNSAMPLER = True
    C.MODEL.PER_TASK_DOWNSAMPLER = True
    C.MODEL.UPDATE_RELATIVE_POSITION = False

    C.MODEL.MTLORA = ConfigNode(new_allowed=True)
    C.MODEL.MTLORA.ENABLED = False
    C.MODEL.MTLORA.BIAS = "none"
    C.MODEL.MTLORA.R = [8, 8, 8, 8]
    C.MODEL.MTLORA.SHARED_SCALE = [2.0, 2.0, 2.0, 2.0]
    C.MODEL.MTLORA.TASK_SCALE = [2.0, 2.0, 2.0, 2.0]
    C.MODEL.MTLORA.DROPOUT = [0.05, 0.05, 0.05, 0.05]
    C.MODEL.MTLORA.TRAINABLE_SCALE_SHARED = False
    C.MODEL.MTLORA.TRAINABLE_SCALE_PER_TASK = False
    C.MODEL.MTLORA.INTERMEDIATE_SPECIALIZATION = False
    C.MODEL.MTLORA.FREEZE_PRETRAINED = True
    C.MODEL.MTLORA.SPLIT_QKV = False
    C.MODEL.MTLORA.R_PER_TASK = ConfigNode(new_allowed=True)
    C.MODEL.MTLORA.SCALE_PER_TASK = ConfigNode(new_allowed=True)
    C.MODEL.MTLORA.SHARED_MODE = "matrix"
    C.MODEL.MTLORA.QKV_ENABLED = True
    C.MODEL.MTLORA.PROJ_ENABLED = True
    C.MODEL.MTLORA.FC1_ENABLED = True
    C.MODEL.MTLORA.FC2_ENABLED = True
    C.MODEL.MTLORA.DOWNSAMPLER_ENABLED = False

    C.TRAIN = ConfigNode(new_allowed=True)
    C.TRAIN.START_EPOCH = 0
    C.TRAIN.EPOCHS = 300
    C.TRAIN.WARMUP_EPOCHS = 20
    C.TRAIN.WEIGHT_DECAY = 0.05
    C.TRAIN.BASE_LR = 5e-4
    C.TRAIN.WARMUP_LR = 5e-7
    C.TRAIN.MIN_LR = 5e-6
    C.TRAIN.CLIP_GRAD = 5.0
    C.TRAIN.AUTO_RESUME = False
    C.TRAIN.ACCUMULATION_STEPS = 1
    C.TRAIN.USE_CHECKPOINT = False
    C.TRAIN.SKIP_DECODER_CKPT = False

    C.TRAIN.LR_SCHEDULER = ConfigNode(new_allowed=True)
    C.TRAIN.LR_SCHEDULER.NAME = "cosine"
    C.TRAIN.LR_SCHEDULER.DECAY_EPOCHS = 30
    C.TRAIN.LR_SCHEDULER.DECAY_RATE = 0.1
    C.TRAIN.LR_SCHEDULER.WARMUP_PREFIX = True
    C.TRAIN.LR_SCHEDULER.GAMMA = 0.1
    C.TRAIN.LR_SCHEDULER.MULTISTEPS = []

    C.TRAIN.FREEZE_PATCH_EMBED = False
    C.TRAIN.FREEZE_LAYER_NORM = False
    C.TRAIN.FREEZE_RELATIVE_POSITION_BIAS = False
    C.TRAIN.FREEZE_DOWNSAMPLE_REDUCTION = False

    C.TRAIN.OPTIMIZER = ConfigNode(new_allowed=True)
    C.TRAIN.OPTIMIZER.NAME = "adamw"
    C.TRAIN.OPTIMIZER.EPS = 1e-8
    C.TRAIN.OPTIMIZER.BETAS = (0.9, 0.999)
    C.TRAIN.OPTIMIZER.MOMENTUM = 0.9
    C.TRAIN.LAYER_DECAY = 1.0

    C.AUG = ConfigNode(new_allowed=True)
    C.AUG.COLOR_JITTER = 0.4
    C.AUG.AUTO_AUGMENT = "rand-m9-mstd0.5-inc1"
    C.AUG.REPROB = 0.25
    C.AUG.REMODE = "pixel"
    C.AUG.RECOUNT = 1
    C.AUG.MIXUP = 0.8
    C.AUG.CUTMIX = 1.0
    C.AUG.CUTMIX_MINMAX = None
    C.AUG.MIXUP_PROB = 1.0
    C.AUG.MIXUP_SWITCH_PROB = 0.5
    C.AUG.MIXUP_MODE = "batch"

    C.TEST = ConfigNode(new_allowed=True)
    C.TEST.CROP = True
    C.TEST.SEQUENTIAL = False
    C.TEST.SHUFFLE = False

    C.ENABLE_AMP = False
    C.AMP_ENABLE = True     # bf16 compute
    C.AMP_OPT_LEVEL = ""
    C.OUTPUT = ""
    C.TAG = "default"
    C.SAVE_FREQ = 1
    C.PRINT_FREQ = 10
    C.SEED = 0
    C.EVAL_MODE = False
    C.THROUGHPUT_MODE = False
    C.LOCAL_RANK = 0
    C.FUSED_WINDOW_PROCESS = False
    C.FUSED_LAYERNORM = False
    C.SKIP_INITIAL_EVAL = False
    # the reference's per-batch val-loss wandb series (one host read a
    # batch), off by default
    C.WANDB_STEP_VAL = False

    # the JAX package's kernel switches, read by :func:`from_config`
    C.TPU = ConfigNode(new_allowed=True)
    C.TPU.MESH_SHAPE = [-1]
    C.TPU.USE_PALLAS = True
    C.TPU.USE_PALLAS_LORA_GEMM = False
    C.TPU.USE_PALLAS_ADAPTER = True
    C.TPU.USE_PALLAS_LN = True
    C.TPU.COMPUTE_DTYPE = "bfloat16"
    C.TPU.EVAL_DTYPE = "float32"
    C.TPU.REMAT = False
    return C


def _update_config_from_file(config: ConfigNode, cfg_file: str):
    """Merge a YAML file after its ``BASE`` list, depth-first
    (``mtlora_tpu/config.py:342-350``)."""
    yaml_cfg = yaml_subset.load(cfg_file) or {}
    for base in yaml_cfg.get("BASE", [""]):
        if base:
            _update_config_from_file(
                config, os.path.join(os.path.dirname(cfg_file), base))
    config.merge_from_file(cfg_file)


def _broadcast_per_stage(value, n_stages: int, what: str) -> list:
    if not isinstance(value, (list, tuple)):
        return [value] * n_stages
    value = list(value)
    if len(value) == 1:
        return value * n_stages
    assert len(value) == n_stages, (
        f"MTLoRA {what} length should be the same as the number of layers")
    return value


def normalize_mtlora(config: ConfigNode):
    """The MTLoRA rank, scale and dropout options as one value per stage,
    and ``R_PER_TASK_LIST`` / ``SCALE_PER_TASK_LIST``: one
    ``{task_or_shared: value}`` dict per Swin stage
    (``mtlora_tpu/config.py:365-409``, reference ``config.py:477-557``)."""
    m = config.MODEL.MTLORA
    if not m.ENABLED:
        return
    n = len(config.MODEL.SWIN.DEPTHS)
    m.R = _broadcast_per_stage(m.R, n, "ranks")
    m.SHARED_SCALE = _broadcast_per_stage(m.SHARED_SCALE, n, "shared scale")
    m.TASK_SCALE = _broadcast_per_stage(m.TASK_SCALE, n, "task scale")
    m.DROPOUT = _broadcast_per_stage(m.DROPOUT, n, "dropout")
    tasks = list(config.TASKS)
    if len(m.R_PER_TASK) == 0:
        for task in tasks + ["shared"]:
            m.R_PER_TASK[task] = list(m.R)
    else:
        for task in tasks + ["shared"]:
            m.R_PER_TASK[task] = _broadcast_per_stage(
                m.R_PER_TASK[task], n, "ranks")
    if len(m.SCALE_PER_TASK) == 0:
        for task in tasks:
            m.SCALE_PER_TASK[task] = list(m.SHARED_SCALE)
    else:
        for task in tasks:
            m.SCALE_PER_TASK[task] = _broadcast_per_stage(
                m.SCALE_PER_TASK[task], n, "task scale")
    r_list, s_list = [], []
    for i in range(n):
        layer_r = {"shared": (m.R[i] if "shared" not in m.R_PER_TASK
                              else m.R_PER_TASK["shared"][i])}
        layer_s = {}
        for task in tasks:
            layer_r[task] = m.R_PER_TASK[task][i]
            layer_s[task] = m.SCALE_PER_TASK[task][i]
        r_list.append(layer_r)
        s_list.append(layer_s)
    m.R_PER_TASK_LIST = r_list
    m.SCALE_PER_TASK_LIST = s_list


def _set_tasks(config: ConfigNode, tasks, db_name: str):
    from mtlora_tpu_torch.data.task_config import get_tasks_config

    config.TASKS = list(tasks)
    config.MTL = True
    tsk_config, _ = get_tasks_config(db_name, config.TASKS,
                                     config.DATA.IMG_SIZE)
    config.TASKS_CONFIG = ConfigNode(tsk_config, new_allowed=True)
    config.MODEL.NUM_CLASSES = 0


def update_config(config: ConfigNode, args):
    """The YAML file, then ``--opts``, then the CLI flags
    (``mtlora_tpu/config.py:412-506``); the output directory becomes
    ``OUTPUT/<MODEL.NAME>/<TAG>``."""
    _update_config_from_file(config, args.cfg)
    if getattr(args, "opts", None):
        config.merge_from_list(args.opts)

    def has(name):
        return getattr(args, name, None) not in (None, False, "", 0)

    if has("batch_size"):
        config.DATA.BATCH_SIZE = args.batch_size
    if has("ckpt_freq"):
        config.SAVE_FREQ = args.ckpt_freq
    config.EVAL_FREQ = args.eval_freq if has("eval_freq") else 1
    if has("skip_initial_validation"):
        config.SKIP_INITIAL_EVAL = True
    config.EVAL_TRAINING = (args.eval_training_freq
                            if has("eval_training_freq") else None)
    if has("epochs"):
        config.TRAIN.EPOCHS = args.epochs
    if has("decoder_map"):
        with open(args.decoder_map) as f:
            for task, head in json.load(f).items():
                config.MODEL.DECODER_HEAD[task] = head
    if has("skip_decoder"):
        config.TRAIN.SKIP_DECODER_CKPT = args.skip_decoder
    if has("data_path"):
        config.DATA.DATA_PATH = args.data_path

    db_name = "NYUD"
    if has("nyud"):
        config.DATA.NYUD = args.nyud
        config.DATA.DATA_PATH = args.nyud
        db_name = "NYUD"
    elif has("pascal"):
        config.DATA.PASCAL = args.pascal
        config.DATA.DATA_PATH = args.pascal
        db_name = "PASCALContext"
    elif has("tasks") and any(t in args.tasks
                              for t in ("sal", "human_parts")):
        # synthetic runs without a dataset: PASCAL-only tasks name it
        db_name = "PASCALContext"
    config.DATA.DBNAME = db_name

    if has("tasks"):
        tasks = re.split(r"\s*,\s*", args.tasks.strip())
        assert "shared" not in tasks, "shared is a reserved task name"
        _set_tasks(config, tasks, db_name)
    if has("pretrained"):
        config.MODEL.PRETRAINED = args.pretrained
    if has("resume"):
        config.MODEL.RESUME = args.resume
    config.MODEL.RESUME_BACKBONE = (args.resume_backbone
                                    if has("resume_backbone") else False)
    config.MODEL.FREEZE_BACKBONE = (bool(args.freeze_backbone)
                                    if has("freeze_backbone") else False)
    config.MODEL.SAVE_SAMPLE = (bool(args.save_sample)
                                if has("save_sample") else False)
    if has("accumulation_steps"):
        config.TRAIN.ACCUMULATION_STEPS = args.accumulation_steps
    if has("use_checkpoint"):
        config.TRAIN.USE_CHECKPOINT = True
        config.TPU.REMAT = True
    if has("disable_amp"):
        config.AMP_ENABLE = False
    if has("output"):
        config.OUTPUT = args.output
    if has("tag"):
        config.TAG = args.tag
    if has("eval"):
        config.EVAL_MODE = True
    if has("throughput"):
        config.THROUGHPUT_MODE = True
    if has("fused_window_process"):
        config.FUSED_WINDOW_PROCESS = True
    if has("fused_layernorm"):
        config.FUSED_LAYERNORM = True
    if has("optim"):
        config.TRAIN.OPTIMIZER.NAME = args.optim
    if has("name"):
        config.MODEL.NAME = args.name
    config.LOCAL_RANK = getattr(args, "local_rank", 0) or 0
    config.OUTPUT = os.path.join(config.OUTPUT, config.MODEL.NAME,
                                 config.TAG)
    if config.MODEL.MTLORA.ENABLED:
        normalize_mtlora(config)
    config.freeze()


def get_config(args) -> ConfigNode:
    """A frozen config from parsed CLI arguments (reference get_config)."""
    config = default_config()
    update_config(config, args)
    return config


def load_config(cfg_file: str, tasks: Optional[List[str]] = None,
                db_name: str = "PASCALContext",
                img_size: Optional[int] = None,
                opts: Optional[List[str]] = None, **overrides) -> ConfigNode:
    """A frozen config from a YAML file without argparse
    (``mtlora_tpu/config.py:516-551``): the file, ``opts``, ``overrides``
    by dotted key, the image size, and the tasks of ``db_name``."""
    config = default_config()
    _update_config_from_file(config, cfg_file)
    if opts:
        config.merge_from_list(opts)
    for k, v in overrides.items():
        node = config
        parts = k.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = v
    if img_size is not None:
        config.DATA.IMG_SIZE = img_size
    config.DATA.DBNAME = db_name
    if tasks is not None:
        _set_tasks(config, tasks, db_name)
        if config.MODEL.MTLORA.ENABLED:
            normalize_mtlora(config)
    config.EVAL_FREQ = 1
    config.EVAL_TRAINING = None
    config.MODEL.RESUME_BACKBONE = False
    config.MODEL.FREEZE_BACKBONE = False
    config.MODEL.SAVE_SAMPLE = False
    config.freeze()
    return config


@dataclasses.dataclass(frozen=True)
class StageLoRA:
    """Adapter ranks and scales of one Swin stage (``LoRASpec``)."""
    r_shared: int
    r_tasks: Tuple[int, ...]
    shared_scale: float
    task_scales: Tuple[float, ...]
    dropout: float = 0.0        # on the adapters' shared input, in training


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Everything the forward of ``MultiTaskSwin`` depends on."""
    tasks: Tuple[str, ...]
    num_outputs: Tuple[int, ...]
    img_size: int
    stages: Tuple[StageLoRA, ...]
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: float | None = None
    patch_norm: bool = True
    qkv_enabled: bool = True
    proj_enabled: bool = True
    fc1_enabled: bool = True
    fc2_enabled: bool = True
    decoder_channels: Tuple[int, ...] = (18, 36, 72, 144)
    compute_dtype: str = "bfloat16"   # "bfloat16" (AMP_ENABLE) or "float32"
    drop_path_rate: float = 0.0       # stochastic depth, linear over blocks
    # TPU.USE_PALLAS_LN: LN fused into qkv (kernel 2), the whole MLP of the
    # no-task blocks (kernel 4) and the patch merges (kernel 3)
    use_pallas_ln: bool = False
    # TPU.USE_PALLAS_ADAPTER (with USE_PALLAS_LN): the stage-tail blocks'
    # task streams stay factored; fc1 in kernel 2's tail mode, the adapter
    # MLP tail (kernel 5), the factored task merge (kernel 6)
    use_pallas_adapter: bool = False
    # TPU.USE_PALLAS_LORA_GEMM: the frozen GEMM and the shared adapter of
    # every MTLoRALinear with no task branch and no LN kernel in one pass
    # (kernel 8)
    use_pallas_lora_gemm: bool = False
    # MTLORA_ATTN_DENSE: window attention of a stage with one window per
    # image, no mask and a batch that fills 8-window cells in kernel 1c
    attn_dense: bool = False
    # TPU.USE_PALLAS: False turns every kernel off (the JAX package's
    # ``_pallas_available`` gate, mtl.py:284-293): the four switches above
    # off, and kernels 1, 1c and 7 replaced by their plain versions on any
    # device; the fp32 eval clone's setting (``models.mtl.eval_model_for``)
    use_pallas: bool = True

    def __post_init__(self):
        if not self.use_pallas and (
                self.use_pallas_ln or self.use_pallas_adapter
                or self.use_pallas_lora_gemm or self.attn_dense):
            raise ValueError("use_pallas False turns every kernel off: "
                             "use_pallas_ln, use_pallas_adapter, "
                             "use_pallas_lora_gemm and attn_dense must be off")


def attn_dense_enabled() -> bool:
    """The JAX package's switch of the dense attention cells
    (``pallas_window_attn._dense_enabled``): the environment variable
    ``MTLORA_ATTN_DENSE`` set to anything but "0"."""
    return os.environ.get("MTLORA_ATTN_DENSE", "0") != "0"


def _unsupported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, {item}); the port does not "
        "run a plain stand-in for it")


def from_config(config) -> ModelConfig:
    """Build from a loaded reference-schema config node (after
    ``normalize_mtlora``), read by attribute; ``TPU.USE_PALLAS`` and
    ``TPU.REMAT`` by ``get`` with the JAX package's defaults, as it reads
    them. ``TPU.USE_PALLAS`` False gates every kernel switch off, as the
    JAX package's ``_pallas_available`` does."""
    tpu = config.TPU
    m = config.MODEL.MTLORA
    swin = config.MODEL.SWIN
    # read as the JAX package reads them (models/build.py, models/mtl.py)
    if config.MODEL.TYPE != "swin":
        _unsupported(f"MODEL.TYPE {config.MODEL.TYPE!r} (the reference "
                     "builds only 'swin')", "Queue 1, item 10")
    use_pallas = bool(config.get("TPU", {}).get("USE_PALLAS", True))
    if (bool(config.get("TPU", {}).get("REMAT", False))
            or bool(config.TRAIN.USE_CHECKPOINT)):
        _unsupported("TRAIN.USE_CHECKPOINT / TPU.REMAT (rematerialized "
                     "Swin blocks)", "Queue 1, item 10")
    use_ln = use_pallas and bool(tpu.USE_PALLAS_LN)
    use_adapter = use_pallas and bool(tpu.USE_PALLAS_ADAPTER)
    _check_adapter_route(use_ln, use_adapter, bool(m.PROJ_ENABLED))
    if use_ln and not (bool(m.QKV_ENABLED) and bool(m.FC1_ENABLED)
                       and bool(m.FC2_ENABLED)):
        _unsupported("TPU.USE_PALLAS_LN with qkv, fc1 or fc2 adapters off "
                     "(kernel 2's GELU and dropped-output modes)",
                     "Queue 1, item 9")
    if not bool(m.ENABLED):
        _unsupported("MODEL.MTLORA.ENABLED False", "Queue 1, item 9")
    if not bool(m.FREEZE_PRETRAINED):
        _unsupported("MTLORA.FREEZE_PRETRAINED False", "Queue 1, item 9")
    if str(m.SHARED_MODE) != "matrix":
        _unsupported(f"MTLORA.SHARED_MODE {m.SHARED_MODE!r}", "Queue 1, item 9")
    for flag in ("DOWNSAMPLER_ENABLED", "INTERMEDIATE_SPECIALIZATION",
                 "SPLIT_QKV", "TRAINABLE_SCALE_SHARED",
                 "TRAINABLE_SCALE_PER_TASK"):
        if bool(getattr(m, flag)):
            _unsupported(f"MTLORA.{flag}", "Queue 1, item 9")
    if bool(swin.APE):
        _unsupported("MODEL.SWIN.APE", "Queue 1, item 9")
    if float(config.MODEL.DROP_RATE) != 0.0:
        _unsupported("MODEL.DROP_RATE > 0 (token and projection dropout)",
                     "Queue 1, item 9")
    if not (bool(config.MODEL.DECODER_DOWNSAMPLER)
            and bool(config.MODEL.PER_TASK_DOWNSAMPLER)):
        _unsupported("shared or disabled decoder downsampler",
                     "Queue 1, item 9")
    tasks = tuple(config.TASKS)
    for t in tasks:
        if config.MODEL.DECODER_HEAD.get(t, "hrnet") != "hrnet":
            _unsupported(f"decoder head {config.MODEL.DECODER_HEAD[t]!r}",
                         "Queue 1, item 9")
    stages = []
    for i in range(len(swin.DEPTHS)):
        r_map = m.R_PER_TASK_LIST[i]
        s_map = m.SCALE_PER_TASK_LIST[i]
        stages.append(StageLoRA(
            r_shared=int(r_map["shared"]),
            r_tasks=tuple(int(r_map[t]) for t in tasks),
            shared_scale=float(m.SHARED_SCALE[i]),
            task_scales=tuple(float(s_map[t]) for t in tasks),
            dropout=float(m.DROPOUT[i])))
    _check_kernel_ranks(use_ln, use_adapter, tuple(stages))
    amp = bool(config.AMP_ENABLE)
    compute = ("bfloat16" if amp and str(tpu.COMPUTE_DTYPE) == "bfloat16"
               else "float32")
    return ModelConfig(
        tasks=tasks,
        num_outputs=tuple(int(config.TASKS_CONFIG.ALL_TASKS.NUM_OUTPUT[t])
                          for t in tasks),
        img_size=int(config.DATA.IMG_SIZE),
        stages=tuple(stages),
        patch_size=int(swin.PATCH_SIZE),
        embed_dim=int(swin.EMBED_DIM),
        depths=tuple(int(d) for d in swin.DEPTHS),
        num_heads=tuple(int(h) for h in swin.NUM_HEADS),
        window_size=int(swin.WINDOW_SIZE),
        mlp_ratio=float(swin.MLP_RATIO),
        qkv_bias=bool(swin.QKV_BIAS),
        qk_scale=(None if swin.QK_SCALE is None else float(swin.QK_SCALE)),
        patch_norm=bool(swin.PATCH_NORM),
        qkv_enabled=bool(m.QKV_ENABLED),
        proj_enabled=bool(m.PROJ_ENABLED),
        fc1_enabled=bool(m.FC1_ENABLED),
        fc2_enabled=bool(m.FC2_ENABLED),
        decoder_channels=tuple(int(c) for c in config.MODEL.DECODER_CHANNELS),
        compute_dtype=compute,
        drop_path_rate=float(config.MODEL.DROP_PATH_RATE),
        use_pallas_ln=use_ln,
        use_pallas_adapter=use_adapter,
        use_pallas_lora_gemm=use_pallas and bool(tpu.USE_PALLAS_LORA_GEMM),
        attn_dense=use_pallas and attn_dense_enabled(),
        use_pallas=use_pallas,
    )


def eval_dtype(config) -> str:
    """``TPU.EVAL_DTYPE`` read as the JAX package reads it (``get`` with
    the default ``"float32"``, ``models/mtl.py:eval_model_for``):
    ``"bfloat16"`` keeps the model's bf16 kernel path for eval, anything
    else selects the fp32 clone with every kernel off."""
    return ("bfloat16" if str(config.get("TPU", {}).get(
        "EVAL_DTYPE", "float32")) == "bfloat16" else "float32")


def _check_adapter_route(use_ln: bool, use_adapter: bool,
                         proj_enabled: bool = True):
    """The adapter route runs only on the LN route, with proj task
    adapters: without them fc1 takes ``_ln_fused``'s ``x_tasks None``
    branch."""
    if use_adapter and not use_ln:
        _unsupported("TPU.USE_PALLAS_ADAPTER with TPU.USE_PALLAS_LN off "
                     "(kernel 5 with the task streams expanded by "
                     "expand_factored_tasks)", "Queue 1, item 9")
    if use_adapter and not proj_enabled:
        _unsupported("TPU.USE_PALLAS_ADAPTER with MTLORA.PROJ_ENABLED off "
                     "(fc1's task projection from the shared LN output)",
                     "Queue 1, item 9")


def _check_kernel_ranks(use_ln: bool, use_adapter: bool, stages):
    """Ranks and task counts the task-stream kernels do not take: the
    shared rank of kernels 2, 2b, 2-tail and 2b-tail (a multiple of 16 up
    to 64) on the LN routes; on the adapter route the per-task rank 4 and
    at most 4 tasks of kernels 5 and 5b, whose r1 + r2 == 8 kernels 6 and
    6b take too."""
    if use_ln:
        for st in stages:
            if st.r_shared % 16 or not 16 <= st.r_shared <= 64:
                _unsupported(f"shared rank {st.r_shared} on the LN routes "
                             "(kernels 2, 2b, 2-tail and 2b-tail take a "
                             "multiple of 16 up to 64)", "Queue 1, item 9")
    if use_adapter:
        ranks = sorted({r for st in stages for r in st.r_tasks})
        tasks = len(stages[0].r_tasks)
        if tasks > 4 or ranks != [4]:
            _unsupported(f"TPU.USE_PALLAS_ADAPTER with {tasks} tasks of "
                         f"per-task ranks {ranks} (kernels 5, 5b, 6 and 6b "
                         "take at most 4 tasks of rank 4)", "Queue 1, item 9")


def tiny_448_r64_pertask(use_pallas_ln: bool = True,
                         use_pallas_adapter: bool | None = None,
                         use_pallas_lora_gemm: bool = False
                         ) -> ModelConfig:
    """``configs/mtlora/tiny_448/mtlora_tiny_448_r64_scale4_pertask.yaml``
    with the four PASCAL tasks: Swin-T at 448, shared rank 64 and per-task
    rank 4 at scale 4 in every stage, adapter dropout 0.05, drop-path 0.2,
    bf16 compute. ``use_pallas_ln`` and ``use_pallas_adapter`` are
    ``TPU.USE_PALLAS_LN`` and ``TPU.USE_PALLAS_ADAPTER``: both on by
    default, as in the YAML; adapter off is the LN route of kernels 2, 3,
    4 with materialized task streams, and both off the route with
    LayerNorm outside the GEMMs. The adapter route needs the LN route, so
    ``use_pallas_adapter`` defaults to ``use_pallas_ln``.
    ``use_pallas_lora_gemm`` is ``TPU.USE_PALLAS_LORA_GEMM`` (off, as in
    the YAML). The JAX package's default size, ``DATA.IMG_SIZE 224``, is
    ``dataclasses.replace(cfg, img_size=224)``; ``attn_dense``
    (``MTLORA_ATTN_DENSE``) likewise."""
    if use_pallas_adapter is None:
        use_pallas_adapter = use_pallas_ln
    _check_adapter_route(use_pallas_ln, use_pallas_adapter)
    stage = StageLoRA(r_shared=64, r_tasks=(4, 4, 4, 4), shared_scale=4.0,
                      task_scales=(4.0, 4.0, 4.0, 4.0), dropout=0.05)
    return ModelConfig(
        tasks=("semseg", "normals", "sal", "human_parts"),
        num_outputs=(21, 3, 1, 7),
        img_size=448,
        stages=(stage,) * 4,
        drop_path_rate=0.2,
        use_pallas_ln=use_pallas_ln,
        use_pallas_adapter=use_pallas_adapter,
        use_pallas_lora_gemm=use_pallas_lora_gemm,
    )
