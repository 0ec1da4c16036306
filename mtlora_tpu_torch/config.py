"""Model settings of the port.

Counterpart of ``mtlora_tpu/config.py`` plus ``MTLoRASpec.from_config``
(``mtlora_tpu/models/lora.py:49-128``). The port never parses YAML: the
machine that runs it has no ``yaml``, and ``mtlora_tpu``'s loader reaches
``cv2``. :func:`from_config` reads a config node that was already loaded
(any object with the reference schema's attributes), and
:func:`tiny_448_r64_pertask` is the flagship written out as a literal.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple


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
