"""Multi-task model: backbone, per-task downsamplers, per-task heads.

Counterpart of ``mtlora_tpu/models/mtl.py:27-65,90-281`` on the route with
per-task HRNet heads run one after another (``MTLORA_BATCHED_HEADS`` off).
``forward(images [B, H, W, 3], generator=None) -> {task: [B, H, W,
n_task]}``, NHWC, in the model's compute dtype. Parameters are fp32 and
are cast where they are used, as under the JAX package's ``AMP_ENABLE``;
autograd through those casts gives fp32 gradients.

``model.train()`` is the JAX ``deterministic=False`` with batch-statistics
BatchNorm (``mtl.py:153-155``): adapter dropout and drop-path draw from the
``generator`` passed to the forward, and the heads normalise with the
batch moments and update their running statistics. ``model.eval()`` is
the eval path, with no draw. :func:`eval_model_for` is the fp32 eval clone
with every kernel off (``mtl.py:296-314``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from mtlora_tpu_torch.config import ModelConfig
from mtlora_tpu_torch.models.heads import HighResolutionHead, resize_bilinear
from mtlora_tpu_torch.models.swin import SwinTransformerMTLoRA


class PerTaskDownsampler(nn.Module):
    """One 1x1 conv per scale (no bias) reducing stage channels to the
    decoder channels; the reference key layout
    ``downsampler.{task}.downsample_{s}.weight [ch, dim, 1, 1]``."""

    def __init__(self, dims, channels):
        super().__init__()
        for s, (d, c) in enumerate(zip(dims, channels)):
            setattr(self, f"downsample_{s}", nn.Conv2d(d, c, 1, bias=False))

    def forward(self, feats, res):
        """feats: per scale [B, L_s, C_s] -> per scale [B, r_s, r_s, ch_s]."""
        outs = []
        for s, f in enumerate(feats):
            conv = getattr(self, f"downsample_{s}")
            w = conv.weight.view(conv.out_channels, -1).to(f.dtype)
            outs.append(F.linear(f, w).view(f.shape[0], res[s], res[s], -1))
        return outs


class MultiTaskSwin(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        n = len(cfg.depths)
        self.stage_dims = tuple(cfg.embed_dim * 2 ** (i + 1 if i < n - 1
                                                      else i)
                                for i in range(n))
        pr = cfg.img_size // cfg.patch_size
        self.stage_res = tuple(pr // 2 ** (i + 1 if i < n - 1 else i)
                               for i in range(n))
        self.backbone = SwinTransformerMTLoRA(cfg)
        self.downsampler = nn.ModuleDict(
            {t: PerTaskDownsampler(self.stage_dims, cfg.decoder_channels)
             for t in cfg.tasks})
        self.decoders = nn.ModuleDict(
            {t: HighResolutionHead(sum(cfg.decoder_channels), n_out,
                                   kernel=cfg.use_pallas)
             for t, n_out in zip(cfg.tasks, cfg.num_outputs)})

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> dict:
        x = images.to(self.compute_dtype)
        stages = self.backbone(x, generator)
        size = (self.cfg.img_size, self.cfg.img_size)
        out = {}
        for i, task in enumerate(self.cfg.tasks):
            feats = self.downsampler[task]([t[i] for _, t in stages],
                                           self.stage_res)
            out[task] = resize_bilinear(self.decoders[task](feats), size)
        return out


def build_mtl_model(cfg: ModelConfig, device="cuda") -> MultiTaskSwin:
    """Eval model with zero-initialised parameters, allocated on ``device``
    (the card unless the caller names another); load a state dict
    (``ckpt/convert.py``) or call :func:`init_random_` next."""
    with torch.device(device):
        model = MultiTaskSwin(cfg)
    # buffers made from numpy constants (window masks, the relative
    # position index) are born on the CPU
    return model.to(device).eval()


def eval_model_for(model: MultiTaskSwin,
                   eval_dtype: str = "float32") -> MultiTaskSwin:
    """The model that ``validate`` and ``throughput`` run (``mtl.py:296-314``,
    ``TPU.EVAL_DTYPE``): with ``"bfloat16"`` the model itself, its bf16
    kernel path; otherwise a clone that computes in fp32 with every kernel
    off (``use_pallas`` False: LayerNorm outside the GEMMs, materialized
    task streams, the plain versions of kernels 1 and 7, GELU the exact
    erf), the reference's eval numerics.

    The clone SHARES the model's tensors: its parameters are the model's
    ``nn.Parameter`` objects and its buffers (BatchNorm running statistics,
    masks) the model's buffers, so it always computes with the model's
    current weights and statistics, as the JAX clone shares ``params``;
    nothing is copied and nothing is allocated on the device. It is a
    separate module tree with its own ``training`` flag (eval), so the
    model's route and mode stay as they were."""
    if eval_dtype == "bfloat16":
        return model
    cfg = dataclasses.replace(model.cfg, compute_dtype="float32",
                              use_pallas=False, use_pallas_ln=False,
                              use_pallas_adapter=False,
                              use_pallas_lora_gemm=False, attn_dense=False)
    with torch.device("meta"):
        clone = MultiTaskSwin(cfg)
    # remove_duplicate=False: a tensor the model uses at two sites is
    # shared at both
    for name, t in (*model.named_parameters(remove_duplicate=False),
                    *model.named_buffers(remove_duplicate=False)):
        owner, _, leaf = name.rpartition(".")
        setattr(clone.get_submodule(owner), leaf, t)
    left = [n for n, t in (*clone.named_parameters(), *clone.named_buffers())
            if t.is_meta]
    if left:
        raise RuntimeError(f"eval clone: no tensor of the model for {left}")
    return clone.eval()


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights on which every branch counts: weights
    U(+-1/sqrt(fan_in)), LoRA A likewise and LoRA B U(+-0.01) (B is zero
    at a real init), norm scales 1 +- 0.1, biases U(+-0.02), relative
    position bias U(+-0.02), BatchNorm running mean U(+-0.05) and
    variance U(0.8, 1.2). Draws on the CPU generator, then copies."""
    def fill(t, lo, hi):
        t.copy_(torch.empty(t.shape).uniform_(lo, hi, generator=generator))

    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("lora_shared_B", "lora_tasks_B"):
            fill(p, -0.01, 0.01)
        elif leaf == "relative_position_bias_table":
            fill(p, -0.02, 0.02)
        elif p.dim() >= 2:
            fan_in = p.shape[-1] if leaf == "lora_tasks_A" else p[0].numel()
            bound = fan_in ** -0.5
            fill(p, -bound, bound)
        elif leaf == "weight":
            fill(p, 0.9, 1.1)
        else:
            fill(p, -0.02, 0.02)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            fill(m.running_mean, -0.05, 0.05)
            fill(m.running_var, 0.8, 1.2)
    return model
