"""Swin Transformer backbone with MTLoRA adapters.

Counterpart of ``mtlora_tpu/models/swin.py``, the window attention core in
the CUDA kernel of ``ops/window_attn.py``. Three routes, as the JAX
package's ``TPU.USE_PALLAS_LN`` and ``TPU.USE_PALLAS_ADAPTER`` switches
(``cfg.use_pallas_ln``, ``cfg.use_pallas_adapter``):

  - both off: LayerNorm outside the GEMMs, every linear layer as a
    module, materialized task streams ``[T, B, L, C]``;
  - LN on: norm1 -> qkv runs kernel 2 in every block (``swin.py:411-421``);
    the whole MLP of a block with no task streams runs kernel 4
    (:215-251); the stage-tail blocks keep ``layer_norm`` plus the module
    path (:298-302); PatchMerging runs kernel 3 on the shared stream and
    on the flattened task streams (:704-741);
  - LN and adapter on (the JAX default): the stage-tail blocks keep their
    task streams factored (:524-626): proj's task output is a
    ``TaskStream`` with per-(task, sample) drop-path coefficients, fc1
    runs kernel 2's tail mode with the task projection folded from the
    shared tensors, fc2's task branch runs kernel 5, and the block hands
    ``DeferredTasks`` to PatchMerging, which merges the task streams in
    kernel 6 without forming them (at every merge: the JAX package's
    ``Wh % 8`` gate is a TPU tiling constraint); the last stage expands
    them once (``expand_task_streams``).
Parameters are the same on every route.

``cfg.use_pallas_lora_gemm`` (``TPU.USE_PALLAS_LORA_GEMM``) hands qkv, proj,
fc1 and fc2 the kernel-8 switch (``swin.py:194,199,377,384``); a layer that
kernel 2, kernel 4 or the factored tail takes, or one with a task branch,
never reaches it. ``cfg.attn_dense`` (``MTLORA_ATTN_DENSE``) sends the
window attention of a stage with one window per image (no shift: the
window clamps) to kernel 1c when :func:`window_attn.dense_applies` says
the JAX model's ``_maybe_packed`` would; stages with an even window count
take the TPU's padded pack-2 route there (``swin.py:402-435``), kernel 1
here.
Token layout is ``[B, L, C]`` with L = H*W row-major; the qkv GEMM runs on
the tokens after the window gather, the proj GEMM after the inverse
gather, as in the JAX ``WindowAttention``.

Task-stream contract (``swin.py:16-23``):
  - qkv adapters have no task branches;
  - proj/fc1/fc2 carry task branches only in the last block of a stage;
  - a block returns ``attn_tasks + mlp_tasks``, where the attention task
    streams are ``shortcut + proj_t`` and enter fc1 through norm2;
  - PatchMerging runs its one set of weights on the shared stream and on
    every task stream.
Parameter names follow the reference torch keys
(``layers.0.blocks.0.attn.qkv.linear.weight``, ``layers.0.downsample.
reduction.weight``, ...).

In training (``module.train()``) the adapters drop their shared input and
the blocks drop paths per sample (``swin.py:153-166``): one keep draw per
sample on the shared stream and one per (task, sample) on ``[T, B, L, C]``
streams, at rates ``linspace(0, drop_path_rate, 12)`` over the blocks
(``swin.py:1042``). Every draw comes from the ``torch.Generator`` passed
down the forward; eval is the identity and draws nothing.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mtlora_tpu_torch.config import ModelConfig, StageLoRA
from mtlora_tpu_torch.models.lora import (
    DeferredTasks,
    MTLoRALinear,
    TaskStream,
    droppath_coef,
    expand_task_streams,
)
from mtlora_tpu_torch.ops import dropout as hash_dropout
from mtlora_tpu_torch.ops.attention import (
    dtype_const,
    relative_position_index,
    shift_attention_mask,
)
from mtlora_tpu_torch.ops.window import (
    shift_window_partition,
    window_merge_unshift,
)
from mtlora_tpu_torch.ops.ln_lora import fused_merge_ln_linear
from mtlora_tpu_torch.ops.ln_mlp import fused_ln_mlp
from mtlora_tpu_torch.ops.task_merge import fused_task_merge
from mtlora_tpu_torch.ops.window_attn import (
    dense_applies,
    fused_window_attention,
    fused_window_attention_dense,
)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with fp32 statistics, variance as E[x^2] - E[x]^2 (the
    flax ``nn.LayerNorm`` and ``_manual_ln`` numerics), output in x's
    dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mu * mu
    y = (x32 - mu) * torch.rsqrt(var + norm.eps) * norm.weight + norm.bias
    return y.to(x.dtype)


def drop_path(x: torch.Tensor, rate: float,
              generator: torch.Generator | None) -> torch.Tensor:
    """Per-sample stochastic depth (timm ``DropPath``): one keep draw for
    each index of ``x.shape[:-2]`` -- per sample on ``[B, L, C]``, per
    (task, sample) on ``[T, B, L, C]`` -- and kept rows scaled by
    ``1 / keep`` in x's dtype."""
    if generator is None:
        raise ValueError("drop-path in training needs an explicit "
                         "torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape[:-2] + (1, 1), generator=generator,
                      device=x.device) < keep
    return x * (mask.to(x.dtype) * dtype_const(1.0 / keep, x.dtype))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, lora: StageLoRA,
                 tasks: tuple, fc1_tasks: bool, fc2_tasks: bool,
                 fc1_lora: bool, fc2_lora: bool, gemm: bool = False):
        super().__init__()
        self.fc1 = _lora_linear(dim, hidden, lora, tasks if fc1_tasks else (),
                                fc1_lora, gemm=gemm)
        self.fc2 = _lora_linear(hidden, dim, lora, tasks if fc2_tasks else (),
                                fc2_lora, gemm=gemm)

    def forward(self, x, x_tasks=None, generator=None):
        x, t = self.fc1(x, x_tasks, generator)
        x = F.gelu(x)
        if t is not None:
            t = F.gelu(t)
        return self.fc2(x, t, generator)

    @property
    def ln_fusible(self) -> bool:
        """Kernel 4 takes the whole MLP: no task streams, shared adapters
        on both layers (``_ln_mlp_fusible``)."""
        return (not self.fc1.tasks and not self.fc2.tasks
                and self.fc1.r_shared > 0 and self.fc2.r_shared > 0)

    def ln_fused_tail(self, x, norm: nn.LayerNorm, stream: TaskStream,
                      generator=None):
        """A stage-tail MLP on the adapter route (``swin.py:252-297``,
        ``fused``): fc1 as kernel 2's tail mode on the pre-norm ``x`` (GELU
        in the kernel, the task projection folded from ``stream``), fc2's
        shared branch on fc1's in-kernel dropped output, its task branch
        through kernel 5. Returns ``(y [..., C], FactoredTasks)``."""
        h, t, hd = self.fc1.ln_fused_tail(x, norm, stream, generator,
                                          out_drop=True)
        return self.fc2(h, None, generator, factored_tasks=True,
                        task_factored=t, x_dropped=hd)

    def ln_fused(self, x, norm: nn.LayerNorm, generator=None):
        """norm -> fc1 -> GELU -> fc2 on the pre-norm ``x [..., C]`` as one
        kernel-4 call (``swin.py:224-251``); the two dropout streams hash
        seed[0] and seed[1] of one draw."""
        dt = x.dtype
        lead = x.shape[:-1]
        drop = self.fc1.drop_rate()
        seed = (hash_dropout.draw_seed(generator, x.device) if drop > 0.0
                else torch.zeros(2, dtype=torch.int32, device=x.device))
        y = fused_ln_mlp(x.reshape(-1, x.shape[-1]).contiguous(),
                         norm.weight.to(dt), norm.bias.to(dt),
                         *self.fc1.kernel_operands(dt),
                         *self.fc2.kernel_operands(dt), seed,
                         self.fc1.shared_scale, self.fc2.shared_scale, drop)
        return y.view(*lead, -1)


def _lora_linear(cin, cout, lora: StageLoRA, tasks, enabled: bool,
                 bias: bool = True, gemm: bool = False) -> MTLoRALinear:
    if not enabled:
        return MTLoRALinear(cin, cout, bias=bias)
    return MTLoRALinear(cin, cout, r_shared=lora.r_shared,
                        shared_scale=lora.shared_scale, tasks=tasks,
                        r_tasks=lora.r_tasks, task_scales=lora.task_scales,
                        bias=bias, dropout=lora.dropout, use_pallas_gemm=gemm)


class WindowAttention(nn.Module):
    """(S)W-MSA with relative position bias and MTLoRA qkv/proj."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 lora: StageLoRA, tasks: tuple, proj_tasks: bool,
                 qkv_lora: bool = True, proj_lora: bool = True,
                 qkv_bias: bool = True, qk_scale: float | None = None,
                 gemm: bool = False, dense: bool = False,
                 kernel: bool = True):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        self.dense = dense
        self.kernel = kernel        # TPU.USE_PALLAS: kernels 1 / 1c or plain
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window_size)).long(),
            persistent=False)
        self.qkv = _lora_linear(dim, 3 * dim, lora, (), qkv_lora, qkv_bias,
                                gemm=gemm)
        self.proj = _lora_linear(dim, dim, lora,
                                 tasks if proj_tasks else (), proj_lora,
                                 gemm=gemm)

    def rel_bias(self) -> torch.Tensor:
        N = self.window_size ** 2
        idx = self.relative_position_index.view(-1)
        return (self.relative_position_bias_table[idx]
                .view(N, N, self.num_heads).permute(2, 0, 1).contiguous())

    def forward(self, x, H: int, W: int, shift: int, mask=None,
                generator=None, norm: nn.LayerNorm | None = None,
                factored_tasks: bool = False):
        """x [B, H*W, C] -> (y [B, L, C], y_tasks or None). ``norm``: x is
        PRE-norm and the LayerNorm runs inside the qkv kernel (kernel 2) on
        the gathered tokens, or before the module path when qkv has no
        adapter. ``factored_tasks``: proj's task output as a
        ``FactoredTasks``."""
        B = x.shape[0]
        ws = self.window_size
        xw = shift_window_partition(x, H, W, ws, shift)     # [B*nW, N, C]
        if norm is not None and self.qkv.r_shared > 0:
            qkv = self.qkv.ln_fused(xw, norm, generator)
        else:
            if norm is not None:
                xw = layer_norm(xw, norm)
            qkv, _ = self.qkv(xw, None, generator)
        attn = self._core(qkv, B, H, W, mask)
        tok = window_merge_unshift(attn, B, H, W, ws, shift)
        return self.proj(tok, None, generator, factored_tasks=factored_tasks)

    def _core(self, qkv, B: int, H: int, W: int, mask):
        """Kernel 1c where the JAX model takes ``_fused_windows_dense``:
        not the padded pack-2 route (an even window count, ``2N <= 128``),
        and ``_maybe_packed``'s dense decision; kernel 1 elsewhere; the
        plain version on any device where ``kernel`` is off."""
        ws = self.window_size
        nw, N = (H // ws) * (W // ws), ws * ws
        pad2 = nw % 2 == 0 and 2 * N <= 128
        if (self.kernel and self.dense and not pad2
                and dense_applies(qkv.dtype, N, nw, B, mask)):
            return fused_window_attention_dense(qkv, self.num_heads,
                                                self.rel_bias(), mask,
                                                self.scale)
        return fused_window_attention(qkv, self.num_heads, self.rel_bias(),
                                      mask, self.scale, kernel=self.kernel)


class SwinBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dim: int, resolution: int,
                 num_heads: int, lora: StageLoRA, produce_tasks: bool,
                 shift_size: int, drop_path_rate: float = 0.0,
                 defer_expand: bool = False):
        super().__init__()
        self.drop_path_rate = float(drop_path_rate)
        self.use_pallas_ln = cfg.use_pallas_ln
        # the adapter route's factored task streams (swin.py:524-529);
        # from_config admits the route only with the LN route and proj, fc1
        # and fc2 adapters
        self.factored = (cfg.use_pallas_adapter and produce_tasks
                         and max(lora.r_tasks, default=0) > 0)
        # hand the streams to PatchMerging unexpanded (DeferredTasks)
        self.defer_expand = defer_expand and self.factored
        ws, shift = cfg.window_size, shift_size
        if resolution <= ws:   # window clamping (swin.py:496-497)
            ws, shift = resolution, 0
        self.resolution, self.shift = resolution, shift
        tasks = cfg.tasks if produce_tasks else ()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(
            dim, ws, num_heads, lora, tasks,
            proj_tasks=produce_tasks and cfg.proj_enabled,
            qkv_lora=cfg.qkv_enabled, proj_lora=cfg.proj_enabled,
            qkv_bias=cfg.qkv_bias, qk_scale=cfg.qk_scale,
            gemm=cfg.use_pallas_lora_gemm, dense=cfg.attn_dense,
            kernel=cfg.use_pallas)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio), lora, tasks,
                       fc1_tasks=produce_tasks and cfg.fc1_enabled,
                       fc2_tasks=produce_tasks and cfg.fc2_enabled,
                       fc1_lora=cfg.fc1_enabled, fc2_lora=cfg.fc2_enabled,
                       gemm=cfg.use_pallas_lora_gemm)
        mask = (torch.from_numpy(shift_attention_mask(
            resolution, resolution, ws, shift)) if shift > 0 else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x, generator=None):
        H = W = self.resolution
        if self.training and self.drop_path_rate > 0.0:
            def dp(t):
                return drop_path(t, self.drop_path_rate, generator)
        else:
            def dp(t):
                return t
        if self.factored:
            return self._forward_factored(x, generator, dp)
        shortcut = x
        if self.use_pallas_ln:
            aw, aw_tasks = self.attn(x, H, W, self.shift, self.attn_mask,
                                     generator, norm=self.norm1)
        else:
            aw, aw_tasks = self.attn(layer_norm(x, self.norm1), H, W,
                                     self.shift, self.attn_mask, generator)
        x = shortcut + dp(aw)
        attn_tasks = (shortcut[None] + dp(aw_tasks)
                      if aw_tasks is not None else None)
        if (self.use_pallas_ln and attn_tasks is None
                and self.mlp.ln_fusible):
            return x + dp(self.mlp.ln_fused(x, self.norm2, generator)), None
        mlp_out, mlp_tasks = self.mlp(
            layer_norm(x, self.norm2),
            layer_norm(attn_tasks, self.norm2)
            if attn_tasks is not None else None, generator)
        x = x + dp(mlp_out)
        if mlp_tasks is None:
            return x, attn_tasks
        if attn_tasks is None:
            # no shortcut when only the MLP produced task streams
            # (reference quirk, swin.py:627-634)
            return x, dp(mlp_tasks)
        return x, attn_tasks + dp(mlp_tasks)

    def _forward_factored(self, x, generator, dp):
        """The stage-tail block on the adapter route (``swin.py:550-626``):
        the task streams never materialize here; the block returns them
        as ``DeferredTasks`` or expanded once."""
        H = W = self.resolution
        B, L, _ = x.shape
        shortcut = x
        aw, ft = self.attn(x, H, W, self.shift, self.attn_mask, generator,
                           norm=self.norm1, factored_tasks=True)
        x = shortcut + dp(aw)
        rate = self.drop_path_rate if self.training else 0.0
        T = ft.B.shape[0]
        stream = TaskStream(base=shortcut, pre=ft.pretrained.view(B, L, -1),
                            midT=ft.midT, B=ft.B, scales=ft.scales,
                            coef=droppath_coef(rate, T, B, generator,
                                               x.device))
        mlp_out, mlp_tasks = self.mlp.ln_fused_tail(x, self.norm2, stream,
                                                    generator)
        x = x + dp(mlp_out)
        coef2 = droppath_coef(rate, T, B, generator, x.device)
        if self.defer_expand:
            return x, DeferredTasks(stream, mlp_tasks, coef2)
        return x, expand_task_streams(stream, mlp_tasks, coef2)


class PatchMerging(nn.Module):
    """2x2 merge + LayerNorm(4C) + 4C -> 2C reduction, concat order
    [x(0,0), x(1,0), x(0,1), x(1,1)] (row offset first)."""

    def __init__(self, resolution: int, dim: int,
                 use_pallas_ln: bool = False):
        super().__init__()
        self.resolution = resolution
        self.use_pallas_ln = use_pallas_ln
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def _merge(self, x):
        *lead, L, C = x.shape
        H = W = self.resolution
        if self.use_pallas_ln:
            # kernel 3: the 2x2 gather, LN(4C) and the reduction in one
            # pass over [L', H*W, C] (swin.py:709, :737-741)
            dt = x.dtype
            y = fused_merge_ln_linear(
                x.reshape(-1, L, C).contiguous(), self.norm.weight.to(dt),
                self.norm.bias.to(dt), self.reduction.weight.to(dt), H, W)
            return y.view(*lead, L // 4, -1)
        x = x.reshape(*lead, H // 2, 2, W // 2, 2, C)
        n = len(lead)
        # [.., H/2, di, W/2, dj, C] -> [.., H/2, W/2, dj, di, C]
        x = x.permute(*range(n), n, n + 2, n + 3, n + 1, n + 4)
        x = x.reshape(*lead, L // 4, 4 * C)
        return F.linear(layer_norm(x, self.norm),
                        self.reduction.weight.to(x.dtype))

    def _task_merge(self, d: DeferredTasks):
        """Kernel 6 (``task_merge_down``, ``swin.py:712-735``): the 2x2
        merge, LN and reduction of every implicit task stream of ``d``,
        ``[T, B, L/4, 2C]`` in the compute dtype."""
        s, f2 = d.stream, d.f2
        B, L, C = s.base.shape
        dt = s.base.dtype
        return fused_task_merge(
            s.base.contiguous(), s.pre.contiguous(),
            f2.pretrained.reshape(B, L, C).contiguous(), s.midT, s.B,
            f2.midT, f2.B, s.coef, d.coef2, s.scales, f2.scales,
            self.norm.weight.to(dt), self.norm.bias.to(dt),
            self.reduction.weight.to(dt), self.resolution, self.resolution)

    def forward(self, x, x_tasks=None):
        out = self._merge(x)
        if x_tasks is None:
            return out, None
        if isinstance(x_tasks, DeferredTasks):
            return out, self._task_merge(x_tasks)
        T = x_tasks.shape[0]
        out_t = self._merge(x_tasks.flatten(0, 1))
        return out, out_t.view(T, *out.shape)


class BasicLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, stage: int, drop_path_rates):
        super().__init__()
        dim = cfg.embed_dim * 2 ** stage
        res = cfg.img_size // cfg.patch_size // 2 ** stage
        depth = cfg.depths[stage]
        has_down = stage < len(cfg.depths) - 1
        self.blocks = nn.ModuleList(
            SwinBlock(cfg, dim, res, cfg.num_heads[stage], cfg.stages[stage],
                      produce_tasks=(i == depth - 1),
                      shift_size=0 if i % 2 == 0 else cfg.window_size // 2,
                      drop_path_rate=drop_path_rates[i],
                      defer_expand=has_down and i == depth - 1)
            for i in range(depth))
        self.downsample = (PatchMerging(res, dim, cfg.use_pallas_ln)
                           if has_down else None)

    def forward(self, x, generator=None):
        tasks = None
        for blk in self.blocks:
            x, t = blk(x, generator)
            if t is not None:
                tasks = t   # only the last streams survive
        if self.downsample is not None:
            x, tasks = self.downsample(x, tasks)
        return x, tasks


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int, patch_norm: bool):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5) if patch_norm else None

    def forward(self, x):
        """[B, H, W, 3] -> [B, L, C]."""
        dt = x.dtype
        y = F.conv2d(x.permute(0, 3, 1, 2), self.proj.weight.to(dt),
                     self.proj.bias.to(dt), stride=self.proj.stride)
        y = y.flatten(2).transpose(1, 2)
        return layer_norm(y, self.norm) if self.norm is not None else y


class SwinTransformerMTLoRA(nn.Module):
    """Backbone: per stage (shared [B, L, C], tasks [T, B, L, C]);
    stage outputs are post-merge except the last."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.num_tasks = len(cfg.tasks)
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.embed_dim,
                                      cfg.patch_norm)
        dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths)).tolist()
        starts = np.cumsum((0,) + tuple(cfg.depths)).tolist()
        self.layers = nn.ModuleList(
            BasicLayer(cfg, i, dpr[starts[i]:starts[i + 1]])
            for i in range(len(cfg.depths)))

    def forward(self, x, generator=None):
        x = self.patch_embed(x)
        outs = []
        for layer in self.layers:
            x, tasks = layer(x, generator)
            if tasks is None:
                tasks = x[None].expand(self.num_tasks, *x.shape)
            outs.append((x, tasks))
        return outs
