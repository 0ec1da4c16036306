"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and exits non-zero:
  1. device: a CUDA card must be present; its name and power limit;
  2. build: the seventeen CUDA sources from ops/csrc (one nvcc each, in
     parallel), with the build time;
  3. forward kernels vs plain, on the card, against their plain PyTorch
     versions on the same tensors, at the batch-32 training step's shapes:
     window attention at the four Swin-T 448 stage shapes (shifted and
     not), the HRNet head for the four task widths, kernel 2 (LN + qkv GEMM
     + shared LoRA) and kernel 4 (LN + whole MLP) at the four stage shapes,
     kernel 3 (patch merge) at the three merges for the shared and the
     task streams, kernel 2's tail mode (norm2 -> fc1 with GELU, p and
     dropout(y)) and kernel 5 (adapter MLP tail) at the four stage-tail
     blocks, kernel 6 (factored task merge) at the three merges with
     drop-path coefficients, all with adapter dropout on (rate 0.05, the
     same seeds); kernel 8 (the LoRA GEMM of TPU.USE_PALLAS_LORA_GEMM) at
     proj, qkv, fc1 and fc2 of the four stages with one input and with two
     (the dropped one); kernel 1c (the dense attention cells of
     MTLORA_ATTN_DENSE) at the four 448 stage shapes, shifted and not, and
     at stage 3 of the 224 model, also against kernel 1; kernel, plain and
     library-call times and the roofline bound; kernels 1 and 1c also with
     their plan, achieved TFLOP/s and share of the bound per shape, two
     launches bit-identical, and at the batch-2 step's stages and Swin-B's
     stage-0 and stage-3 heads (ATTN_COVERAGE, DENSE_COVERAGE); kernel 2
     also with its plan, achieved TFLOP/s, share of the bound and
     weight-slot rate per stage, and at the ragged 392 rows of stage 3,
     rank 16, Swin-B's [6272, 1024] -> 3072, scale 3, scale 0 and dropout
     off;
  3b. backward kernels vs plain: the same shapes, every gradient against
     the plain backward (kernel 8: its dx layout; kernel 1c: also against
     kernel 1b), with the same four numbers; kernel 4b also with its
     achieved TFLOP/s, share of the bound and weight-slice rate per stage,
     and at the ragged 392 rows of stage 3 (phase 8's batch-2 step);
     kernel 7b also with its achieved TFLOP/s and share of the bound per
     task width, its row pass's dhc and z against their plain version,
     and at the ragged 784 rows of one 224-px image for n = 21 and 1;
     kernel 2b (both modes) also with its achieved TFLOP/s, share of the
     bound and weight-slice rate per stage, and its row kernel's stored
     rows (lnd, m, dm; the tail's du) against their plain version; y-only
     also at the ragged 392 rows of stage 3, rank 16, Swin-B's
     [6272, 1024] -> 3072 and scale 3, the tail mode at the ragged 392
     rows of stage 3, ranks 16 and 32 and Swin-B's [6272, 1024] -> 4096;
     kernel 3b also with its stored rows (lnd) against their plain
     version, its share of the bound and W's slot rate per merge, and at
     Swin-B's last merge [6272, 2048] -> 1024, path B's 14 -> 7 merge (odd
     Wh) and the ragged 392 rows of the batch-2 step's last merge;
     kernel 2's tail mode also with its share of the byte bound and its
     output TB/s per stage, and at the ragged 392 rows, with GELU off,
     without dropout(y) (the serve form), ranks 16 and 32 and Swin-B's
     [6272, 1024] -> 4096; kernels 5 and 5b also with their plans,
     achieved TFLOP/s and share of both bounds (the rank products counted
     on the tensor cores, and all in fp32) per stage, two launches
     bit-identical, and at one and three tasks, the ragged 392 rows, 389
     rows and Swin-B's H4 = 4096 (ADAPTER_COVERAGE), kernel 5 also at
     path B's 1,568 stage-3 rows;
  3c. the GELU form: kernels 2-tail, 4, 4b, 5 and 5b at stage 1 against
     their plain versions, which take the tanh form in bf16 as the JAX
     kernels do, with the distance to the exact-erf form beside it; the
     probe kernels of the JAX package's tools/ against their plain
     versions with the same four numbers, at every shape the probe path
     gives them: kernel 1's body with a part switched (five modes, the
     four stage shapes, shifted and not), the quad-operand attention (the
     four stages), kernels 5 and 5b with a part switched (eight forward,
     three backward variants, M = 32 * 12544);
then the probe path: each entry point of mtlora_tpu_torch.tools once at
its full shapes, with few launches, and the launches of every probe
kernel in that run;
then, for the adapter route (TPU.USE_PALLAS_LN and USE_PALLAS_ADAPTER on,
the JAX package's default and the main path), the LN route without the
adapter kernels, the LN-outside route (both off), path A (kernel 8 on the
adapter and the LN-outside routes) and path B (the adapter route at 224
with kernel 1c), each with its seconds per phase:
  4. serve: the flagship model (bf16, seeded random weights) answers
     requests of 1, 8 and 32 images through ``serve.predict``; shapes,
     finiteness and the exact launches of every kernel per forward;
  5. cross-check: the 1-image request (path B: the 8-image one, which
     takes kernel 1c) against the same weights run on the CPU in fp32
     through the plain versions;
  6. throughput: bf16 forward img/s at batch 32;
  7. train: the flagship at batch 32, full width and depth, adapter
     dropout and drop-path on, 3 steps of ``train.step.train_step``:
     finite losses and grad norm, exact launches per step (each forward
     kernel and its backward), frozen weights bit-unchanged, every
     trainable with a gradient changed, BatchNorm running statistics
     moved, peak memory; then the train img/s at batch 32;
  8. train cross-check: one step at batch 2 (path B: 8) with dropout and
     drop-path off, on the card in bf16 and on the CPU in fp32 through
     the plain versions, from the same weights and batch; the card step's
     exact launches (kernel 8's backward takes its dx layout here);
then, on the adapter route only:
  9. validate: ``train.loop.validate`` at batch 32 over 3 synthetic
     labelled batches (the last padded, 20 valid rows) on the bf16 kernel
     path and on the fp32 clone with every kernel off
     (``models.mtl.eval_model_for``), after the eval forward img/s of
     both paths at batch 32 and a warm-up, each loop timed and under
     ``torch.cuda.set_sync_debug_mode("error")`` (no host sync); exact
     launches (serve's per forward times 3 on the bf16 path, none on the
     clone); finite scores and their distance between the paths; the
     meters on the card against the same meters on the CPU on the same
     ``get_output`` results (first and last batch: counts equal, fp32
     sums within 1e-5 relative); the clone's validate of one 2-image
     batch (one row padded) against the same on the CPU in fp32;
  10. data: the data pipeline (``mtlora_tpu_torch.data``) feeding the
     adapter route at batch 32 and 448: a line of what the machine has
     (PIL and scipy.io importable, the cores, the loader's workers, the
     image ops' build time); epoch 0 of the train loader (SyntheticMTL
     structured, the train transforms) bit-identical with 0 workers, with
     persistent workers and over two passes, epoch 1 different; the
     loader's own img/s; 3 training steps fed by the pinned loader with
     phase 7's checks, then the train img/s fed by it against the fixed
     batch; the padded val loader over 84 samples (batches of 32, 32, 20)
     feeding validate on both eval paths under set_sync_debug_mode("error"),
     the valid rows summing to 84, exact launches, its img/s against the
     pre-built batches; where PIL imports, a 6-image PASCAL tree written
     here, read through build_loader and validated on the bf16 path;
  11. checkpoints, on the adapter route at 448 and batch 32: a
     backbone-only Swin-T ``.pth`` in the official layout (no
     ``backbone.`` prefix, plain ``qkv.weight``, window-7 tables,
     ``attn_mask``, ``relative_position_index``, the final norm, a
     1000-class head) written from seeded weights and loaded onto the
     JAX init as ``--pretrained`` loads it, its loaded, missing and
     unexpected counts equal to ``pretrained_expectation`` (which the CPU
     tests hold to the JAX package's ``merge_converted``); the loaded
     model's bf16 forward of one image with exact launches against the
     CPU fp32 forward (phase 5's bound); 3 training steps with dropout and
     drop-path on, a checkpoint, a fresh model, optimizer and generator
     loaded from it and 3 more steps, against 5 uninterrupted runs of 6
     from the same start: ``updates``, the LR and the generator state
     equal, the losses of steps 4-6 and the final trainables within twice
     the uninterrupted runs' largest pairwise distance (the bilinear
     backward adds with atomics); the file's MB, the save and load
     seconds;
  12. the CLI (``mtlora_tpu_torch.main.cli``, what ``python -m
     mtlora_tpu_torch`` runs), driven in this process on the flagship
     YAML read by the port's own reader (held equal to the preset) with
     ``--tasks semseg,normals,sal,human_parts --synthetic-data
     --batch-size 32``: 2 epochs (``--ckpt-freq 1 --eval-freq 1``) under
     ``--sync-debug error`` (a host sync inside a step fails it), exact
     launches (phase 7's a step), two checkpoints, ``config.json``,
     ``config.yaml``, ``log_rank0.txt`` and ``val_scores_r0.json``, each
     epoch's loss the mean of its steps', the epoch seconds and the
     CLI's train img/s beside phase 7's fixed batch; ``--eval --resume
     ckpt_epoch_1.pth`` against the final validate (``CLI_EVAL_REL``),
     no launch (the fp32 clone); ``--throughput``, both eval paths, exact
     launches; ``--accumulation-steps 2`` (launches of 2 microbatches an
     update, the LR scaled by 2, BN statistics updated a microbatch); a
     world-1 NCCL run from torchrun's environment against plain runs by
     phase 11's noise-floor rule;
then a JSON line of the kernels (with ``cli_launches``, each kernel's
launches in phase 12's training run), and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import re
import shutil
import time

import numpy as np

import torch
import torch.nn.functional as F

from mtlora_tpu_torch.config import tiny_448_r64_pertask
from mtlora_tpu_torch.data import native as data_native
from mtlora_tpu_torch.data.loader import (
    DataLoader,
    build_loader,
    data_node,
    epochs,
    ignore_fill_sample,
)
from mtlora_tpu_torch.data.synthetic import SyntheticMTL
from mtlora_tpu_torch.data.task_config import get_tasks_config
from mtlora_tpu_torch.data.transforms import get_transformations
from mtlora_tpu_torch.ckpt.checkpoint import (
    load_checkpoint,
    load_pretrained_,
    save_checkpoint,
)
from mtlora_tpu_torch.ckpt.torch_convert import load_unit
from mtlora_tpu_torch.config import from_config, load_config
from mtlora_tpu_torch.main import cli
from mtlora_tpu_torch.models.init import init_weights_
from mtlora_tpu_torch.models.mtl import build_mtl_model
from mtlora_tpu_torch.ops import _build, counters
from mtlora_tpu_torch.ops.attention import (
    relative_position_index,
    shift_attention_mask,
    window_attention,
)
from mtlora_tpu_torch.models.lora import droppath_coef
from mtlora_tpu_torch.ops.adapter_mlp import (
    adapter_mid_bwd,
    adapter_mid_bwd_plain,
    adapter_mid_fwd,
    adapter_mid_plain,
)
from mtlora_tpu_torch.ops.adapter_mlp import bwd_plan as adapter_bwd_plan
from mtlora_tpu_torch.ops.adapter_mlp import fwd_plan as adapter_fwd_plan
from mtlora_tpu_torch.ops.ln_lora import (
    ln_lora_bwd,
    ln_lora_bwd_kernel,
    ln_lora_bwd_plain,
    ln_lora_bwd_rows_plain,
    ln_lora_fwd,
    ln_lora_plain,
    ln_lora_tail_bwd,
    ln_lora_tail_bwd_kernel,
    ln_lora_tail_bwd_plain,
    ln_lora_tail_bwd_rows_plain,
    ln_lora_tail_fwd,
    ln_lora_tail_plain,
    merge_bwd_plan,
    merge_bwd_scratch,
    merge_fwd_plan,
    merge_ln_bwd,
    merge_ln_bwd_kernel,
    merge_ln_bwd_plain,
    merge_ln_bwd_rows_plain,
    merge_ln_fwd,
    merge_ln_plain,
    qkv_bwd_plan,
    qkv_bwd_scratch,
    qkv_fwd_plan,
    tail_bwd_plan,
    tail_bwd_scratch,
    tail_fwd_plan,
)
from mtlora_tpu_torch.ops.task_merge import (
    rank_operands,
    task_merge_bwd,
    task_merge_bwd_kernel,
    task_merge_bwd_plain,
    task_merge_bwd_plan,
    task_merge_bwd_rows_plain,
    task_merge_bwd_scratch,
    task_merge_fwd,
    task_merge_fwd_plan,
    task_merge_plain,
)
from mtlora_tpu_torch.ops.lora_matmul import (
    lora_matmul_dx,
    lora_matmul_dx_plain,
    lora_matmul_fwd,
    lora_matmul_plain,
)
from mtlora_tpu_torch.ops.ln_mlp import (
    bwd_plan,
    fwd_plan,
    ln_mlp_bwd,
    ln_mlp_bwd_plain,
    ln_mlp_fwd,
    ln_mlp_plain,
)
from mtlora_tpu_torch.ops.head import (
    bwd_scratch,
    head_bwd_rows_plain,
    head_mlp_bwd,
    head_mlp_bwd_kernel,
    head_mlp_bwd_plain,
    head_mlp_fwd,
    head_mlp_plain,
)
from mtlora_tpu_torch.ops.head import bwd_plan as head_bwd_plan
from mtlora_tpu_torch.ops.head import fwd_plan as head_fwd_plan
from mtlora_tpu_torch.ops.window_attn import (
    dense_applies,
    window_attention_bwd,
    window_attention_bwd_plain,
    window_attention_dense_bwd,
    window_attention_dense_fwd,
    window_attention_fwd,
)
from mtlora_tpu_torch.ops.window_attn import fwd_plan as attn_fwd_plan
from mtlora_tpu_torch.serve import (
    initial_model,
    predict,
    random_model,
    synthetic_images,
    throughput,
)
from mtlora_tpu_torch.train.optim import (
    TrainConfig,
    build_optimizer,
    build_schedule,
)
from mtlora_tpu_torch.train.step import (
    device_batch,
    synthetic_batch,
    synthetic_eval_batches,
    train_step,
)
from mtlora_tpu_torch.evaluation.meters import PerformanceMeter, get_output
from mtlora_tpu_torch.train.loop import throughput as eval_throughput
from mtlora_tpu_torch.train.loop import validate
from mtlora_tpu_torch.ops import adapter_mlp, ln_lora
from mtlora_tpu_torch.ops.adapter_mlp import (
    BWD_PROBES,
    FWD_PROBES,
    adapter_mid_bwd_probe,
    adapter_mid_bwd_probe_plain,
    adapter_mid_probe,
    adapter_mid_probe_plain,
)
from mtlora_tpu_torch.ops.quad_attn import (
    quad_attention,
    quad_attention_plain,
)
from mtlora_tpu_torch.ops.window_attn import (
    PROBE_MODES,
    UNMASKED_MODES,
    window_attention_probe,
    window_attention_probe_plain,
)
from mtlora_tpu_torch.tools import (
    adapter_variants,
    attn_probe,
    card_line,
    median_ms,
)

SEED = 0
# phase 7's fixed-batch train img/s, by path (the first route of each)
TRAIN_RATES = {}
REQUESTS = (1, 8, 32)
THROUGHPUT_BATCH = 32
TRAIN_BATCH = 32
# the kernels are checked and timed at the training step's shapes
KERNEL_BATCH = TRAIN_BATCH
TRAIN_STEPS = 3
TRAIN_TIMED = 5
CROSS_BATCH = 2
ITERS_PER_EPOCH = 1000
# published peaks of one H100 SXM (dense bf16 tensor cores, fp32 outside
# the tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# fp32 operations counted per element of an activation form, alone and
# with its derivative: the exact erf (CUDA's erff is a polynomial of about
# 13 fused multiply-adds; its derivative adds an exp), the tanh form
# (tanhf about 12 operations, the form's own 6, the derivative 8 more),
# the sigmoid form (expf and an exact divide about 14, its own 5, the
# derivative 8 more); the kernels' GELU is the tanh form
ACT_OPS = {"erf": (20, 30), "tanh": (18, 26), "sig": (19, 27),
           "none": (0, 0)}
GELU_OPS, GELU_PAIR_OPS = ACT_OPS["tanh"]
# kernel vs plain, both bf16 on the card: outputs agree up to the order of
# fp32 sums, which can flip a bf16 rounding of P (attention) or of the
# hidden (head) and of the output. Attention outputs are convex mixes of v
# (|v| < 6 here), the head's |y| < 4: 2^-5 is two bf16 ulps at |y| = 4.
KERNEL_ATOL = 2.0 ** -5
# attention backward, kernel vs plain on the card: dqkv (bf16) within two
# bf16 ulps of its largest element, 2^-6 relative (a flipped last bit, as
# above); dbias (fp32), sums over up to 8,192 windows in another order,
# within 1e-4 of its largest element.
BWD_BF16_REL = 2.0 ** -6
BWD_FP32_REL = 1e-4
# head backward: the kernel and the plain version accumulate h in other
# orders, so a hidden unit whose bf16 pre-activation sits at 0 can take
# the other side of the ReLU and change a whole term of a gradient: of
# dx, dWe, dWp, and of the column sums dbe, dmul, dadd, where one flipped
# row moves a sum of 100,352 terms of random sign by ~1/317 of itself.
# The relative RMS error of every output is bounded at 2^-7 (the bf16
# rounding alone is ~2^-10 RMS, one flip per column ~2^-7); the largest
# error, a gross check, within 2^-3 of the largest element.
HEAD_BWD_RMS = 2.0 ** -7
HEAD_BWD_MAX_REL = 2.0 ** -3
# kernel 7b's row pass, dhc and z elementwise against head_bwd_rows_plain:
# each element within two bf16 ulps (2^-6 of itself), but where the
# hidden's bf16 rounding flipped it across the ReLU (a whole value, as
# above) or where bf16(hc mul) + add cancels: those at most 2^-10 of the
# elements; the relative RMS error at the head backward's 2^-7.
HEAD_ROWS_REL = 2.0 ** -6
HEAD_ROWS_SHARE = 2.0 ** -10
# kernels 2, 3, 4 vs their plain versions, both bf16 on the card: the bf16
# outputs (y, dx) within 2^-6 of their largest element (a last bit flipped
# where fp32 sums taken in another order round the other way, or where a
# bf16 intermediate -- ln, m, g -- does); the fp32 sums over up to 401,408
# rows (dgamma, dbeta, the adapters' and the reduction's gradients) at the
# head backward's bounds: relative RMS <= 2^-7, largest error <= 2^-3 of
# the largest element.
LN_BF16_REL = 2.0 ** -6
# card (bf16, 12 blocks) vs CPU (fp32): relative RMS error of each task's
# logits; bf16 keeps 8 bits (rel. step 2^-8 = 3.9e-3), and ~40 rounded
# ops in a row grow that to about 1e-2.
CROSS_REL_RMS = 5e-2
# train step, card bf16 vs CPU fp32, same weights and batch: each task's
# loss is a mean over 2*448^2 pixels of a smooth function of logits that
# carry ~1e-2 relative error (phase 5), which averages down: 2e-2 leaves
# margin. The gradients also pass the bf16 backward of 12 blocks (dqkv,
# dx and the activation grads rounded at every layer), ~1e-2 per element
# and more where terms cancel: the norm at 5e-2. Elementwise relative
# errors of eps leave a cosine of about 1 - eps^2 / 2: 0.98 allows
# eps ~ 0.2 on the flattened trainable gradient.
TRAIN_LOSS_REL = 2e-2
TRAIN_GRAD_NORM_REL = 5e-2
TRAIN_GRAD_COSINE = 0.98
# phase 9: validate over 3 batches of 32, the last with 20 valid rows
EVAL_BATCHES = 3
EVAL_VALID_LAST = 20
# meters, card vs CPU on the same get_output results: the confusion and
# pixel counts are integers of integer inputs and equal; the fp32 sums
# (angles, per-image ratios) differ by their order of summation only.
# The threshold counts (normals' angles under 11.25, 22.5, 30 degrees, the
# saliency's double sigmoid over 19 thresholds) count fp32 values that the
# card's and the CPU's acos or sigmoid give an ulp apart, so a pixel
# within an ulp of a threshold can fall on the other side: O(1) pixels of
# the 6.4 M a batch tests; bound 1e-6 of the pixels tested
METER_SUM_REL = 1e-5
METER_SUM_KEYS = ("v1_sum", "v2_sum", "jac_sum", "prec_sum", "rec_sum",
                  "sq", "log_sq", "loss")
# (task, key) -> the count's scale in the state (normals keep 100 x count)
METER_THRESHOLD_COUNTS = {("normals", "v1_1125"): 100.0,
                          ("normals", "v1_225"): 100.0,
                          ("normals", "v1_30"): 100.0,
                          ("sal", "tp"): 1.0, ("sal", "pred_pos"): 1.0}
METER_FLIP_SHARE = 1e-6
# the fp32 clone on the card (TF32 off) vs the same on the CPU, one image
# of 448^2 pixels: the logits differ by fp32 round-off (~1e-6 relative),
# so the loss averages agree to ~1e-6 and 1e-4 leaves margin; a score moves
# only where a pixel's argmax or a threshold test flips, each flip
# 1 / (tp + fp + fn) of an IoU (~5e-5 here) or 100 / 200,704 of a
# normals percentage: 1e-3 absolute allows about 2 flips in one number
EVAL_LOSS_REL = 1e-4
EVAL_SCORE_ABS = 1e-3


def ops_seconds(flops, fp32_ops=0.0) -> float:
    """Least time of the operations: the tensor-core products at the bf16
    rate and the fp32 work outside the tensor cores at its rate, the two
    units running at once."""
    return max(flops / PEAK_BF16_FLOPS, fp32_ops / PEAK_FP32_FLOPS)


class Tally:
    """Sums of one kernel's numbers over the shapes it is checked at."""

    def __init__(self):
        self.err = self.ms = self.plain = self.lib = 0.0
        self.bound = {"bytes": 0.0, "operations": 0.0}

    def add(self, err, ms, plain, lib, nbytes, flops, weight=1, fp32_ops=0.0):
        """``weight``: the launches of this shape per pass (the sites of a
        forward that take it), so that the sums are per pass; ``fp32_ops``:
        operations on the CUDA cores (GELU, rank-4 products); ``lib`` None
        where no PyTorch call computes the function (then the sum is
        None). The pass's bound is the sum of each shape's own bound
        (:func:`bound_text`): the least time of its shapes run one after
        another."""
        self.err = max(self.err, err)
        self.ms += weight * ms
        self.plain += weight * plain
        self.lib = (None if lib is None or self.lib is None
                    else self.lib + weight * lib)
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        t_ops = ops_seconds(flops, fp32_ops) * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        self.bound[by] += weight * max(t_bytes, t_ops)

    def json(self) -> dict:
        """``bound_by``: the term that bounds the shapes that take most of
        the bound."""
        b = self.bound
        return {"max_abs_err": self.err, "ms": self.ms,
                "plain_ms": self.plain,
                "bound_ms": b["bytes"] + b["operations"],
                "bound_by": ("bytes" if b["bytes"] >= b["operations"]
                             else "operations"),
                "library_ms": self.lib}


def bound_text(nbytes, flops, fp32_ops=0.0) -> str:
    t = max(nbytes / PEAK_HBM_BYTES, ops_seconds(flops, fp32_ops)) * 1e3
    return (f"bound {t:.4f} ms ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
            f"GFLOP bf16, {fp32_ops / 1e9:.2f} GFLOP fp32)")


def attention_shapes(gen):
    """Per stage and shift: (qkv, dO, bias, mask, nH, nW, scale)."""
    cfg = tiny_448_r64_pertask()
    for s in range(4):
        res = cfg.img_size // cfg.patch_size // 2 ** s
        C, nH, ws = cfg.embed_dim * 2 ** s, cfg.num_heads[s], cfg.window_size
        nW = (res // ws) ** 2
        N = ws * ws
        qkv = torch.randn(KERNEL_BATCH * nW, N, 3 * C, generator=gen,
                          device="cuda").to(torch.bfloat16)
        dout = torch.randn(KERNEL_BATCH * nW, N, C, generator=gen,
                           device="cuda").to(torch.bfloat16)
        bias = 0.1 * torch.randn(nH, N, N, generator=gen, device="cuda")
        scale = (C // nH) ** -0.5
        for shift in (0, ws // 2):
            mask = (torch.from_numpy(shift_attention_mask(
                res, res, ws, shift)).cuda() if shift else None)
            yield s, shift, qkv, dout, bias, mask, nH, nW, scale


def sdpa_operands(qkv, bias, mask, nH, nW):
    """q, k, v [B*nW, nH, N, hd] and the bias + mask as one bf16 float
    mask [B*nW, nH, N, N], for F.scaled_dot_product_attention."""
    Bw, N, C3 = qkv.shape
    hd = C3 // 3 // nH
    x = qkv.view(Bw, N, 3, nH, hd).permute(2, 0, 3, 1, 4)
    q, k, v = (t.contiguous() for t in x)
    am = bias[None] if mask is None else bias[None] + mask[:, None]
    am = am[None].expand(Bw // am.shape[0], *am.shape)   # window b*nW + w
    return q, k, v, am.reshape(Bw, nH, N, N).to(torch.bfloat16).contiguous()


def attn_fwd_cost(qkv, nH, mask):
    """Bytes (qkv, bias and mask read once, the output written once) and
    bf16 FLOP of the attention forward."""
    Bw, N, C3 = qkv.shape
    mb = mask.numel() * 4 if mask is not None else 0
    nbytes = Bw * N * C3 * 2 + nH * N * N * 4 + mb + Bw * N * C3 // 3 * 2
    return nbytes, 4.0 * Bw * nH * N * N * (C3 // 3 // nH)


def check_attn_fwd(label, fn, qkv, nH, bias, mask, scale, dense):
    """Kernel 1 (``dense``: 1c) through its wrapper ``fn`` against the
    plain version: two launches bit-identical, the error within
    KERNEL_ATOL; times it and prints its plan, TFLOP/s and share of the
    bound. Returns (err, kernel ms, bytes, FLOP)."""
    out = fn(qkv, nH, bias, mask, scale)
    again = fn(qkv, nH, bias, mask, scale)
    ref = window_attention(qkv, nH, bias, mask, scale)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert torch.equal(out, again), f"{label}: two launches differ"
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= KERNEL_ATOL, f"{label}: attention disagrees: {err}"
    t_k = median_ms(lambda: fn(qkv, nH, bias, mask, scale))
    Bw, N, C3 = qkv.shape
    plan = attn_fwd_plan(Bw, N, nH,
                         mask.shape[0] if mask is not None else 0, dense,
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count, C3 // 3 // nH)
    nbytes, flops = attn_fwd_cost(qkv, nH, mask)
    t_b = nbytes / PEAK_HBM_BYTES * 1e3
    print(f"{label} plan: {plan.group} windows a block, {plan.blocks} "
          f"blocks, {plan.per_sm} an SM, {plan.buffers} buffers, "
          f"{plan.tiles} resident mask tiles, {plan.smem} B; "
          f"{flops / t_k / 1e9:.2f} TFLOP/s, {t_b / t_k:.4f} of the bound; "
          f"two launches bit-identical")
    return err, t_k, nbytes, flops


# kernels 1 and 1c's coverage (checked, bit-identical, timed; not in the
# tally): (label, batch, nW, C, heads, shifted) -- the batch-2 step's
# stages (phase 8), Swin-B's stage 0 and stage 3 (448 px, head dim 32),
# shifted
ATTN_COVERAGE = tuple(
    (f"batch 2 stage {s} shift {sh}", CROSS_BATCH, (16 // 2 ** s) ** 2,
     96 * 2 ** s, 3 * 2 ** s, sh) for s in range(4) for sh in (0, 3)) + (
    ("swin-b stage 0 shift 3", KERNEL_BATCH, 256, 128, 4, 3),
    ("swin-b stage 3 shift 3", KERNEL_BATCH, 4, 1024, 32, 3))


def coverage_operands(gen, batch, nW, C, nH, shift):
    """qkv, bias, mask, scale of an attention coverage shape (window 7)."""
    res = 7 * int(round(nW ** 0.5))
    qkv = torch.randn(batch * nW, 49, 3 * C, generator=gen,
                      device="cuda").to(torch.bfloat16)
    bias = 0.1 * torch.randn(nH, 49, 49, generator=gen, device="cuda")
    mask = (torch.from_numpy(shift_attention_mask(res, res, 7, shift)).cuda()
            if shift else None)
    return qkv, bias, mask, (C // nH) ** -0.5


def check_attention(gen) -> dict:
    """Kernels 1 and 1b against their plain versions at the four stage
    shapes, shifted and not; each shape weighted by its blocks (half the
    stage's depth), so that the sums are per pass over the 12 blocks.
    Kernel 1 also at ``ATTN_COVERAGE``."""
    fwd, bwd = Tally(), Tally()
    depths = tiny_448_r64_pertask().depths
    for s, shift, qkv, dout, bias, mask, nH, nW, scale in attention_shapes(gen):
        Bw, N, C3 = qkv.shape
        C, hd = C3 // 3, C3 // 3 // nH
        sites = depths[s] // 2
        mb = nW * N * N * 4 if mask is not None else 0
        # forward
        label = f"attention fwd stage {s} qkv {tuple(qkv.shape)} nH {nH} " \
                f"shift {shift}"
        err, t_k, nbytes, flops = check_attn_fwd(
            label, window_attention_fwd, qkv, nH, bias, mask, scale, False)
        q, k, v, am = sdpa_operands(qkv, bias, mask, nH, nW)
        t_p = median_ms(lambda: window_attention(qkv, nH, bias, mask, scale))
        t_l = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=am, scale=scale))
        print(f"{label}: max_abs_err {err:.3e} (bound "
              f"{KERNEL_ATOL:.3e}) kernel {t_k:.4f} ms plain {t_p:.4f} ms "
              f"sdpa {t_l:.4f} ms {bound_text(nbytes, flops)}")
        fwd.add(err, t_k, t_p, t_l, nbytes, flops, sites)
        # backward
        dq, db = window_attention_bwd(qkv, nH, bias, mask, scale, dout)
        rq, rb = window_attention_bwd_plain(qkv, nH, bias, mask, scale, dout)
        torch.cuda.synchronize()
        assert dq.shape == qkv.shape and dq.dtype == torch.bfloat16
        assert db.shape == bias.shape and db.dtype == torch.float32
        e_q = (dq.float() - rq.float()).abs().max().item()
        e_b = (db - rb).abs().max().item()
        b_q = BWD_BF16_REL * rq.float().abs().max().item()
        b_b = BWD_FP32_REL * rb.abs().max().item()
        for t in (q, k, v):
            t.requires_grad_(True)
        y = F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                           scale=scale)
        g = dout.view(Bw, N, nH, hd).transpose(1, 2).contiguous()
        t_k = median_ms(lambda: window_attention_bwd(qkv, nH, bias, mask,
                                                     scale, dout))
        t_p = median_ms(lambda: window_attention_bwd_plain(
            qkv, nH, bias, mask, scale, dout))
        t_l = median_ms(lambda: torch.autograd.grad(
            y, (q, k, v), g, retain_graph=True))
        nbytes = (2 * Bw * N * C3 * 2 + Bw * N * C * 2 + 2 * nH * N * N * 4
                  + mb)
        flops = 10.0 * Bw * nH * N * N * hd
        print(f"attention bwd stage {s} shift {shift}: dqkv max_abs_err "
              f"{e_q:.3e} (bound {b_q:.3e}) dbias max_abs_err {e_b:.3e} "
              f"(bound {b_b:.3e}) kernel {t_k:.4f} ms plain {t_p:.4f} ms "
              f"sdpa backward {t_l:.4f} ms {bound_text(nbytes, flops)}")
        assert e_q <= b_q and e_b <= b_b, "attention backward disagrees"
        bwd.add(max(e_q, e_b), t_k, t_p, t_l, nbytes, flops, sites)
    for label, batch, nW, C, nH, shift in ATTN_COVERAGE:
        qkv, bias, mask, scale = coverage_operands(gen, batch, nW, C, nH,
                                                   shift)
        label = f"attention fwd {label} qkv {tuple(qkv.shape)} nH {nH}"
        err, t_k, nbytes, flops = check_attn_fwd(
            label, window_attention_fwd, qkv, nH, bias, mask, scale, False)
        print(f"{label}: max_abs_err {err:.3e} (bound {KERNEL_ATOL:.3e}) "
              f"kernel {t_k:.4f} ms {bound_text(nbytes, flops)}")
    return {"fwd": fwd, "bwd": bwd}


def head_library(x, ek, eb, mul, add, pk, pb):
    """The head through two bf16 cuBLAS GEMMs with the affine and ReLU
    between them."""
    h = torch.addmm(eb, x, ek)
    return torch.addmm(pb, torch.relu(h * mul + add), pk)


def head_bwd_errors(args, gy) -> tuple:
    """Kernel 7b against the plain backward: the seven gradients, then the
    row pass's dhc and z (left in the kernel's scratch) against
    ``head_bwd_rows_plain``, so that a fault shows in the pass that made
    it: the gradients within the head backward's bounds, dhc and z within
    the row pass's. Returns the gradients' largest error and the text."""
    x, ek, eb, mul, add, pk, _ = args
    sc = bwd_scratch(head_bwd_plan(*x.shape, ek.shape[1], pk.shape[1],
                                   ln_lora._sms(x.device)), x.device)
    got = head_mlp_bwd_kernel(*args, gy, scratch=sc)
    want = head_mlp_bwd_plain(*args, gy)
    _, dhc, z, *_ = head_bwd_rows_plain(x, ek, eb, mul, add, pk, gy)
    torch.cuda.synchronize()
    names = ("dx", "dWe", "dbe", "dmul", "dadd", "dWp", "dbp", "dhc", "z")
    worst, parts = 0.0, []
    for name, a, b in zip(names, (*got, sc["dhc"], sc["z"]),
                          (*want, dhc, z)):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        d = a.float() - b.float()
        e = d.abs().max().item()
        rms = (d.norm() / b.float().norm()).item()
        parts.append(f"{name} {e:.2e} rel_rms {rms:.2e}")
        assert rms <= HEAD_BWD_RMS, f"head backward {name}: {rms}"
        if name in ("dhc", "z"):
            share = (d.abs() > HEAD_ROWS_REL * b.float().abs()).float()
            share = share.mean().item()
            parts[-1] += f" off {share:.2e}"
            assert share <= HEAD_ROWS_SHARE, f"head rows {name}: {share}"
            continue
        assert e <= HEAD_BWD_MAX_REL * b.float().abs().max().item(), name
        worst = max(worst, e)
    return worst, " ".join(parts)


def head_operands(gen, M, n, weights):
    """x [M, C], Wp [n, O] (the 1x1 conv layout, passed as a transposed
    view, as the model's head passes it), pb and gy [M, n] beside the
    given ``(ek, eb, mul, add)``."""
    ek, eb, mul, add = weights
    C, O = ek.shape
    x = torch.randn(M, C, generator=gen, device="cuda").to(torch.bfloat16)
    pk = ((torch.rand(n, O, generator=gen, device="cuda") * 2 - 1)
          * O ** -0.5).to(torch.bfloat16).t()
    pb = 0.02 * torch.randn(1, n, generator=gen, device="cuda")
    gy = (torch.randn(M, n, generator=gen, device="cuda")
          * M ** -0.5).to(torch.bfloat16)
    return (x, ek, eb, mul, add, pk, pb), gy


# one 224-px image: 28 * 28 rows at the head, not a multiple of kernel
# 7b's 64-row blocks
HEAD_RAGGED_ROWS = 784
# kernel 7's coverage (checked at the four task widths and timed, not in
# the tally): (label, rows) -- one 224-px image (784 rows, not a multiple
# of the 128-row tiles, 7 tiles on 7 SMs), path B's head at batch 32 and 8
# (224 px: 28^2 rows an image)
HEAD_COVERAGE = (("one 224-px image", HEAD_RAGGED_ROWS),
                 ("path B batch 32", KERNEL_BATCH * 28 * 28),
                 ("path B batch 8", 8 * 28 * 28))


def head_plan_text(plan, t_k) -> str:
    """Kernel 7's plan and the rate of its ring's stages in ``t_k`` ms."""
    return (f"{plan.rows}-row tiles, {plan.tiles} tiles on {plan.blocks} "
            f"blocks, Wp^T slot {plan.np} rows, ring {plan.stages}, "
            f"{plan.smem} bytes, slots {plan.slot_bytes / 1e9:.3f} GB, "
            f"{plan.slot_bytes / t_k / 1e9:.3f} TB/s")


def check_head_fwd(label, args):
    """Kernel 7 against ``head_mlp_plain``: y, bf16, within
    ``KERNEL_ATOL``. Returns (error, plan, |y| max)."""
    x, ek, pk = args[0], args[1], args[5]
    plan = head_fwd_plan(*x.shape, ek.shape[1], pk.shape[1],
                         ln_lora._sms(x.device))
    out = head_mlp_fwd(*args)
    ref = head_mlp_plain(*args)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == torch.bfloat16, label
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= KERNEL_ATOL, f"{label}: head disagrees: {err}"
    return err, plan, ref.float().abs().max().item()


def check_head(gen) -> dict:
    """Kernel 7 and 7b at the four task widths of the batch-32 step, 7
    with its plan, rate, share of the bound and the bytes of its ring's
    stages; 7 also at ``HEAD_COVERAGE``, 7b at the ragged rows of one
    224-px image for n = 21 and n = 1 (checked, not in the tally)."""
    cfg = tiny_448_r64_pertask()
    res = cfg.img_size // cfg.patch_size // 2
    M, C = KERNEL_BATCH * res * res, sum(cfg.decoder_channels)
    O = 4 * C
    x = torch.randn(M, C, generator=gen, device="cuda").to(torch.bfloat16)
    # weights in the 1x1 conv layout, passed as transposed views, as the
    # model's head passes them
    ek = (torch.rand(O, C, generator=gen, device="cuda") * 2 - 1) * C ** -0.5
    ek = ek.to(torch.bfloat16).t()
    eb = 0.02 * torch.randn(1, O, generator=gen, device="cuda")
    mul = 0.5 + torch.rand(1, O, generator=gen, device="cuda")
    add = 0.1 * torch.randn(1, O, generator=gen, device="cuda")
    fwd, bwd = Tally(), Tally()
    slots = 0
    for n in cfg.num_outputs:
        pk = ((torch.rand(n, O, generator=gen, device="cuda") * 2 - 1)
              * O ** -0.5).to(torch.bfloat16).t()
        pb = 0.02 * torch.randn(1, n, generator=gen, device="cuda")
        gy = (torch.randn(M, n, generator=gen, device="cuda")
              * M ** -0.5).to(torch.bfloat16)
        args = (x, ek, eb, mul, add, pk, pb)
        lib_args = [a.to(torch.bfloat16).contiguous() for a in args]
        # forward
        err, plan, top = check_head_fwd(f"head fwd n {n}", args)
        t_k = median_ms(lambda: head_mlp_fwd(*args))
        t_p = median_ms(lambda: head_mlp_plain(*args))
        t_l = median_ms(lambda: head_library(*lib_args))
        w_bytes = C * O * 2 + 3 * O * 4 + O * n * 2 + n * 4
        nbytes = M * C * 2 + w_bytes + M * n * 2
        flops = 2.0 * M * C * O + 2.0 * M * O * n
        t_b = max(nbytes / PEAK_HBM_BYTES, ops_seconds(flops)) * 1e3
        print(f"head fwd M {M} C {C} hidden {O} n {n}: max_abs_err "
              f"{err:.3e} (bound {KERNEL_ATOL:.3e}, |y| max {top:.3f}) "
              f"kernel {t_k:.4f} ms ({flops / t_k / 1e9:.2f} TFLOP/s, "
              f"{t_b / t_k:.4f} of the bound; {head_plan_text(plan, t_k)}) "
              f"plain {t_p:.4f} ms cublas {t_l:.4f} ms "
              f"{bound_text(nbytes, flops)}")
        fwd.add(err, t_k, t_p, t_l, nbytes, flops)
        slots += plan.slot_bytes
        # backward
        worst, text = head_bwd_errors(args, gy)
        leaves = [a.detach().requires_grad_(True) for a in lib_args]
        y = head_library(*leaves)
        t_k = median_ms(lambda: head_mlp_bwd(*args, gy))
        t_p = median_ms(lambda: head_mlp_bwd_plain(*args, gy))
        t_l = median_ms(lambda: torch.autograd.grad(y, leaves, gy,
                                                    retain_graph=True))
        nbytes = 2 * M * C * 2 + M * n * 2 + 2 * w_bytes
        flops = 6.0 * M * C * O + 4.0 * M * O * n
        t_b = max(nbytes / PEAK_HBM_BYTES, ops_seconds(flops)) * 1e3
        print(f"head bwd n {n}: max_abs_err {text} (rel_rms bound "
              f"{HEAD_BWD_RMS:.1e}) kernel {t_k:.4f} ms "
              f"({flops / t_k / 1e9:.2f} TFLOP/s, {t_b / t_k:.4f} of the "
              f"bound) plain {t_p:.4f} ms cublas backward {t_l:.4f} ms "
              f"{bound_text(nbytes, flops)}")
        bwd.add(worst, t_k, t_p, t_l, nbytes, flops)
        del y, leaves
    f = fwd.json()
    print(f"head fwd pass of the {len(cfg.num_outputs)} tasks: kernel "
          f"{f['ms']:.4f} ms ({f['bound_ms'] / f['ms']:.4f} of the bound "
          f"{f['bound_ms']:.4f} ms) cublas {f['library_ms']:.4f} ms plain "
          f"{f['plain_ms']:.4f} ms, We^T's, Wp^T's and the vectors' slots "
          f"{slots / 1e9:.3f} GB")
    # its own generator: the later checks draw the same tensors as before
    cover = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for label, rows in HEAD_COVERAGE:
        for n in cfg.num_outputs:
            args, _ = head_operands(cover, rows, n, (ek, eb, mul, add))
            shape = f"{label} x [{rows}, {C}] n {n}"
            err, plan, top = check_head_fwd(f"head fwd {shape}", args)
            t_k = median_ms(lambda: head_mlp_fwd(*args))
            print(f"head fwd {shape}: max_abs_err {err:.3e} (bound "
                  f"{KERNEL_ATOL:.3e}, |y| max {top:.3f}) kernel "
                  f"{t_k:.4f} ms ({head_plan_text(plan, t_k)})")
    # its own generator: the later checks draw the same tensors as before
    ragged = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for n in (21, 1):
        args, gy = head_operands(ragged, HEAD_RAGGED_ROWS, n,
                                 (ek, eb, mul, add))
        _, text = head_bwd_errors(args, gy)
        print(f"head bwd ragged x [{HEAD_RAGGED_ROWS}, {C}] n {n}: "
              f"max_abs_err {text}")
    return {"fwd": fwd, "bwd": bwd}


# ---------------------------------------------------------------------------
# Kernels 2, 3, 4 (the TPU.USE_PALLAS_LN route): LN + GEMM + LoRA, patch
# merge, whole MLP, forward and backward, at every site shape of the
# batch-32 step, dropout on at the flagship's rate on the same seeds.
# ---------------------------------------------------------------------------

def _uniform(gen, shape, bound):
    return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1)
            * bound).to(torch.bfloat16)


def _ln_params(gen, K):
    gamma = (0.9 + 0.2 * torch.rand(K, generator=gen, device="cuda"))
    beta = 0.02 * torch.randn(K, generator=gen, device="cuda")
    return gamma.to(torch.bfloat16), beta.to(torch.bfloat16)


def _seed(gen):
    return torch.randint(0, 2 ** 31 - 1, (2,), generator=gen, device="cuda",
                         dtype=torch.int32)


def check_outputs(label, got, want, names, bf16_idx):
    """Forward-style bound for the bf16 outputs at ``bf16_idx`` (largest
    error <= 2^-6 of the largest element), and relative RMS <= 2^-7 plus
    largest error <= 2^-3 of the largest element for the fp32 sums.
    Returns (worst error, text)."""
    worst, parts = 0.0, []
    for i, (name, a, b) in enumerate(zip(names, got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, (label, name)
        d = (a.float() - b.float())
        e = d.abs().max().item()
        top = b.float().abs().max().item()
        if i in bf16_idx:
            parts.append(f"{name} {e:.2e}/{LN_BF16_REL * top:.2e}")
            assert e <= LN_BF16_REL * top, f"{label} {name}: {e} > {top}"
        else:
            rms = (d.norm() / b.float().norm()).item()
            parts.append(f"{name} {e:.2e} rel_rms {rms:.2e}")
            assert rms <= HEAD_BWD_RMS, f"{label} {name}: rel_rms {rms}"
            assert e <= HEAD_BWD_MAX_REL * top, f"{label} {name}: {e}"
        worst = max(worst, e)
    return worst, " ".join(parts)


def stage_dims(s):
    cfg = tiny_448_r64_pertask()
    res = cfg.img_size // cfg.patch_size // 2 ** s
    C = cfg.embed_dim * 2 ** s
    return cfg, res, C, KERNEL_BATCH * res * res


def ln_lora_library(x, gamma, beta, wt, bias, at, bt, scale):
    ln = F.layer_norm(x, (x.shape[1],), gamma, beta, 1e-5)
    return torch.addmm(bias, ln, wt.t()) + scale * ((ln @ at.t()) @ bt.t())


def qkv_operands(gen, M, C, r, sc, p):
    """Kernel 2's operands at a qkv site: x [M, C] -> 3C, rank r, scale sc,
    dropout p, and gy: (args, gy)."""
    O = 3 * C
    x = torch.randn(M, C, generator=gen, device="cuda").to(torch.bfloat16)
    gamma, beta = _ln_params(gen, C)
    wt = _uniform(gen, (O, C), C ** -0.5)
    bias = _uniform(gen, (O,), 0.02)
    at = _uniform(gen, (r, C), C ** -0.5)
    bt = _uniform(gen, (O, r), r ** -0.5)
    seed = _seed(gen)
    gy = torch.randn(M, O, generator=gen, device="cuda").to(torch.bfloat16)
    return (x, gamma, beta, wt, bias, at, bt, seed, sc, p), gy


def check_qkv_rows(label, args, gy):
    """Kernel 2b (y-only) against its plain versions: the whole backward
    against ``ln_lora_bwd_plain`` and the row kernel's stored rows (lnd,
    m, dm; bf16, within 2^-6 of the largest element) against
    ``ln_lora_bwd_rows_plain``. Returns (worst error of the backward,
    text)."""
    x, wt, at = args[0], args[3], args[5]
    plan = qkv_bwd_plan(x.shape[0], x.shape[1], wt.shape[0], at.shape[0],
                        ln_lora._sms(x.device))
    sc = qkv_bwd_scratch(plan, x.device)
    got = ln_lora_bwd_kernel(*args, gy, scratch=sc)
    want = ln_lora_bwd_plain(*args, gy)
    torch.cuda.synchronize()
    err, text = check_outputs(label, got, want,
                              ("dx", "dgamma", "dbeta", "dA", "dB"), {0})
    del got, want
    rows = (sc["lnd"], sc["mbuf"][0], sc["mbuf"][1])
    want = ln_lora_bwd_rows_plain(*args, gy)[3:]
    _, rtext = check_outputs(f"{label} rows", rows, want, ("lnd", "m", "dm"),
                             {0, 1, 2})
    return err, f"{text}; rows {rtext}"


# phase 8's batch-2 step at stage 3 (and path B's batch 8 at 224): 392 rows,
# not a multiple of kernel 4b's 32-row blocks
RAGGED_ROWS = 392


# kernel 2's and 2b's coverage (checked, not in the tally): (label, M, C,
# r, scale) -- the ragged 392 rows of stage 3 (the batch-2 step), rank 16
# (the r16 YAMLs) at stage 0's width (O = 288: a half-filled last chunk),
# Swin-B's last stage (mtlora_base_448's qkv, [6272, 1024] -> 3072), and a
# scale that is not a power of two, all at dropout 0.05
QKV_COVERAGE = (("ragged", RAGGED_ROWS, 768, 64, 4.0),
                ("r16", 50176, 96, 16, 4.0),
                ("swin-b stage 3", 6272, 1024, 64, 4.0),
                ("scale 3", 6272, 768, 64, 3.0))
# kernel 2's alone: (label, M, C, r, scale, dropout) -- scale 0 (z = p: no
# mask drawn) where two warps share rows, dropout off at stage 0's width
QKV_FWD_COVERAGE = (("scale 0", 6272, 768, 64, 0.0, 0.05),
                    ("dropout 0", 50176, 96, 64, 4.0, 0.0))


def check_qkv_fwd(label, args):
    """Kernel 2 (the qkv mode) against ``ln_lora_plain``: y, bf16, within
    2^-6 of the largest element. Returns (worst error, text)."""
    y = ln_lora_fwd(*args)
    ref = ln_lora_plain(*args)
    torch.cuda.synchronize()
    return check_outputs(label, [y], [ref], ["y"], {0})


def check_ln_lora(gen) -> dict:
    """Kernel 2 at the qkv sites: per stage x [M, C] -> [M, 3C], rank 64,
    scale 4, dropout 0.05; weighted by the stage's blocks. Both directions
    with their plan, achieved TFLOP/s, share of the bound and weight-slot
    rate per stage, the backward (2b) also with its stored rows; both at
    ``QKV_COVERAGE``, the forward also at ``QKV_FWD_COVERAGE`` (checked,
    not in the tally)."""
    fwd, bwd = Tally(), Tally()
    for s in range(4):
        cfg, _, C, M = stage_dims(s)
        st = cfg.stages[s]
        args, gy = qkv_operands(gen, M, C, st.r_shared, st.shared_scale,
                                st.dropout)
        x, gamma, beta, wt, bias, at, bt, seed, sc, p = args
        O, r = wt.shape[0], at.shape[0]
        lib_args = (x, gamma, beta, wt, bias, at, bt, sc)
        n = cfg.depths[s]
        err, text = check_qkv_fwd(f"ln_lora fwd stage {s}", args)
        t_k = median_ms(lambda: ln_lora_fwd(*args))
        t_p = median_ms(lambda: ln_lora_plain(*args))
        t_l = median_ms(lambda: ln_lora_library(*lib_args))
        w_bytes = 2 * (O * C + O + r * C + O * r + 2 * C)
        nbytes = 2 * M * (C + O) + w_bytes
        flops = 2.0 * M * (C * O + C * r + r * O)
        t_b = max(nbytes / PEAK_HBM_BYTES, ops_seconds(flops)) * 1e3
        plan = qkv_fwd_plan(M, C, O, r, ln_lora._sms(x.device))
        print(f"ln_lora fwd stage {s} x [{M}, {C}] -> {O} (x{n}): {text} "
              f"kernel {t_k:.4f} ms ({flops / t_k / 1e9:.2f} TFLOP/s, "
              f"{t_b / t_k:.4f} of the bound; {plan.bm}-row blocks, "
              f"{plan.splits} items a row block, {plan.per_sm} blocks an SM, "
              f"ring {plan.stages}, weight slots "
              f"{plan.slice_bytes / 1e9:.3f} GB, "
              f"{plan.slice_bytes / t_k / 1e9:.3f} TB/s) plain {t_p:.4f} ms "
              f"library {t_l:.4f} ms {bound_text(nbytes, flops)}")
        fwd.add(err, t_k, t_p, t_l, nbytes, flops, n)
        err, text = check_qkv_rows(f"ln_lora bwd stage {s}", args, gy)
        leaves = [t.detach().requires_grad_(True) for t in (x, gamma, beta,
                                                            at, bt)]
        yl = ln_lora_library(leaves[0], leaves[1], leaves[2], wt, bias,
                             leaves[3], leaves[4], sc)
        t_k = median_ms(lambda: ln_lora_bwd(*args, gy))
        t_p = median_ms(lambda: ln_lora_bwd_plain(*args, gy))
        t_l = median_ms(lambda: torch.autograd.grad(yl, leaves, gy,
                                                    retain_graph=True))
        nbytes = 2 * M * (2 * C + O) + 2 * w_bytes
        flops = 2.0 * M * (O * C + 3 * C * r + 2 * O * r)
        t_b = max(nbytes / PEAK_HBM_BYTES, ops_seconds(flops)) * 1e3
        plan = qkv_bwd_plan(M, C, O, r, ln_lora._sms(x.device))
        print(f"ln_lora bwd stage {s}: {text} kernel {t_k:.4f} ms "
              f"({flops / t_k / 1e9:.2f} TFLOP/s, {t_b / t_k:.4f} of the "
              f"bound; {plan.bm}-row blocks, weight slices "
              f"{plan.slice_bytes / 1e9:.3f} GB, "
              f"{plan.slice_bytes / t_k / 1e9:.3f} TB/s) plain {t_p:.4f} ms "
              f"library backward {t_l:.4f} ms {bound_text(nbytes, flops)}")
        bwd.add(err, t_k, t_p, t_l, nbytes, flops, n)
        del x, gy, yl, leaves, args
    # its own generator: the later checks draw the same tensors as before
    cover = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for label, M, C, r, sc in QKV_COVERAGE:
        args, gy = qkv_operands(cover, M, C, r, sc, 0.05)
        shape = f"{label} x [{M}, {C}] -> {3 * C}, r {r}, s {sc}"
        print(f"ln_lora fwd {shape}: "
              f"{check_qkv_fwd(f'ln_lora fwd {shape}', args)[1]}")
        print(f"ln_lora bwd {shape}: "
              f"{check_qkv_rows(f'ln_lora bwd {shape}', args, gy)[1]}")
        del args, gy
    for label, M, C, r, sc, p in QKV_FWD_COVERAGE:
        args, _ = qkv_operands(cover, M, C, r, sc, p)
        shape = f"{label} x [{M}, {C}] -> {3 * C}, r {r}, s {sc}, p {p}"
        print(f"ln_lora fwd {shape}: "
              f"{check_qkv_fwd(f'ln_lora fwd {shape}', args)[1]}")
        del args
    return {"fwd": fwd, "bwd": bwd}


def merge_library(x, gamma, beta, wt, idx):
    """2x2 gather as one index_select, LN(4C), GEMM."""
    L, HW, C = x.shape
    xc = x.index_select(1, idx).reshape(L * HW // 4, 4 * C)
    ln = F.layer_norm(xc, (4 * C,), gamma, beta, 1e-5)
    return ln @ wt.t()


def merge_index(H, W, device):
    """Source token of every (merged token, quarter) in the concat order
    k = di + 2 dj."""
    i, j = torch.meshgrid(torch.arange(H // 2), torch.arange(W // 2),
                          indexing="ij")
    idx = [(2 * i + di) * W + 2 * j + dj for dj in (0, 1) for di in (0, 1)]
    return torch.stack(idx, -1).reshape(-1).to(device)


def check_merge_rows(label, args, gy):
    """Kernel 3b against its plain versions: the whole backward against
    ``merge_ln_bwd_plain`` and the row kernel's stored rows (lnd, bf16,
    within 2^-6 of the largest element) against
    ``merge_ln_bwd_rows_plain``. Returns (worst error of the backward,
    plan, text)."""
    x, wt, W = args[0], args[3], args[5]
    M, K, O = x.shape[0] * x.shape[1] // 4, 4 * x.shape[2], wt.shape[0]
    plan = merge_bwd_plan(M, K, O, W // 2, ln_lora._sms(x.device))
    sc = merge_bwd_scratch(plan, x.device)
    got = merge_ln_bwd_kernel(*args, gy, scratch=sc)
    want = merge_ln_bwd_plain(*args, gy)
    torch.cuda.synchronize()
    err, text = check_outputs(label, got, want,
                              ("dx", "dgamma", "dbeta", "dW"), {0})
    del got, want
    want = merge_ln_bwd_rows_plain(*args, gy)[3]
    _, rtext = check_outputs(f"{label} rows", [sc["lnd"]], [want], ["lnd"],
                             {0})
    return err, plan, f"{text}; rows {rtext}"


def merge_operands(gen, L, res, C):
    """Kernel 3's operands at a merge of x [L, res^2, C] -> [L, res^2 / 4,
    2C]: (args, gy)."""
    K, O = 4 * C, 2 * C
    gamma, beta = _ln_params(gen, K)
    wt = _uniform(gen, (O, K), K ** -0.5)
    x = torch.randn(L, res * res, C, generator=gen,
                    device="cuda").to(torch.bfloat16)
    gy = torch.randn(L, res * res // 4, O, generator=gen,
                     device="cuda").to(torch.bfloat16)
    return (x, gamma, beta, wt, res, res), gy


# kernels 3's and 3b's coverage (checked and timed, not in the tally):
# (label, L, res, C) -- Swin-B's last merge (mtlora_base_448's [6272, 2048]
# -> 1024),
# path B's 14 -> 7 merge at 224 px (Wh = 7, odd) and the ragged 392 rows
# of the batch-2 step's 28 -> 14 merge (phase 8)
MERGE_COVERAGE = (("swin-b 28->14", KERNEL_BATCH, 28, 512),
                  ("path B 14->7", KERNEL_BATCH, 14, 384),
                  ("ragged 28->14", CROSS_BATCH, 28, 384))


def check_merge_fwd(label, args):
    """Kernel 3 against ``merge_ln_plain``: y, bf16, within 2^-6 of the
    largest element. Returns (worst error, plan, text)."""
    x, wt, W = args[0], args[3], args[5]
    M, K, O = x.shape[0] * x.shape[1] // 4, 4 * x.shape[2], wt.shape[0]
    plan = merge_fwd_plan(M, K, O, W // 2, ln_lora._sms(x.device))
    y = merge_ln_fwd(*args)
    ref = merge_ln_plain(*args)
    torch.cuda.synchronize()
    err, text = check_outputs(label, [y], [ref], ["y"], {0})
    return err, plan, text


def plan_text(plan, t_k) -> str:
    """Kernel 3's plan and the rate of W's slots in ``t_k`` ms."""
    return (f"{plan.bm}-row blocks, {plan.splits} items a row block, "
            f"{plan.per_sm} blocks an SM, ring {plan.stages}, W's slots "
            f"{plan.slice_bytes / 1e9:.3f} GB, "
            f"{plan.slice_bytes / t_k / 1e9:.3f} TB/s")


def check_merge(gen) -> dict:
    """Kernel 3 at the three merges, for the shared stream (B rows) and the
    flattened task streams (T*B rows); the sums count the shared stream's
    shapes only, the main path's (the adapter route merges the task
    streams in kernel 6), and a line gives the task streams' sums (the LN
    route's merges of them). Both directions with their plan, share of the
    bound and W's slot rate per merge, the backward (3b) also with its
    stored rows; both at ``MERGE_COVERAGE``."""
    fwd, bwd = Tally(), Tally()
    streams = {"kernel": 0.0, "library": 0.0, "bound": 0.0}
    for s in range(3):
        cfg, res, C, _ = stage_dims(s)
        K, O = 4 * C, 2 * C
        gamma, beta = _ln_params(gen, K)
        wt = _uniform(gen, (O, K), K ** -0.5)
        idx = merge_index(res, res, "cuda")
        for L in (KERNEL_BATCH, len(cfg.tasks) * KERNEL_BATCH):
            x = torch.randn(L, res * res, C, generator=gen,
                            device="cuda").to(torch.bfloat16)
            gy = torch.randn(L, res * res // 4, O, generator=gen,
                             device="cuda").to(torch.bfloat16)
            M = L * res * res // 4
            args = (x, gamma, beta, wt, res, res)
            err, plan, text = check_merge_fwd(f"merge fwd {s} L {L}", args)
            t_k = median_ms(lambda: merge_ln_fwd(*args))
            t_p = median_ms(lambda: merge_ln_plain(*args))
            t_l = median_ms(lambda: merge_library(x, gamma, beta, wt, idx))
            nbytes = 2 * (M * K + M * O + O * K + 2 * K)
            flops = 2.0 * M * K * O
            t_b = max(nbytes / PEAK_HBM_BYTES, ops_seconds(flops)) * 1e3
            print(f"merge fwd {res}->{res // 2} L {L} x [{M}, {K}] -> {O}: "
                  f"{text} kernel {t_k:.4f} ms ({flops / t_k / 1e9:.2f} "
                  f"TFLOP/s, {t_b / t_k:.4f} of the bound; "
                  f"{plan_text(plan, t_k)}) plain {t_p:.4f} ms library "
                  f"{t_l:.4f} ms {bound_text(nbytes, flops)}")
            main = int(L == KERNEL_BATCH)
            fwd.add(err, t_k, t_p, t_l, nbytes, flops, main)
            if not main:
                for key, v in (("kernel", t_k), ("library", t_l),
                               ("bound", t_b)):
                    streams[key] += v
            err, plan, text = check_merge_rows(f"merge bwd {s} L {L}",
                                               args, gy)
            leaves = [t.detach().requires_grad_(True)
                      for t in (x, gamma, beta, wt)]
            yl = merge_library(*leaves, idx).reshape(gy.shape)
            t_k = median_ms(lambda: merge_ln_bwd(*args, gy))
            t_p = median_ms(lambda: merge_ln_bwd_plain(*args, gy))
            t_l = median_ms(lambda: torch.autograd.grad(yl, leaves, gy,
                                                        retain_graph=True))
            nbytes = 2 * (2 * M * K + M * O + O * K + 2 * K) + 4 * (O * K
                                                                + 2 * K)
            flops = 4.0 * M * K * O
            t_b = max(nbytes / PEAK_HBM_BYTES, ops_seconds(flops)) * 1e3
            print(f"merge bwd {res}->{res // 2} L {L}: {text} kernel "
                  f"{t_k:.4f} ms ({t_b / t_k:.4f} of the bound; "
                  f"{plan.bm}-row blocks in clusters of {plan.split}, W's "
                  f"slots {plan.slice_bytes / 1e9:.3f} GB, "
                  f"{plan.slice_bytes / t_k / 1e9:.3f} TB/s) plain "
                  f"{t_p:.4f} ms library backward {t_l:.4f} ms "
                  f"{bound_text(nbytes, flops)}")
            bwd.add(err, t_k, t_p, t_l, nbytes, flops, main)
            del x, gy, yl, leaves
    print(f"merge fwd L {len(cfg.tasks) * KERNEL_BATCH} sum of the three "
          f"merges (the LN route's task streams): kernel "
          f"{streams['kernel']:.4f} ms library {streams['library']:.4f} ms "
          f"bound {streams['bound']:.4f} ms")
    # its own generator: the later checks draw the same tensors as before
    cover = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for label, L, res, C in MERGE_COVERAGE:
        args, gy = merge_operands(cover, L, res, C)
        M = L * res * res // 4
        shape = f"{label} x [{M}, {4 * C}] -> {2 * C}, Wh {res // 2}"
        _, plan, text = check_merge_fwd(f"merge fwd {shape}", args)
        t_k = median_ms(lambda: merge_ln_fwd(*args))
        print(f"merge fwd {shape}: {text} kernel {t_k:.4f} ms "
              f"({plan_text(plan, t_k)})")
        label = f"merge bwd {shape}"
        _, plan, text = check_merge_rows(label, args, gy)
        t_k = median_ms(lambda: merge_ln_bwd(*args, gy))
        print(f"{label}: {text} kernel {t_k:.4f} ms ({plan.bm}-row blocks "
              f"in clusters of {plan.split})")
        del args, gy
    return {"fwd": fwd, "bwd": bwd}


def ln_mlp_library(x, gamma, beta, w1, bias1, a1, bb1, w2, bias2, a2, bb2,
                   s1, s2):
    ln = F.layer_norm(x, (x.shape[1],), gamma, beta, 1e-5)
    h = torch.addmm(bias1, ln, w1.t()) + s1 * ((ln @ a1.t()) @ bb1.t())
    g = F.gelu(h, approximate="tanh")
    return torch.addmm(bias2, g, w2.t()) + s2 * ((g @ a2.t()) @ bb2.t())


def ln_mlp_operands(gen, s, M=None):
    """Kernel 4's operands at stage s, ``M`` rows (default: the batch-32
    step's), rank 64, scales 4, dropout 0.05: (args, gy, weights)."""
    cfg, _, C, M_step = stage_dims(s)
    M = M_step if M is None else M
    st = cfg.stages[s]
    H4, r, sc, p = 4 * C, st.r_shared, st.shared_scale, st.dropout
    x = torch.randn(M, C, generator=gen, device="cuda").to(torch.bfloat16)
    gamma, beta = _ln_params(gen, C)
    w1 = _uniform(gen, (H4, C), C ** -0.5)
    bias1 = _uniform(gen, (H4,), 0.02)
    a1 = _uniform(gen, (r, C), C ** -0.5)
    bb1 = _uniform(gen, (H4, r), r ** -0.5)
    w2 = _uniform(gen, (C, H4), H4 ** -0.5)
    bias2 = _uniform(gen, (C,), 0.02)
    a2 = _uniform(gen, (r, H4), H4 ** -0.5)
    bb2 = _uniform(gen, (C, r), r ** -0.5)
    seed = _seed(gen)
    gy = torch.randn(M, C, generator=gen, device="cuda").to(torch.bfloat16)
    ws = (w1, bias1, a1, bb1, w2, bias2, a2, bb2)
    return (x, gamma, beta, *ws, seed, sc, sc, p), gy, ws


def ln_mlp_bwd_cost(M, C, r):
    """(bytes, operations) of kernel 4b: x, gy and dx once, the weights
    and their adapter gradients once; the three frozen products and the
    rank products."""
    H4 = 4 * C
    w_bytes = 2 * (2 * C * H4 + H4 + C + 2 * r * (C + H4) + 2 * C)
    return (6 * M * C + 2 * w_bytes,
            2.0 * M * (3 * C * H4 + 6 * r * H4 + 5 * r * C))


def check_ln_mlp(gen) -> dict:
    """Kernel 4 at the no-task blocks' MLPs: per stage x [M, C], hidden 4C,
    rank 64, scales 4, dropout 0.05; weighted by the stage's no-task
    blocks. Kernels 4 and 4b also at the ragged stage-3 rows of phase 8
    (checked, not in the tally)."""
    fwd, bwd = Tally(), Tally()
    for s in range(4):
        cfg, _, C, M = stage_dims(s)
        args, gy, ws = ln_mlp_operands(gen, s)
        x, gamma, beta = args[:3]
        w1, bias1, a1, bb1, w2, bias2, a2, bb2 = ws
        sc, r, H4 = args[-3], a1.shape[0], w1.shape[0]
        n = cfg.depths[s] - 1
        y = ln_mlp_fwd(*args)
        ref = ln_mlp_plain(*args)
        torch.cuda.synchronize()
        err, text = check_outputs(f"ln_mlp fwd stage {s}", [y], [ref], ["y"],
                                  {0})
        t_k = median_ms(lambda: ln_mlp_fwd(*args))
        t_p = median_ms(lambda: ln_mlp_plain(*args))
        t_l = median_ms(lambda: ln_mlp_library(x, gamma, beta, *ws, sc, sc))
        w_bytes = 2 * (2 * C * H4 + H4 + C + 2 * r * (C + H4) + 2 * C)
        nbytes = 4 * M * C + w_bytes
        flops = 2.0 * M * (2 * C * H4 + 2 * r * (C + H4))
        t_b = max(nbytes / PEAK_HBM_BYTES, ops_seconds(flops)) * 1e3
        plan = fwd_plan(M, C, H4, r)
        print(f"ln_mlp fwd stage {s} x [{M}, {C}] hidden {H4} (x{n}): {text} "
              f"kernel {t_k:.4f} ms ({flops / t_k / 1e9:.2f} TFLOP/s, "
              f"{t_b / t_k:.4f} of the bound; {plan.bm}-row blocks, weight "
              f"slices {plan.slice_bytes / 1e9:.3f} GB, "
              f"{plan.slice_bytes / t_k / 1e9:.3f} TB/s) plain {t_p:.4f} ms "
              f"library {t_l:.4f} ms {bound_text(nbytes, flops)}")
        fwd.add(err, t_k, t_p, t_l, nbytes, flops, n)
        got = ln_mlp_bwd(*args, gy)
        want = ln_mlp_bwd_plain(*args, gy)
        torch.cuda.synchronize()
        err, text = check_outputs(
            f"ln_mlp bwd stage {s}", got, want,
            ("dx", "dgamma", "dbeta", "dA1", "dB1", "dA2", "dB2"), {0})
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, gamma, beta, a1, bb1, a2, bb2)]
        yl = ln_mlp_library(leaves[0], leaves[1], leaves[2], w1, bias1,
                            leaves[3], leaves[4], w2, bias2, leaves[5],
                            leaves[6], sc, sc)
        t_k = median_ms(lambda: ln_mlp_bwd(*args, gy), reps=5)
        t_p = median_ms(lambda: ln_mlp_bwd_plain(*args, gy), reps=5)
        t_l = median_ms(lambda: torch.autograd.grad(yl, leaves, gy,
                                                    retain_graph=True),
                        reps=5)
        nbytes, flops = ln_mlp_bwd_cost(M, C, r)
        t_b = max(nbytes / PEAK_HBM_BYTES, ops_seconds(flops)) * 1e3
        plan = bwd_plan(M, C, H4, r, ln_lora._sms(x.device))
        print(f"ln_mlp bwd stage {s}: {text} kernel {t_k:.4f} ms "
              f"({flops / t_k / 1e9:.2f} TFLOP/s, {t_b / t_k:.4f} of the "
              f"bound; weight slices {plan.slice_bytes / 1e9:.3f} GB, "
              f"{plan.slice_bytes / t_k / 1e9:.3f} TB/s) plain {t_p:.4f} ms "
              f"library backward {t_l:.4f} ms {bound_text(nbytes, flops)}")
        bwd.add(err, t_k, t_p, t_l, nbytes, flops, n)
        del x, gy, y, ref, got, want, yl, leaves, args, ws
    # its own generator: the later checks draw the same tensors as before
    ragged = torch.Generator(device="cuda").manual_seed(SEED + 1)
    args, gy, _ = ln_mlp_operands(ragged, 3, RAGGED_ROWS)
    y = ln_mlp_fwd(*args)
    ref = ln_mlp_plain(*args)
    torch.cuda.synchronize()
    _, text = check_outputs(
        f"ln_mlp fwd ragged x [{RAGGED_ROWS}, {args[0].shape[1]}]", [y], [ref],
        ["y"], {0})
    print(f"ln_mlp fwd ragged x [{RAGGED_ROWS}, {args[0].shape[1]}]: {text}")
    got = ln_mlp_bwd(*args, gy)
    want = ln_mlp_bwd_plain(*args, gy)
    torch.cuda.synchronize()
    _, text = check_outputs(
        f"ln_mlp bwd ragged x [{RAGGED_ROWS}, {args[0].shape[1]}]", got, want,
        ("dx", "dgamma", "dbeta", "dA1", "dB1", "dA2", "dB2"), {0})
    print(f"ln_mlp bwd ragged x [{RAGGED_ROWS}, {args[0].shape[1]}]: {text}")
    return {"fwd": fwd, "bwd": bwd}


# ---------------------------------------------------------------------------
# The TPU.USE_PALLAS_ADAPTER route: kernel 2's tail mode (norm2 -> fc1 of
# the stage-tail blocks), kernel 5 (adapter MLP tail) and kernel 6
# (factored task merge), forward and backward, at every site shape of the
# batch-32 step, adapter dropout on and drop-path coefficients drawn at
# the flagship's rates.
# ---------------------------------------------------------------------------

def ln_lora_tail_library(x, gamma, beta, wt, bias, at, bt, scale):
    ln = F.layer_norm(x, (x.shape[1],), gamma, beta, 1e-5)
    p = torch.addmm(bias, ln, wt.t())
    return F.gelu(p + scale * ((ln @ at.t()) @ bt.t()),
                  approximate="tanh"), p


def tail_operands(gen, s, M=None, C=None, r=None):
    """Kernel 2's tail-mode operands at the fc1 site of stage s, ``M``
    rows (default: the batch-32 step's), width ``C`` (default the stage's),
    O = 4C, rank ``r`` (default 64), scale 4, dropout 0.05, and the
    cotangents of y, p and d: (args, (gy, gp, gd))."""
    cfg, _, C_step, M_step = stage_dims(s)
    M = M_step if M is None else M
    C = C_step if C is None else C
    st = cfg.stages[s]
    O, sc, p = 4 * C, st.shared_scale, st.dropout
    r = st.r_shared if r is None else r
    x = torch.randn(M, C, generator=gen, device="cuda").to(torch.bfloat16)
    gamma, beta = _ln_params(gen, C)
    wt = _uniform(gen, (O, C), C ** -0.5)
    bias = _uniform(gen, (O,), 0.02)
    at = _uniform(gen, (r, C), C ** -0.5)
    bt = _uniform(gen, (O, r), r ** -0.5)
    seed = _seed(gen)
    cots = tuple(torch.randn(M, O, generator=gen, device="cuda")
                 .to(torch.bfloat16) for _ in range(3))
    return (x, gamma, beta, wt, bias, at, bt, seed, sc, p), cots


def check_tail_rows(label, args, cots):
    """Kernel 2b's tail mode against its plain versions: the whole
    backward against ``ln_lora_tail_bwd_plain`` and the row kernel's
    stored rows (lnd, m, dm, du; bf16, within 2^-6 of the largest
    element) against ``ln_lora_tail_bwd_rows_plain``. Returns (worst
    error of the backward, text)."""
    x, wt, at = args[0], args[3], args[5]
    plan = tail_bwd_plan(x.shape[0], x.shape[1], wt.shape[0], at.shape[0],
                         ln_lora._sms(x.device))
    sc = tail_bwd_scratch(plan, x.device)
    got = ln_lora_tail_bwd_kernel(*args, *cots, True, scratch=sc)
    want = ln_lora_tail_bwd_plain(*args, *cots, True)
    torch.cuda.synchronize()
    err, text = check_outputs(label, got, want,
                              ("dx", "dgamma", "dbeta", "dA", "dB"), {0})
    del got, want
    rows = (sc["lnd"], sc["mbuf"][0], sc["mbuf"][1], sc["du"])
    want = ln_lora_tail_bwd_rows_plain(*args, *cots, True)[3:]
    _, rtext = check_outputs(f"{label} rows", rows, want,
                             ("lnd", "m", "dm", "du"), {0, 1, 2, 3})
    return err, f"{text}; rows {rtext}"


def tail_bwd_cost(M, C, O, r, w_bytes):
    """(bytes, operations) of kernel 2b's tail mode: x, gy, gp, gd and dx
    once, the weights and their adapter gradients once; z's frozen
    product, dln, and the rank products m, u, dm, dl, dA, dB."""
    return (2 * M * (2 * C + 3 * O) + 2 * w_bytes,
            2.0 * M * (2 * O * C + 3 * C * r + 3 * O * r))


def check_tail_fwd(label, args, act=True, out_drop=True):
    """Kernel 2's tail mode against ``ln_lora_tail_plain``: y, p and (with
    ``out_drop``) d, bf16, within 2^-6 of the largest element. Returns
    (worst error, text)."""
    got = ln_lora_tail_fwd(*args, act, out_drop)
    want = ln_lora_tail_plain(*args, act, out_drop)
    torch.cuda.synchronize()
    n = 3 if out_drop else 2
    return check_outputs(label, got[:n], want[:n], ("y", "p", "d")[:n],
                         set(range(n)))


# kernel 2-tail's coverage (checked, not in the tally): (label, stage, M,
# C, r, act, out_drop, dropout) -- the ragged 392 rows of stage 3 (the
# batch-2 step), GELU off, the serve form (no dropout(y), no dropout),
# ranks 16 and 32 (the r16 and r32 YAMLs), Swin-B's last stage
# (mtlora_base_448's fc1, [6272, 1024] -> 4096); 2b-tail also at the last
# three (with its stored rows)
TAIL_COVERAGE = (("ragged", 3, RAGGED_ROWS, None, 64, True, True, 0.05),
                 ("act off", 1, None, None, 64, False, True, 0.05),
                 ("serve", 0, None, None, 64, True, False, 0.0),
                 ("r16", 0, None, None, 16, True, True, 0.05),
                 ("r32", 2, None, None, 32, True, True, 0.05),
                 ("swin-b stage 3", 3, None, 1024, 64, True, True, 0.05))
TAIL_BWD_COVERAGE = ("r16", "r32", "swin-b stage 3")


def check_ln_lora_tail(gen) -> dict:
    """Kernel 2's tail mode at the four fc1 sites: x [M, C] -> y =
    gelu(z), p and dropout(y) [M, 4C], rank 64, scale 4, dropout 0.05,
    with its share of the byte bound and output TB/s; the backward from
    the cotangents of all three, also with its stored rows; both at
    ``TAIL_COVERAGE`` (checked, not in the tally), and 2b-tail at the
    ragged 392 rows of stage 3."""
    fwd, bwd = Tally(), Tally()
    for s in range(4):
        args, (gy, gp, gd) = tail_operands(gen, s)
        x, gamma, beta, wt, bias, at, bt, seed, sc, p = args
        M, C = x.shape
        O, r = wt.shape[0], at.shape[0]
        err, text = check_tail_fwd(f"ln_lora_tail fwd stage {s}", args)
        t_k = median_ms(lambda: ln_lora_tail_fwd(*args, True, True))
        t_p = median_ms(lambda: ln_lora_tail_plain(*args, True, True))
        t_l = median_ms(lambda: ln_lora_tail_library(x, gamma, beta, wt, bias,
                                                     at, bt, sc))
        w_bytes = 2 * (O * C + O + r * C + O * r + 2 * C)
        nbytes = 2 * M * (C + 3 * O) + w_bytes
        flops = 2.0 * M * (C * O + C * r + r * O)
        ops32 = float(GELU_OPS) * M * O
        t_b = max(nbytes / PEAK_HBM_BYTES, ops_seconds(flops, ops32)) * 1e3
        plan = tail_fwd_plan(M, C, O, r, ln_lora._sms(x.device))
        print(f"ln_lora_tail fwd stage {s} x [{M}, {C}] -> {O}: {text} "
              f"kernel {t_k:.4f} ms ({t_b / t_k:.4f} of the bound, outputs "
              f"{6 * M * O / t_k / 1e9:.3f} TB/s; {plan.bm}-row blocks, "
              f"{plan.splits} items a row block, {plan.per_sm} blocks an SM, "
              f"ring {plan.stages}) plain "
              f"{t_p:.4f} ms library {t_l:.4f} ms "
              f"{bound_text(nbytes, flops, ops32)}")
        fwd.add(err, t_k, t_p, t_l, nbytes, flops, 1, ops32)
        err, text = check_tail_rows(f"ln_lora_tail bwd stage {s}", args,
                                    (gy, gp, gd))
        leaves = [t.detach().requires_grad_(True) for t in (x, gamma, beta,
                                                            at, bt)]
        yl, pl = ln_lora_tail_library(leaves[0], leaves[1], leaves[2], wt,
                                      bias, leaves[3], leaves[4], sc)
        t_k = median_ms(lambda: ln_lora_tail_bwd(*args, gy, gp, gd, True),
                        reps=10)
        t_p = median_ms(lambda: ln_lora_tail_bwd_plain(*args, gy, gp, gd,
                                                       True), reps=5)
        t_l = median_ms(lambda: torch.autograd.grad(
            (yl, pl), leaves, (gy, gp), retain_graph=True), reps=10)
        nbytes, flops = tail_bwd_cost(M, C, O, r, w_bytes)
        ops32 = float(GELU_PAIR_OPS) * M * O
        t_b = max(nbytes / PEAK_HBM_BYTES, ops_seconds(flops, ops32)) * 1e3
        plan = tail_bwd_plan(M, C, O, r, ln_lora._sms(x.device))
        print(f"ln_lora_tail bwd stage {s}: {text} kernel {t_k:.4f} ms "
              f"({flops / t_k / 1e9:.2f} TFLOP/s, {t_b / t_k:.4f} of the "
              f"bound; weight slices {plan.slice_bytes / 1e9:.3f} GB, "
              f"{plan.slice_bytes / t_k / 1e9:.3f} TB/s) plain {t_p:.4f} ms "
              f"library backward {t_l:.4f} ms "
              f"{bound_text(nbytes, flops, ops32)}")
        bwd.add(err, t_k, t_p, t_l, nbytes, flops, 1, ops32)
        del x, gy, gp, gd, yl, pl, leaves, args
    # its own generator: the later checks draw the same tensors as before
    ragged = torch.Generator(device="cuda").manual_seed(SEED + 2)
    args, cots = tail_operands(ragged, 3, RAGGED_ROWS)
    label = f"ln_lora_tail bwd ragged x [{RAGGED_ROWS}, {args[0].shape[1]}]"
    print(f"{label}: {check_tail_rows(label, args, cots)[1]}")
    del args, cots
    cover = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for label, s, M, C, r, act, out_drop, drop in TAIL_COVERAGE:
        args, cots = tail_operands(cover, s, M, C, r)
        args = args[:-1] + (drop,)
        M, C = args[0].shape
        shape = f"x [{M}, {C}] -> {4 * C}, r {r}"
        text = check_tail_fwd(f"ln_lora_tail fwd {label}", args, act,
                              out_drop)[1]
        print(f"ln_lora_tail fwd {label} {shape}: {text}")
        if label in TAIL_BWD_COVERAGE:
            full = f"ln_lora_tail bwd {label} {shape}"
            print(f"{full}: {check_tail_rows(full, args, cots)[1]}")
        del args, cots
    return {"fwd": fwd, "bwd": bwd}


def adapter_library(mid1T, p1, b1, a2T, s, approximate="tanh"):
    """bmm -> add -> GELU -> bmm, the [T, M, 4C] hidden in device memory
    (``approximate``: F.gelu's form, "tanh" as the kernels take it)."""
    h = F.gelu(p1[None] + s * torch.bmm(mid1T.transpose(1, 2), b1),
               approximate=approximate)
    return torch.bmm(a2T, h.transpose(1, 2))


def adapter_operands(gen, T, M, H4):
    """Kernel 5's operands: T tasks of rank 4, M rows, H4 hidden columns,
    and the cotangent g: (mid1T, p1, b1, a2T, g)."""
    r = 4
    mid1T = (0.5 * torch.randn(T, r, M, generator=gen, device="cuda")
             ).to(torch.bfloat16)
    p1 = torch.randn(M, H4, generator=gen, device="cuda").to(torch.bfloat16)
    b1 = _uniform(gen, (T, r, H4), 0.1)
    a2T = _uniform(gen, (T, r, H4), H4 ** -0.5)
    g = torch.randn(T, r, M, generator=gen, device="cuda").to(torch.bfloat16)
    return mid1T, p1, b1, a2T, g


def adapter_cost(T, M, H4, backward):
    """(bytes, bf16 FLOP, fp32 operations, the fp32 operations of the count
    without tensor cores) of kernel 5 or 5b at T tasks of rank 4: the rank
    rows, p1 (and dp1) and the weights once (5b: dB1 and dA2T in fp32);
    the rank products (5: u and the projection; 5b: u, dh, dmid1, dB1 and
    dA2T) on the tensor cores, 2 r flops an element each; on the CUDA
    cores the GELU (5b: with its derivative) and z's add (5b: also dz's
    product, dp1's sum and bf16(h)'s pack), or, with every rank product on
    them too, 4 r (5b: 10 r) more."""
    r, E = 4, float(T) * M * H4
    if backward:
        nbytes = (2 * (3 * T * r * M + 2 * M * H4 + 2 * T * r * H4)
                  + 4 * 2 * T * r * H4)
        return (nbytes, 2.0 * 5 * r * E, E * (GELU_PAIR_OPS + 4),
                E * (GELU_PAIR_OPS + 10 * r))
    nbytes = 2 * (2 * T * r * M + M * H4 + 2 * T * r * H4)
    return nbytes, 2.0 * 2 * r * E, E * (GELU_OPS + 2), E * (GELU_OPS + 4 * r)


def adapter_bounds_ms(cost):
    """(the bound, the bound of the count with every rank product on the
    CUDA cores) in ms."""
    nbytes, flops, ops32, old32 = cost
    return (max(nbytes / PEAK_HBM_BYTES, ops_seconds(flops, ops32)) * 1e3,
            max(nbytes / PEAK_HBM_BYTES, old32 / PEAK_FP32_FLOPS) * 1e3)


def adapter_bound_text(cost) -> str:
    t_old = adapter_bounds_ms(cost)[1]
    return f"{bound_text(*cost[:3])} (all fp32: {t_old:.4f} ms)"


def check_adapter_fwd(label, args):
    """Kernel 5 against ``adapter_mid_plain`` (mid2T, bf16, within 2^-6 of
    the largest element and within KERNEL_ATOL) and a second launch on the
    same inputs bit for bit against the first. Returns (error, plan,
    text)."""
    mid1T, p1 = args[0], args[1]
    plan = adapter_fwd_plan(p1.shape[0], p1.shape[1], mid1T.shape[0],
                            ln_lora._sms(p1.device))
    got = adapter_mid_fwd(*args)
    again = adapter_mid_fwd(*args)
    want = adapter_mid_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again), f"{label}: two launches differ"
    err, text = check_outputs(label, [got], [want], ["mid2T"], {0})
    assert err <= KERNEL_ATOL, f"{label}: {err} > {KERNEL_ATOL}"
    return err, plan, (f"{text} (atol {KERNEL_ATOL:.3e}); two launches "
                       f"bit-identical")


def adapter_fwd_plan_text(plan, t_k, cost) -> str:
    """Kernel 5's plan, TFLOP/s and share of both bounds in ``t_k`` ms."""
    t_b, t_old = adapter_bounds_ms(cost)
    return (f"{cost[1] / t_k / 1e9:.2f} TFLOP/s, {t_b / t_k:.4f} of the bound "
            f"({t_old / t_k:.4f} of the all-fp32 count); {plan.chunks} "
            f"chunk(s) of {plan.cols} columns, {plan.steps} 16-row steps "
            f"a chunk over {plan.stripes} blocks of "
            f"{adapter_mlp.FWD_WARPS} warps, {plan.blocks} blocks "
            f"({plan.per_sm} an SM), {plan.smem} bytes")


def check_adapter_bwd(label, args, g):
    """Kernel 5b against ``adapter_mid_bwd_plain`` (dmid1T and dp1, bf16,
    within 2^-6 of the largest element; dB1 and dA2T, fp32, at relative
    RMS <= 2^-7) and a second launch on the same inputs bit for bit
    against the first. Returns (worst error, plan, text)."""
    mid1T, p1 = args[0], args[1]
    plan = adapter_bwd_plan(p1.shape[0], p1.shape[1], mid1T.shape[0],
                            ln_lora._sms(p1.device))
    got = adapter_mid_bwd(*args, g)
    again = adapter_mid_bwd(*args, g)
    want = adapter_mid_bwd_plain(*args, g)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again)), (
        f"{label}: two launches differ")
    err, text = check_outputs(label, got, want,
                              ("dmid1T", "dp1", "dB1", "dA2T"), {0, 1})
    return err, plan, f"{text}; two launches bit-identical"


def adapter_plan_text(plan, t_k, cost) -> str:
    """Kernel 5b's plan, TFLOP/s and share of both bounds in ``t_k`` ms."""
    t_b, t_old = adapter_bounds_ms(cost)
    return (f"{cost[1] / t_k / 1e9:.2f} TFLOP/s, {t_b / t_k:.4f} of the bound "
            f"({t_old / t_k:.4f} of the all-fp32 count); {plan.chunks} "
            f"chunk(s) of {plan.cols} columns ({adapter_mlp.BWD_PAIRS} pairs "
            f"a warp), {adapter_mlp.BWD_ROWS}-row tiles in {plan.stripes} "
            f"stripes of {plan.tps}, "
            f"{plan.blocks} blocks ({plan.per_sm} an SM), {plan.smem} bytes")


# kernels 5's and 5b's coverage (checked and timed, not in the tally):
# (label, T, M, H4) -- one and three tasks, the batch-2 step's stage-3
# rows (392, also path B's at batch 8), rows that are not a multiple of 8
# (the scalar staging of mid1 and g; kernel 5's scalar stores), Swin-B's
# stage-3 width (4C = 4096)
ADAPTER_COVERAGE = (("T 1 stage 0", 1, KERNEL_BATCH * 112 ** 2, 384),
                    ("T 3 stage 2", 3, KERNEL_BATCH * 28 ** 2, 1536),
                    ("ragged stage 3", 4, RAGGED_ROWS, 3072),
                    ("odd rows", 3, 389, 768),
                    ("swin-b stage 3", 4, KERNEL_BATCH * 14 ** 2, 4096))
# kernel 5 also at path B's stage-3 rows (224 px: 7 * 7 tokens an image)
# at batch 32 (batch 8's 392 are the ragged stage 3 above)
ADAPTER_FWD_COVERAGE = ADAPTER_COVERAGE + (
    ("path B stage 3", 4, KERNEL_BATCH * 7 ** 2, 3072),)


def check_adapter_mid(gen) -> dict:
    """Kernels 5 and 5b at the four stage-tail MLPs: T 4, rank 4, M = 32
    L_s, H4 = 4 C_s; the rank products counted as bf16 tensor-core work
    (the four tasks' ranks, 16, are one mma depth), the all-fp32 count
    beside it. Each with two launches bit for bit and its plan, also at
    ``ADAPTER_FWD_COVERAGE`` (5) and ``ADAPTER_COVERAGE`` (5b)."""
    fwd, bwd = Tally(), Tally()
    for s in range(4):
        cfg, _, C, M = stage_dims(s)
        T, H4 = len(cfg.tasks), 4 * C
        scales = cfg.stages[s].task_scales
        mid1T, p1, b1, a2T, g = adapter_operands(gen, T, M, H4)
        args = (mid1T, p1, b1, a2T, scales)
        sv = torch.tensor(scales, device="cuda").view(T, 1, 1).to(
            torch.bfloat16)
        err, plan, text = check_adapter_fwd(f"adapter_mid fwd stage {s}",
                                            args)
        t_k = median_ms(lambda: adapter_mid_fwd(*args))
        t_p = median_ms(lambda: adapter_mid_plain(*args), reps=5)
        t_l = median_ms(lambda: adapter_library(mid1T, p1, b1, a2T, sv),
                        reps=5)
        cost = adapter_cost(T, M, H4, False)
        print(f"adapter_mid fwd stage {s} T {T} M {M} H4 {H4}: {text} kernel "
              f"{t_k:.4f} ms ({adapter_fwd_plan_text(plan, t_k, cost)}) "
              f"plain {t_p:.4f} ms library {t_l:.4f} ms "
              f"{adapter_bound_text(cost)}")
        fwd.add(err, t_k, t_p, t_l, *cost[:2], 1, cost[2])
        label = f"adapter_mid bwd stage {s}"
        err, plan, text = check_adapter_bwd(label, args, g)
        leaves = [t.detach().requires_grad_(True)
                  for t in (mid1T, p1, b1, a2T)]
        yl = adapter_library(*leaves, sv)
        t_k = median_ms(lambda: adapter_mid_bwd(*args, g), reps=5)
        t_p = median_ms(lambda: adapter_mid_bwd_plain(*args, g), reps=3)
        t_l = median_ms(lambda: torch.autograd.grad(yl, leaves, g,
                                                    retain_graph=True),
                        reps=5)
        cost = adapter_cost(T, M, H4, True)
        print(f"{label}: {text} kernel {t_k:.4f} ms "
              f"({adapter_plan_text(plan, t_k, cost)}) plain {t_p:.4f} ms "
              f"library backward {t_l:.4f} ms {adapter_bound_text(cost)}")
        bwd.add(err, t_k, t_p, t_l, *cost[:2], 1, cost[2])
        del mid1T, p1, g, yl, leaves
    # its own generator: the later checks draw the same tensors as before
    cover = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for name, T, M, H4 in ADAPTER_FWD_COVERAGE:
        mid1T, p1, b1, a2T, g = adapter_operands(cover, T, M, H4)
        args = (mid1T, p1, b1, a2T, (4.0, 2.0, 1.0, 0.5)[:T])
        label = f"adapter_mid fwd {name} T {T} M {M} H4 {H4}"
        _, plan, text = check_adapter_fwd(label, args)
        t_k = median_ms(lambda: adapter_mid_fwd(*args))
        cost = adapter_cost(T, M, H4, False)
        print(f"{label}: {text} kernel {t_k:.4f} ms "
              f"({adapter_fwd_plan_text(plan, t_k, cost)})")
        if (name, T, M, H4) in ADAPTER_COVERAGE:
            label = f"adapter_mid bwd {name} T {T} M {M} H4 {H4}"
            _, plan, text = check_adapter_bwd(label, args, g)
            t_k = median_ms(lambda: adapter_mid_bwd(*args, g), reps=5)
            cost = adapter_cost(T, M, H4, True)
            print(f"{label}: {text} kernel {t_k:.4f} ms "
                  f"({adapter_plan_text(plan, t_k, cost)})")
        del mid1T, p1, g, args
    return {"fwd": fwd, "bwd": bwd}


def task_merge_library(base, pre, p2, midc, bs, k1, k2, gamma, beta, wt,
                       idx):
    """The streams expanded (one bmm and the shared terms), the 2x2 gather
    as one index_select, LN(4C), GEMM."""
    T = midc.shape[0]
    B, L, C = base.shape
    u = torch.bmm(midc.transpose(1, 2), bs).view(T, B, L, C)
    y = (base + k1 * pre + k2 * p2 + u).view(T * B, L, C)
    xc = y.index_select(1, idx).reshape(T * B * L // 4, 4 * C)
    return F.layer_norm(xc, (4 * C,), gamma, beta, 1e-5) @ wt.t()


TM_BWD_NAMES = ("dbase", "dpre", "dp2", "dmid1T", "dB1", "dmid2T", "dB2",
                "dgamma", "dbeta", "dW")


def task_merge_operands(gen, gcpu, T, B, res, C, rate, sc):
    """Kernel 6's operands at a merge of T task streams [B, res^2, C] ->
    [B, res^2 / 4, 2C]: r1 = r2 = 4, drop-path coefficients drawn at
    ``rate``, scales ``sc``: (args, gy)."""
    r, L, K, O = 4, res * res, 4 * C, 2 * C
    base, pre, p2 = (torch.randn(B, L, C, generator=gen, device="cuda")
                     .to(torch.bfloat16) for _ in range(3))
    mid1T, mid2T = ((0.5 * torch.randn(T, r, B * L, generator=gen,
                                       device="cuda")).to(torch.bfloat16)
                    for _ in range(2))
    b1, b2 = (_uniform(gen, (T, r, C), 0.1) for _ in range(2))
    c1, c2 = (droppath_coef(rate, T, B, gcpu, "cpu").cuda()
              for _ in range(2))
    gamma, beta = _ln_params(gen, K)
    wt = _uniform(gen, (O, K), K ** -0.5)
    gy = torch.randn(T, B, L // 4, O, generator=gen,
                     device="cuda").to(torch.bfloat16)
    return (base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, sc, sc, gamma,
            beta, wt, res, res), gy


def check_task_merge_rows(label, args, gy):
    """Kernel 6b against its plain versions: the whole backward against
    ``task_merge_bwd_plain``, the row kernel's stored rows (lnd, bf16,
    within 2^-6 of the largest element) against
    ``task_merge_bwd_rows_plain``, and a second launch on the same inputs
    bit for bit against the first. Returns (worst error of the backward,
    plan, text)."""
    base, wt, H, W = args[0], args[13], args[14], args[15]
    T, (Bn, L, C), O = args[3].shape[0], base.shape, wt.shape[0]
    plan = task_merge_bwd_plan(T, Bn * L // 4, 4 * C, O, W // 2,
                               (H // 2) * (W // 2), ln_lora._sms(base.device))
    sc = task_merge_bwd_scratch(plan, base.device)
    got = task_merge_bwd_kernel(*args, gy, scratch=sc)
    again = task_merge_bwd_kernel(*args, gy)
    want = task_merge_bwd_plain(*args, gy)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    assert same, f"{label}: two launches differ"
    err, text = check_outputs(label, got, want, TM_BWD_NAMES,
                              {0, 1, 2, 3, 5})
    del got, again, want
    want = task_merge_bwd_rows_plain(*args, gy)[9]
    _, rtext = check_outputs(f"{label} rows", [sc["lnd"]], [want], ["lnd"],
                             {0})
    return err, plan, f"{text}; rows {rtext}; two launches bit-identical"


def check_task_merge_fwd(label, args):
    """Kernel 6 against ``task_merge_plain`` (y, bf16, within 2^-6 of the
    largest element) and a second launch on the same inputs bit for bit
    against the first. Returns (worst error, plan, text)."""
    base, wt, H, W = args[0], args[13], args[14], args[15]
    T, (Bn, L, C), O = args[3].shape[0], base.shape, wt.shape[0]
    plan = task_merge_fwd_plan(T, Bn * L // 4, 4 * C, O, W // 2,
                               (H // 2) * (W // 2), ln_lora._sms(base.device))
    y = task_merge_fwd(*args)
    again = task_merge_fwd(*args)
    ref = task_merge_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(y, again), f"{label}: two launches differ"
    err, text = check_outputs(label, [y], [ref], ["y"], {0})
    return err, plan, f"{text}; two launches bit-identical"


def task_merge_fwd_cost(T, B, res, C):
    """(bytes, bf16 FLOP, fp32 operations) of kernel 6 at a merge of T task
    streams [B, res^2, C]: the shared rows, the rank rows and Bs, W, gamma
    and beta read once, y written once; the products; the streams' rank
    term (8 multiply-adds a source value and task)."""
    r, L, K, O = 4, res * res, 4 * C, 2 * C
    Mm = B * L // 4
    nbytes = 2 * (3 * B * L * C + T * B * L * 2 * r + 2 * T * r * C
                  + T * Mm * O + O * K + 2 * K)
    return nbytes, 2.0 * T * Mm * K * O, 2.0 * T * B * L * C * 2 * r


def fwd_rate_text(plan, t_k, nbytes, flops, ops32) -> str:
    """Kernel 6's TFLOP/s, share of the bound and plan in ``t_k`` ms."""
    t_b = max(nbytes / PEAK_HBM_BYTES, ops_seconds(flops, ops32)) * 1e3
    return (f"{flops / t_k / 1e9:.2f} TFLOP/s, {t_b / t_k:.4f} of the bound; "
            f"{plan_text(plan, t_k)}")


# kernel 6b's coverage (checked and timed, not in the tally): (label, T,
# batch, res, C) -- path B's 14 -> 7 merge at 224 px (Wh = 7, odd: 49
# merged rows a sample, so that blocks straddle samples), Swin-B's last
# merge (C = 512, K = 2048), the batch-2 step's 28 -> 14 merge (392
# rows, phase 8) and a merge of six tasks; kernel 6's too
TASK_MERGE_COVERAGE = (("path B 14->7", 4, KERNEL_BATCH, 14, 384),
                       ("swin-b 28->14", 4, KERNEL_BATCH, 28, 512),
                       ("ragged 28->14", 4, CROSS_BATCH, 28, 384),
                       ("T 6 28->14", 6, KERNEL_BATCH, 28, 384))


def check_task_merge(gen) -> dict:
    """Kernel 6 at the three merges: T 4, r1 = r2 = 4, batch 32, drop-path
    coefficients drawn at the rate of the merging block (both non-trivial),
    scales 4; the reduction trains. Both directions with two launches bit
    for bit, their plan, share of the bound and W's slot bytes per merge,
    and at ``TASK_MERGE_COVERAGE``; the backward (6b) also with its stored
    rows."""
    fwd, bwd = Tally(), Tally()
    gcpu = torch.Generator().manual_seed(SEED)
    for s in range(3):
        cfg, res, C, _ = stage_dims(s)
        T, r, B, L = len(cfg.tasks), 4, KERNEL_BATCH, res * res
        K, O, Mm = 4 * C, 2 * C, KERNEL_BATCH * res * res // 4
        rate = 0.2 * (sum(cfg.depths[:s + 1]) - 1) / (sum(cfg.depths) - 1)
        args, gy = task_merge_operands(gen, gcpu, T, B, res, C, rate,
                                       cfg.stages[s].task_scales)
        (base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, sc, _, gamma, beta,
         wt) = args[:14]
        err, plan, text = check_task_merge_fwd(f"task_merge fwd {s}", args)
        midc, bs = rank_operands(mid1T, b1, mid2T, b2, c1, c2, sc, sc, B, L)
        k1, k2 = (c.to(torch.bfloat16).view(T, B, 1, 1) for c in (c1, c2))
        idx = merge_index(res, res, "cuda")
        lib = (base, pre, p2, midc, bs, k1, k2, gamma, beta, wt, idx)
        t_k = median_ms(lambda: task_merge_fwd(*args))
        t_p = median_ms(lambda: task_merge_plain(*args), reps=5)
        t_l = median_ms(lambda: task_merge_library(*lib), reps=5)
        w_bytes = 2 * (O * K + 2 * K)
        nbytes, flops, ops32 = task_merge_fwd_cost(T, B, res, C)
        print(f"task_merge fwd {res}->{res // 2} T {T} B {B} C {C} -> {O}: "
              f"{text} kernel {t_k:.4f} ms "
              f"({fwd_rate_text(plan, t_k, nbytes, flops, ops32)}) plain "
              f"{t_p:.4f} ms library {t_l:.4f} ms "
              f"{bound_text(nbytes, flops, ops32)}")
        fwd.add(err, t_k, t_p, t_l, nbytes, flops, 1, ops32)
        err, plan, text = check_task_merge_rows(f"task_merge bwd {s}", args,
                                                gy)
        leaves = [t.detach().requires_grad_(True)
                  for t in (base, pre, p2, midc, bs, gamma, beta, wt)]
        yl = task_merge_library(*leaves[:5], k1, k2, *leaves[5:], idx)
        t_k = median_ms(lambda: task_merge_bwd(*args, gy), reps=5)
        t_p = median_ms(lambda: task_merge_bwd_plain(*args, gy), reps=3)
        t_l = median_ms(lambda: torch.autograd.grad(
            yl, leaves, gy.view(yl.shape), retain_graph=True), reps=5)
        nbytes = (2 * (6 * B * L * C + 2 * T * B * L * 2 * r + T * Mm * O
                       + 2 * T * r * C) + 2 * w_bytes
                  + 4 * (O * K + 2 * K + 2 * T * r * C))
        # dln, dW, the streams' expansion recomputed, dmid and dB
        flops = 4.0 * T * Mm * K * O
        ops32 = 3 * 2.0 * T * B * L * C * 2 * r
        t_b = max(nbytes / PEAK_HBM_BYTES, ops_seconds(flops, ops32)) * 1e3
        print(f"task_merge bwd {res}->{res // 2}: {text} kernel {t_k:.4f} ms "
              f"({t_b / t_k:.4f} of the bound; 32-row blocks in clusters of "
              f"{plan.split}, {plan.ks} columns, tasks in {plan.groups} "
              f"group(s) of {plan.tg}, W's slots "
              f"{plan.slice_bytes / 1e9:.3f} GB, "
              f"{plan.slice_bytes / t_k / 1e9:.3f} TB/s) plain {t_p:.4f} ms "
              f"library backward {t_l:.4f} ms "
              f"{bound_text(nbytes, flops, ops32)}")
        bwd.add(err, t_k, t_p, t_l, nbytes, flops, 1, ops32)
        del args, base, pre, p2, mid1T, mid2T, gy, yl, leaves
    # its own generators: the later checks draw the same tensors as before
    cover = torch.Generator(device="cuda").manual_seed(SEED + 6)
    ccpu = torch.Generator().manual_seed(SEED + 6)
    for label, T, B, res, C in TASK_MERGE_COVERAGE:
        args, gy = task_merge_operands(cover, ccpu, T, B, res, C, 0.1,
                                       (4.0,) * T)
        shape = (f"{label} T {T} x [{B * res * res // 4}, {4 * C}] -> "
                 f"{2 * C}, Wh {res // 2}")
        _, plan, text = check_task_merge_fwd(f"task_merge fwd {shape}", args)
        t_k = median_ms(lambda: task_merge_fwd(*args))
        cost = task_merge_fwd_cost(T, B, res, C)
        print(f"task_merge fwd {shape}: {text} kernel {t_k:.4f} ms "
              f"({fwd_rate_text(plan, t_k, *cost)})")
        label = f"task_merge bwd {shape}"
        _, plan, text = check_task_merge_rows(label, args, gy)
        t_k = median_ms(lambda: task_merge_bwd(*args, gy), reps=5)
        print(f"{label}: {text} kernel {t_k:.4f} ms (32-row blocks in "
              f"clusters of {plan.split}, tasks in {plan.groups} group(s) "
              f"of {plan.tg})")
        del args, gy
    return {"fwd": fwd, "bwd": bwd}


# ---------------------------------------------------------------------------
# Kernel 8 (TPU.USE_PALLAS_LORA_GEMM) and kernel 1c (MTLORA_ATTN_DENSE).
# ---------------------------------------------------------------------------

def lora_gemm_sites(cfg, s):
    """Kernel 8's sites of stage ``s`` in one forward: (name, K, N,
    launches on the adapter route with the GEMM flag, the main path of
    kernel 8), proj in the blocks without task streams; qkv, fc1 and fc2
    run it on the LN-outside route only."""
    C = cfg.embed_dim * 2 ** s
    notask = cfg.depths[s] - 1
    return (("proj", C, C, notask), ("qkv", C, 3 * C, 0),
            ("fc1", C, 4 * C, 0), ("fc2", 4 * C, C, 0))


def lora_gemm_library(x, xd, wt, at, bt, scale):
    """The same function as a chain of cuBLAS calls: the frozen GEMM, the
    two rank-64 products, the scaled add."""
    return torch.addmm(x @ wt.t(), xd @ at.t(), bt.t(), alpha=scale)


def check_lora_matmul(gen) -> dict:
    """Kernel 8 at every site shape of the batch-32 step at 448 (proj,
    qkv, fc1, fc2 at the four stages), one input and two (adapter dropout
    0.05 on the same seeds), and its dx layout; weighted by the adapter
    route's sites, the two-input forward (training) and the dx layout
    (the dropout-off step's backward)."""
    fwd, bwd = Tally(), Tally()
    for s in range(4):
        cfg, _, _, M = stage_dims(s)
        st = cfg.stages[s]
        r, sc, p = st.r_shared, st.shared_scale, st.dropout
        for name, K, N, n in lora_gemm_sites(cfg, s):
            x = torch.randn(M, K, generator=gen, device="cuda").to(
                torch.bfloat16)
            keep = torch.rand(M, K, generator=gen, device="cuda") >= p
            xd = torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
            wt = _uniform(gen, (N, K), K ** -0.5)
            at = _uniform(gen, (r, K), K ** -0.5)
            bt = _uniform(gen, (N, r), r ** -0.5)
            dy = torch.randn(M, N, generator=gen, device="cuda").to(
                torch.bfloat16)
            w_bytes = 2 * (N * K + r * K + N * r)
            flops = 2.0 * M * (K * N + K * r + r * N)
            for two in (False, True):
                d = xd if two else None
                y = lora_matmul_fwd(x, d, wt, at, bt, sc)
                ref = lora_matmul_plain(x, d, wt, at, bt, sc)
                torch.cuda.synchronize()
                err, text = check_outputs(
                    f"lora_matmul {name} stage {s} two {two}", [y], [ref],
                    ["y"], {0})
                t_k = median_ms(lambda: lora_matmul_fwd(x, d, wt, at, bt, sc))
                t_p = median_ms(lambda: lora_matmul_plain(x, d, wt, at, bt,
                                                          sc), reps=5)
                t_l = median_ms(lambda: lora_gemm_library(
                    x, xd if two else x, wt, at, bt, sc))
                nbytes = 2 * M * (K * (2 if two else 1) + N) + w_bytes
                print(f"lora_matmul fwd {name} stage {s} x [{M}, {K}] -> {N} "
                      f"{'two inputs' if two else 'one input'} (x{n}): "
                      f"{text} kernel {t_k:.4f} ms plain {t_p:.4f} ms "
                      f"library {t_l:.4f} ms {bound_text(nbytes, flops)}")
                fwd.add(err, t_k, t_p, t_l, nbytes, flops, n if two else 0)
                del y, ref
            dx = lora_matmul_dx(dy, wt, at, bt, sc)
            ref = lora_matmul_dx_plain(dy, wt, at, bt, sc)
            torch.cuda.synchronize()
            err, text = check_outputs(f"lora_matmul dx {name} stage {s}",
                                      [dx], [ref], ["dx"], {0})
            t_k = median_ms(lambda: lora_matmul_dx(dy, wt, at, bt, sc))
            t_p = median_ms(lambda: lora_matmul_dx_plain(dy, wt, at, bt, sc),
                            reps=5)
            t_l = median_ms(lambda: torch.addmm(dy @ wt, dy @ bt, at,
                                                alpha=sc))
            nbytes = 2 * M * (N + K) + w_bytes
            print(f"lora_matmul dx {name} stage {s} dy [{M}, {N}] -> {K} "
                  f"(x{n}): {text} kernel {t_k:.4f} ms plain {t_p:.4f} ms "
                  f"library {t_l:.4f} ms {bound_text(nbytes, flops)}")
            bwd.add(err, t_k, t_p, t_l, nbytes, flops, n)
            del x, xd, keep, dy, dx, ref
    return {"fwd": fwd, "bwd": bwd}


def dense_shapes(gen):
    """Kernel 1c's shapes: the four Swin-T 448 stages, shifted and not
    (the op admits every one: their window counts, 256, 64, 16 and 4,
    tile the 8-window cells), weight 0, and stage 3 at 224 (one window
    per image, no shift), weight 2: its two blocks, kernel 1c's main
    path. Per shape: (label, qkv, dO, bias, mask, nH, scale, weight)."""
    cfg = tiny_448_r64_pertask()
    for s, shift, qkv, dout, bias, mask, nH, _, scale in attention_shapes(
            gen):
        yield (f"448 stage {s} shift {shift}", qkv, dout, bias, mask, nH,
               scale, 0)
    C, nH = cfg.embed_dim * 8, cfg.num_heads[3]
    qkv = torch.randn(KERNEL_BATCH, 49, 3 * C, generator=gen,
                      device="cuda").to(torch.bfloat16)
    dout = torch.randn(KERNEL_BATCH, 49, C, generator=gen,
                       device="cuda").to(torch.bfloat16)
    bias = 0.1 * torch.randn(nH, 49, 49, generator=gen, device="cuda")
    yield ("224 stage 3", qkv, dout, bias, None, nH, (C // nH) ** -0.5,
           cfg.depths[3])


# kernel 1c's coverage beyond dense_shapes (checked, bit-identical,
# timed; not in the tally): (label, batch, nW, C, heads, shifted) -- the
# batch-2 step's 448 stages, Swin-B's 448 stage 0 (shifted) and its 224
# stage 3 (one window an image, 32 heads)
DENSE_COVERAGE = tuple(
    (f"batch 2 448 stage {s} shift 3", CROSS_BATCH, (16 // 2 ** s) ** 2,
     96 * 2 ** s, 3 * 2 ** s, 3) for s in range(4)) + (
    ("swin-b 448 stage 0 shift 3", KERNEL_BATCH, 256, 128, 4, 3),
    ("swin-b 224 stage 3", KERNEL_BATCH, 1, 1024, 32, 0))


def check_dense_attention(gen) -> dict:
    """Kernel 1c forward and backward against the plain versions and
    against kernels 1 and 1b on the same tensors; its forward also at
    ``DENSE_COVERAGE``."""
    fwd, bwd = Tally(), Tally()
    for label, qkv, dout, bias, mask, nH, scale, n in dense_shapes(gen):
        Bw, N, C3 = qkv.shape
        C, hd = C3 // 3, C3 // 3 // nH
        mb = mask.numel() * 4 if mask is not None else 0
        label = f"attention 1c fwd {label} qkv {tuple(qkv.shape)} nH {nH}"
        err, t_k, nbytes, flops = check_attn_fwd(
            label, window_attention_dense_fwd, qkv, nH, bias, mask, scale,
            True)
        k1 = window_attention_fwd(qkv, nH, bias, mask, scale)
        out = window_attention_dense_fwd(qkv, nH, bias, mask, scale)
        torch.cuda.synchronize()
        e1 = (out.float() - k1.float()).abs().max().item()
        assert e1 <= KERNEL_ATOL, (label, err, e1)
        t_1 = median_ms(lambda: window_attention_fwd(qkv, nH, bias, mask,
                                                     scale))
        q, k, v, am = sdpa_operands(qkv, bias, mask, nH, 1)
        t_p = median_ms(lambda: window_attention(qkv, nH, bias, mask, scale))
        t_l = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=am, scale=scale))
        print(f"{label} (x{n}): max_abs_err {err:.3e} vs plain, {e1:.3e} "
              f"vs kernel 1 (bound {KERNEL_ATOL:.3e}) kernel {t_k:.4f} ms "
              f"kernel 1 {t_1:.4f} ms plain {t_p:.4f} ms sdpa {t_l:.4f} ms "
              f"{bound_text(nbytes, flops)}")
        fwd.add(max(err, e1), t_k, t_p, t_l, nbytes, flops, n)
        dq, db = window_attention_dense_bwd(qkv, nH, bias, mask, scale, dout)
        rq, rb = window_attention_bwd_plain(qkv, nH, bias, mask, scale, dout)
        q1, b1 = window_attention_bwd(qkv, nH, bias, mask, scale, dout)
        torch.cuda.synchronize()
        b_q = BWD_BF16_REL * rq.float().abs().max().item()
        b_b = BWD_FP32_REL * rb.abs().max().item()
        e_q = (dq.float() - rq.float()).abs().max().item()
        e_b = (db - rb).abs().max().item()
        e_q1 = (dq.float() - q1.float()).abs().max().item()
        e_b1 = (db - b1).abs().max().item()
        assert max(e_q, e_q1) <= b_q and max(e_b, e_b1) <= b_b, (
            label, e_q, e_q1, e_b, e_b1)
        t_k = median_ms(lambda: window_attention_dense_bwd(
            qkv, nH, bias, mask, scale, dout))
        t_1 = median_ms(lambda: window_attention_bwd(qkv, nH, bias, mask,
                                                     scale, dout))
        for t in (q, k, v):
            t.requires_grad_(True)
        y = F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=scale)
        g = dout.view(Bw, N, nH, hd).transpose(1, 2).contiguous()
        t_p = median_ms(lambda: window_attention_bwd_plain(
            qkv, nH, bias, mask, scale, dout))
        t_l = median_ms(lambda: torch.autograd.grad(
            y, (q, k, v), g, retain_graph=True))
        nbytes = (2 * Bw * N * C3 * 2 + Bw * N * C * 2 + 2 * nH * N * N * 4
                  + mb)
        flops = 10.0 * Bw * nH * N * N * hd
        print(f"attention 1c bwd {label}: dqkv max_abs_err {e_q:.3e} vs "
              f"plain, {e_q1:.3e} vs 1b (bound {b_q:.3e}) dbias {e_b:.3e} "
              f"vs plain, {e_b1:.3e} vs 1b (bound {b_b:.3e}) kernel "
              f"{t_k:.4f} ms kernel 1b {t_1:.4f} ms plain {t_p:.4f} ms sdpa "
              f"backward {t_l:.4f} ms {bound_text(nbytes, flops)}")
        bwd.add(max(e_q, e_b, e_q1, e_b1), t_k, t_p, t_l, nbytes, flops, n)
    for label, batch, nW, C, nH, shift in DENSE_COVERAGE:
        qkv, bias, mask, scale = coverage_operands(gen, batch, nW, C, nH,
                                                   shift)
        label = f"attention 1c fwd {label} qkv {tuple(qkv.shape)} nH {nH}"
        err, t_k, nbytes, flops = check_attn_fwd(
            label, window_attention_dense_fwd, qkv, nH, bias, mask, scale,
            True)
        print(f"{label}: max_abs_err {err:.3e} (bound {KERNEL_ATOL:.3e}) "
              f"kernel {t_k:.4f} ms {bound_text(nbytes, flops)}")
    return {"fwd": fwd, "bwd": bwd}


# ---------------------------------------------------------------------------
# Phase 3c: the probe kernels of the JAX package's tools/ (kernel 1's body
# with a part switched, kernels 5 and 5b with a part switched, the
# quad-operand attention) against their plain versions, at every shape the
# probe path runs them at (the four attention stages, the adapter at M =
# 32 * 12544); and the GELU form of kernels 2-tail, 4, 4b, 5 and 5b: against
# the tanh plain version (the bound), with the distance to the exact-erf
# form printed beside it.
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_form(form: str):
    """The plain versions on the GELU ``form`` whatever the dtype."""
    saved = ln_lora.gelu_form, adapter_mlp.gelu_form
    ln_lora.gelu_form = adapter_mlp.gelu_form = lambda cdt: form
    try:
        yield
    finally:
        ln_lora.gelu_form, adapter_mlp.gelu_form = saved


def bf16_err(label, got, want):
    """Largest error, asserted within 2^-6 of the largest element."""
    assert got.shape == want.shape and got.dtype == want.dtype, label
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    assert err <= LN_BF16_REL * top, f"{label}: {err} > 2^-6 of {top}"
    return err, f"max_abs_err {err:.3e} (bound {LN_BF16_REL * top:.3e})"


def rel_rms(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def check_gelu_form(gen):
    """Kernels 2-tail, 4, 4b, 5 and 5b at stage 1 against the tanh plain
    versions (the bound of phases 3 and 3b), and the relative RMS distance
    of one output to the tanh and to the exact-erf plain version: the
    first must be under half the second (the kernels' own rounding
    leaves ~1e-4, the form's gap ~1e-3 and more)."""
    cfg, _, C, M = stage_dims(1)
    st = cfg.stages[1]
    O, r, sc, T = 4 * C, st.r_shared, st.shared_scale, len(cfg.tasks)
    x = torch.randn(M, C, generator=gen, device="cuda").to(torch.bfloat16)
    gamma, beta = _ln_params(gen, C)
    tail = (x, gamma, beta, _uniform(gen, (O, C), C ** -0.5),
            _uniform(gen, (O,), 0.02), _uniform(gen, (r, C), C ** -0.5),
            _uniform(gen, (O, r), r ** -0.5), _seed(gen), sc, 0.0)
    mlp = (x, gamma, beta, _uniform(gen, (O, C), C ** -0.5),
           _uniform(gen, (O,), 0.02), _uniform(gen, (r, C), C ** -0.5),
           _uniform(gen, (O, r), r ** -0.5), _uniform(gen, (C, O), O ** -0.5),
           _uniform(gen, (C,), 0.02), _uniform(gen, (r, O), O ** -0.5),
           _uniform(gen, (C, r), r ** -0.5), _seed(gen), sc, sc, 0.0)
    gy = torch.randn(M, C, generator=gen, device="cuda").to(torch.bfloat16)
    mid = ((0.5 * torch.randn(T, 4, M, generator=gen, device="cuda")).to(
        torch.bfloat16), torch.randn(M, O, generator=gen, device="cuda").to(
        torch.bfloat16), _uniform(gen, (T, 4, O), 0.1),
        _uniform(gen, (T, 4, O), O ** -0.5), st.task_scales)
    g = torch.randn(T, 4, M, generator=gen, device="cuda").to(torch.bfloat16)
    cases = [
        ("ln_lora_tail y", lambda: ln_lora_tail_fwd(*tail)[0],
         lambda: ln_lora_tail_plain(*tail)[0]),
        ("ln_mlp y", lambda: ln_mlp_fwd(*mlp), lambda: ln_mlp_plain(*mlp)),
        ("ln_mlp_bwd dx", lambda: ln_mlp_bwd(*mlp, gy)[0],
         lambda: ln_mlp_bwd_plain(*mlp, gy)[0]),
        ("adapter_mid mid2T", lambda: adapter_mid_fwd(*mid),
         lambda: adapter_mid_plain(*mid)),
        ("adapter_mid_bwd dp1", lambda: adapter_mid_bwd(*mid, g)[1],
         lambda: adapter_mid_bwd_plain(*mid, g)[1]),
    ]
    for label, kernel, plain in cases:
        got = kernel()
        want = plain()
        with plain_form("erf"):
            erf = plain()
        torch.cuda.synchronize()
        _, text = bf16_err(f"gelu form {label}", got, want)
        d_tanh, d_erf = rel_rms(got, want), rel_rms(got, erf)
        print(f"gelu form stage 1 {label}: vs tanh plain {text}; rel_rms "
              f"to the tanh plain {d_tanh:.3e}, to the erf plain "
              f"{d_erf:.3e}")
        assert d_tanh < 0.5 * d_erf, f"{label} is not the tanh form"
        del got, want, erf


def attn_probe_library(mode, qkv, bias, mask, nH, nW, scale):
    """One PyTorch call (chain) per mode with one: SDPA for ``full``, bmm
    chains for ``nosmax`` and ``dots_only``; None for the others."""
    if mode not in ("full", "nosmax", "dots_only"):
        return None
    q, k, v, am = sdpa_operands(qkv, bias, mask, nH, nW)
    if mode == "full":
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                      scale=scale)
    Bw, _, N, hd = q.shape
    q3, k3, v3 = (t.reshape(Bw * nH, N, hd) for t in (q, k, v))
    qs = q3 * scale
    if mode == "dots_only":
        return lambda: torch.bmm(torch.bmm(qs, k3.transpose(1, 2)), v3)
    am3 = am.reshape(Bw * nH, N, N)
    return lambda: torch.bmm(torch.baddbmm(am3, qs, k3.transpose(1, 2)), v3)


def attn_probe_cost(mode, Bw, N, C, nH, nW, masked):
    """(bytes, bf16 tensor-core flops, fp32 operations) that a probe mode's
    output needs. The card reads in 32-byte sectors: ``nodots`` needs the
    sector of each head's first q and k lane (the head's 32 lanes span two
    sectors or more) and all of v; ``softmax_only`` the sector of each
    token's first qkv column; ``dots_only`` no bias and no mask."""
    hd, sector = C // nH, 32
    qkv = {"nodots": Bw * N * (2 * C + 2 * nH * sector),
           "softmax_only": Bw * N * sector}.get(mode, Bw * N * 3 * C * 2)
    bias = 0 if mode == "dots_only" else nH * N * N * 4
    nbytes = qkv + bias + (nW * N * N * 4 if masked else 0) + Bw * N * C * 2
    dots = {"full": 2, "nosmax": 2, "nodots": 1, "dots_only": 2,
            "softmax_only": 0}[mode]
    flops = 2.0 * dots * Bw * nH * N * N * hd
    # the softmax: about 8 operations per score
    ops32 = (8.0 * Bw * nH * N * N
             if mode in ("full", "nodots", "softmax_only") else 0.0)
    return nbytes, flops, ops32


def check_attention_probes(gen) -> dict:
    """Each mode of kernel 1's probe and the quad-operand attention at the
    four stage shapes of the probe path (batch 32), with and without the
    shift mask where the mode takes one."""
    out = {mode: Tally() for mode in (*PROBE_MODES, "quad_pre")}
    for stage in attn_probe.STAGES:
        qkv, bias, mask, nH, scale = attn_probe.stage_inputs(stage, gen)
        Bw, N, C3 = qkv.shape
        C, nW = C3 // 3, mask.shape[0]
        for mode in PROBE_MODES:
            for m in ((None,) if mode in UNMASKED_MODES else (None, mask)):
                args = (qkv, nH, bias, m, scale, mode)
                got = window_attention_probe(*args)
                want = window_attention_probe_plain(*args)
                torch.cuda.synchronize()
                err, text = bf16_err(f"attention probe {mode} {stage}", got,
                                     want)
                del got, want
                t_k = median_ms(lambda: window_attention_probe(*args))
                t_p = median_ms(lambda: window_attention_probe_plain(*args))
                lib = attn_probe_library(mode, qkv, bias, m, nH, nW, scale)
                t_l = median_ms(lib) if lib else None
                cost = attn_probe_cost(mode, Bw, N, C, nH, nW, m is not None)
                lib_text = f"{t_l:.4f} ms" if t_l is not None else "none"
                print(f"attention probe {mode} {stage} qkv "
                      f"{tuple(qkv.shape)} shift {m is not None}: {text} "
                      f"kernel {t_k:.4f} ms plain {t_p:.4f} ms library "
                      f"{lib_text} {bound_text(*cost)}")
                out[mode].add(err, t_k, t_p, t_l, cost[0], cost[1], 1,
                              cost[2])
        del qkv, bias, mask
        qb, kb, qbias = attn_probe.quad_inputs(stage, gen)
        nq, nH, Rq, D = qb.shape
        Nk = kb.shape[3]
        got = quad_attention(qb, kb, qbias)
        want = quad_attention_plain(qb, kb, qbias)
        torch.cuda.synchronize()
        err, text = bf16_err(f"quad_pre attention {stage}", got, want)
        del want
        t_k = median_ms(lambda: quad_attention(qb, kb, qbias))
        t_p = median_ms(lambda: quad_attention_plain(qb, kb, qbias))
        q3 = qb.reshape(nq * nH, Rq, D)
        k3 = kb[:, :, 0].reshape(nq * nH, Nk, D)
        v3 = kb[:, :, 1].reshape(nq * nH, Nk, D)
        b3 = qbias.to(torch.bfloat16)[None].expand(nq, nH, Rq, Nk).reshape(
            nq * nH, Rq, Nk)

        def quad_library():
            p = torch.softmax(torch.baddbmm(b3, q3, k3.transpose(1, 2)), -1)
            return torch.bmm(p, v3).view(nq, nH, Rq, 4, 32).sum(3)

        t_l = median_ms(quad_library)
        nbytes = (2 * (qb.numel() + kb.numel()) + 4 * qbias.numel()
                  + 2 * got.numel())
        flops = 4.0 * nq * nH * Rq * Nk * D
        ops32 = 8.0 * nq * nH * Rq * Nk
        print(f"quad_pre attention {stage} qb {tuple(qb.shape)} kb "
              f"{tuple(kb.shape)}: {text} kernel {t_k:.4f} ms plain "
              f"{t_p:.4f} ms library {t_l:.4f} ms "
              f"{bound_text(nbytes, flops, ops32)}")
        out["quad_pre"].add(err, t_k, t_p, t_l, nbytes, flops, 1, ops32)
        del got, qb, kb, qbias, q3, k3, v3, b3
    return out


def adapter_probe_library(name, mid1T, p1, b1, a2T, sv):
    """A PyTorch chain for the forward probes that F.gelu or no activation
    computes (base, tanh, noact, nodot1); None for the others."""
    if name in ("base", "tanh"):
        form = "none" if name == "base" else "tanh"
        return lambda: adapter_library(mid1T, p1, b1, a2T, sv, form)
    if name == "noact":
        return lambda: torch.bmm(a2T, (p1[None] + sv * torch.bmm(
            mid1T.transpose(1, 2), b1)).transpose(1, 2))
    if name == "nodot1":
        return lambda: torch.bmm(a2T, F.gelu(sv * p1[None]).transpose(1, 2))
    return None


def check_adapter_probes(gen) -> dict:
    """Each forward and backward probe of kernels 5 and 5b at the probe
    path's shape: T 4, rank 4, M = 32 * 12544, H4 = 384, bf16 (the probe's
    inputs)."""
    M, T, r = adapter_variants.TOKENS, adapter_variants.TASKS, 4
    H4 = adapter_variants.H4
    scales = adapter_variants.SCALES
    mid1T, p1, b1, a2T, g = adapter_variants.inputs(gen, M)
    mid1N = mid1T.transpose(1, 2).contiguous()
    sv = torch.tensor(scales, device="cuda").view(T, 1, 1).to(torch.bfloat16)
    out = {}
    for name, (_, form, kind) in FWD_PROBES.items():
        mid = mid1N if kind in ("vpu1", "vpu12") else mid1T
        args = (mid, p1, b1, a2T, scales, name)
        got = adapter_mid_probe(*args)
        want = adapter_mid_probe_plain(*args)
        torch.cuda.synchronize()
        err, text = bf16_err(f"adapter probe fwd {name}", got, want)
        t_k = median_ms(lambda: adapter_mid_probe(*args))
        t_p = median_ms(lambda: adapter_mid_probe_plain(*args), reps=5)
        lib = adapter_probe_library(name, mid1T, p1, b1, a2T, sv)
        t_l = median_ms(lib, reps=5) if lib else None
        # mid1 and B1 (not read without the rank expansion), p1, A2, out
        nbytes = 2 * ((T * r * M + T * r * H4 if kind != "nodot1" else 0)
                      + M * H4 + T * r * H4 + T * r * M)
        # the activation, the rank-r expansion (one multiply without it)
        # and the rank-r projection, 2 r operations each
        ops32 = float(T) * M * H4 * (ACT_OPS[form][0]
                                     + (2 * r if kind != "nodot1" else 1)
                                     + 2 * r)
        lib_text = f"{t_l:.4f} ms" if t_l is not None else "none"
        print(f"adapter probe fwd {name} T {T} M {M} H4 {H4}: {text} kernel "
              f"{t_k:.4f} ms plain {t_p:.4f} ms library {lib_text} "
              f"{bound_text(nbytes, 0.0, ops32)}")
        out[f"fwd {name}"] = Tally()
        out[f"fwd {name}"].add(err, t_k, t_p, t_l, nbytes, 0.0, 1, ops32)
        del got, want
    for name, (_, form) in BWD_PROBES.items():
        args = (mid1T, p1, b1, a2T, scales, g, name)
        got = adapter_mid_bwd_probe(*args)
        want = adapter_mid_bwd_probe_plain(*args)
        torch.cuda.synchronize()
        err, text = check_outputs(f"adapter probe bwd {name}", got, want,
                                  ("dmid1T", "dp1", "dB1", "dA2T"), {0, 1})
        del got, want
        t_k = median_ms(lambda: adapter_mid_bwd_probe(*args), reps=5)
        t_p = median_ms(lambda: adapter_mid_bwd_probe_plain(*args), reps=3)
        t_l = None
        if name != "sig":
            leaves = [t.detach().requires_grad_(True)
                      for t in (mid1T, p1, b1, a2T)]
            yl = adapter_library(*leaves, sv,
                                 "none" if name == "base" else "tanh")
            t_l = median_ms(lambda: torch.autograd.grad(
                yl, leaves, g, retain_graph=True), reps=5)
            del yl, leaves
        nbytes = (2 * (3 * T * r * M + 2 * M * H4 + 2 * T * r * H4)
                  + 4 * 2 * T * r * H4)
        ops32 = float(T) * M * H4 * (ACT_OPS[form][1] + 10 * r)
        lib_text = f"{t_l:.4f} ms" if t_l is not None else "none"
        print(f"adapter probe bwd {name}: {text} kernel {t_k:.4f} ms plain "
              f"{t_p:.4f} ms library backward {lib_text} "
              f"{bound_text(nbytes, 0.0, ops32)}")
        out[f"bwd {name}"] = Tally()
        out[f"bwd {name}"].add(err, t_k, t_p, t_l, nbytes, 0.0, 1, ops32)
    return out


def probe_path() -> dict:
    """The probe path: each tools entry point's ``main`` once at its full
    shapes, with few launches; returns the launches of the run."""
    counters.reset()
    args = ["--reps", "2", "--rounds", "1"]
    attn_probe.main(args)
    adapter_variants.main(args)
    torch.cuda.synchronize()
    return counters.read()


def lora_gemm_launches(cfg) -> int:
    """Kernel 8 launches per forward: every MTLoRALinear with a shared
    adapter, no task branch and no LN kernel; on the LN routes proj of the
    blocks without task streams (kernel 2 takes qkv, kernel 4 their MLP),
    LN outside also qkv of every block and fc1, fc2 of those blocks."""
    if not cfg.use_pallas_lora_gemm:
        return 0
    n_blocks, stages = sum(cfg.depths), len(cfg.depths)
    notask = n_blocks - stages
    return notask if cfg.use_pallas_ln else n_blocks + 3 * notask


def dense_blocks(cfg, batch: int) -> int:
    """Blocks whose attention takes kernel 1c at ``batch``: the stages with
    one window per image (the window clamps, no shift), where
    ``dense_applies`` says the JAX model takes the dense cells."""
    if not cfg.attn_dense:
        return 0
    n = 0
    for s, depth in enumerate(cfg.depths):
        res = cfg.img_size // cfg.patch_size // 2 ** s
        ws = min(cfg.window_size, res)
        nw = (res // ws) ** 2
        if nw == 1 and dense_applies(torch.bfloat16, ws * ws, nw, batch,
                                     None):
            n += depth
    return n


def launches_per_pass(cfg, backward: bool, batch: int,
                      dropout: bool = True) -> dict:
    """Exact kernel launches of one forward (or training step) at
    ``batch``: attention in every block (kernel 1c in the blocks of
    :func:`dense_blocks`), a head per task; on the LN route kernel 2 in
    every block, kernel 4 in the blocks with no task streams and kernel 3
    on the shared and the task streams at every merge; kernel 8 at
    :func:`lora_gemm_launches`; each doubled by the backward, but for
    kernel 8: its dx layout runs only when nothing is dropped
    (``dropout`` False), its two-input backward is plain products."""
    n_blocks, stages = sum(cfg.depths), len(cfg.depths)
    dense = dense_blocks(cfg, batch)
    fwd = {"window_attention": n_blocks - dense,
           "window_attention_dense": dense,
           "hrnet_head_mlp": len(cfg.tasks)}
    if cfg.use_pallas_ln:
        fwd.update(ln_lora=n_blocks, ln_mlp=n_blocks - stages,
                   patch_merge=2 * (stages - 1))
    if cfg.use_pallas_adapter:
        # the stage-tail blocks: fc1 in kernel 2's tail mode, fc2's task
        # branch in kernel 5; the merges take the task streams in kernel 6
        fwd.update(ln_lora_tail=stages, adapter_mid=stages,
                   patch_merge=stages - 1, task_merge=stages - 1)
    want = dict.fromkeys(counters.read(), 0)
    for name, n in fwd.items():
        want[name] = n
        if backward:
            want[name + "_bwd"] = n
    want["lora_matmul"] = lora_gemm_launches(cfg)
    if backward and not dropout:
        want["lora_matmul_dx"] = want["lora_matmul"]
    return want


def routes():
    """The configurations of phases 4 to 8, each path's first the one whose
    launches the kernels line reports: the adapter route (TPU.USE_PALLAS_LN
    and USE_PALLAS_ADAPTER on, the JAX package's default and the main
    path), the LN route without the adapter kernels and the route with
    LayerNorm outside the GEMMs; path A, TPU.USE_PALLAS_LORA_GEMM on the
    adapter and the LN-outside routes; path B, the adapter route at the
    JAX package's default size, 224, with MTLORA_ATTN_DENSE."""
    yield tiny_448_r64_pertask()
    yield tiny_448_r64_pertask(use_pallas_adapter=False)
    yield tiny_448_r64_pertask(use_pallas_ln=False)
    yield tiny_448_r64_pertask(use_pallas_lora_gemm=True)
    yield tiny_448_r64_pertask(use_pallas_ln=False, use_pallas_lora_gemm=True)
    yield dataclasses.replace(tiny_448_r64_pertask(), img_size=224,
                              attn_dense=True)


def path_of(cfg) -> str:
    """"A" (kernel 8's path), "B" (kernel 1c's) or "main"."""
    if cfg.use_pallas_lora_gemm:
        return "A"
    return "B" if cfg.attn_dense else "main"


def route_name(cfg) -> str:
    if cfg.use_pallas_adapter:
        name = "adapter route (TPU.USE_PALLAS_LN and USE_PALLAS_ADAPTER on)"
    elif cfg.use_pallas_ln:
        name = "LN route (TPU.USE_PALLAS_LN on, USE_PALLAS_ADAPTER off)"
    else:
        name = "LN-outside route (TPU.USE_PALLAS_LN off)"
    if cfg.use_pallas_lora_gemm:
        name += " + TPU.USE_PALLAS_LORA_GEMM"
    if cfg.attn_dense:
        name += " + MTLORA_ATTN_DENSE"
    return f"{name} at {cfg.img_size}"


def cross_request(cfg) -> int:
    """The request that phase 5 checks on the CPU: the 1-image one, or the
    8-image one where kernel 1c runs (it needs 8-window cells)."""
    return 1 if cfg.attn_dense else 0


def serve_requests(model, cfg) -> tuple:
    """Phase 4; returns (launch counts of the run, the images and outputs
    of the request that phase 5 checks)."""
    counters.reset()
    first = None
    per_forward = []
    for i, batch in enumerate(REQUESTS):
        images = synthetic_images(batch, cfg.img_size, SEED + i)
        before = counters.read()
        out = predict(model, images)
        torch.cuda.synchronize()
        after = counters.read()
        per_forward.append({k: after[k] - before[k] for k in after})
        want = launches_per_pass(cfg, backward=False, batch=batch)
        assert per_forward[-1] == want, \
            f"expected {want} launches per forward, got {per_forward[-1]}"
        for task, n in zip(cfg.tasks, cfg.num_outputs):
            y = out[task]
            assert y.shape == (batch, cfg.img_size, cfg.img_size, n), \
                (task, tuple(y.shape))
            assert bool(torch.isfinite(y).all()), f"{task}: non-finite"
        print(f"serve request {i}: {batch} images -> "
              + ", ".join(f"{t} {tuple(out[t].shape)}" for t in cfg.tasks)
              + f"; launches {per_forward[-1]}")
        if i == cross_request(cfg):
            first = (images, {t: v.float().cpu() for t, v in out.items()})
    return counters.read(), first


def cross_check(model, cfg, images, card_out):
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    cpu = build_mtl_model(cfg32, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    ref = predict(cpu, images)
    secs = time.perf_counter() - t0
    worst = 0.0
    for task in cfg.tasks:
        a, b = card_out[task], ref[task]
        rel_rms = ((a - b).norm() / b.norm()).item()
        rel_max = ((a - b).abs().max() / b.abs().max()).item()
        print(f"cross-check {task}: card bf16 vs CPU fp32 rel_rms "
              f"{rel_rms:.3e} (bound {CROSS_REL_RMS:.1e}) rel_max "
              f"{rel_max:.3e}")
        assert rel_rms <= CROSS_REL_RMS, f"{task} disagrees: {rel_rms}"
        worst = max(worst, rel_rms)
    print(f"cross-check: CPU fp32 forward took {secs:.1f} s; cudnn.allow_tf32"
          f"={torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} (only the card's bf16 "
          f"path ran there)")
    return worst


def train_phase(cfg, card) -> dict:
    """Phase 7: returns the kernel launches of the checked steps."""
    model = random_model(cfg, SEED, "cuda")
    # the flagship's TRAIN settings at the base LR from the first update
    # (no warmup), so that every trainable moves in 3 steps
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, warmup_epochs=0)
    opt = build_optimizer(model, tcfg)
    sched = build_schedule(tcfg, ITERS_PER_EPOCH)
    batch = synthetic_batch(TRAIN_BATCH, cfg.img_size, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    stats0 = {k: b.clone() for k, b in model.named_buffers()
              if k.endswith("running_mean") or k.endswith("running_var")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = launches_per_pass(cfg, backward=True, batch=TRAIN_BATCH)
    counters.reset()
    had_grad = set()
    for i in range(TRAIN_STEPS):
        before = counters.read()
        m = train_step(model, opt, sched, batch, gen,
                       clip_grad=tcfg.clip_grad)
        torch.cuda.synchronize()
        after = counters.read()
        step_counts = {k: after[k] - before[k] for k in after}
        vals = {k: float(v) for k, v in m.items()}
        print(f"train step {i}: " + " ".join(f"{k} {v:.5f}"
                                             for k, v in vals.items())
              + f"; launches {step_counts}")
        assert all(v == v and abs(v) != float("inf") for v in vals.values())
        assert step_counts == want, f"expected {want}, got {step_counts}"
        had_grad |= {k for k, p in params.items()
                     if p.grad is not None and bool(p.grad.any())}
    counts = counters.read()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    frozen = [k for k, p in params.items() if not p.requires_grad]
    assert frozen and all(".linear." in k for k in frozen)
    for k in frozen:
        assert torch.equal(params[k], start[k]), f"frozen {k} moved"
    unmoved = [k for k in had_grad if torch.equal(params[k], start[k])]
    assert not unmoved, f"trainables with gradients did not move: {unmoved}"
    for k, v in stats0.items():
        assert not torch.equal(model.get_buffer(k), v), f"{k} did not move"
    print(f"train: {len(frozen)} frozen tensors bit-unchanged, "
          f"{len(had_grad)} trainable tensors with gradients all moved, "
          f"{len(stats0)} BN running statistics moved; peak memory "
          f"{peak:.2f} GiB at batch {TRAIN_BATCH}")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(TRAIN_TIMED):
        train_step(model, opt, sched, batch, gen, clip_grad=tcfg.clip_grad)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / TRAIN_TIMED
    print(f"train throughput: {TRAIN_BATCH / (ms / 1e3):.2f} img/s at batch "
          f"{TRAIN_BATCH} ({ms:.2f} ms/step, bf16, dropout and drop-path "
          f"on) on {card}")
    TRAIN_RATES.setdefault(path_of(cfg), TRAIN_BATCH / (ms / 1e3))
    return counts


def train_cross_check(cfg) -> dict:
    """Phase 8: one step on the card in bf16 and on the CPU in fp32, at
    batch 2, or 8 where kernel 1c runs; returns the card step's exact
    launches (with dropout off, kernel 8's backward is its dx layout)."""
    batch_size = 8 if cfg.attn_dense else CROSS_BATCH
    cfg0 = dataclasses.replace(
        cfg, drop_path_rate=0.0,
        stages=tuple(dataclasses.replace(s, dropout=0.0) for s in cfg.stages))
    card = random_model(cfg0, SEED + 1, "cuda")
    cpu = build_mtl_model(dataclasses.replace(cfg0, compute_dtype="float32"),
                          device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    tcfg = TrainConfig(batch_size=batch_size, warmup_epochs=0)
    results = []
    for model, device in ((card, "cuda"), (cpu, "cpu")):
        opt = build_optimizer(model, tcfg)
        batch = synthetic_batch(batch_size, cfg.img_size, SEED + 1, device)
        t0 = time.perf_counter()
        counters.reset()
        m = train_step(model, opt, build_schedule(tcfg, ITERS_PER_EPOCH),
                       batch, None, clip_grad=tcfg.clip_grad)
        if device == "cuda":
            torch.cuda.synchronize()
            card_counts = counters.read()
        grads = torch.cat([p.grad.detach().float().cpu().flatten()
                           for _, p in sorted(model.named_parameters())
                           if p.requires_grad])
        results.append(({k: float(v) for k, v in m.items()}, grads,
                        time.perf_counter() - t0))
    (mc, gc, _), (mf, gf, secs) = results
    for t in cfg.tasks:
        k = f"loss_{t}"
        rel = abs(mc[k] - mf[k]) / abs(mf[k])
        print(f"train cross-check {k}: card {mc[k]:.6f} CPU {mf[k]:.6f} "
              f"rel {rel:.3e} (bound {TRAIN_LOSS_REL:.0e})")
        assert rel <= TRAIN_LOSS_REL, f"{k} disagrees: {rel}"
    rel = abs(mc["grad_norm"] - mf["grad_norm"]) / mf["grad_norm"]
    cos = float(torch.dot(gc.double(), gf.double())
                / (gc.double().norm() * gf.double().norm()))
    print(f"train cross-check grad_norm: card {mc['grad_norm']:.5f} CPU "
          f"{mf['grad_norm']:.5f} rel {rel:.3e} (bound "
          f"{TRAIN_GRAD_NORM_REL:.0e}); cosine of the {gc.numel()} trainable "
          f"gradients {cos:.5f} (bound >= {TRAIN_GRAD_COSINE}); CPU fp32 "
          f"step took {secs:.1f} s")
    assert rel <= TRAIN_GRAD_NORM_REL, f"grad_norm disagrees: {rel}"
    assert cos >= TRAIN_GRAD_COSINE, f"gradients disagree: cosine {cos}"
    want = launches_per_pass(cfg0, backward=True, batch=batch_size,
                             dropout=False)
    print(f"train cross-check at batch {batch_size}: card launches "
          f"{card_counts}")
    assert card_counts == want, f"expected {want}, got {card_counts}"
    return card_counts


def score_items(scores) -> dict:
    """``{task/metric[/class]: value}`` of a score dict, per-class IoUs
    included."""
    out = {}
    for task, res in scores.items():
        for k, v in res.items():
            vals = v if isinstance(v, list) else [v]
            for i, x in enumerate(vals):
                key = f"{task}/{k}" + (f"/{i}" if isinstance(v, list) else "")
                out[key] = float(x)
    return out


def largest_diff(a: dict, b: dict, rel: bool = False) -> tuple:
    """(key, difference) of the largest |a - b| (relative to |b| with
    ``rel``) over the keys of ``a``."""
    diffs = {k: abs(a[k] - b[k]) / (abs(b[k]) if rel else 1.0) for k in a}
    key = max(diffs, key=diffs.get)
    return key, diffs[key]


def check_meters(model, batch, cfg, label):
    """The meters on the card against the same meters on the CPU, on the
    card's ``get_output`` results for ``batch`` (bf16 path): every
    confusion and pixel count equal, every fp32 sum within
    ``METER_SUM_REL``, every threshold count within ``METER_FLIP_SHARE``
    of the pixels tested."""
    weight = batch.get("_valid")
    with torch.inference_mode():
        preds = predict(model, batch["image"])
        outs = {t: get_output(preds[t], t) for t in cfg.tasks}
        card = PerformanceMeter(cfg.tasks, "PASCALContext", "cuda")
        card.update(outs, batch, processed=True, weight=weight)
        cpu = PerformanceMeter(cfg.tasks, "PASCALContext", "cpu")
        cpu.update({t: v.cpu() for t, v in outs.items()},
                   {t: batch[t].cpu() for t in cfg.tasks}, processed=True,
                   weight=None if weight is None else weight.cpu())
    pixels = batch["image"][..., 0].numel()
    worst, flips = 0.0, 0.0
    for t in cfg.tasks:
        for k, v in card.states[t].items():
            a, b = v.double().cpu(), cpu.states[t][k].double()
            if k in METER_SUM_KEYS:
                rel = float((a - b).abs().max()
                            / b.abs().max().clamp(min=1e-30))
                assert rel <= METER_SUM_REL, f"meter {t}.{k}: rel {rel}"
                worst = max(worst, rel)
            elif (t, k) in METER_THRESHOLD_COUNTS:
                n = float((a - b).abs().max()) / METER_THRESHOLD_COUNTS[t, k]
                assert n <= METER_FLIP_SHARE * pixels, \
                    f"meter {t}.{k}: {n} pixels flipped"
                flips = max(flips, n)
            else:
                assert torch.equal(a, b), f"meter {t}.{k}: {a} vs {b}"
    print(f"meters ({label}): card = CPU on every confusion and pixel "
          f"count, fp32 sums within {worst:.2e} relative (bound "
          f"{METER_SUM_REL:.0e}), threshold counts within {flips:.0f} "
          f"pixels (bound {METER_FLIP_SHARE * pixels:.1f} of {pixels})")


def eval_cross_check(model, cfg) -> tuple:
    """The fp32 clone's validate of one 2-image batch (one row padded) on
    the card against the same weights and batch on the CPU in fp32; returns
    the largest (score, loss) differences."""
    cpu = build_mtl_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    runs = []
    for m, device in ((model, "cuda"), (cpu, "cpu")):
        batch = synthetic_eval_batches(1, CROSS_BATCH, cfg.img_size, SEED + 2,
                                       device)
        t0 = time.perf_counter()
        runs.append(validate(m, batch, cfg.tasks, "PASCALContext", "float32")
                    + (time.perf_counter() - t0,))
    (sc, lc, _), (sf, lf, secs) = runs
    skey, sdiff = largest_diff(score_items(sc), score_items(sf))
    lkey, ldiff = largest_diff(lc, lf, rel=True)
    print(f"eval cross-check (fp32 clone, card vs CPU, batch {CROSS_BATCH} "
          f"with 1 valid row): largest score difference {sdiff:.3e} at "
          f"{skey} (bound {EVAL_SCORE_ABS:.0e} absolute), largest loss "
          f"difference {ldiff:.3e} relative at {lkey} (bound "
          f"{EVAL_LOSS_REL:.0e}); CPU validate took {secs:.1f} s")
    assert sdiff <= EVAL_SCORE_ABS, f"score {skey} disagrees: {sdiff}"
    assert ldiff <= EVAL_LOSS_REL, f"loss {lkey} disagrees: {ldiff}"
    return sdiff, ldiff


def eval_phase(card) -> dict:
    """Phase 9, on the adapter route: the eval forward img/s of both
    paths; validate on both with exact launches and no host sync in the
    loop, its img/s; the meters and the clone against the CPU; returns
    the launches of the bf16 run."""
    cfg = tiny_448_r64_pertask()
    model = random_model(cfg, SEED, "cuda")
    batches = synthetic_eval_batches(EVAL_BATCHES, THROUGHPUT_BATCH,
                                     cfg.img_size, SEED, "cuda",
                                     EVAL_VALID_LAST)
    per_forward = launches_per_pass(cfg, backward=False,
                                    batch=THROUGHPUT_BATCH)
    # the forward rates first, and a validate of the first batch on each
    # path: they warm both paths and the meters' kernels for the timed loops
    rates = eval_throughput(model, batches[0]["image"], "float32", iters=5)
    for path, rate in rates.items():
        print(f"eval throughput ({path}): {rate:.2f} img/s forward at batch "
              f"{THROUGHPUT_BATCH} on {card}")
    for dtype in ("bfloat16", "float32"):
        validate(model, batches[:1], cfg.tasks, "PASCALContext", dtype)
    results = {}
    for dtype in ("bfloat16", "float32"):
        want = ({k: EVAL_BATCHES * n for k, n in per_forward.items()}
                if dtype == "bfloat16" else dict.fromkeys(per_forward, 0))
        torch.cuda.synchronize()
        counters.reset()
        t0 = time.perf_counter()
        scores, losses = validate(model, batches, cfg.tasks, "PASCALContext",
                                  dtype, sync_debug="error")
        secs = time.perf_counter() - t0
        counts = counters.read()
        path = "bf16 + kernels" if dtype == "bfloat16" else "fp32 clone"
        assert counts == want, \
            f"validate ({path}): expected {want}, got {counts}"
        items = score_items(scores)
        bad = [k for k, v in {**items, **losses}.items()
               if v != v or abs(v) == float("inf")]
        assert not bad, f"validate ({path}): non-finite {bad}"
        results[dtype] = (items, losses, counts)
        main_scores = {t: {k: round(v, 5) for k, v in r.items()
                           if not isinstance(v, list)}
                       for t, r in scores.items()}
        print(f"validate ({path}, TPU.EVAL_DTYPE {dtype}): "
              f"{EVAL_BATCHES} batches of {THROUGHPUT_BATCH} (last "
              f"{EVAL_VALID_LAST} valid) in {secs:.3f} s, "
              f"{EVAL_BATCHES * THROUGHPUT_BATCH / secs:.2f} img/s on {card}, "
              f"no host sync in the loop; scores {main_scores}; loss "
              f"{ {t: round(v, 6) for t, v in losses.items()} }; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
    (ib, lb, counts), (i32, l32, _) = results["bfloat16"], results["float32"]
    skey, sdiff = largest_diff(ib, i32)
    lkey, ldiff = largest_diff(lb, l32, rel=True)
    print(f"validate bf16 path vs fp32 clone (reported, not gated): largest "
          f"score difference {sdiff:.4e} at {skey}, largest loss difference "
          f"{ldiff:.4e} relative at {lkey}")
    check_meters(model, batches[0], cfg, "first batch")
    check_meters(model, batches[-1], cfg, "padded last batch")
    eval_cross_check(model, cfg)
    return counts


# phase 10: the data pipeline feeding the adapter route at batch 32
DATA_TRAIN_BATCHES = 7          # the train loader's epoch: 224 samples
DATA_DET_LEN, DATA_DET_BATCH = 16, 4   # the determinism check's set
DATA_VAL_LEN = 84               # val batches of 32, 32 and 20 (padded)
DATA_TIMED = 3                  # timed train steps on the fixed batch
# worker processes of the loaders: the cores this process may run on, one
# left to it, at most 7 (the card's machine has 8)
LOADER_MAX_WORKERS = 7


def loader_workers() -> int:
    return max(1, min(len(os.sched_getaffinity(0)) - 1, LOADER_MAX_WORKERS))


def synthetic_loader(cfg, n, train, workers, batch=TRAIN_BATCH):
    """A pinned loader over ``SyntheticMTL(structured=True)`` of ``n``
    samples through the train transforms (shuffled, dropping last) or the
    eval transforms (in order, the last batch padded)."""
    tc, _ = get_tasks_config("PASCALContext", list(cfg.tasks), cfg.img_size)
    tr, tv = get_transformations("PASCALContext", tc)
    ds = SyntheticMTL(cfg.tasks, cfg.img_size, length=n, seed=SEED,
                      structured=True, transform=tr if train else tv)
    kw = (dict(seed=SEED) if train else
          dict(shuffle=False, drop_last=False, pad_last=True,
               pad_fill=ignore_fill_sample))
    return DataLoader(ds, batch, num_workers=workers, pin_memory=True,
                      persistent_workers=workers > 0, **kw)


def same_batches(a, b) -> bool:
    """Two lists of loader batches equal bit for bit, meta included."""
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(
            x[k] == y[k] if k == "meta" else torch.equal(x[k], y[k])
            for k in x) for x, y in zip(a, b))


def check_loader_determinism(cfg, workers):
    """Epoch 0 of a train loader (16 samples in batches of 4, so that the
    workers share the epoch) bit-identical with 0 workers and with
    ``workers`` persistent workers, and over two passes of the latter;
    epoch 1 different."""
    n, batch = DATA_DET_LEN, DATA_DET_BATCH
    t0 = time.perf_counter()
    alone = list(synthetic_loader(cfg, n, True, 0, batch).iter_epoch(0))
    loader = synthetic_loader(cfg, n, True, workers, batch)
    first = list(loader.iter_epoch(0))
    second = list(loader.iter_epoch(0))
    other = list(loader.iter_epoch(1))
    del loader
    assert len(alone) == n // batch, len(alone)
    assert same_batches(alone, first), f"0 and {workers} workers differ"
    assert same_batches(first, second), "two passes of epoch 0 differ"
    assert not torch.equal(first[0]["image"], other[0]["image"]), \
        "epoch 1 repeats epoch 0"
    print(f"loader determinism: epoch 0 ({n // batch} batches of "
          f"{batch}, train transforms at {cfg.img_size}) bit-identical "
          f"with 0 workers, with {workers} persistent workers and over two "
          f"passes; epoch 1 differs ({time.perf_counter() - t0:.1f} s)")


def loader_rate(loader, epoch) -> float:
    """img/s of one epoch of ``loader`` alone (its workers up already)."""
    t0 = time.perf_counter()
    n = sum(b["image"].shape[0] for b in loader.iter_epoch(epoch))
    return n / (time.perf_counter() - t0)


def data_train(cfg, card, workers):
    """The train loader feeds 3 checked steps (phase 7's checks: finite
    losses, exact launches per step), then the timed steps fed by it
    against the timed steps on a fixed batch."""
    model = random_model(cfg, SEED, "cuda")
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, warmup_epochs=0)
    opt = build_optimizer(model, tcfg)
    sched = build_schedule(tcfg, ITERS_PER_EPOCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    loader = synthetic_loader(cfg, DATA_TRAIN_BATCHES * TRAIN_BATCH, True,
                              workers)
    t0 = time.perf_counter()
    assert loader_rate(loader, 0) > 0     # starts the workers
    start_s = time.perf_counter() - t0
    rate = loader_rate(loader, 1)
    print(f"loader alone: {rate:.2f} img/s (train transforms at "
          f"{cfg.img_size}, {workers} workers, an epoch of "
          f"{DATA_TRAIN_BATCHES} batches of {TRAIN_BATCH}; the first epoch, "
          f"workers starting, took {start_s:.1f} s) on {card}")
    stream = epochs(loader, start=2)
    keys = ("image", *cfg.tasks)
    waits = []

    def fed_step():
        t = time.perf_counter()
        batch = next(stream)
        waits.append(time.perf_counter() - t)
        assert batch["image"].is_pinned(), "the loader's batch is not pinned"
        return train_step(model, opt, sched, device_batch(batch, keys, "cuda"),
                          gen, clip_grad=tcfg.clip_grad)

    want = launches_per_pass(cfg, backward=True, batch=TRAIN_BATCH)
    counters.reset()
    for i in range(TRAIN_STEPS):
        before = counters.read()
        m = fed_step()
        torch.cuda.synchronize()
        after = counters.read()
        step_counts = {k: after[k] - before[k] for k in after}
        vals = {k: float(v) for k, v in m.items()}
        print(f"train step {i} fed by the loader: "
              + " ".join(f"{k} {v:.5f}" for k, v in vals.items())
              + f"; loader wait {1e3 * waits[-1]:.1f} ms")
        assert all(v == v and abs(v) != float("inf") for v in vals.values())
        assert step_counts == want, f"expected {want}, got {step_counts}"
    counts = counters.read()
    fixed = synthetic_batch(TRAIN_BATCH, cfg.img_size, SEED)
    rates = {}
    for label, steps in (("fixed batch", DATA_TIMED),
                         ("loader", DATA_TRAIN_BATCHES),
                         ("fixed batch", DATA_TIMED)):
        waits.clear()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(steps):
            if label == "loader":
                fed_step()
            else:
                train_step(model, opt, sched, fixed, gen,
                           clip_grad=tcfg.clip_grad)
        b.record()
        b.synchronize()
        rates.setdefault(label, []).append(
            TRAIN_BATCH * steps / (a.elapsed_time(b) / 1e3))
        if label == "loader":
            fed_waits = list(waits)
    print(f"train throughput fed by the loader: {rates['loader'][0]:.2f} "
          f"img/s over {DATA_TRAIN_BATCHES} steps (an epoch's worth, across "
          f"an epoch boundary; loader wait "
          f"{1e3 * sum(fed_waits) / len(fed_waits):.1f} ms a step, longest "
          f"{1e3 * max(fed_waits):.1f} ms) against the fixed "
          f"batch {' / '.join(f'{r:.2f}' for r in rates['fixed batch'])} "
          f"img/s ({DATA_TIMED} steps before and after), batch {TRAIN_BATCH},"
          f" on {card}")
    del loader, stream
    return counts


def valid_rows(batches, rows):
    """``batches`` passed through, each one's valid rows (its ``_valid``
    on the host) appended to ``rows``."""
    for b in batches:
        rows.append(float(b["_valid"].sum()))
        yield b


def data_validate(cfg, card, workers):
    """The padded val loader over 84 samples feeds ``validate`` on both
    eval paths under set_sync_debug_mode("error"): the valid rows sum to
    84, exact launches (serve's per forward times 3 on the bf16 path, none
    on the clone), finite scores; its img/s against the pre-built batches
    of phase 9 on the same path."""
    model = random_model(cfg, SEED, "cuda")
    loader = synthetic_loader(cfg, DATA_VAL_LEN, False, workers,
                              THROUGHPUT_BATCH)
    n_batches = len(loader)
    assert n_batches == 3, n_batches
    prebuilt = synthetic_eval_batches(n_batches, THROUGHPUT_BATCH,
                                      cfg.img_size, SEED, "cuda",
                                      DATA_VAL_LEN % THROUGHPUT_BATCH)
    per_forward = launches_per_pass(cfg, backward=False,
                                    batch=THROUGHPUT_BATCH)
    for dtype in ("bfloat16", "float32"):    # warm both paths and workers
        validate(model, prebuilt[:1], cfg.tasks, "PASCALContext", dtype)
    assert sum(b["image"].shape[0] for b in loader.iter_epoch(0)) > 0
    for dtype in ("bfloat16", "float32"):
        want = ({k: n_batches * n for k, n in per_forward.items()}
                if dtype == "bfloat16" else dict.fromkeys(per_forward, 0))
        rates = {}
        for source in ("pre-built", "loader"):
            rows = []
            batches = (prebuilt if source == "pre-built"
                       else valid_rows(loader.iter_epoch(0), rows))
            torch.cuda.synchronize()
            counters.reset()
            t0 = time.perf_counter()
            scores, losses = validate(model, batches, cfg.tasks,
                                      "PASCALContext", dtype,
                                      sync_debug="error")
            secs = time.perf_counter() - t0
            counts = counters.read()
            assert counts == want, \
                f"validate ({dtype}, {source}): expected {want}, got {counts}"
            items = score_items(scores)
            bad = [k for k, v in {**items, **losses}.items()
                   if v != v or abs(v) == float("inf")]
            assert not bad, f"validate ({dtype}, {source}): non-finite {bad}"
            if source == "loader":
                assert len(rows) == n_batches and sum(rows) == DATA_VAL_LEN, \
                    f"valid rows {rows}"
            rates[source] = n_batches * THROUGHPUT_BATCH / secs
        print(f"validate fed by the loader (TPU.EVAL_DTYPE {dtype}): "
              f"{n_batches} batches of {THROUGHPUT_BATCH}, valid rows "
              f"{[int(r) for r in rows]} (sum {int(sum(rows))}), no host sync "
              f"in the loop, launches exact; {rates['loader']:.2f} img/s "
              f"against {rates['pre-built']:.2f} img/s on the pre-built "
              f"batches, on {card}")
    del loader
    return model


def write_pascal_tree(root, n=6, hw=(64, 80)):
    """A PASCAL_MT tree of ``n`` images (the first 4 train, the rest val)
    in the layout of tests/fixtures_mtl.py: JPEG images, PNG semseg,
    distilled normals and saliency, the context LabelMap and the
    human-parts ``anno`` structs as MATLAB files."""
    import scipy.io as sio
    from PIL import Image

    def save(path, arr, **kw):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(arr).save(path, **kw)

    ids = [f"2008_{i:06d}" for i in range(n)]
    for i, im_id in enumerate(ids):
        r = np.random.RandomState(np.array([SEED, i], np.uint32))
        save(os.path.join(root, "JPEGImages", im_id + ".jpg"),
             r.randint(0, 255, (*hw, 3), dtype=np.uint8), quality=90)
        tiles = r.choice([0, 3, 4, 9, 59], size=(hw[0] // 8, hw[1] // 8))
        lab = np.kron(tiles, np.ones((8, 8), np.int64)).astype(np.uint16)
        os.makedirs(os.path.join(root, "pascal-context", "trainval"),
                    exist_ok=True)
        sio.savemat(os.path.join(root, "pascal-context", "trainval",
                                 im_id + ".mat"), {"LabelMap": lab})
        mask = np.zeros(hw, np.uint8)
        mask[8:40, 8:40] = 1
        head = np.zeros(hw, np.uint8)
        head[8:16, 8:40] = 1
        parts = np.zeros((1, 1), dtype=[("part_name", "O"), ("mask", "O")])
        parts[0, 0] = ("head", head)
        objs = np.zeros((1, 1), dtype=[("class", "O"), ("class_ind", "O"),
                                       ("mask", "O"), ("parts", "O")])
        objs[0, 0] = ("obj0", np.array([[15]], np.uint8), mask, parts)
        anno = np.zeros((1, 1), dtype=[("imname", "O"), ("objects", "O")])
        anno[0, 0] = (im_id, objs)
        os.makedirs(os.path.join(root, "human_parts"), exist_ok=True)
        sio.savemat(os.path.join(root, "human_parts", im_id + ".mat"),
                    {"anno": anno})
        save(os.path.join(root, "normals_distill", im_id + ".png"),
             r.randint(0, 255, (*hw, 3), dtype=np.uint8))
        save(os.path.join(root, "sal_distill", im_id + ".png"),
             r.randint(0, 255, hw, dtype=np.uint8))
        save(os.path.join(root, "semseg", "VOC12", im_id + ".png"),
             r.randint(0, 21, hw, dtype=np.uint8))
    os.makedirs(os.path.join(root, "ImageSets", "Context"), exist_ok=True)
    for split, part in (("train", ids[:4]), ("val", ids[4:])):
        with open(os.path.join(root, "ImageSets", "Context", split + ".txt"),
                  "w") as f:
            f.write("\n".join(part) + "\n")
    return len(ids) - 4


def data_pascal(model, cfg, card):
    """The PASCAL tree, written here, read through ``build_loader`` at
    the model's size (its val split of 2 images, padded to one batch of
    32, built in this process: 2 images do not pay for starting workers)
    and validated on the bf16 path with exact launches."""
    root = str(_build.BUILD_DIR / "smoke_pascal")
    shutil.rmtree(root, ignore_errors=True)
    try:
        n_val = write_pascal_tree(root)
        loader = build_loader(data_node("PASCALContext", root, cfg.tasks,
                                        cfg.img_size, THROUGHPUT_BATCH, SEED,
                                        num_workers=0))[3]
        rows = []
        counters.reset()
        scores, losses = validate(model, valid_rows(loader.iter_epoch(0),
                                                    rows),
                                  cfg.tasks, "PASCALContext", "bfloat16",
                                  sync_debug="error")
        counts = counters.read()
        del loader
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = launches_per_pass(cfg, backward=False, batch=THROUGHPUT_BATCH)
    assert counts == want, f"PASCAL validate: expected {want}, got {counts}"
    assert rows == [float(n_val)], rows
    items = score_items(scores)
    bad = [k for k, v in {**items, **losses}.items()
           if v != v or abs(v) == float("inf")]
    assert not bad, f"PASCAL validate: non-finite {bad}"
    print(f"PASCAL tree ({n_val + 4} images written with PIL and "
          f"scipy.io): build_loader at {cfg.img_size}, val split of {n_val} "
          f"in one batch of {THROUGHPUT_BATCH} (valid rows {rows}), validate "
          f"on the bf16 path, launches exact, scores finite: "
          f"{ {t: {k: round(v, 4) for k, v in r.items() if not isinstance(v, list)} for t, r in scores.items()} } "
          f"on {card}")


def data_phase(card):
    """Phase 10, on the adapter route at full width: what the machine has,
    the loader's determinism across worker counts, the loader feeding the
    training step and validate, the PASCAL tree where PIL is present."""
    cfg = tiny_448_r64_pertask()
    pil = importlib.util.find_spec("PIL") is not None
    try:
        import scipy.io  # noqa: F401
        scipy_io = True
    except ImportError:
        scipy_io = False
    workers = loader_workers()
    t0 = time.perf_counter()
    data_native.library()
    built = data_native.build_seconds
    print(f"data machine: PIL {'importable' if pil else 'NOT importable'}, "
          f"scipy.io {'importable' if scipy_io else 'NOT importable'}, "
          f"os.cpu_count() {os.cpu_count()}, cores usable "
          f"{len(os.sched_getaffinity(0))}, loader workers {workers}, image "
          f"ops " + (f"built in {built:.1f} s" if built is not None else
                     f"loaded from an earlier build in "
                     f"{time.perf_counter() - t0:.2f} s"))
    check_loader_determinism(cfg, workers)
    counts = data_train(cfg, card, workers)
    model = data_validate(cfg, card, workers)
    if pil:
        data_pascal(model, cfg, card)
    else:
        print("PASCAL tree: not run, PIL is not importable")
    return counts


# phase 11: init, pretrained load and checkpoints on the adapter route
OFFICIAL_WINDOW = 7             # swin_tiny_patch4_window7_224.pth
OFFICIAL_CLASSES = 1000
CKPT_STEPS = 3                  # steps before the save, and after the load
# uninterrupted runs from the same start: the bilinear upsampling's
# backward adds with atomics on CUDA (models/heads.py:resize_bilinear), so
# two of them differ; their largest pairwise distance is the noise floor
CKPT_FLOOR_RUNS = 5
# the resumed run against the first uninterrupted one: at most
# CKPT_FLOOR_FACTOR times the floor, or these absolute bounds where the
# floor is 0 (loss: the largest relative difference over steps 4-6 and
# every loss; params: the relative L2 distance of all trainables)
CKPT_FLOOR_FACTOR = 2.0
CKPT_ABS = {"loss": 1e-6, "params": 1e-6}


def official_swin_state_dict(model, window: int = OFFICIAL_WINDOW,
                             classes: int = OFFICIAL_CLASSES,
                             seed: int = SEED) -> dict:
    """A Swin backbone in the layout of the official ImageNet checkpoints
    (``swin_tiny_patch4_window7_224.pth``) from ``model``'s backbone: no
    ``backbone.`` prefix, plain ``qkv.weight``, relative position tables
    of ``window`` with their ``relative_position_index``, an ``attn_mask``
    in each shifted block, the final ``norm`` and a ``classes``-way
    ``head``; the tables, norm and head drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if not k.startswith("backbone.") or "lora_" in k:
            continue
        k = k[len("backbone."):].replace(".linear.", ".")
        v = v.detach().float().cpu()
        if k.endswith("relative_position_bias_table"):
            v = _cpu_uniform(g, ((2 * window - 1) ** 2, v.shape[1]), 0.02)
            sd[k.replace("bias_table", "index")] = torch.from_numpy(
                relative_position_index(window)).long()
        sd[k] = v
        m = re.match(r"(layers\.\d+\.blocks\.(\d+))\.norm1\.weight$", k)
        if m and int(m.group(2)) % 2:
            sd[m.group(1) + ".attn_mask"] = torch.zeros(
                1, window ** 2, window ** 2)
    dim = model.stage_dims[-1]
    sd["norm.weight"] = 1.0 + _cpu_uniform(g, (dim,), 0.1)
    sd["norm.bias"] = _cpu_uniform(g, (dim,), 0.02)
    sd["head.weight"] = _cpu_uniform(g, (classes, dim), dim ** -0.5)
    sd["head.bias"] = _cpu_uniform(g, (classes,), 0.02)
    return sd


def pretrained_expectation(model) -> dict:
    """What ``--pretrained`` loads from an official backbone file into the
    model, in ``load_converted_``'s units: every backbone tensor but the
    adapters; missing the adapters, downsamplers and decoders (they keep
    their init); unexpected the final norm, which the MTL backbone does not
    have. ``tests/test_torch_port_ckpt.py`` holds this to the JAX
    package's ``merge_converted`` at the toy shape."""
    units = sorted({load_unit(k) for k in model.state_dict()
                    if not k.endswith("num_batches_tracked")})
    missing = [u for u in units if "lora_" in u
               or u.startswith(("downsampler.", "decoders."))]
    return {"loaded": len(units) - len(missing), "missing": missing,
            "unexpected": ["backbone.norm.bias", "backbone.norm.weight"]}


def _cpu_uniform(g, shape, bound):
    return torch.empty(shape).uniform_(-bound, bound, generator=g)


def ckpt_train(model, opt, gen, batch, steps, tcfg) -> list:
    """``steps`` training steps; their metrics as floats."""
    sched = build_schedule(tcfg, ITERS_PER_EPOCH)
    out = [train_step(model, opt, sched, batch, gen,
                      clip_grad=tcfg.clip_grad) for _ in range(steps)]
    return [{k: float(v) for k, v in m.items()} for m in out]


def ckpt_run(cfg, start, batch, steps, tcfg):
    """A model, optimizer and step generator from the start state, and
    ``steps`` steps; returns (model, optimizer, generator, metrics)."""
    model = build_mtl_model(cfg, "cuda")
    model.load_state_dict(start)
    opt = build_optimizer(model, tcfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return model, opt, gen, ckpt_train(model, opt, gen, batch, steps, tcfg)


def ckpt_trainables(model) -> torch.Tensor:
    return torch.cat([p.detach().float().flatten()
                      for _, p in sorted(model.named_parameters())
                      if p.requires_grad])


def ckpt_distances(a, b) -> dict:
    """(metrics, trainables) of two runs -> the largest relative loss
    difference over steps 4-6 and the relative L2 distance of the final
    trainables."""
    (ma, pa), (mb, pb) = a, b
    loss = max(abs(x[k] - y[k]) / abs(y[k])
               for x, y in zip(ma[CKPT_STEPS:], mb[CKPT_STEPS:])
               for k in y if k.startswith("loss"))
    params = float((pa - pb).norm() / pb.norm())
    return {"loss": loss, "params": params}


def ckpt_phase(card):
    """Phase 11, on the adapter route at full width: a backbone-only
    official-layout ``.pth`` loaded as ``--pretrained`` loads it, with the
    counts held to :func:`pretrained_expectation`; the loaded model's bf16
    forward against the CPU fp32 forward with exact launches; 3 steps,
    save, a fresh model, optimizer and generator from the file, 3 more,
    against uninterrupted runs from the same start."""
    cfg = tiny_448_r64_pertask()
    root = _build.BUILD_DIR / "smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    model = build_mtl_model(cfg, "cuda")
    init_weights_(model, torch.Generator().manual_seed(SEED))
    source = random_model(cfg, SEED + 11, "cpu")
    official = root / "swin_tiny_official.pth"
    torch.save({"model": official_swin_state_dict(source)}, official)
    del source
    counts = load_pretrained_(model, str(official))
    want = pretrained_expectation(model)
    got = {**counts, "missing": sorted(counts["missing"]),
           "unexpected": sorted(counts["unexpected"])}
    print(f"pretrained load ({official.stat().st_size / 2 ** 20:.1f} MB "
          f"official-layout Swin-T, window {OFFICIAL_WINDOW}, "
          f"{OFFICIAL_CLASSES}-class head): loaded {got['loaded']}, missing "
          f"{len(got['missing'])}, unexpected {len(got['unexpected'])} "
          f"{got['unexpected']}; expected {want['loaded']}, "
          f"{len(want['missing'])}, {len(want['unexpected'])}")
    assert got == want, f"pretrained load: expected {want}, got {got}"

    images = synthetic_images(REQUESTS[0], cfg.img_size, SEED + 11)
    counters.reset()
    out = predict(model, images)
    torch.cuda.synchronize()
    launches = counters.read()
    want_launches = launches_per_pass(cfg, backward=False,
                                      batch=REQUESTS[0])
    print(f"pretrained forward: {REQUESTS[0]} image, launches {launches}")
    assert launches == want_launches, \
        f"expected {want_launches} launches, got {launches}"
    cross_check(model, cfg, images, {t: v.float().cpu()
                                     for t, v in out.items()})

    tcfg = TrainConfig(batch_size=TRAIN_BATCH, warmup_epochs=0)
    batch = synthetic_batch(TRAIN_BATCH, cfg.img_size, SEED + 11, "cuda")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    del model, out
    resumed, state, secs, mb = ckpt_resumed(cfg, start, batch, tcfg, root)
    runs = [resumed]
    for _ in range(CKPT_FLOOR_RUNS):
        m, opt, gen, metrics = ckpt_run(cfg, start, batch, 2 * CKPT_STEPS,
                                        tcfg)
        assert [g["updates"] for g in opt.param_groups] == state[0]
        assert [g["lr"] for g in opt.param_groups] == state[1]
        assert torch.equal(gen.get_state(), state[2])
        runs.append((metrics, ckpt_trainables(m)))
        del m, opt, gen
    bad = [(i, k, v) for i, r in enumerate(runs)
           for k, v in r[0][-1].items() if v != v or abs(v) == float("inf")]
    assert not bad, f"non-finite metrics {bad}"
    dist = ckpt_distances(runs[0], runs[1])
    floor = {k: max(ckpt_distances(runs[i], runs[j])[k]
                    for i in range(1, len(runs))
                    for j in range(i + 1, len(runs))) for k in dist}
    # the check's power, reported and not gated: the same resume with the
    # step generator left at a fresh seed (other dropout and drop-path)
    unrestored = ckpt_distances(ckpt_resumed(cfg, start, batch, tcfg, root,
                                             generator=False)[0], runs[1])
    for k in dist:
        bound = CKPT_FLOOR_FACTOR * floor[k] if floor[k] > 0 else CKPT_ABS[k]
        print(f"resume ({CKPT_STEPS} + {CKPT_STEPS} steps at batch "
              f"{TRAIN_BATCH}, dropout and drop-path on) vs uninterrupted "
              f"{2 * CKPT_STEPS}: {k} distance {dist[k]:.3e}, noise floor "
              f"{floor[k]:.3e} (largest of {CKPT_FLOOR_RUNS} uninterrupted "
              f"runs' pairs), bound {bound:.3e}; a resume without the "
              f"generator's state {unrestored[k]:.3e} (not gated)")
        assert dist[k] <= bound, f"resume {k}: {dist[k]} > {bound}"
    print(f"checkpoint: {mb:.1f} MB, saved in {secs[0]:.2f} s, loaded in "
          f"{secs[1]:.2f} s (model, optimizer, generator); updates "
          f"{state[0]}, lr {state[1]} and the generator state equal to the "
          f"uninterrupted runs'; losses of step 6: resumed "
          f"{runs[0][0][-1]['loss']:.6f}, uninterrupted "
          f"{runs[1][0][-1]['loss']:.6f} on {card}")
    shutil.rmtree(root, ignore_errors=True)


def ckpt_resumed(cfg, start, batch, tcfg, root, generator=True):
    """``CKPT_STEPS`` steps from the start state, a checkpoint, a fresh
    model, optimizer and generator (other seeds) loaded from it (the
    generator's state left out without ``generator``), ``CKPT_STEPS``
    more; returns ((metrics, trainables), (updates, LRs, generator state),
    (save s, load s), the file's MB)."""
    m, opt, gen, metrics = ckpt_run(cfg, start, batch, CKPT_STEPS, tcfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = save_checkpoint(str(root), 0, m, opt, gen)
    save_s = time.perf_counter() - t0
    del m, opt, gen
    m = initial_model(cfg, SEED + 12, "cuda")
    opt = build_optimizer(m, tcfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    t0 = time.perf_counter()
    info = load_checkpoint(path, m, opt, gen if generator else None)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    assert info == {"epoch": 0, "max_accuracy": 0.0}, info
    metrics += ckpt_train(m, opt, gen, batch, CKPT_STEPS, tcfg)
    state = ([g["updates"] for g in opt.param_groups],
             [g["lr"] for g in opt.param_groups], gen.get_state())
    return ((metrics, ckpt_trainables(m)), state, (save_s, load_s),
            os.path.getsize(path) / 2 ** 20)


# phase 12: the CLI (``python -m mtlora_tpu_torch``) on the flagship YAML,
# driven in this process so that the kernels' counts are read
CLI_YAML = "configs/mtlora/tiny_448/mtlora_tiny_448_r64_scale4_pertask.yaml"
CLI_NAME = "mtlora_tiny_448_r64_scale4_pertask"
CLI_ARGS = ["--cfg", CLI_YAML, "--tasks", "semseg,normals,sal,human_parts",
            "--synthetic-data", "--batch-size", str(TRAIN_BATCH),
            "--disable_wandb"]
CLI_TRAIN_STEPS = 64 // TRAIN_BATCH     # main.py's 64 synthetic samples
# --eval --resume ckpt_epoch_1.pth against the training run's final
# validate: the same weights and BN statistics through the same fp32 clone
# (TF32 off); the meters' fp32 sums add with atomics in another order, and
# an IoU moves only where a pixel's argmax flips
CLI_EVAL_REL = 1e-5
# plain 1-epoch runs beside the 2-epoch run's first epoch (the same LRs:
# the warmup spans 20 epochs) for the world-1 NCCL run's noise floor
CLI_FLOOR_RUNS = 2


@contextlib.contextmanager
def env_vars(values):
    """The environment with ``values`` set inside, restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cli_run(root, name, *flags, env=None):
    """One CLI run writing under ``root/name``: (its result, the kernels'
    launches in it, seconds, its output directory)."""
    out = root / name
    counters.reset()
    t0 = time.perf_counter()
    with env_vars(env or {}):
        result = cli([*CLI_ARGS, "--output", str(out), *flags])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"CLI {name} ({' '.join(flags) or 'train'}): {secs:.1f} s")
    return result, counters.read(), secs, out / CLI_NAME / "default"


def flat_scores(scores) -> dict:
    return {f"{t}/{k}": float(v) for t, res in scores.items()
            for k, v in res.items() if isinstance(v, (int, float))}


def step_losses(result) -> list:
    return [loss for e in result["epochs"] for _, loss in e["logged"]]


def times_counts(per: dict, n: int) -> dict:
    return {k: v * n for k, v in per.items()}


def loss_distance(a: list, b: list) -> float:
    """The largest relative difference of two runs' step losses."""
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def cli_phase(card) -> dict:
    """Phase 12: the CLI on the flagship YAML at batch 32, synthetic data:
    2 epochs saving and validating each, under
    ``set_sync_debug_mode("error")``; ``--eval --resume`` of the last
    checkpoint; ``--throughput``; ``--accumulation-steps 2``; a world-1
    NCCL run from torchrun's environment against plain runs. Returns the
    kernels' launches of the 2-epoch run."""
    cfg = tiny_448_r64_pertask()
    yaml_cfg = load_config(CLI_YAML, tasks=list(cfg.tasks))
    assert from_config(yaml_cfg) == cfg, "the YAML is not the flagship"
    root = _build.BUILD_DIR / "smoke_cli"
    shutil.rmtree(root, ignore_errors=True)
    per_step = launches_per_pass(cfg, backward=True, batch=TRAIN_BATCH)

    # the training run
    result, counts, secs, out = cli_run(
        root, "train", "--epochs", "2", "--ckpt-freq", "1", "--eval-freq",
        "1", "--sync-debug", "error")
    epochs = result["epochs"]
    steps = sum(e["steps"] for e in epochs)
    assert [e["steps"] for e in epochs] == [CLI_TRAIN_STEPS] * 2, epochs
    want = times_counts(per_step, steps)
    assert counts == want, f"expected {want} launches, got {counts}"
    files = sorted(os.listdir(out))
    assert files == ["ckpt_epoch_0.pth", "ckpt_epoch_1.pth", "config.json",
                     "config.yaml", "log_rank0.txt", "val_scores_r0.json"], \
        files
    for e in epochs:
        logged = [loss for _, loss in e["logged"]]
        assert len(logged) == e["steps"], e     # PRINT_FREQ 10 > 2 steps
        mean = sum(logged) / len(logged)
        assert abs(e["loss"] - mean) <= 1e-6 * abs(mean), (e["loss"], mean)
        assert all(v == v and abs(v) != float("inf") for v in logged)
    scores = flat_scores(result["scores"])
    assert scores and all(v == v for v in scores.values()), scores
    with open(out / "val_scores_r0.json") as f:
        assert flat_scores(json.load(f)) == scores
    fixed = TRAIN_RATES["main"]
    for e in epochs:
        print(f"CLI epoch {e['epoch']}: {e['seconds']:.2f} s, "
              f"{e['samples'] / e['seconds']:.2f} img/s train (loader, "
              f"{int(yaml_cfg.DATA.NUM_WORKERS)} workers, validate not "
              f"included) against {fixed:.2f} img/s on phase 7's fixed "
              f"batch; loss {e['loss']:.6f} = mean of its steps "
              f"{[round(v, 6) for _, v in e['logged']]} on {card}")
    print(f"CLI training: {steps} steps, launches exact ({per_step} a "
          f"step), no host sync inside the steps, files {files}, final "
          f"scores {scores}")

    # --eval of the last checkpoint
    ckpt = str(out / "ckpt_epoch_1.pth")
    ev, ev_counts, _, _ = cli_run(root, "eval", "--eval", "--resume", ckpt)
    assert ev["start_epoch"] == 2, ev["start_epoch"]
    assert not any(ev_counts.values()), ev_counts     # the fp32 clone
    got = flat_scores(ev["scores"])
    assert set(got) == set(scores)
    worst = max(abs(got[k] - scores[k]) / max(abs(scores[k]), 1e-12)
                for k in scores)
    print(f"CLI --eval --resume ckpt_epoch_1.pth vs the final validate: "
          f"largest relative score difference {worst:.3e} (bound "
          f"{CLI_EVAL_REL:g})")
    assert worst <= CLI_EVAL_REL, (got, scores)

    # --throughput: both eval paths
    tp, tp_counts, _, _ = cli_run(root, "throughput", "--throughput")
    rates = tp["throughput"]
    assert set(rates) == {"fp32, kernels off", "bf16 + kernels"}, rates
    assert all(r > 0 for r in rates.values()), rates
    forwards = 35                               # 5 warm-up and 30 timed
    want = times_counts(launches_per_pass(cfg, backward=False,
                                          batch=TRAIN_BATCH), forwards)
    assert tp_counts == want, f"expected {want}, got {tp_counts}"
    print(f"CLI --throughput at batch {TRAIN_BATCH}: "
          + ", ".join(f"{k} {v:.2f} img/s" for k, v in rates.items())
          + f"; launches {forwards} forwards' on {card}")

    # --accumulation-steps 2
    ac, ac_counts, _, ac_out = cli_run(root, "accum", "--epochs", "1",
                                       "--accumulation-steps", "2")
    updates = ac["epochs"][0]["steps"]
    want = times_counts(launches_per_pass(cfg, backward=True,
                                          batch=TRAIN_BATCH // 2),
                        2 * updates)
    assert ac_counts == want, f"expected {want}, got {ac_counts}"
    state = torch.load(ac_out / "ckpt_epoch_0.pth", map_location="cpu",
                       weights_only=True)
    groups = state["optimizer"]["param_groups"]
    t = yaml_cfg.TRAIN
    # update 1 in the warmup, over n_eff = steps // 2 updates an epoch,
    # at batch * world / 512 times the 2 accumulated microbatches
    scale = TRAIN_BATCH / 512 * 2
    n_eff = CLI_TRAIN_STEPS // 2
    lr = (t.WARMUP_LR * scale + (updates - 1)
          * (t.BASE_LR * scale - t.WARMUP_LR * scale)
          / (t.WARMUP_EPOCHS * n_eff))
    assert [g["updates"] for g in groups] == [updates] * 2, groups
    assert all(abs(g["lr"] - lr) <= 1e-12 + 1e-9 * lr for g in groups), \
        (groups[0]["lr"], lr)
    tracked = [v for k, v in state["model"].items()
               if k.endswith("num_batches_tracked")]
    assert tracked and all(int(v) == 2 * updates for v in tracked), tracked
    print(f"CLI --accumulation-steps 2: {updates} updates of 2 microbatches "
          f"of {TRAIN_BATCH // 2}, launches exact, lr {groups[0]['lr']:.6e} "
          f"(the LR scaled by 2), BN statistics updated {2 * updates} "
          f"times, loss {ac['epochs'][0]['loss']:.6f}")

    # a world-1 NCCL run from torchrun's environment against plain runs
    plain = [step_losses({"epochs": epochs[:1]})]
    for i in range(CLI_FLOOR_RUNS):
        r, c, _, _ = cli_run(root, f"plain{i}", "--epochs", "1")
        assert r["backend"] is None and c == times_counts(per_step,
                                                          CLI_TRAIN_STEPS)
        plain.append(step_losses(r))
    torchrun = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                "MASTER_ADDR": "127.0.0.1",
                "MASTER_PORT": str(free_port())}
    nc, nc_counts, _, _ = cli_run(root, "nccl", "--epochs", "1",
                                  env=torchrun)
    assert nc["backend"] == "nccl" and nc["world"] == 1, nc["backend"]
    assert nc_counts == times_counts(per_step, CLI_TRAIN_STEPS), nc_counts
    assert not torch.distributed.is_initialized()
    dist_ = loss_distance(step_losses(nc), plain[0])
    floor = max(loss_distance(plain[i], plain[j])
                for i in range(len(plain)) for j in range(i + 1, len(plain)))
    bound = CKPT_FLOOR_FACTOR * floor if floor > 0 else CKPT_ABS["loss"]
    print(f"CLI world-1 NCCL run (torchrun's environment) vs plain: step "
          f"losses {step_losses(nc)} vs {plain[0]}, largest relative "
          f"difference {dist_:.3e}, noise floor {floor:.3e} (largest of "
          f"{len(plain)} plain runs' pairs), bound {bound:.3e}")
    assert dist_ <= bound, f"NCCL run {dist_} > {bound}"
    shutil.rmtree(root, ignore_errors=True)
    return counts


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    # fp32 products on the card (the plain versions) in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")

    _build.library()
    secs = _build.build_seconds or 0.0
    print(f"build: {secs:.1f} s (nvcc sm_90a, "
          f"{len(list(_build.CSRC.glob('*.cu')))} sources in parallel)")
    for line in _build.ptxas_log.splitlines():
        if "Used" in line or "Function properties" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    attn = check_attention(gen)
    head = check_head(gen)
    ln2 = check_ln_lora(gen)
    merge = check_merge(gen)
    mlp = check_ln_mlp(gen)
    tail = check_ln_lora_tail(gen)
    mid = check_adapter_mid(gen)
    tmerge = check_task_merge(gen)
    gemm = check_lora_matmul(gen)
    dense = check_dense_attention(gen)
    print(f"phases 3 and 3b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_gelu_form(gen)
    attn_probes = check_attention_probes(gen)
    adapter_probes = check_adapter_probes(gen)
    print(f"phase 3c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    probe_counts = {"probe": probe_path()}
    print(f"probe path: launches "
          f"{ {k: v for k, v in probe_counts['probe'].items() if v} }, "
          f"{time.perf_counter() - t0:.1f} s")

    # the launches of each path's checked training steps (phase 7), and of
    # its dropout-off step (phase 8), by route
    train_counts, cross_counts = {}, {}
    for cfg in routes():
        route = route_name(cfg)
        print(f"=== {route}")
        t0 = time.perf_counter()
        model = random_model(cfg, SEED, "cuda")
        serve_counts, (images1, card_out1) = serve_requests(model, cfg)
        t1 = time.perf_counter()
        cross_check(model, cfg, images1, card_out1)
        t2 = time.perf_counter()
        batch = torch.from_numpy(synthetic_images(
            THROUGHPUT_BATCH, cfg.img_size, SEED)).cuda()
        torch.cuda.reset_peak_memory_stats()
        rate = throughput(model, batch, iters=5)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"throughput ({route}): {rate:.2f} img/s bf16 forward at "
              f"batch {THROUGHPUT_BATCH} (peak {peak:.2f} GiB) on {card}")
        del model, batch
        t3 = time.perf_counter()
        counts = train_phase(cfg, card)
        print(f"launches ({route}): serve {serve_counts}, train {counts}")
        t4 = time.perf_counter()
        cross = train_cross_check(cfg)
        t5 = time.perf_counter()
        print(f"phase seconds ({route}): 4 {t1 - t0:.1f}, 5 {t2 - t1:.1f}, "
              f"6 {t3 - t2:.1f}, 7 {t4 - t3:.1f}, 8 {t5 - t4:.1f}")
        train_counts.setdefault(path_of(cfg), counts)
        cross_counts.setdefault(path_of(cfg), cross)
    print(f"=== validate ({route_name(tiny_448_r64_pertask())})")
    t0 = time.perf_counter()
    eval_phase(card)
    print(f"phase seconds (validate): 9 {time.perf_counter() - t0:.1f}")
    print(f"=== data pipeline ({route_name(tiny_448_r64_pertask())})")
    t0 = time.perf_counter()
    data_phase(card)
    print(f"phase seconds (data): 10 {time.perf_counter() - t0:.1f}")
    print(f"=== checkpoints ({route_name(tiny_448_r64_pertask())})")
    t0 = time.perf_counter()
    ckpt_phase(card)
    print(f"phase seconds (checkpoints): 11 {time.perf_counter() - t0:.1f}")
    print(f"=== CLI ({route_name(tiny_448_r64_pertask())})")
    t0 = time.perf_counter()
    cli_counts = cli_phase(card)
    print(f"phase seconds (CLI): 12 {time.perf_counter() - t0:.1f}")

    def entry(name, source, replaces, tally, path="main", counts=None,
              root="mtlora_tpu/ops/"):
        launches = (counts or train_counts)[path][name]
        assert launches > 0, f"{name} never launched on its path"
        # the CLI's training run (phase 12) drives the main path
        if path == "main":
            assert cli_counts[name] > 0, f"{name} never launched by the CLI"
        return {"name": name, "route": "cuda",
                "source": f"mtlora_tpu_torch/ops/csrc/{source}",
                "replaces": f"{root}{replaces}",
                "launches": launches,
                "cli_launches": cli_counts.get(name, 0), **tally.json()}

    def probe_entry(name, source, replaces, tally):
        return entry(name, source, replaces, tally, "probe", probe_counts,
                     "tools/")

    probes = [
        probe_entry(f"window_attention_probe.{mode}", "window_attn.cu",
                    "attn_variants.py:513" if mode in UNMASKED_MODES
                    else "attn_probe.py:85", attn_probes[mode])
        for mode in PROBE_MODES]
    probes.append(probe_entry("quad_pre_attention", "quad_attn.cu",
                              "attn_variants.py:475",
                              attn_probes["quad_pre"]))
    probes += [
        probe_entry(f"adapter_mid_probe.{name}", "adapter_mlp.cu",
                    "adapter_variants.py:117" if kind in ("vpu1", "vpu12")
                    else "adapter_variants.py:191",
                    adapter_probes[f"fwd {name}"])
        for name, (_, _, kind) in FWD_PROBES.items()]
    probes += [
        probe_entry(f"adapter_mid_bwd_probe.{name}", "adapter_mlp_bwd.cu",
                    "adapter_variants.py:209", adapter_probes[f"bwd {name}"])
        for name in BWD_PROBES]

    print(json.dumps({"kernels": [
        entry("window_attention", "window_attn_fwd.cu",
              "pallas_window_attn.py:84", attn["fwd"]),
        entry("window_attention_bwd", "window_attn_bwd.cu",
              "pallas_window_attn.py:119", attn["bwd"]),
        entry("hrnet_head_mlp", "head_mlp_fwd.cu", "pallas_head.py:96",
              head["fwd"]),
        entry("hrnet_head_mlp_bwd", "head_mlp_bwd.cu", "pallas_head.py:111",
              head["bwd"]),
        entry("ln_lora", "ln_lora_tail_fwd.cu", "pallas_ln_lora.py:74",
              ln2["fwd"]),
        entry("ln_lora_bwd", "ln_lora_qkv_bwd.cu", "pallas_ln_lora.py:124",
              ln2["bwd"]),
        entry("patch_merge", "merge_ln_fwd.cu", "pallas_ln_lora.py:465",
              merge["fwd"]),
        entry("patch_merge_bwd", "merge_ln_bwd.cu", "pallas_ln_lora.py:492",
              merge["bwd"]),
        entry("ln_mlp", "ln_mlp.cu", "pallas_ln_mlp.py:54", mlp["fwd"]),
        entry("ln_mlp_bwd", "ln_mlp_bwd.cu", "pallas_ln_mlp.py:103",
              mlp["bwd"]),
        entry("ln_lora_tail", "ln_lora_tail_fwd.cu", "pallas_ln_lora.py:74",
              tail["fwd"]),
        entry("ln_lora_tail_bwd", "ln_lora_tail_bwd.cu",
              "pallas_ln_lora.py:124",
              tail["bwd"]),
        entry("adapter_mid", "adapter_mlp_fwd.cu",
              "pallas_adapter_mlp.py:129",
              mid["fwd"]),
        entry("adapter_mid_bwd", "adapter_mlp_bwd.cu",
              "pallas_adapter_mlp.py:146", mid["bwd"]),
        entry("task_merge", "merge_ln_fwd.cu", "pallas_task_merge.py:70",
              tmerge["fwd"]),
        entry("task_merge_bwd", "task_merge_bwd.cu",
              "pallas_task_merge.py:115", tmerge["bwd"]),
        entry("window_attention_dense", "window_attn_fwd.cu",
              "pallas_window_attn.py:420", dense["fwd"], "B"),
        entry("window_attention_dense_bwd", "window_attn_bwd.cu",
              "pallas_window_attn.py:450", dense["bwd"], "B"),
        entry("lora_matmul", "lora_matmul.cu", "pallas_lora_matmul.py:117",
              gemm["fwd"], "A"),
        entry("lora_matmul_dx", "lora_matmul.cu",
              "pallas_lora_matmul.py:117", gemm["bwd"], "A", cross_counts),
        *probes,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
