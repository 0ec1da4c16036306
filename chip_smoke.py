"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and exits non-zero:
  1. device: a CUDA card must be present; its name and power limit;
  2. build: the four CUDA kernels from ops/csrc (one nvcc each, in
     parallel), with the build time;
  3. forward kernels vs plain: window attention at the four Swin-T 448
     stage shapes (batch 32, shifted and not) and the HRNet head at batch
     32 for the four task widths (the training step's shapes, and the
     batch-32 forward's), on the card, against their plain PyTorch
     versions on the same tensors; kernel, plain and library-call times
     and the roofline bound;
  3b. backward kernels vs plain: the same shapes, every gradient against
     the plain backward, with the same four numbers;
  4. serve: the flagship model (bf16, seeded random weights) answers
     requests of 1, 8 and 32 images through ``serve.predict``; shapes,
     finiteness and 12 attention + 4 head launches per forward;
  5. cross-check: the 1-image request against the same weights run on the
     CPU in fp32 through the plain versions;
  6. throughput: bf16 forward img/s at batch 32;
  7. train: the flagship at batch 32, full width and depth, adapter
     dropout and drop-path on, 3 steps of ``train.step.train_step``:
     finite losses and grad norm, 12 + 12 attention and 4 + 4 head
     launches per step, frozen weights bit-unchanged, every trainable
     with a gradient changed, BatchNorm running statistics moved, peak
     memory; then the train img/s at batch 32;
  8. train cross-check: one step at batch 2 at 448 with dropout and
     drop-path off, on the card in bf16 and on the CPU in fp32 through
     the plain versions, from the same weights and batch;
then a JSON line of the kernels, and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import time

import torch
import torch.nn.functional as F

from mtlora_tpu_torch.config import tiny_448_r64_pertask
from mtlora_tpu_torch.models.mtl import build_mtl_model
from mtlora_tpu_torch.ops import _build, counters
from mtlora_tpu_torch.ops.attention import (
    shift_attention_mask,
    window_attention,
)
from mtlora_tpu_torch.ops.head import (
    head_mlp_bwd,
    head_mlp_bwd_plain,
    head_mlp_fwd,
    head_mlp_plain,
)
from mtlora_tpu_torch.ops.window_attn import (
    window_attention_bwd,
    window_attention_bwd_plain,
    window_attention_fwd,
)
from mtlora_tpu_torch.serve import (
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
from mtlora_tpu_torch.train.step import synthetic_batch, train_step

SEED = 0
REQUESTS = (1, 8, 32)
THROUGHPUT_BATCH = 32
TRAIN_BATCH = 32
# the kernels are checked and timed at the training step's shapes
KERNEL_BATCH = TRAIN_BATCH
TRAIN_STEPS = 3
TRAIN_TIMED = 5
CROSS_BATCH = 2
ITERS_PER_EPOCH = 1000
# published peaks of one H100 SXM (dense bf16 tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
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


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def median_ms(fn, reps: int = 20, rounds: int = 3, warmup: int = 3) -> float:
    """ms per call: CUDA events around ``reps`` calls back to back (so the
    host enqueues ahead of the card), the median of ``rounds``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


class Tally:
    """Sums of one kernel's numbers over the shapes it is checked at."""

    def __init__(self):
        self.err = self.ms = self.plain = self.lib = 0.0
        self.bytes = self.flops = 0.0

    def add(self, err, ms, plain, lib, nbytes, flops):
        self.err = max(self.err, err)
        self.ms += ms
        self.plain += plain
        self.lib += lib
        self.bytes += nbytes
        self.flops += flops

    def json(self) -> dict:
        t_bytes = self.bytes / PEAK_HBM_BYTES * 1e3
        t_ops = self.flops / PEAK_BF16_FLOPS * 1e3
        return {"max_abs_err": self.err, "ms": self.ms,
                "plain_ms": self.plain, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": self.lib}


def bound_text(nbytes, flops) -> str:
    return (f"bound {max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS) * 1e3:.4f}"
            f" ms ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")


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


def check_attention(gen) -> dict:
    fwd, bwd = Tally(), Tally()
    for s, shift, qkv, dout, bias, mask, nH, nW, scale in attention_shapes(gen):
        Bw, N, C3 = qkv.shape
        C, hd = C3 // 3, C3 // 3 // nH
        mb = nW * N * N * 4 if mask is not None else 0
        # forward
        out = window_attention_fwd(qkv, nH, bias, mask, scale)
        ref = window_attention(qkv, nH, bias, mask, scale)
        torch.cuda.synchronize()
        assert out.shape == ref.shape and out.dtype == torch.bfloat16
        err = (out.float() - ref.float()).abs().max().item()
        q, k, v, am = sdpa_operands(qkv, bias, mask, nH, nW)
        t_k = median_ms(lambda: window_attention_fwd(qkv, nH, bias, mask,
                                                     scale))
        t_p = median_ms(lambda: window_attention(qkv, nH, bias, mask, scale))
        t_l = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=am, scale=scale))
        nbytes = Bw * N * C3 * 2 + nH * N * N * 4 + mb + Bw * N * C * 2
        flops = 4.0 * Bw * nH * N * N * hd
        print(f"attention fwd stage {s} qkv {tuple(qkv.shape)} nH {nH} "
              f"shift {shift}: max_abs_err {err:.3e} (bound "
              f"{KERNEL_ATOL:.3e}) kernel {t_k:.4f} ms plain {t_p:.4f} ms "
              f"sdpa {t_l:.4f} ms {bound_text(nbytes, flops)}")
        assert err <= KERNEL_ATOL, f"attention disagrees: {err}"
        fwd.add(err, t_k, t_p, t_l, nbytes, flops)
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
        bwd.add(max(e_q, e_b), t_k, t_p, t_l, nbytes, flops)
    return {"fwd": fwd, "bwd": bwd}


def head_library(x, ek, eb, mul, add, pk, pb):
    """The head through two bf16 cuBLAS GEMMs with the affine and ReLU
    between them."""
    h = torch.addmm(eb, x, ek)
    return torch.addmm(pb, torch.relu(h * mul + add), pk)


def check_head(gen) -> dict:
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
    names = ("dx", "dWe", "dbe", "dmul", "dadd", "dWp", "dbp")
    for n in cfg.num_outputs:
        pk = ((torch.rand(n, O, generator=gen, device="cuda") * 2 - 1)
              * O ** -0.5).to(torch.bfloat16).t()
        pb = 0.02 * torch.randn(1, n, generator=gen, device="cuda")
        gy = (torch.randn(M, n, generator=gen, device="cuda")
              * M ** -0.5).to(torch.bfloat16)
        args = (x, ek, eb, mul, add, pk, pb)
        lib_args = [a.to(torch.bfloat16).contiguous() for a in args]
        # forward
        out = head_mlp_fwd(*args)
        ref = head_mlp_plain(*args)
        torch.cuda.synchronize()
        assert out.shape == (M, n) and out.dtype == torch.bfloat16
        err = (out.float() - ref.float()).abs().max().item()
        t_k = median_ms(lambda: head_mlp_fwd(*args))
        t_p = median_ms(lambda: head_mlp_plain(*args))
        t_l = median_ms(lambda: head_library(*lib_args))
        w_bytes = C * O * 2 + 3 * O * 4 + O * n * 2 + n * 4
        nbytes = M * C * 2 + w_bytes + M * n * 2
        flops = 2.0 * M * C * O + 2.0 * M * O * n
        print(f"head fwd M {M} C {C} hidden {O} n {n}: max_abs_err "
              f"{err:.3e} (bound {KERNEL_ATOL:.3e}, |y| max "
              f"{ref.float().abs().max().item():.3f}) kernel {t_k:.4f} ms "
              f"plain {t_p:.4f} ms cublas {t_l:.4f} ms "
              f"{bound_text(nbytes, flops)}")
        assert err <= KERNEL_ATOL, f"head disagrees: {err}"
        fwd.add(err, t_k, t_p, t_l, nbytes, flops)
        # backward
        got = head_mlp_bwd(*args, gy)
        want = head_mlp_bwd_plain(*args, gy)
        torch.cuda.synchronize()
        worst, parts = 0.0, []
        for name, a, b in zip(names, got, want):
            assert a.shape == b.shape and a.dtype == b.dtype, name
            d = a.float() - b.float()
            e = d.abs().max().item()
            rms = (d.norm() / b.float().norm()).item()
            parts.append(f"{name} {e:.2e} rel_rms {rms:.2e}")
            assert rms <= HEAD_BWD_RMS, f"head backward {name}: {rms}"
            assert e <= HEAD_BWD_MAX_REL * b.float().abs().max().item(), name
            worst = max(worst, e)
        leaves = [a.detach().requires_grad_(True) for a in lib_args]
        y = head_library(*leaves)
        t_k = median_ms(lambda: head_mlp_bwd(*args, gy))
        t_p = median_ms(lambda: head_mlp_bwd_plain(*args, gy))
        t_l = median_ms(lambda: torch.autograd.grad(y, leaves, gy,
                                                    retain_graph=True))
        nbytes = 2 * M * C * 2 + M * n * 2 + 2 * w_bytes
        flops = 6.0 * M * C * O + 4.0 * M * O * n
        print(f"head bwd n {n}: max_abs_err {' '.join(parts)} (rel_rms "
              f"bound {HEAD_BWD_RMS:.1e}) "
              f"kernel {t_k:.4f} ms plain {t_p:.4f} ms cublas backward "
              f"{t_l:.4f} ms {bound_text(nbytes, flops)}")
        bwd.add(worst, t_k, t_p, t_l, nbytes, flops)
    return {"fwd": fwd, "bwd": bwd}


def serve_requests(model, cfg) -> tuple:
    """Phase 4; returns (launch counts of the run, the 1-image request's
    images and outputs)."""
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
        for task, n in zip(cfg.tasks, cfg.num_outputs):
            y = out[task]
            assert y.shape == (batch, cfg.img_size, cfg.img_size, n), \
                (task, tuple(y.shape))
            assert bool(torch.isfinite(y).all()), f"{task}: non-finite"
        print(f"serve request {i}: {batch} images -> "
              + ", ".join(f"{t} {tuple(out[t].shape)}" for t in cfg.tasks)
              + f"; launches {per_forward[-1]}")
        if first is None:
            first = (images, {t: v.float().cpu() for t, v in out.items()})
    counts = counters.read()
    want = {"window_attention": sum(cfg.depths), "window_attention_bwd": 0,
            "hrnet_head_mlp": len(cfg.tasks), "hrnet_head_mlp_bwd": 0}
    for c in per_forward:
        assert c == want, f"expected {want} launches per forward, got {c}"
    return counts, first


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
    want = {"window_attention": sum(cfg.depths),
            "window_attention_bwd": sum(cfg.depths),
            "hrnet_head_mlp": len(cfg.tasks),
            "hrnet_head_mlp_bwd": len(cfg.tasks)}
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
    return counts


def train_cross_check(cfg):
    """Phase 8: one step on the card in bf16 and on the CPU in fp32."""
    cfg0 = dataclasses.replace(
        cfg, drop_path_rate=0.0,
        stages=tuple(dataclasses.replace(s, dropout=0.0) for s in cfg.stages))
    card = random_model(cfg0, SEED + 1, "cuda")
    cpu = build_mtl_model(dataclasses.replace(cfg0, compute_dtype="float32"),
                          device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    tcfg = TrainConfig(batch_size=CROSS_BATCH, warmup_epochs=0)
    results = []
    for model, device in ((card, "cuda"), (cpu, "cpu")):
        opt = build_optimizer(model, tcfg)
        batch = synthetic_batch(CROSS_BATCH, cfg.img_size, SEED + 1, device)
        t0 = time.perf_counter()
        m = train_step(model, opt, build_schedule(tcfg, ITERS_PER_EPOCH),
                       batch, None, clip_grad=tcfg.clip_grad)
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
    attn = check_attention(gen)
    head = check_head(gen)

    cfg = tiny_448_r64_pertask()
    model = random_model(cfg, SEED, "cuda")
    serve_counts, (images1, card_out1) = serve_requests(model, cfg)
    cross_check(model, cfg, images1, card_out1)

    batch = torch.from_numpy(synthetic_images(
        THROUGHPUT_BATCH, cfg.img_size, SEED)).cuda()
    torch.cuda.reset_peak_memory_stats()
    rate = throughput(model, batch, iters=5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"throughput: {rate:.2f} img/s bf16 forward at batch "
          f"{THROUGHPUT_BATCH} (peak {peak:.2f} GiB) on {card}")
    del model, batch

    train_counts = train_phase(cfg, card)
    print(f"launches: serve {serve_counts}, train {train_counts}")
    train_cross_check(cfg)

    def entry(name, source, replaces, tally):
        return {"name": name, "route": "cuda",
                "source": f"mtlora_tpu_torch/ops/csrc/{source}",
                "replaces": f"mtlora_tpu/ops/{replaces}",
                "launches": train_counts[name], **tally.json()}

    print(json.dumps({"kernels": [
        entry("window_attention", "window_attn.cu",
              "pallas_window_attn.py:84", attn["fwd"]),
        entry("window_attention_bwd", "window_attn_bwd.cu",
              "pallas_window_attn.py:119", attn["bwd"]),
        entry("hrnet_head_mlp", "head_mlp.cu", "pallas_head.py:96",
              head["fwd"]),
        entry("hrnet_head_mlp_bwd", "head_mlp_bwd.cu", "pallas_head.py:111",
              head["bwd"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
