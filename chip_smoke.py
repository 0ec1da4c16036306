"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and exits non-zero:
  1. device: a CUDA card must be present; its name and power limit;
  2. build: both CUDA kernels from ops/csrc, with the build time;
  3. kernels vs plain: window attention at the four Swin-T 448 stage
     shapes (batch 8, shifted and not) and the HRNet head at batch 8 for
     the four task widths, on the card, against their plain PyTorch
     versions on the same tensors, with both times;
  4. serve: the flagship model (bf16, seeded random weights) answers
     requests of 1, 8 and 32 images through ``serve.predict``; shapes,
     finiteness and 12 attention + 4 head launches per forward;
  5. cross-check: the 1-image request against the same weights run on the
     CPU in fp32 through the plain versions;
  6. throughput: bf16 forward img/s at batch 32;
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

from mtlora_tpu_torch.config import tiny_448_r64_pertask
from mtlora_tpu_torch.models.mtl import build_mtl_model
from mtlora_tpu_torch.ops import _build
from mtlora_tpu_torch.ops.attention import (
    shift_attention_mask,
    window_attention,
)
from mtlora_tpu_torch.ops.head import head_mlp, head_mlp_plain
from mtlora_tpu_torch.ops.window_attn import fused_window_attention
from mtlora_tpu_torch.serve import (
    predict,
    random_model,
    synthetic_images,
    throughput,
)

SEED = 0
KERNEL_BATCH = 8
REQUESTS = (1, 8, 32)
THROUGHPUT_BATCH = 32
# kernel vs plain, both bf16 on the card: outputs agree up to the order of
# fp32 sums, which can flip a bf16 rounding of P (attention) or of the
# hidden (head) and of the output. Attention outputs are convex mixes of v
# (|v| < 6 here), the head's |y| < 4: 2^-5 is two bf16 ulps at |y| = 4.
KERNEL_ATOL = 2.0 ** -5
# card (bf16, 12 blocks) vs CPU (fp32): relative RMS error of each task's
# logits; bf16 keeps 8 bits (rel. step 2^-8 = 3.9e-3), and ~40 rounded
# ops in a row grow that to about 1e-2.
CROSS_REL_RMS = 5e-2


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def median_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check_attention(gen) -> dict:
    cfg = tiny_448_r64_pertask()
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for s in range(4):
        res = cfg.img_size // cfg.patch_size // 2 ** s
        C, nH, ws = cfg.embed_dim * 2 ** s, cfg.num_heads[s], cfg.window_size
        nW = (res // ws) ** 2
        N = ws * ws
        qkv = torch.randn(KERNEL_BATCH * nW, N, 3 * C, generator=gen,
                          device="cuda").to(torch.bfloat16)
        bias = 0.1 * torch.randn(nH, N, N, generator=gen, device="cuda")
        scale = (C // nH) ** -0.5
        for shift in (0, ws // 2):
            mask = (torch.from_numpy(shift_attention_mask(
                res, res, ws, shift)).cuda() if shift else None)
            out = fused_window_attention(qkv, nH, bias, mask, scale)
            ref = window_attention(qkv, nH, bias, mask, scale)
            torch.cuda.synchronize()
            assert out.shape == ref.shape and out.dtype == torch.bfloat16
            err = (out.float() - ref.float()).abs().max().item()
            t_k = median_ms(lambda: fused_window_attention(
                qkv, nH, bias, mask, scale))
            t_p = median_ms(lambda: window_attention(
                qkv, nH, bias, mask, scale))
            print(f"attention stage {s} qkv {tuple(qkv.shape)} nH {nH} "
                  f"shift {shift}: max_abs_err {err:.3e} (bound "
                  f"{KERNEL_ATOL:.3e}) kernel {t_k:.4f} ms plain "
                  f"{t_p:.4f} ms")
            assert err <= KERNEL_ATOL, f"attention disagrees: {err}"
            worst, ms, plain_ms = max(worst, err), ms + t_k, plain_ms + t_p
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for n in cfg.num_outputs:
        pk = ((torch.rand(n, O, generator=gen, device="cuda") * 2 - 1)
              * O ** -0.5).to(torch.bfloat16).t()
        pb = 0.02 * torch.randn(1, n, generator=gen, device="cuda")
        args = (x, ek, eb, mul, add, pk, pb)
        out = head_mlp(*args)
        ref = head_mlp_plain(*args)
        torch.cuda.synchronize()
        assert out.shape == (M, n) and out.dtype == torch.bfloat16
        err = (out.float() - ref.float()).abs().max().item()
        t_k = median_ms(lambda: head_mlp(*args))
        t_p = median_ms(lambda: head_mlp_plain(*args))
        print(f"head M {M} C {C} hidden {O} n {n}: max_abs_err {err:.3e} "
              f"(bound {KERNEL_ATOL:.3e}, |y| max "
              f"{ref.float().abs().max().item():.3f}) kernel {t_k:.4f} ms "
              f"plain {t_p:.4f} ms")
        assert err <= KERNEL_ATOL, f"head disagrees: {err}"
        worst, ms, plain_ms = max(worst, err), ms + t_k, plain_ms + t_p
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def serve_requests(model, cfg) -> tuple:
    """Phase 4; returns (launch counts of the run, the 1-image request's
    images and outputs)."""
    fused_window_attention.launches = 0
    head_mlp.launches = 0
    first = None
    per_forward = []
    for i, batch in enumerate(REQUESTS):
        images = synthetic_images(batch, cfg.img_size, SEED + i)
        a0, h0 = fused_window_attention.launches, head_mlp.launches
        out = predict(model, images)
        torch.cuda.synchronize()
        per_forward.append((fused_window_attention.launches - a0,
                            head_mlp.launches - h0))
        for task, n in zip(cfg.tasks, cfg.num_outputs):
            y = out[task]
            assert y.shape == (batch, cfg.img_size, cfg.img_size, n), \
                (task, tuple(y.shape))
            assert bool(torch.isfinite(y).all()), f"{task}: non-finite"
        print(f"serve request {i}: {batch} images -> "
              + ", ".join(f"{t} {tuple(out[t].shape)}" for t in cfg.tasks)
              + f"; launches attention/head {per_forward[-1]}")
        if first is None:
            first = (images, {t: v.float().cpu() for t, v in out.items()})
    counts = {"attention": fused_window_attention.launches,
              "head": head_mlp.launches}
    blocks = sum(cfg.depths)
    for a, h in per_forward:
        assert (a, h) == (blocks, len(cfg.tasks)), (
            f"expected {blocks} attention and {len(cfg.tasks)} head "
            f"launches per forward, got {a} and {h}")
    assert counts["attention"] > 0 and counts["head"] > 0
    return counts, first


def cross_check(model, cfg, images, card_out):
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    cpu = build_mtl_model(cfg32)
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
          f"{len(list(_build.CSRC.glob('*.cu')))} sources)")
    for line in _build.ptxas_log.splitlines():
        if "Used" in line or "Function properties" in line:
            print(f"ptxas: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    attn = check_attention(gen)
    head = check_head(gen)

    cfg = tiny_448_r64_pertask()
    model = random_model(cfg, SEED, "cuda")
    counts, (images1, card_out1) = serve_requests(model, cfg)

    cross_check(model, cfg, images1, card_out1)

    batch = torch.from_numpy(synthetic_images(
        THROUGHPUT_BATCH, cfg.img_size, SEED)).cuda()
    torch.cuda.reset_peak_memory_stats()
    rate = throughput(model, batch, iters=5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"throughput: {rate:.2f} img/s bf16 forward at batch "
          f"{THROUGHPUT_BATCH} (peak {peak:.2f} GiB) on {card}")

    print(json.dumps({"kernels": [
        {"name": "window_attention", "route": "cuda",
         "source": "mtlora_tpu_torch/ops/csrc/window_attn.cu",
         "replaces": "mtlora_tpu/ops/pallas_window_attn.py:84",
         "launches": counts["attention"], **attn},
        {"name": "hrnet_head_mlp", "route": "cuda",
         "source": "mtlora_tpu_torch/ops/csrc/head_mlp.cu",
         "replaces": "mtlora_tpu/ops/pallas_head.py:96",
         "launches": counts["head"], **head},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
