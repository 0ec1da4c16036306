"""Kernels 4 and 4b on the card against variants of themselves and other
checkouts (and, with ``--checks``, any kernel: kernel 2's and 2b's
variants at the qkv sites, ``qkv-fwd-*`` and ``qkv-*``, run with
``--checks check_ln_lora``, kernel 2-tail's, ``tail-fwd-*``, with
``--checks check_ln_lora_tail``, kernels 3's and 3b's, ``merge-fwd-*`` and
``merge-*``, with ``--checks check_merge``, kernel 6's, ``task-merge-fwd-*``,
with ``--checks check_task_merge``, kernel 5b's, ``adapter-bwd-*``, with
``--checks check_adapter_mid``, kernel 5's, ``adapter-fwd-*``, with the
same checks, kernel 7's, ``head-fwd-*``, with ``--checks check_head``).

    python -m mtlora_tpu_torch.tools.ln_mlp_bwd_variants
        [--variants NAME,...] [--against DIR ...] [--checks FUNC,...]
        [--time-qkv | --time-merge | --time-task-merge | --time-adapter-bwd
         | --time-adapter-fwd]
        [--passes 2]

The trees: this checkout; one copy of its ``mtlora_tpu_torch`` per
variant, with that variant's edits of ``VARIANTS`` applied (under
``build/variants/``); each ``--against``, the root of another checkout
(such as the parent commit, unpacked with ``git archive``), named by its
directory. Every tree runs in
a process of its own, with its own package on the path and its own
kernel library, in the order A B .. B A (``--passes``), so that a drift
of the card shows as a difference between passes. The libraries build
first, all at once.

Each process checks kernel 4 (``ops/ln_mlp.py:ln_mlp_fwd``) against
``ln_mlp_plain`` and kernel 4b (``ln_mlp_bwd``) against
``ln_mlp_bwd_plain`` at the four stage shapes of the batch-32 step and at
the ragged 392 rows of stage 3 (bf16 y and dx within 2^-6 of the largest
element, fp32 sums at relative RMS <= 2^-7, as ``chip_smoke.py``; a
stage that misses them is reported and not timed, and the run fails),
times both per stage (CUDA events, the median of 3 rounds of 10
launches), and prints one JSON line: the ms per stage, their sums per
pass (stage 2 has five no-task blocks) and the card; each tree's build
prints the registers and spills that ptxas reported for the instances of
kernel 4, of the LN-family backward row kernels (4b, 2b, 3b, 6b), of
kernels 3 and 6 (one body), of the attention forward and backward
(kernels 1, 1b and 1c's), of kernel 5b and of kernel 7. The edits of
``VARIANTS`` reach either kernel's source and plan (and 1's, 2b's,
2-tail's, 3's, 3b's, 5b's, 6's, 7's; kernel 1's, ``attn-fwd-*``, run with
``--checks check_attention,check_dense_attention``). With ``--checks`` it
runs those ``check_*`` functions of its tree's
``chip_smoke.py`` instead (the phase 3/3b rows of other kernels) and
prints their sums and, per line of theirs that names a kernel time
(``<label>: ... kernel <ms> ms``), that time by label: the per-stage
comparison of those checks between the trees.

With ``--time-qkv`` each tree instead times kernel 2 at the four qkv
sites (the tree's ``ln_lora_fwd``, dropout 0.05 and off) and the tail
mode without GELU and d at the same shapes, unchecked, so that the trees
of ``PARTS`` (kernel 2's qkv mode with a part of its work taken out) run
beside it: where the time of a stage goes. With ``--time-merge`` each
tree times kernel 3 at the three merges for L = 32 and 128, unchecked, so
that the trees of ``PARTS`` with a part of kernel 3 taken out run beside
it; with ``--time-task-merge``, kernel 6 at its three merges (four tasks,
batch 32) and at ``chip_smoke.py``'s coverage shapes, beside the trees of
``PARTS`` with a part of kernel 6 taken out; with ``--time-adapter-bwd``,
kernel 5b at its four stage shapes: ms a call, device ms and the
wrapper's host ms a call; with ``--time-adapter-fwd``, kernel 5 at the
same shapes (ms and device ms a call) and the SM clock under it, beside
the trees of ``PARTS`` with a part of kernel 5 taken out.

This file imports only torch and the standard library at the top: a
process of another tree imports that tree's package, never this one's.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
VARIANT_DIR = ROOT / "build" / "variants"

# kernel 3's variant merge-fwd-refill-ring: 2-tail's ring (ln_lora_tail_fwd.cu),
# adapted to kernel 3's walk of its items
MERGE_REFILL_RING = r"""// 2-tail's ring (ln_lora_tail_fwd.cu): a.stages slots in groups of
// a.group, one mbarrier a group that its boxes complete, one count a group
// of the warps done with it. Where a slot starts a group, next() first
// hands back the warp's group before: the last of the kWarps warps to hand
// a group back starts the group nbar ahead into its slots (its lanes a box
// each). Then it waits on the group's mbarrier.
struct RefillRing {
  bf16* buf;       // 1024-byte aligned
  uint64_t* bars;  // stages / group
  int* held;       // stages / group: the warps' hand-backs, counted up
  int nbar;
  int g = 0, qg = 0, slot = 0;   // group, slot in the group, ring slot

  __device__ __forceinline__ RefillRing(bf16* b, uint64_t* bs, int stages,
                                        int group)
      : buf(b), bars(bs), held(reinterpret_cast<int*>(bs + stages / group)),
        nbar(stages / group) {}

  __device__ __forceinline__ unsigned char* end(int) const {
    return reinterpret_cast<unsigned char*>(held + nbar);
  }

  __device__ __forceinline__ void init(int) const {
    for (int i = 0; i < nbar; ++i) {
      mbar_init(bars + i);
      held[i] = 0;
    }
  }

  template <int WN>
  __device__ __forceinline__ void produce(const Params&, const Walk&) {}

  // The calling warp starts group gi: lane j box j, lane 0 first posting
  // the group's bytes.
  template <int WN>
  __device__ __forceinline__ void issue(const Params& p, const Walk& w,
                                        int gi) {
    const Args& a = p.a;
    const int per = w.nci * w.ncs, first = gi * a.group;
    const int n = min(a.group, w.nitems * per - first);
    if (n <= 0) return;
    const int j = lane_id();
    uint64_t* bar = bars + gi % nbar;
    if (j == 0) mbar_expect(bar, n * kSlice * (int)sizeof(bf16));
    __syncwarp();
    if (j < n) {
      const int qq = first + j, kk = qq / per;
      const int c0 = w.item(kk) % a.splits * w.nci;
      const int2 b = slot_box<WN>(qq - kk * per, c0, w.nci, w.ncs);
      tma_box(buf + (qq % a.stages) * kSlice, &p.w, bar, b.x, b.y);
    }
  }

  // warp 0 starts the first nbar groups (after the block's one barrier)
  template <int WN>
  __device__ __forceinline__ void begin(const Params& p, const Walk& w) {
    for (int i = 0; i < nbar; ++i) issue<WN>(p, w, i);
  }

  template <int WN>
  __device__ __forceinline__ void release(const Params& p, const Walk& w,
                                          int gi) {
    __syncwarp();
    int last = 0;
    if (lane_id() == 0) {
      __threadfence_block();
      last = atomicAdd(held + gi % nbar, 1) == kWarps * (gi / nbar + 1) - 1;
    }
    if (__shfl_sync(0xffffffffu, last, 0)) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue<WN>(p, w, gi + nbar);
    }
  }

  template <int WN>
  __device__ __forceinline__ const bf16* next(const Params& p,
                                              const Walk& w) {
    if (qg == 0) {
      if (g > 0) release<WN>(p, w, g - 1);
      mbar_wait(bars + g % nbar, (g / nbar) & 1);
    }
    return buf + slot * kSlice;
  }

  __device__ __forceinline__ void done(const Params& p) {
    if (++slot == p.a.stages) slot = 0;
    if (++qg == p.a.group) {
      qg = 0;
      ++g;
    }
  }
};

"""

# the first lines of kernel 3's LayerNorm pass (merge_ln) and of its task
# mode's (task_ln, kernel 6)
MERGE_LN_LOOP = ("K = a.K, P = K / 8;\n#pragma unroll 1\n"
                 "  for (int r = ni; r < RW; r += RB * WN) {")
TASK_LN_LOOP = ("M = a.M, P = K / 8;\n"
                "  const bf16* mid = a.mid")
TASK_LN_OFF = (TASK_LN_LOOP, TASK_LN_LOOP.replace(
    "  const bf16* mid", "  if (a.M > 0) return;\n  const bf16* mid"))
# kernel 6: the rows a warp forms at a time in its LayerNorm pass
TASK_RT = "RT = UT <= 2 ? 4 : UT <= 3 ? 2 : 1,"
# kernel 6: the loads of a row's shared and rank rows
TASK_ROWS = "          const int tok = tok0[h] + dt[u0 + j];"
# the products and the stores of kernels 3 and 6 (one body)
PRODUCTS = ("ring.next<WN>(p, w);\n            slot_mma<MT, NT, KS>",
            "ring.next<WN>(p, w);\n            if (a.M < 0) slot_mma<MT, NT, KS>")
STORES = ("              if (row >= M) continue;",
          "              if (row >= M || a.M > 0) continue;")


# kernel 1's variant attn-fwd-p-smem: P's A fragments from shared memory
ATTN_P_REGISTERS = """    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0] * inv[0], s[2 * kk][1] * inv[0]);
      pa[kk][1] = pack_bf16(s[2 * kk][2] * inv[1], s[2 * kk][3] * inv[1]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0] * inv[0],
                            s[2 * kk + 1][1] * inv[0]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2] * inv[1],
                            s[2 * kk + 1][3] * inv[1]);
    }
"""
ATTN_P_SMEM = """    __nv_bfloat16* pw = reinterpret_cast<__nv_bfloat16*>(
        smem + dynamic_smem_bytes()) - (kWarps - warp) * 16 * kRows;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(pw + sw64(g + 8 * half, j) + 2 * t) =
            pack_bf16(s[j][2 * half] * inv[half],
                      s[j][2 * half + 1] * inv[half]);
    __syncwarp();
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm_x4(pa[kk], pw + sw64((lane & 7) + ((lane >> 3) & 1) * 8,
                                2 * kk + (lane >> 4)));
"""


def _fwd(*edits):
    return [("ops/csrc/merge_ln_fwd.cu", old, new) for old, new in edits]


# kernel 7's first product by wgmma (the kept tree) and, in the variant
# head-fwd-mma-sync, by mma.sync on ldmatrix fragments of the same slots
HEAD_FWD_WGMMA = """  const uint64_t d0 = sw128_desc(st);
  wg_fence();
  pin(h);
#pragma unroll
  for (int k = 0; k < kKs - 1; ++k)
    wgmma_64x64(h, af[k],
                d0 + (((k / 4) * 2 * kSlot + (k % 4) * 32) >> 4), k > 0);
  wgmma_64x64(h, af[kKs - 1], sw32_desc(st + 2 * kSlices * kSlot), 1);
  wg_commit();
"""
HEAD_FWD_MMA_SYNC = """  float (*acc)[4] = reinterpret_cast<float (*)[4]>(h);
  zero<8>(acc);
#pragma unroll
  for (int cs = 0; cs < kSlices; ++cs)
    mma_slot<8>(acc, af + 4 * cs,
                reinterpret_cast<const bf16*>(st) + cs * kSlot, 0, 4);
  // the tail slot: rows of 32 bytes, their 16-byte halves swapped where
  // the row's bit 2 is set (the 32-byte swizzle)
  const int lane = lane_id();
  const bf16* tl = reinterpret_cast<const bf16*>(st) + kSlices * kSlot;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = 16 * q + (lane & 7) + ((lane >> 4) << 3);
    uint32_t b[4];
    ldsm_x4(b, tl + 16 * r + 8 * (((lane >> 3) & 1) ^ ((r >> 2) & 1)));
    mma_bf16_16816(acc[2 * q], af[kKs - 1], b[0], b[1]);
    mma_bf16_16816(acc[2 * q + 1], af[kKs - 1], b[2], b[3]);
  }
"""
# kernel 7's chunks one at a time (the kept tree: each chunk's products
# waited for before its epilogue) and, in the variant head-fwd-two-chunks,
# two at a time: chunk c + 1's products issued before chunk c's epilogue
HEAD_FWD_TWO_CHUNKS = """    float ha[32], hb[32];
    const unsigned char* sa = ring.take();
    issue_chunk(ha, af, sa);
#pragma unroll 1
    for (int c = 0; c < nch; c += 2) {
      const unsigned char* sbs = sa;
      if (c + 1 < nch) {
        sbs = ring.take();
        issue_chunk(hb, af, sbs);
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      pin(ha);
      chunk_out<NT>(out, ha, sa, t);
      ring.release();
      if (c + 1 == nch) break;
      if (c + 2 < nch) {
        sa = ring.take();
        issue_chunk(ha, af, sa);
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      pin(hb);
      chunk_out<NT>(out, hb, sbs, t);
      ring.release();
    }
"""
HEAD_FWD_PING_PONG = """    float ha[32];
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {
      const unsigned char* sa = ring.take();
      if (wg == 0)
        asm volatile("bar.sync 1, 256;\\n" ::: "memory");
      else
        asm volatile("bar.sync 2, 256;\\n" ::: "memory");
      issue_chunk(ha, af, sa);
      if (wg == 0)
        asm volatile("bar.arrive 2, 256;\\n" ::: "memory");
      else if (--turns > 0)
        asm volatile("bar.arrive 1, 256;\\n" ::: "memory");
      wg_wait<0>();
      pin(ha);
      chunk_out<NT>(out, ha, sa, t);
      ring.release();
    }
"""
HEAD_FWD_ONE_CHUNK = """    float ha[32];
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {
      const unsigned char* sa = ring.take();
      issue_chunk(ha, af, sa);
      wg_wait<0>();
      pin(ha);
      chunk_out<NT>(out, ha, sa, t);
      ring.release();
    }
"""


# name -> edits (file under mtlora_tpu_torch/, text, replacement); each
# text occurs exactly once in this checkout
VARIANTS = {
    # kernel 4: a ring of 8 slots in groups of 4 (half the shared memory,
    # half the MMAs between barriers)
    "fwd-ring-8": [("ops/csrc/ln_mlp.cu", "constexpr int kStages = 16;",
                    "constexpr int kStages = 8;"),
                   ("ops/csrc/ln_mlp.cu", "constexpr int kGroup = 8;",
                    "constexpr int kGroup = 4;"),
                   ("ops/ln_mlp.py", "FWD_STAGES = 16", "FWD_STAGES = 8"),
                   ("ops/ln_mlp.py", "FWD_GROUP = 8 ", "FWD_GROUP = 4 ")],
    # kernel 4: blocks of 4 warps (half the rows) with 8 slots in groups of
    # 4, two blocks an SM in place of one
    "fwd-two-blocks-an-sm": [
        ("ops/csrc/ln_mlp.cu", "constexpr int kWarps = 8;",
         "constexpr int kWarps = 4;"),
        ("ops/csrc/ln_mlp.cu", "constexpr int kStages = 16;",
         "constexpr int kStages = 8;"),
        ("ops/csrc/ln_mlp.cu", "constexpr int kGroup = 8;",
         "constexpr int kGroup = 4;"),
        ("ops/ln_mlp.py", "FWD_WARPS = 8 ", "FWD_WARPS = 4 "),
        ("ops/ln_mlp.py", "FWD_STAGES = 16", "FWD_STAGES = 8"),
        ("ops/ln_mlp.py", "FWD_GROUP = 8 ", "FWD_GROUP = 4 ")],
    # kernel 4: the same 16 slots in groups of 4 (three groups in flight)
    "fwd-group-4": [("ops/csrc/ln_mlp.cu", "constexpr int kGroup = 8;",
                     "constexpr int kGroup = 4;"),
                    ("ops/ln_mlp.py", "FWD_GROUP = 8 ", "FWD_GROUP = 4 ")],
    # the dln products stream W1 again instead of keeping the h pass's
    # slices
    "no-keep-w1": [("ops/ln_mlp.py", "keep_w1 = 3 <= ncs <= 6",
                    "keep_w1 = False")],
    # 32-row blocks at every stage (the plan's 64 reuse each slice twice
    # as often)
    "32-row-blocks": [("ops/ln_mlp.py", "bm = 64 if ncs <= 6 else 32",
                       "bm = 32")],
    # at C <= 128 one block per SM, with all the registers it wants
    "one-block-per-sm": [("ops/csrc/ln_mlp_bwd.cu",
                          "__launch_bounds__(kThreads, NCS <= 2 ? 2 : 1)",
                          "__launch_bounds__(kThreads, 1)")],
    # the 64-row blocks in one instance, sized for six slices of C
    "one-64-row-instance": [
        ("ops/csrc/ln_mlp_bwd.cu",
         "                  : ncs <= 2 ? launch_rows<64, 2>(a, blocks, smem, "
         "st)\n                  : ncs <= 3 ? launch_rows<64, 3>(a, blocks, "
         "smem, st)\n", "")],
    # kernel 1b: two blocks an SM (up to 255 registers a thread, 264
    # blocks in a wave) in place of three
    "attn-bwd-2-per-sm": [
        ("ops/csrc/window_attn_bwd.cu", "constexpr int kBlocksPerSm = 3;",
         "constexpr int kBlocksPerSm = 2;"),
        ("ops/window_attn.py", "BWD_BLOCKS_PER_SM = 3",
         "BWD_BLOCKS_PER_SM = 2")],
    # kernel 1b: four waves of blocks with a quarter of the windows each
    # in place of one
    "attn-bwd-4-waves": [
        ("ops/window_attn.py", "slots = max(1, sms * per_sm // num_heads)",
         "slots = max(1, 4 * sms * per_sm // num_heads)")],
    # kernel 1: three buffers (two windows in flight while one is
    # computed)
    "attn-fwd-3-buffers": [
        ("ops/csrc/window_attn_fwd.cu", "constexpr int kStages = 2;",
         "constexpr int kStages = 3;"),
        ("ops/window_attn.py", "FWD_STAGES = 2", "FWD_STAGES = 3")],
    # kernel 1: expf of the scores less their row max, in place of ex2 of
    # the log2(e)-prescaled scores
    "attn-fwd-expf": [
        ("ops/csrc/window_attn_fwd.cu",
         "const float mo = quad_max(mx) * kLog2e;",
         "const float mo = quad_max(mx);"),
        ("ops/csrc/window_attn_fwd.cu",
         "ex2(fmaf(s[j][2 * half + e], kLog2e, -mo))",
         "expf(s[j][2 * half + e] - mo)")],
    # kernel 1: three or five blocks an SM (registers capped at 168, 102)
    "attn-fwd-3-per-sm": [
        ("ops/csrc/window_attn_fwd.cu", "constexpr int kBlocksPerSm = 4;",
         "constexpr int kBlocksPerSm = 3;"),
        ("ops/window_attn.py", "FWD_BLOCKS_PER_SM = 4",
         "FWD_BLOCKS_PER_SM = 3")],
    "attn-fwd-5-per-sm": [
        ("ops/csrc/window_attn_fwd.cu", "constexpr int kBlocksPerSm = 4;",
         "constexpr int kBlocksPerSm = 5;"),
        ("ops/window_attn.py", "FWD_BLOCKS_PER_SM = 4",
         "FWD_BLOCKS_PER_SM = 5")],
    # kernel 1: two waves of blocks with half the windows each
    "attn-fwd-2-waves": [
        ("ops/window_attn.py", "slots = max(1, per_sm * sms // num_heads)",
         "slots = max(1, 2 * per_sm * sms // num_heads)")],
    # kernel 1: P through shared memory (a 16 x 64 bf16 tile a warp at the
    # end of the block's, read back by ldmatrix) in place of its C
    # fragments repacked in registers
    "attn-fwd-p-smem": [
        ("ops/csrc/window_attn_fwd.cu",
         "  return (size_t)kStages * kQkvBytes +",
         "  return (size_t)kWarps * 16 * kRows * 2 +\n"
         "         (size_t)kStages * kQkvBytes +"),
        ("ops/csrc/window_attn_fwd.cu", ATTN_P_REGISTERS, ATTN_P_SMEM),
        ("ops/window_attn.py",
         "smem = (FWD_STAGES * 3 * MAX_N * FWD_HEAD_DIM * 2",
         "smem = (4 * 16 * MAX_N * 2\n"
         "            + FWD_STAGES * 3 * MAX_N * FWD_HEAD_DIM * 2")],
    # kernel 5b: one block an SM (up to 255 registers a thread)
    "adapter-bwd-1-per-sm": [
        ("ops/csrc/adapter_mlp_bwd.cu", "constexpr int kPerSm = 2;",
         "constexpr int kPerSm = 1;"),
        ("ops/adapter_mlp.py", "BWD_PER_SM = 2 ", "BWD_PER_SM = 1 ")],
    # kernel 5b: blocks of 4 warps (192 columns), three an SM
    "adapter-bwd-4-warps": [
        ("ops/csrc/adapter_mlp_bwd.cu", "constexpr int kWarps = 8;",
         "constexpr int kWarps = 4;"),
        ("ops/csrc/adapter_mlp_bwd.cu", "constexpr int kPerSm = 2;",
         "constexpr int kPerSm = 3;"),
        ("ops/adapter_mlp.py", "BWD_WARPS = 8 ", "BWD_WARPS = 4 "),
        ("ops/adapter_mlp.py", "BWD_PER_SM = 2 ", "BWD_PER_SM = 3 ")],
    # kernel 5b: one block an SM of 12 warps of 2 pairs (384 columns, 168
    # registers a thread)
    "adapter-bwd-12-warps": [
        ("ops/csrc/adapter_mlp_bwd.cu", "constexpr int kWarps = 8;",
         "constexpr int kWarps = 12;"),
        ("ops/csrc/adapter_mlp_bwd.cu", "constexpr int kPairs = 3;",
         "constexpr int kPairs = 2;"),
        ("ops/csrc/adapter_mlp_bwd.cu", "constexpr int kPerSm = 2;",
         "constexpr int kPerSm = 1;"),
        ("ops/adapter_mlp.py", "BWD_WARPS = 8 ", "BWD_WARPS = 12 "),
        ("ops/adapter_mlp.py", "BWD_PAIRS = 3 ", "BWD_PAIRS = 2 "),
        ("ops/adapter_mlp.py", "BWD_PER_SM = 2 ", "BWD_PER_SM = 1 ")],
    # kernel 5b: each pair's p1 loaded where the pair starts, in place of
    # the next pair's loaded under the current pair's work
    "adapter-bwd-p1-no-prefetch": [
        ("ops/csrc/adapter_mlp_bwd.cu",
         "  uint2 pn[2] = {make_uint2(0u, 0u), make_uint2(0u, 0u)};\n"
         "  if (t0 < t1 && wc0 < H4)\n"
         "    load_p(pn, p1, M, H4, t0 * kRows, wc0, g8, q);\n", ""),
        ("ops/csrc/adapter_mlp_bwd.cu",
         "        const uint2 pc[2] = {pn[0], pn[1]};\n"
         "        // the next pair's p1 (this sub's, the next sub's, the next tile's)\n"
         "        {\n"
         "          const int nh = pp + 1 < kPairs ? h0 + 16 : wc0;\n"
         "          const int nr = pp + 1 < kPairs ? r0\n"
         "                         : sub + 1 < kRows / 16 ? r0 + 16\n"
         "                         : tile + 1 < t1    ? m0 + kRows\n"
         "                                            : -1;\n"
         "          if (nr >= 0 && nh < H4) load_p(pn, p1, M, H4, nr, nh, g8, q);\n"
         "        }\n"
         "        if (h0 >= H4) continue;   // the chunk's columns past H4\n",
         "        if (h0 >= H4) continue;   // the chunk's columns past H4\n"
         "        uint2 pc[2];\n"
         "        load_p(pc, p1, M, H4, r0, h0, g8, q);\n")],
    # kernel 5b: the 16-row steps of a tile left to the compiler to unroll
    "adapter-bwd-sub-unroll": [
        ("ops/csrc/adapter_mlp_bwd.cu",
         "#pragma unroll 1   // one 16-row step at a time (registers)\n", "")],
    # kernel 5: three blocks an SM (at most 80 registers a thread)
    "adapter-fwd-3-per-sm": [
        ("ops/csrc/adapter_mlp_fwd.cu", "constexpr int kPerSm = 2;",
         "constexpr int kPerSm = 3;"),
        ("ops/adapter_mlp.py", "FWD_PER_SM = 2 ", "FWD_PER_SM = 3 ")],
    # kernel 5: chunks of at most 768 columns (half the chunks from stage
    # 1 on: too few warp steps to fill the card at stages 2 and 3)
    "adapter-fwd-768-cols": [
        ("ops/csrc/adapter_mlp_fwd.cu", "constexpr int kMaxCols = 384;",
         "constexpr int kMaxCols = 768;"),
        ("ops/adapter_mlp.py", "FWD_MAX_COLS = 384 ", "FWD_MAX_COLS = 768 ")],
    # kernel 5: the GELU's 0.5 taken out of each element and put on the
    # projection's sums (bf16 rounding commutes with a power of two: the
    # same bits but for subnormal h)
    "adapter-fwd-half-fold": [
        ("ops/csrc/adapter_mlp_fwd.cu",
         "            h[e] = act_fwd<kGelu>(fmaf(a.s[t], u[e], pv[j][e]));\n",
         "          {\n"
         "            const float z = fmaf(a.s[t], u[e], pv[j][e]);\n"
         "            h[e] = z * (1.f + tanhf(z * (lnk::kGeluC + lnk::kGeluCD"
         " * (z * z))));\n"
         "          }\n"),
        ("ops/csrc/adapter_mlp_fwd.cu",
         "* kStg + g8 + 8 * (e >> 1)] = mo[G][e];",
         "* kStg + g8 + 8 * (e >> 1)] = 0.5f * mo[G][e];")],
    # kernel 2b (y-only): each thread loads its A fragments of the chunk's
    # gy from device memory into registers, in place of gy's boxes through
    # the TMA ring
    "qkv-gy-registers": [
        ("ops/csrc/ln_lora_qkv_bwd.cu", "  a.per = 2 + ncs;",
         "  a.per = 1 + ncs;"),
        ("ops/csrc/ln_lora_qkv_bwd.cu", "i = q - j * a.per;",
         "i = q - j * a.per + 1;"),
        ("ops/csrc/ln_lora_qkv_bwd.cu",
         "    a_frags_slot(af, ring.next(p), wr, ks);\n",
         "#pragma unroll\n"
         "    for (int k = 0; k < kS / 16; ++k)\n"
         "      if (k < ks)\n"
         "#pragma unroll\n"
         "        for (int e = 0; e < 4; ++e) {\n"
         "          const int m = m0 + wr + g + 8 * (e & 1);\n"
         "          af[k][e] = m < M ? __ldg(reinterpret_cast<const unsigned*>"
         "(a.gy + (size_t)m * O + kS * (ch.j0 + j) + 16 * k + 8 * (e >> 1)"
         " + 2 * t)) : 0u;\n"
         "        }\n"),
        ("ops/csrc/ln_lora_qkv_bwd.cu", "  const bf16 *gamma, *beta;\n",
         "  const bf16 *gamma, *beta, *gy;\n"),
        ("ops/csrc/ln_lora_qkv_bwd.cu",
         "  a.beta = static_cast<const bf16*>(beta);\n  a.dx",
         "  a.beta = static_cast<const bf16*>(beta);\n"
         "  a.gy = static_cast<const bf16*>(gy);\n  a.dx")],
    # kernel 2b (y-only): thread 0 starts a group's TMA boxes one after
    # another, in place of one lane of warp 0 each
    "qkv-issue-one-thread": [
        ("ops/csrc/ln_lora_qkv_bwd.cu",
         "    if (threadIdx.x >= 32 || n <= 0) return;\n"
         "    const int k = threadIdx.x;\n"
         "    Box b{0, 0, 0};\n"
         "    int bytes = 0;\n"
         "    if (k < n) {\n"
         "      b = box_of(a, first + k, ncs);\n"
         "      bytes = b.map == kGy ? a.gy_bytes : kSlice * (int)sizeof(bf16);\n"
         "    }\n"
         "#pragma unroll\n"
         "    for (int o = 16; o; o >>= 1)\n"
         "      bytes += __shfl_xor_sync(0xffffffffu, bytes, o);\n"
         "    uint64_t* bar = bars + gi % nbar;\n"
         "    if (k == 0) mbar_expect(bar, bytes);\n"
         "    __syncwarp();\n"
         "    if (k < n)\n"
         "      tma_box(buf + ((first + k) % a.stages) * kSlice, &p.maps[b.map], bar,\n"
         "              b.c0, b.r0);\n",
         "    if (threadIdx.x != 0 || n <= 0) return;\n"
         "    int bytes = 0;\n"
         "    for (int k = 0; k < n; ++k)\n"
         "      bytes += box_of(a, first + k, ncs).map == kGy\n"
         "                   ? a.gy_bytes\n"
         "                   : kSlice * (int)sizeof(bf16);\n"
         "    uint64_t* bar = bars + gi % nbar;\n"
         "    mbar_expect(bar, bytes);\n"
         "    for (int k = 0; k < n; ++k) {\n"
         "      const Box b = box_of(a, first + k, ncs);\n"
         "      tma_box(buf + ((first + k) % a.stages) * kSlice, &p.maps[b.map], bar,\n"
         "              b.c0, b.r0);\n"
         "    }\n")],
    # kernel 2b (y-only): at most 8 ring slots (16 where they fit) in place
    # of 12
    "qkv-ring-8": [("ops/ln_lora.py", "QKV_MAX_STAGES = 12 ",
                    "QKV_MAX_STAGES = 8 ")],
    "qkv-ring-16": [("ops/ln_lora.py", "QKV_MAX_STAGES = 12 ",
                     "QKV_MAX_STAGES = 16 ")],
    # kernel 2b (y-only): groups of 2 slots a barrier in place of 4
    "qkv-group-2": [("ops/ln_lora.py", "QKV_GROUP = 4 ", "QKV_GROUP = 2 ")],
    # kernel 2b (y-only): one block of 64 rows an SM at C = 384 (dln at
    # 96 registers a thread) in place of two of 32
    "qkv-rows-64-at-384": [
        ("ops/ln_lora.py", "    bm = 64 if C <= 192 else 32\n",
         "    bm = 64 if C <= 384 else 32\n"),
        ("ops/ln_lora.py", "64: (2, 3)}[bm]", "64: (2, 3, 6)}[bm]"),
        ("ops/csrc/ln_lora_qkv_bwd.cu", "(bm == 64 && ncs <= 3)",
         "(bm == 64 && ncs <= 6)"),
        ("ops/csrc/ln_lora_qkv_bwd.cu",
         "                              : launch_rows<64, 3>(p, blocks, "
         "smem, st))\n",
         "                  : ncs <= 3 ? launch_rows<64, 3>(p, blocks, smem, "
         "st)\n"
         "                             : launch_rows<64, 6>(p, blocks, smem, "
         "st))\n")],
    # kernel 3b: groups of 2 ring slots in place of 4 (more groups in
    # flight: 10 slots where two blocks share an SM)
    "merge-group-2": [("ops/ln_lora.py", "MERGE_GROUP = 4 ",
                       "MERGE_GROUP = 2 ")],
    # kernel 3b: one block an SM at every merge (64 rows, dln at 96
    # registers a thread, clusters of 1, 2, 4), in place of two
    "merge-one-block-an-sm": [
        ("ops/ln_lora.py", "    for least in (2, 1):\n",
         "    for least in (1,):\n"),
        ("ops/ln_lora.py", "MERGE_INSTANCES = {64: (3,),",
         "MERGE_INSTANCES = {64: (3, 6),"),
        ("ops/csrc/merge_ln_bwd.cu", "ncs > (bm == 64 ? 3 : 8)",
         "ncs > (bm == 64 ? 6 : 8)"),
        ("ops/csrc/merge_ln_bwd.cu",
         "      bm == 64   ? launch_rows<64, 3>(p, blocks, smem, st)\n",
         "      bm == 64   ? (ncs <= 3 ? launch_rows<64, 3>(p, blocks, smem, "
         "st)\n                             : launch_rows<64, 6>(p, blocks, "
         "smem, st))\n")],
    # kernel 3b: 32-row blocks at every merge (clusters of 1, 2, 4 at the
    # flagship's merges), in place of 64
    "merge-rows-32": [("ops/ln_lora.py", "        for bm in (64, 32):\n",
                       "        for bm in (32,):\n")],
    # kernel 3b: clusters of 4 at most (32 rows at the last merge), in
    # place of 8
    "merge-splits-to-4": [("ops/ln_lora.py",
                           "MERGE_SPLITS = (1, 2, 4, 8)",
                           "MERGE_SPLITS = (1, 2, 4)")],
    # kernel 3: the last of the 8 warps done with a group of slots refills
    # it (2-tail's ring, 256 threads), in place of a producer warp with
    # full and empty mbarriers a slot
    "merge-fwd-refill-ring": [
        ("ops/csrc/merge_ln_fwd.cu",
         "// The WN warps of row group mi meet (named barrier 1 + mi).",
         MERGE_REFILL_RING
         + "// The WN warps of a row group meet (named barrier 1 + mi)."),
        ("ops/csrc/merge_ln_fwd.cu",
         "constexpr int kThreads = 32 * (kWarps + 4);",
         "constexpr int kThreads = 32 * kWarps;"),
        ("ops/csrc/merge_ln_fwd.cu",
         "  Ring ring(reinterpret_cast<bf16*>(base), bars, a.stages);",
         "  RefillRing ring(reinterpret_cast<bf16*>(base), bars, a.stages,\n"
         "                  a.group);"),
        ("ops/csrc/merge_ln_fwd.cu",
         "  if (warp >= kWarps) {   // the producer warpgroup: its first warp "
         "issues\n"
         "    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 %0;\\n\" ::\"n\"(\n"
         "        kProducerRegs));\n"
         "    if (warp == kWarps) ring.produce<WN>(p, w);\n"
         "    return;\n"
         "  }\n"
         "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 %0;\\n\" ::\"n\"(\n"
         "      kConsumerRegs));\n",
         "  if (warp == 0) ring.begin<WN>(p, w);\n")],
    # kernel 3: nine warps (the producer warp alone), each thread at the
    # 168 registers they leave, in place of a producer warpgroup whose
    # registers the consumer warps take by setmaxnreg (232 a thread)
    "merge-fwd-nine-warps": [
        ("ops/csrc/merge_ln_fwd.cu",
         "constexpr int kThreads = 32 * (kWarps + 4);",
         "constexpr int kThreads = 32 * (kWarps + 1);"),
        ("ops/csrc/merge_ln_fwd.cu",
         "    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 %0;\\n\" ::\"n\"(\n"
         "        kProducerRegs));\n", ""),
        ("ops/csrc/merge_ln_fwd.cu",
         "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 %0;\\n\" ::\"n\"(\n"
         "      kConsumerRegs));\n", "")],
    # kernel 3: the LayerNorm pass on two rows at a time, in place of four
    # (up to K = 1536)
    "merge-fwd-ln-rows-2": [
        ("ops/csrc/merge_ln_fwd.cu",
         "constexpr int UR = ur_of(BM), RB = UR <= 6 ? 4 : 1;",
         "constexpr int UR = ur_of(BM), RB = UR <= 6 ? 2 : 1;")],
    # kernel 3: the LayerNorm pass on one row at a time
    "merge-fwd-ln-rows-1": [
        ("ops/csrc/merge_ln_fwd.cu",
         "constexpr int UR = ur_of(BM), RB = UR <= 6 ? 4 : 1;",
         "constexpr int UR = ur_of(BM), RB = 1;")],
    # kernel 3: 64 rows a block at most (W's slots stream twice as often;
    # a deeper ring at the first two merges), in place of 128
    "merge-fwd-rows-64": [
        ("ops/ln_lora.py", "MERGE_FWD_ROWS = {128: 2, 64: 4, 32: 8, 16: 8}",
         "MERGE_FWD_ROWS = {64: 4, 32: 8, 16: 8}")],
    # kernel 3: 32 rows a block at most
    "merge-fwd-rows-32": [
        ("ops/ln_lora.py", "MERGE_FWD_ROWS = {128: 2, 64: 4, 32: 8, 16: 8}",
         "MERGE_FWD_ROWS = {32: 8, 16: 8}")],
    # kernel 3: the most rows that leave the ring 8 slots (64 rows at the
    # second merge, 32 at the third), in place of 4
    "merge-fwd-ring-8": [
        ("ops/ln_lora.py", "MERGE_FWD_MIN_STAGES = 4 ",
         "MERGE_FWD_MIN_STAGES = 8 ")],
    # kernel 3: each block walks the slices of K from its own offset, so
    # that the SMs do not all ask L2 for the same slot at once (each block's
    # sums then run in its own order)
    "merge-fwd-rotated-slices": [
        ("ops/csrc/merge_ln_fwd.cu",
         "  return make_int2(kS * cs, kS * (c0 + pp * WN + i));",
         "  return make_int2(kS * ((cs + (int)blockIdx.x) % ncs),\n"
         "                   kS * (c0 + pp * WN + i));"),
        ("ops/csrc/merge_ln_fwd.cu",
         "      for (int cs = 0; cs < w.ncs; ++cs) {\n"
         "        if (ksteps(K, cs) == 4)",
         "      for (int cs0 = 0; cs0 < w.ncs; ++cs0) {\n"
         "        const int cs = (cs0 + (int)blockIdx.x) % w.ncs;\n"
         "        if (ksteps(K, cs) == 4)")],
    # kernel 6: the rows' y of two rows a warp at a time in the LayerNorm
    # pass at two or three pieces a lane (K up to 768), in place of four
    # and two
    "task-merge-fwd-ln-rows-2": _fwd((TASK_RT, "RT = UT <= 3 ? 2 : 1,")),
    # kernel 6: one row at a time
    "task-merge-fwd-ln-rows-1": _fwd((TASK_RT, "RT = 1,")),
    # kernel 6: two rows at a time up to six pieces a lane (K up to 1536)
    "task-merge-fwd-ln-rows-2-wide": _fwd(
        (TASK_RT, "RT = UT <= 2 ? 4 : UT <= 6 ? 2 : 1,")),
    # kernel 6: the loads of up to four pieces of the rows issued at once,
    # in place of one piece's
    "task-merge-fwd-loads-all": _fwd(
        ("UC = 1;", "UC = UT <= 4 ? UT : UT / 2;")),
    # kernel 6: the items task by task (every row block of task 0, then of
    # task 1, ..), in place of the T tasks of a row block one after another
    # (a row block's shared rows then come from HBM T times at stage 0)
    "task-merge-fwd-task-major": _fwd(
        ("    const int tk = w.item(it) / a.splits % a.T;",
         "    const int tk = w.item(it) / a.splits / ((M + BM - 1) / BM);"),
        ("    const int rbt = item / a.splits, tk = TASK ? rbt % a.T : 0;\n"
         "    const int row0 = (TASK ? rbt / a.T : rbt) * BM + wr;",
         "    const int nrb = (M + BM - 1) / BM, rbt = item / a.splits;\n"
         "    const int tk = TASK ? rbt / nrb : 0;\n"
         "    const int row0 = (TASK ? rbt % nrb : rbt) * BM + wr;")),
    # kernel 6 (and 3): 64 rows a block at most, W's slots streamed twice
    # as often at the first two merges
    "task-merge-fwd-rows-64": [
        ("ops/ln_lora.py", "MERGE_FWD_ROWS = {128: 2, 64: 4, 32: 8, 16: 8}",
         "MERGE_FWD_ROWS = {64: 4, 32: 8, 16: 8}")],
    # kernel 3: one item a row block, however few the row blocks
    "merge-fwd-no-split": [
        ("ops/ln_lora.py", "for s in range(1, nch + 1) if nch % s == 0)[1]",
         "for s in (1,))[1]")],
    # kernel 2 at the qkv sites: at most 8 ring slots in place of 16 (12
    # fit at stage 2)
    "qkv-fwd-ring-8": [
        ("ops/ln_lora.py",
         "    stages = TAIL_FWD_MAX_STAGES // group * group\n",
         "    stages = (TAIL_FWD_MAX_STAGES if tail else 8) // group\n"
         "    stages *= group\n")],
    # kernel 2 at the qkv sites: 64-row blocks (two warps on the same 16
    # rows, one block an SM) at every width, in place of 128 up to C = 384
    # (the tail mode's too)
    "qkv-fwd-rows-64": [
        ("ops/ln_lora.py", "TAIL_FWD_WIDE = 384 ", "TAIL_FWD_WIDE = 0 "),
        ("ops/csrc/ln_lora_tail_fwd.cu", "constexpr int kWide = 384;",
         "constexpr int kWide = 0;")],
    # kernel 2 at the qkv sites: one block an SM at every width (a ring of
    # 16 slots at stages 0 and 1), in place of two at stages 0 and 1
    "qkv-fwd-one-block-an-sm": [
        ("ops/ln_lora.py", "    two = wn == 1 and fixed_bytes(2)",
         "    two = tail and wn == 1 and fixed_bytes(2)")],
    # kernel 2 at the qkv sites: the blocks in clusters of two on
    # neighbouring row blocks, each box of the ring started once for both
    # by TMA multicast (a group refilled when the last warp of the second
    # block to be done with it has counted itself on rank 0's pair count),
    # in place of single blocks that each take every slot from L2
    "qkv-fwd-multicast": [
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "  int stages, group;  // ring slots and slots a group\n"
         "  float s;\n",
         "  int stages, group;  // ring slots and slots a group\n"
         "  int cl;             // blocks of a cluster (1 or 2), on ne"
         "ighbouring rows\n"
         "  float s;\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "  q -= ncs;\n"
         "  const int item = (int)blockIdx.x + k * (int)gridDim.x;\n"
         "  const int per = a.wn * (ncs + 1), j = q / per;\n",
         "  q -= ncs;\n"
         "  const int item = ((int)blockIdx.x + k * (int)gridDim.x) / "
         "a.cl;\n"
         "  const int per = a.wn * (ncs + 1), j = q / per;\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "  if (i < a.wn * ncs)\n"
         "    return Box{kW, kS * (i / a.wn), kS * (chunk + i % a.wn)}"
         ";      // p\n"
         "  return Box{kB, 0, kS * (chunk + i - a.wn * ncs)};         "
         "       // u\n"
         "}\n"
         "\n"
         "// The ring of slots of a block: a.stages slots in groups of"
         " a.group, one\n",
         "  if (i < a.wn * ncs)\n"
         "    return Box{kW, kS * (i / a.wn), kS * (chunk + i % a.wn)}"
         ";      // p\n"
         "  return Box{kB, 0, kS * (chunk + i - a.wn * ncs)};         "
         "       // u\n"
         "}\n"
         "\n"
         "// Box (c0.., r0..) of a tensor map into the shared memory o"
         "f the blocks of\n"
         "// mask in the cluster, at dst's offset in each; its bytes c"
         "omplete on the\n"
         "// mbarrier at bar's offset in each.\n"
         "__device__ __forceinline__ void tma_box_mc(void* dst, const "
         "CUtensorMap* map,\n"
         "                                           uint64_t* bar, in"
         "t c0, int r0,\n"
         "                                           uint16_t mask) {\n"
         "  asm volatile(\n"
         "      \"cp.async.bulk.tensor.2d.shared::cluster.global.mbarri"
         "er::complete_tx\"\n"
         "      \"::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4]"
         ", %5;\\n\" ::\"r\"(\n"
         "          smem_u32(dst)),\n"
         "      \"l\"(reinterpret_cast<uint64_t>(map)), \"r\"(c0), \"r\"(r0)"
         ",\n"
         "      \"r\"(smem_u32(bar)), \"h\"(mask)\n"
         "      : \"memory\");\n"
         "}\n"
         "\n"
         "// Every thread of the cluster's blocks arrives, and waits f"
         "or the others.\n"
         "__device__ __forceinline__ void cluster_barrier() {\n"
         "  asm volatile(\n"
         "      \"barrier.cluster.arrive.release.aligned;\\n\"\n"
         "      \"barrier.cluster.wait.acquire.aligned;\\n\" ::: \"memory\""
         ");\n"
         "}\n"
         "\n"
         "// *p += v in block rank's shared memory (p: this block's co"
         "py); the old\n"
         "// value.\n"
         "__device__ __forceinline__ int cluster_add(int* p, int rank,"
         " int v) {\n"
         "  unsigned ra;\n"
         "  int old;\n"
         "  asm volatile(\"mapa.shared::cluster.u32 %0, %1, %2;\\n\"\n"
         "               : \"=r\"(ra)\n"
         "               : \"r\"(smem_u32(p)), \"r\"(rank));\n"
         "  asm volatile(\"atom.acq_rel.cluster.shared::cluster.add.u32"
         " %0, [%1], %2;\\n\"\n"
         "               : \"=r\"(old)\n"
         "               : \"r\"(ra), \"r\"(v)\n"
         "               : \"memory\");\n"
         "  return old;\n"
         "}\n"
         "\n"
         "// The ring of slots of a block: a.stages slots in groups of"
         " a.group, one\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "  int total, ncs, nbar;\n"
         "  int g = 0, qg = 0, slot = 0;   // group, slot in the group"
         ", ring slot\n",
         "  int* pair;       // stages / group (cl 2): the blocks' han"
         "d-backs, rank 0's\n"
         "  int total, ncs, nbar, cl, rank;\n"
         "  int g = 0, qg = 0, slot = 0;   // group, slot in the group"
         ", ring slot\n"
         "\n"
         "  // Lane 0 posts group gi's bytes on this block's mbarrier."
         "\n"
         "  __device__ __forceinline__ void arm(const Params& p, int g"
         "i) {\n"
         "    const int n = min(p.a.group, total - gi * p.a.group);\n"
         "    if (n > 0 && lane_id() == 0)\n"
         "      mbar_expect(bars + gi % nbar, n * kSlice * (int)sizeof"
         "(bf16));\n"
         "  }\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "    if (n <= 0) return;\n"
         "    const int k = lane_id();\n"
         "    uint64_t* bar = bars + gi % nbar;\n"
         "    if (k == 0) mbar_expect(bar, n * kSlice * (int)sizeof(bf"
         "16));\n"
         "    __syncwarp();\n"
         "    if (k < n) {\n"
         "      const Box b = box_of(a, first + k, ncs);\n"
         "      tma_box(buf + ((first + k) % a.stages) * kSlice, &p.ma"
         "ps[b.map], bar,\n"
         "              b.c0, b.r0);\n"
         "    }\n",
         "    const int k = lane_id();\n"
         "    if (k >= n) return;\n"
         "    const Box b = box_of(a, first + k, ncs);\n"
         "    bf16* dst = buf + ((first + k) % a.stages) * kSlice;\n"
         "    if (cl == 1)\n"
         "      tma_box(dst, &p.maps[b.map], bars + gi % nbar, b.c0, b"
         ".r0);\n"
         "    else\n"
         "      tma_box_mc(dst, &p.maps[b.map], bars + gi % nbar, b.c0"
         ", b.r0,\n"
         "                 (uint16_t)((1 << cl) - 1));\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "      }\n"
         "    if (threadIdx.x < 32)\n"
         "      for (int k = 0; k < nbar; ++k) issue(p, k);\n",
         "        if (cl > 1) pair[k] = 0;\n"
         "      }\n"
         "    if (cl > 1) cluster_barrier();\n"
         "    if (threadIdx.x < 32)\n"
         "      for (int k = 0; k < nbar; ++k) {\n"
         "        arm(p, k);\n"
         "        __syncwarp();\n"
         "        if (rank == 0) issue(p, k);\n"
         "      }\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "    if (__shfl_sync(0xffffffffu, last, 0)) {\n"
         "      asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"m"
         "emory\");\n"
         "      issue(p, gi + nbar);\n"
         "    }\n",
         "    if (!__shfl_sync(0xffffffffu, last, 0)) return;\n"
         "    arm(p, gi + nbar);\n"
         "    if (cl > 1) {\n"
         "      int both = 0;\n"
         "      if (lane_id() == 0)\n"
         "        both = cluster_add(pair + gi % nbar, 0, 1) == cl * ("
         "gi / nbar + 1) - 1;\n"
         "      if (!__shfl_sync(0xffffffffu, both, 0)) return;\n"
         "    }\n"
         "    asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"mem"
         "ory\");\n"
         "    __syncwarp();\n"
         "    issue(p, gi + nbar);\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "  const int nitems = (a.items - (int)blockIdx.x + (int)gridD"
         "im.x - 1) /\n"
         "                     (int)gridDim.x;\n",
         "  // the block's cluster (cl blocks on neighbouring row bloc"
         "ks), its rank\n"
         "  // there, and the clusters: the cluster's items are cid, +"
         " ncl, ..\n"
         "  const int cl = a.cl, rank = (int)blockIdx.x % cl;\n"
         "  const int cid = (int)blockIdx.x / cl, ncl = (int)gridDim.x"
         " / cl;\n"
         "  const int nitems = (a.items / cl - cid + ncl - 1) / ncl;\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "  // mbarriers and counts. The padded row strides keep ldmat"
         "rix, the\n"
         "  // statistics and the staging free of bank conflicts.\n",
         "  // mbarriers and counts (and, in a cluster, pair counts). "
         "The padded row\n"
         "  // strides keep ldmatrix, the statistics and the staging f"
         "ree of bank\n"
         "  // conflicts.\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "  Ring ring{reinterpret_cast<bf16*>(base), bars,\n"
         "            reinterpret_cast<int*>(bars + nbar),\n"
         "            nitems * item_slots(a, ncs), ncs, nbar};\n"
         "  // the plan's bytes (ops/ln_lora.py:_fwd_plan) must hold t"
         "his layout\n"
         "  if (reinterpret_cast<unsigned char*>(ring.held + nbar) - s"
         "mem >\n",
         "  int* held = reinterpret_cast<int*>(bars + nbar);\n"
         "  Ring ring{reinterpret_cast<bf16*>(base), bars, held, held "
         "+ nbar,\n"
         "            nitems * item_slots(a, ncs), ncs, nbar, cl, rank"
         "};\n"
         "  // the plan's bytes (ops/ln_lora.py:_fwd_plan) must hold t"
         "his layout\n"
         "  if (reinterpret_cast<unsigned char*>(held + (cl > 1 ? 2 : "
         "1) * nbar) -\n"
         "              smem >\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "    const int item = (int)blockIdx.x + k * (int)gridDim.x;\n"
         "    const int m0 = item / a.splits * BM, row0 = m0 + wr;\n",
         "    const int item = cid + k * ncl;\n"
         "    const int m0 = (item / a.splits * cl + rank) * BM, row0 "
         "= m0 + wr;\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "      }\n"
         "    }\n"
         "  }\n"
         "}\n"
         "\n"
         "// The two modes' kernels: their own symbols, so that a trac"
         "e tells them\n",
         "      }\n"
         "    }\n"
         "  }\n"
         "  // no block of a cluster leaves while the other may count "
         "on its pair\n"
         "  // counts\n"
         "  if (cl > 1) cluster_barrier();\n"
         "}\n"
         "\n"
         "// The two modes' kernels: their own symbols, so that a trac"
         "e tells them\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "  if (e != cudaSuccess) return e;\n"
         "  kern<<<blocks, kThreads, smem, st>>>(p);\n"
         "  return cudaGetLastError();\n",
         "  if (e != cudaSuccess) return e;\n"
         "  if (p.a.cl == 1) {\n"
         "    kern<<<blocks, kThreads, smem, st>>>(p);\n"
         "    return cudaGetLastError();\n"
         "  }\n"
         "  cudaLaunchConfig_t cfg = {};\n"
         "  cfg.gridDim = dim3(blocks);\n"
         "  cfg.blockDim = dim3(kThreads);\n"
         "  cfg.dynamicSmemBytes = smem;\n"
         "  cfg.stream = st;\n"
         "  cudaLaunchAttribute cluster[1];\n"
         "  cluster[0].id = cudaLaunchAttributeClusterDimension;\n"
         "  cluster[0].val.clusterDim.x = p.a.cl;\n"
         "  cluster[0].val.clusterDim.y = 1;\n"
         "  cluster[0].val.clusterDim.z = 1;\n"
         "  cfg.attrs = cluster;\n"
         "  cfg.numAttrs = 1;\n"
         "  e = cudaLaunchKernelEx(&cfg, kern, p);\n"
         "  if (e != cudaSuccess) return e;\n"
         "  return cudaGetLastError();\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "        int bm, int splits, int per_sm, int blocks, int stag"
         "es, int group,\n"
         "        int smem, float scale, unsigned thr, int use_drop, f"
         "loat inv_keep,\n"
         "        void* stream) {\n",
         "        int bm, int splits, int per_sm, int cl, int blocks, "
         "int stages,\n"
         "        int group, int smem, float scale, unsigned thr, int "
         "use_drop,\n"
         "        float inv_keep, void* stream) {\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "  const int items = (M + bm - 1) / bm * splits;\n",
         "  if (cl != 1 && cl != 2) return (int)cudaErrorInvalidValue;"
         "\n"
         "  // the row blocks, cl a cluster item (the last cluster's p"
         "ast M masked)\n"
         "  const int items = ((M + bm - 1) / bm + cl - 1) / cl * cl *"
         " splits;\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "      blocks < 1 || blocks > items || group < 1 ||\n",
         "      blocks < 1 || blocks > items || blocks % cl || group <"
         " 1 ||\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "  a.group = group;\n"
         "  a.s = scale;\n",
         "  a.group = group;\n"
         "  a.cl = cl;\n"
         "  a.s = scale;\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "             act, bm, splits, per_sm, blocks, stages, group,"
         " smem, scale,\n",
         "             act, bm, splits, per_sm, 1, blocks, stages, gro"
         "up, smem, scale,\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "// (ops/ln_lora.py:qkv_fwd_plan). use_drop: hash stream 0 at"
         " threshold thr.\n",
         "// (ops/ln_lora.py:qkv_fwd_plan) and cl, the blocks of a clu"
         "ster (1 or 2:\n"
         "// two neighbouring row blocks that take each weight box onc"
         "e from L2, by\n"
         "// multicast; blocks a multiple of cl). use_drop: hash strea"
         "m 0 at\n"
         "// threshold thr.\n"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "    int blocks, int stages, int group, int smem, float scale"
         ", unsigned thr,\n"
         "    int use_drop, float inv_keep, void* stream) {\n"
         "  return run(x, gamma, beta, wt, bias, at, bt, seed, y, null"
         "ptr, nullptr, M,\n"
         "             C, O, r, 0, bm, splits, per_sm, blocks, stages,"
         " group, smem,\n",
         "    int cl, int blocks, int stages, int group, int smem, flo"
         "at scale,\n"
         "    unsigned thr, int use_drop, float inv_keep, void* stream"
         ") {\n"
         "  return run(x, gamma, beta, wt, bias, at, bt, seed, y, null"
         "ptr, nullptr, M,\n"
         "             C, O, r, 0, bm, splits, per_sm, cl, blocks, sta"
         "ges, group, smem,\n"),
        ("ops/ln_lora.py",
         "        plan.blocks, plan.stages, plan.group, plan.smem, flo"
         "at(scale),\n",
         "        plan.cl, plan.blocks, plan.stages, plan.group, plan."
         "smem,\n"
         "        float(scale),\n"),
        ("ops/ln_lora.py",
         "TAIL_FWD_MAX_STAGES = 16     # slots in the TMA ring, at mos"
         "t\n"
         "TAIL_FWD_WIDE = 384     # C above which two warps share 16 r"
         "ows (kWide)\n",
         "TAIL_FWD_MAX_STAGES = 16     # slots in the TMA ring, at mos"
         "t\n"
         "QKV_FWD_CLUSTER = 2     # blocks of a cluster in the qkv mod"
         "e (multicast)\n"
         "TAIL_FWD_WIDE = 384     # C above which two warps share 16 r"
         "ows (kWide)\n"),
        ("ops/ln_lora.py",
         "    slice_bytes: int\n"
         "\n",
         "    slice_bytes: int\n"
         "    cl: int\n"
         "\n"),
        ("ops/ln_lora.py",
         "                           * nbuf * ROW_TILE * TAIL_FWD_TILE"
         ")\n"
         "\n"
         "    def ring_bytes(stages, group):   # the slots; a mbarrier"
         ", a count a group\n"
         "        return stages * slot + 12 * (stages // group)\n"
         "\n"
         "    two = wn == 1 and fixed_bytes(2) + ring_bytes(4, 2) <= S"
         "M_SMEM // 2 - 1024\n",
         "                           * nbuf * ROW_TILE * TAIL_FWD_TILE"
         ")\n"
         "\n"
         "    # blocks of a cluster: two in the qkv mode, one in the t"
         "ail mode\n"
         "    cl = 1 if tail else QKV_FWD_CLUSTER\n"
         "\n"
         "    def ring_bytes(stages, group):\n"
         "        # the slots; a mbarrier and a count a group (and a p"
         "air count in a\n"
         "        # cluster)\n"
         "        return stages * slot + (12 + 4 * (cl > 1)) * (stages"
         " // group)\n"
         "\n"
         "    two = wn == 1 and fixed_bytes(2) + ring_bytes(4, 2) <= S"
         "M_SMEM // 2 - 1024\n"),
        ("ops/ln_lora.py",
         "    rows = -(-M // bm)\n"
         "    splits = min((-(-rows * s // (per_sm * sms))\n"
         "                  * (nsc // s + TAIL_FWD_ITEM_COST), s)\n",
         "    # cluster items (cl row blocks, the last cluster's past "
         "M masked), and\n"
         "    # the clusters in flight\n"
         "    rows = -(-(-(-M // bm)) // cl)\n"
         "    units = per_sm * sms // cl\n"
         "    splits = min((-(-rows * s // units) * (nsc // s + TAIL_F"
         "WD_ITEM_COST), s)\n"),
        ("ops/ln_lora.py",
         "    return TailFwdPlan(bm, wn, splits, items, per_sm, stages"
         ", group, smem,\n"
         "                       min(items, per_sm * sms), items * sli"
         "ces * slot)\n",
         "    return TailFwdPlan(bm, wn, splits, items * cl, per_sm, s"
         "tages, group,\n"
         "                       smem, min(items, units) * cl, items *"
         " slices * slot,\n"
         "                       cl)\n"),
        ("ops/_build.py",
         "    # M, C, O, r, bm, splits, per_sm, blocks, stages, group,"
         " smem, scale,\n"
         "    # drop threshold, use_drop, inv_keep, stream\n"
         "    \"mtlora_ln_lora_qkv_fwd\": [_P] * 9 + [_I] * 11 + [_F, _U"
         ", _I, _F, _P],\n",
         "    # M, C, O, r, bm, splits, per_sm, cl, blocks, stages, gr"
         "oup, smem,\n"
         "    # scale, drop threshold, use_drop, inv_keep, stream\n"
         "    \"mtlora_ln_lora_qkv_fwd\": [_P] * 9 + [_I] * 12 + [_F, _U"
         ", _I, _F, _P],\n")],
    # kernel 2 at the qkv sites: ring groups of 2 slots in place of 4 (more
    # groups in flight, each refilled sooner)
    "qkv-fwd-group-2": [
        ("ops/ln_lora.py",
         "    group = (TAIL_FWD_GROUP\n             if fixed",
         "    group = (TAIL_FWD_GROUP\n             if tail and fixed")],
    # kernel 2 at the qkv sites: where the row blocks leave SMs idle (98 at
    # stage 3), two items a row block, so that every SM takes one
    "qkv-fwd-split-fill": [
        ("ops/ln_lora.py", "    items = rows * splits\n",
         "    if not tail and rows * splits < per_sm * sms and nsc % 2 == 0:\n"
         "        splits = 2\n    items = splits * rows\n")],
    # kernel 2-tail: 64-row blocks (two warps on the same 16 rows, two
    # chunks side by side, one block an SM) at every width, in place of
    # 128 up to C = 384
    "tail-fwd-rows-64": [
        ("ops/ln_lora.py", "TAIL_FWD_WIDE = 384 ", "TAIL_FWD_WIDE = 0 "),
        ("ops/csrc/ln_lora_tail_fwd.cu", "constexpr int kWide = 384;",
         "constexpr int kWide = 0;")],
    # kernel 2-tail: one block an SM at every width, with two staging
    # tiles a warp and the deeper ring that leaves, in place of two blocks
    # an SM at stages 0 and 1
    "tail-fwd-one-block-an-sm": [
        ("ops/ln_lora.py", "    two = wn == 1 and fixed_bytes(2)",
         "    two = False and fixed_bytes(2)")],
    # kernel 2-tail: at most 8 ring slots in place of 16 (where one block
    # an SM has room for more)
    "tail-fwd-ring-8": [("ops/ln_lora.py", "TAIL_FWD_MAX_STAGES = 16 ",
                         "TAIL_FWD_MAX_STAGES = 8 ")],
    # kernel 2-tail: one item a row block, however few the row blocks
    "tail-fwd-no-split": [
        ("ops/ln_lora.py", "for s in range(1, nsc + 1) if nsc % s == 0)[1]",
         "for s in (1,))[1]")],
    # kernel 2-tail: the GELU by tanhf (lnk::act_fwd), in place of z
    # sigma(2u) by ex2.approx and a fast divide
    "tail-fwd-tanhf": [
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "  return __fdividef(z, 1.f + e);",
         "  (void)e;\n  return act_fwd<kGelu>(z);")],
    # kernel 2-tail: the staged rows written 4 bytes a lane (a warp a
    # 128-byte row segment at a time), in place of 16
    "tail-fwd-store-4b": [
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "#pragma unroll\n"
         "  for (int k = 0; k < kRows / 4; ++k, o += step)\n"
         "    if (whole || (row0 + i0 + 4 * k < M && n0 + c < O))\n"
         "      *reinterpret_cast<uint4*>(o) =\n"
         "          *reinterpret_cast<const uint4*>(sb + (i0 + 4 * k) * kLdS + c);\n",
         "  (void)o;\n"
         "  (void)step;\n"
         "#pragma unroll\n"
         "  for (int i = 0; i < kRows; ++i)\n"
         "    if (whole || (row0 + i < M && n0 + 2 * lane < O))\n"
         "      *reinterpret_cast<uint32_t*>(out + (size_t)(row0 + i) * O +\n"
         "                                   n0 + 2 * lane) =\n"
         "          *reinterpret_cast<const uint32_t*>(sb + i * kLdS + 2 * lane);\n")],
    # kernel 7: its first product by mma.sync on ldmatrix fragments of the
    # same slots (a warp's 16 rows, every warp reading every B fragment)
    "head-fwd-mma-sync": [
        ("ops/csrc/head_mlp_fwd.cu", HEAD_FWD_WGMMA, HEAD_FWD_MMA_SYNC)],
    # kernel 7: the last 16 columns of C in a 64 x 64 box (128-byte
    # swizzle, zero past 272) like the other slots, in place of a 16 x 64
    # box (32-byte swizzle): 6 KB more a stage, three stages at every n
    "head-fwd-wide-tail": [
        ("ops/csrc/head_mlp_fwd.cu",
         "wgmma_64x64(h, af[kKs - 1], sw32_desc(st + 2 * kSlices * kSlot), 1);",
         "wgmma_64x64(h, af[kKs - 1], sw128_desc(st + 2 * kSlices * kSlot), 1);"),
        ("ops/csrc/head_mlp_fwd.cu",
         "tma_box(st + 2 * kSlices * kSlot, &p.t, full + s, kS * kSlices,",
         "tma_box(st + 2 * kSlices * kSlot, &p.w, full + s, kS * kSlices,"),
        ("ops/csrc/head_mlp_fwd.cu",
         "constexpr int kWpOff = 2 * kSlices * kSlot + 2 * kTail * kS;",
         "constexpr int kWpOff = 2 * (kSlices + 1) * kSlot;"),
        ("ops/head.py",
         "return (2 * (FWD_SLICES * FWD_CHUNK + FWD_TAIL) * FWD_CHUNK",
         "return (2 * (FWD_SLICES + 1) * FWD_CHUNK * FWD_CHUNK")],
    # kernel 7: a ring of at most 3 stages (4 fit up to n = 32)
    "head-fwd-3-stages": [
        ("ops/head.py", "for s in range(2, FWD_MAX_STAGES + 1)",
         "for s in range(2, 3 + 1)")],
    # kernel 7: two chunks in flight a warpgroup, chunk c + 1's products
    # on the tensor cores under chunk c's epilogue (two sets of 32
    # accumulators)
    "head-fwd-two-chunks": [
        ("ops/csrc/head_mlp_fwd.cu", HEAD_FWD_ONE_CHUNK,
         HEAD_FWD_TWO_CHUNKS)],
    # kernel 7: the warpgroups take turns to issue a chunk's products
    # (named barriers 1 and 2), so that one's epilogue runs under the
    # other's products
    "head-fwd-ping-pong": [
        ("ops/csrc/head_mlp_fwd.cu", HEAD_FWD_ONE_CHUNK,
         HEAD_FWD_PING_PONG),
        ("ops/csrc/head_mlp_fwd.cu",
         "  Stages ring{ring_buf, full, empty, sb, a.stages};\n"
         "#pragma unroll 1\n",
         "  Stages ring{ring_buf, full, empty, sb, a.stages};\n"
         "  int turns = ntiles * nch;   // chunks left to issue\n"
         "  if (wg == 1)   // warpgroup 0 issues first\n"
         "    asm volatile(\"bar.arrive 1, 256;\\n\" ::: \"memory\");\n"
         "#pragma unroll 1\n")],
}

# name -> edits that take a part of kernel 2's qkv mode (run with
# --time-qkv), of kernel 3 (--time-merge) or of kernel 6 (--time-task-merge)
# out, its output then wrong by design: those modes time and never check
PARTS = {
    # kernel 5: the GELU taken out (h = bf16(z))
    "adapter-fwd-without-gelu": [
        ("ops/csrc/adapter_mlp_fwd.cu",
         "h[e] = act_fwd<kGelu>(fmaf(a.s[t], u[e], pv[j][e]));",
         "h[e] = fmaf(a.s[t], u[e], pv[j][e]);")],
    # kernel 5: tanhf taken out of the GELU (tanh(x) = x), its two MUFU
    # operations with it
    "adapter-fwd-without-tanh": [
        ("ops/csrc/adapter_mlp_fwd.cu",
         "            h[e] = act_fwd<kGelu>(fmaf(a.s[t], u[e], pv[j][e]));\n",
         "          {\n"
         "            const float z = fmaf(a.s[t], u[e], pv[j][e]);\n"
         "            h[e] = 0.5f * z * (1.f + z * (lnk::kGeluC + "
         "lnk::kGeluCD * (z * z)));\n"
         "          }\n")],
    # kernel 3: the products (the slots still arrive and are handed back)
    "merge-fwd-without-products": [
        ("ops/csrc/merge_ln_fwd.cu",
         "ring.next<WN>(p, w);\n            slot_mma<MT, NT, KS>",
         "ring.next<WN>(p, w);\n            if (a.M < 0) slot_mma<MT, NT, KS>")],
    # kernel 3: the rows of x (no copies; the tile holds what it held)
    "merge-fwd-without-x": [
        ("ops/csrc/merge_ln_fwd.cu",
         "        if (pc < P)\n          cp_async16(",
         "        if (pc < P && a.M < 0)\n          cp_async16(")],
    # kernel 3: the statistics and bf16(ln) pass
    "merge-fwd-without-ln": [
        ("ops/csrc/merge_ln_fwd.cu", MERGE_LN_LOOP,
         MERGE_LN_LOOP.replace("r < RW;", "r < RW && a.M < 0;"))],
    # kernel 3: y's stores
    "merge-fwd-without-stores": [
        ("ops/csrc/merge_ln_fwd.cu",
         "              if (row >= M) continue;",
         "              if (row >= M || a.M > 0) continue;")],
    # kernel 3: the ring alone (no x, LayerNorm, products or stores)
    "merge-fwd-ring-only": [
        ("ops/csrc/merge_ln_fwd.cu",
         "        if (pc < P)\n          cp_async16(",
         "        if (pc < P && a.M < 0)\n          cp_async16("),
        ("ops/csrc/merge_ln_fwd.cu", MERGE_LN_LOOP,
         MERGE_LN_LOOP.replace("r < RW;", "r < RW && a.M < 0;")),
        ("ops/csrc/merge_ln_fwd.cu",
         "ring.next<WN>(p, w);\n            slot_mma<MT, NT, KS>",
         "ring.next<WN>(p, w);\n            if (a.M < 0) slot_mma<MT, NT, KS>"),
        ("ops/csrc/merge_ln_fwd.cu",
         "              if (row >= M) continue;",
         "              if (row >= M || a.M > 0) continue;")],
    # kernel 3: the products alone, on slots never filled or waited for (no
    # x, LayerNorm, ring or stores)
    "merge-fwd-products-only": [
        ("ops/csrc/merge_ln_fwd.cu",
         "        if (pc < P)\n          cp_async16(",
         "        if (pc < P && a.M < 0)\n          cp_async16("),
        ("ops/csrc/merge_ln_fwd.cu", MERGE_LN_LOOP,
         MERGE_LN_LOOP.replace("r < RW;", "r < RW && a.M < 0;")),
        ("ops/csrc/merge_ln_fwd.cu",
         "              if (row >= M) continue;",
         "              if (row >= M || a.M > 0) continue;"),
        ("ops/csrc/merge_ln_fwd.cu",
         "    if (lane_id() != 0) return;\n    int s = 0, ph = 0;",
         "    if (lane_id() != 0 || a.M > 0) return;\n    int s = 0, ph = 0;"),
        ("ops/csrc/merge_ln_fwd.cu",
         "next(const Params&, const Walk&) {\n    mbar_wait(full + slot, phase);",
         "next(const Params& p, const Walk&) {\n"
         "    if (p.a.M < 0) mbar_wait(full + slot, phase);"),
        ("ops/csrc/merge_ln_fwd.cu",
         "    if (lane_id() == 0) mbar_arrive(empty + slot);",
         "    if (lane_id() == 0 && p.a.M < 0) mbar_arrive(empty + slot);")],
    # kernel 3: the ring and the products alone (no x, no LayerNorm, no
    # stores)
    "merge-fwd-ring-and-products": [
        ("ops/csrc/merge_ln_fwd.cu",
         "        if (pc < P)\n          cp_async16(",
         "        if (pc < P && a.M < 0)\n          cp_async16("),
        ("ops/csrc/merge_ln_fwd.cu", MERGE_LN_LOOP,
         MERGE_LN_LOOP.replace("r < RW;", "r < RW && a.M < 0;")),
        ("ops/csrc/merge_ln_fwd.cu",
         "              if (row >= M) continue;",
         "              if (row >= M || a.M > 0) continue;")],
    # kernel 6: the products (the slots still arrive and are handed back)
    "task-merge-fwd-without-products": _fwd(PRODUCTS),
    # kernel 6: the loads of the rows' shared and rank rows (y formed from
    # whatever the registers hold, its statistics and bf16(ln) still taken)
    "task-merge-fwd-without-rows": _fwd(
        (TASK_ROWS, "          if (a.M > 0) continue;\n"
                    "          const int tok = dt[u0 + j] + tok0[h];")),
    # kernel 6: the whole LayerNorm pass (rows, statistics, bf16(ln))
    "task-merge-fwd-without-ln": _fwd(TASK_LN_OFF),
    # kernel 6: y's stores
    "task-merge-fwd-without-stores": _fwd(STORES),
    # kernel 6: the ring alone (no LayerNorm pass, products or stores)
    "task-merge-fwd-ring-only": _fwd(TASK_LN_OFF, PRODUCTS, STORES),
    # the chunk products (W's and B's MMAs and their B fragments)
    "qkv-fwd-without-products": [
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "          if (i == ni) mma_slot<8>(pc, af, sl, 0, ks);",
         "          if (i == ni && a.M < 0) mma_slot<8>(pc, af, sl, 0, ks);")],
    # y's stores
    "qkv-fwd-without-stores": [
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "      tile_out<NBUF>(a.y, tb, row0, n0, M, O);",
         "      if (a.M < 0) tile_out<NBUF>(a.y, tb, row0, n0, M, O);")],
    # the B fragments of every slot product (ldmatrix): register values
    "qkv-fwd-without-b-fragments": [
        ("ops/csrc/tma.cuh",
         "        ldsm_x4(b, sl + swz(n0 + 16 * p + (lane & 7) + "
         "((lane >> 4) << 3),\n"
         "                            16 * k + ((lane >> 3) & 1) * 8));",
         "        b[0] = lane + k; b[1] = lane ^ p; b[2] = lane * 3; "
         "b[3] = k + p;\n        (void)sl; (void)n0;")],
    # the chunk products and the epilogue (staging and stores): the ring,
    # the rows' prologue and m alone
    "qkv-fwd-without-products-epilogue": [
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "          if (i == ni) mma_slot<8>(pc, af, sl, 0, ks);",
         "          if (i == ni && a.M < 0) mma_slot<8>(pc, af, sl, 0, ks);"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "      stage_tile(tb, pc);\n"
         "      tile_out<NBUF>(a.y, tb, row0, n0, M, O);",
         "      if (a.M < 0) {\n        stage_tile(tb, pc);\n"
         "        tile_out<NBUF>(a.y, tb, row0, n0, M, O);\n      }")],
    # each block walks its item's chunks from its own offset, so that no
    # two SMs read the same slot at once
    "qkv-fwd-rotated-chunks": [
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "  const int chunk = (item % a.splits * a.per_split + j) * a.wn;",
         "  const int chunk = (item % a.splits * a.per_split +\n"
         "                     (j + (int)blockIdx.x) % a.per_split) * a.wn;"),
        ("ops/csrc/ln_lora_tail_fwd.cu",
         "      const int n0 = kS * ((j0 + j) * WN + ni);",
         "      const int n0 =\n"
         "          kS * ((j0 + (j + (int)blockIdx.x) % a.per_split) * WN "
         "+ ni);")],
}

STAGE_WEIGHTS = (1, 1, 5, 1)   # no-task blocks per stage (depths - 1)
RAGGED_ROWS = 392
NAMES = ("dx", "dgamma", "dbeta", "dA1", "dB1", "dA2", "dB2")
FWD_NAMES = ("y",)


def apply_edits(pkg: Path, edits):
    for rel, old, new in edits:
        path = pkg / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant edit of {rel} does not match once: "
                             f"{old!r}")
        path.write_text(text.replace(old, new))


def variant_tree(name: str) -> Path:
    """A copy of this checkout's package and chip_smoke.py with the
    variant's edits, at build/variants/<name>/ (its kernels build in its
    own build/)."""
    root = VARIANT_DIR / name
    pkg = root / "mtlora_tpu_torch"
    if pkg.exists():
        shutil.rmtree(pkg)
    shutil.copytree(ROOT / "mtlora_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", root / "chip_smoke.py")
    apply_edits(pkg, VARIANTS[name] if name in VARIANTS else PARTS[name])
    return root


# ---------------------------------------------------------------------------
# The process of one tree
# ---------------------------------------------------------------------------

def _operands(gen, s: int, M=None):
    """Kernel 4's operands at stage s of the batch-32 step (or M rows):
    rank 64, scales 4, dropout 0.05, as chip_smoke.py draws them."""
    import torch

    C = 96 * 2 ** s
    M = 32 * (112 // 2 ** s) ** 2 if M is None else M
    H4, r = 4 * C, 64

    def uniform(shape, bound):
        return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1)
                * bound).to(torch.bfloat16)

    x = torch.randn(M, C, generator=gen, device="cuda").to(torch.bfloat16)
    gamma = (0.9 + 0.2 * torch.rand(C, generator=gen, device="cuda"))
    beta = 0.02 * torch.randn(C, generator=gen, device="cuda")
    ws = (uniform((H4, C), C ** -0.5), uniform((H4,), 0.02),
          uniform((r, C), C ** -0.5), uniform((H4, r), r ** -0.5),
          uniform((C, H4), H4 ** -0.5), uniform((C,), 0.02),
          uniform((r, H4), H4 ** -0.5), uniform((C, r), r ** -0.5))
    seed = torch.randint(0, 2 ** 31 - 1, (2,), generator=gen, device="cuda",
                         dtype=torch.int32)
    gy = torch.randn(M, C, generator=gen, device="cuda").to(torch.bfloat16)
    args = (x, gamma.to(torch.bfloat16), beta.to(torch.bfloat16), *ws, seed,
            4.0, 4.0, 0.05)
    return args, gy


def _errors(got, want, names=NAMES) -> list:
    """The outputs that miss their bound, with their largest errors."""
    bad = []
    for i, (name, a, b) in enumerate(zip(names, got, want)):
        d = (a.float() - b.float())
        e, top = d.abs().max().item(), b.float().abs().max().item()
        if i == 0:
            ok = e <= 2.0 ** -6 * top
        else:
            ok = ((d.norm() / b.float().norm()).item() <= 2.0 ** -7
                  and e <= 2.0 ** -3 * top)
        if not ok:
            bad.append(f"{name}: error {e} (largest {top})")
    return bad


def _ptxas(log: str) -> dict:
    """Registers and spill bytes of every instance of kernel 4, of the
    LN-family forward kernels (2, 2-tail, 3: ``patch_merge_fwd_rows``, and
    its task mode, kernel 6: ``task_merge_fwd_rows``) and backward row
    kernels (4b, 2b in both modes, 3b: ``patch_merge_bwd_rows``, and
    ``merge_ln_bwd_rows`` in checkouts before it; 6b) and of the attention
    forward (kernels 1 and 1c: ``window_attn_fwd_rows``) and backward
    (kernels 1b and 1c's), of kernel 5 (``adapter_mid_fwd_fused``) and
    5b's fused pass (``adapter_mid_bwd_fused``) and of kernel 7
    (``head_fwd_tiles``)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S*(?:ln_mlp_fwd_kernel|"
                      r"ln_mlp_bwd_rows|window_attn_bwd_kernel|"
                      r"window_attn_fwd_rows|ln_lora_\w*"
                      r"bwd_rows|merge_\w*bwd_rows|ln_lora_\w*fwd_kernel|"
                      r"patch_merge_fwd_rows|task_merge_fwd_rows|"
                      r"adapter_mid_\w+_fused|head_fwd_tiles)"
                      r"\S*)", line)
        if m:
            name = m[1]
            continue
        if name and "spill stores" in line:
            out[name] = {"spill_stores": int(re.search(
                r"(\d+) bytes spill stores", line)[1])}
        elif name and "Used" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers",
                                                   line)[1])
            name = None
    return out


def kernel_lines(text: str) -> dict:
    """label -> kernel ms of each ``<label>: ... kernel <ms> ms`` line."""
    return {m[1]: float(m[2]) for m in re.finditer(
        r"^(.*?): .*?\bkernel ([0-9.]+) ms", text, re.M)}


def build():
    """Builds the tree's kernels; prints the row kernel's ptxas report."""
    from mtlora_tpu_torch.ops import _build

    _build.library()
    print(json.dumps(_ptxas(_build.ptxas_log)), flush=True)


QKV_STAGES = ((401408, 96), (100352, 192), (25088, 384), (6272, 768))
# kernel 3's merges of the batch-32 step: (L, res, C) of x [L, res^2, C],
# the shared stream (L = 32) then the LN route's four task streams
MERGE_SHAPES = tuple((L, 112 // 2 ** s, 96 * 2 ** s) for L in (32, 128)
                     for s in range(3))


def time_qkv(rec: dict):
    """Kernel 2 at the four qkv sites of the batch-32 step (rank 64, scale
    4), ms per stage with dropout 0.05 and 0 (no checks: a tree of PARTS
    computes a wrong y), and the tail mode without GELU and d at the same
    shapes (it also writes p), with its plan's weight-slot GB."""
    import torch
    from mtlora_tpu_torch.ops import ln_lora
    from mtlora_tpu_torch.tools import median_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    for key in ("qkv_ms", "qkv_ms_no_dropout", "tail_mode_ms", "slot_gb"):
        rec[key] = []
    for M, C in QKV_STAGES:
        O, r = 3 * C, 64

        def uniform(shape, bound):
            return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1)
                    * bound).to(torch.bfloat16)

        x = torch.randn(M, C, generator=gen, device="cuda").to(torch.bfloat16)
        gamma = (0.9 + 0.2 * torch.rand(C, generator=gen, device="cuda"))
        beta = 0.02 * torch.randn(C, generator=gen, device="cuda")
        ops = (x, gamma.to(torch.bfloat16), beta.to(torch.bfloat16),
               uniform((O, C), C ** -0.5), uniform((O,), 0.02),
               uniform((r, C), C ** -0.5), uniform((O, r), r ** -0.5),
               torch.randint(0, 2 ** 31 - 1, (2,), generator=gen,
                             device="cuda", dtype=torch.int32), 4.0)
        rec["qkv_ms"].append(median_ms(
            lambda: ln_lora.ln_lora_fwd(*ops, 0.05)))
        rec["qkv_ms_no_dropout"].append(median_ms(
            lambda: ln_lora.ln_lora_fwd(*ops, 0.0)))
        rec["tail_mode_ms"].append(median_ms(
            lambda: ln_lora.ln_lora_tail_fwd_kernel(*ops, 0.05, False,
                                                    False)))
        rec["slot_gb"].append(ln_lora.tail_fwd_plan(
            M, C, O, r, ln_lora._sms(x.device)).slice_bytes / 1e9)
        del x, ops


def time_merge(rec: dict):
    """Kernel 3 at ``MERGE_SHAPES``, ms a merge (the tree's
    ``merge_ln_fwd``; no checks: a tree of PARTS computes a wrong y)."""
    import torch
    from mtlora_tpu_torch.ops import ln_lora
    from mtlora_tpu_torch.tools import median_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    rec["merge_ms"] = []
    for L, res, C in MERGE_SHAPES:
        K, O = 4 * C, 2 * C
        x = torch.randn(L, res * res, C, generator=gen,
                        device="cuda").to(torch.bfloat16)
        gamma = (0.9 + 0.2 * torch.rand(K, generator=gen, device="cuda"))
        beta = 0.02 * torch.randn(K, generator=gen, device="cuda")
        wt = ((torch.rand(O, K, generator=gen, device="cuda") * 2 - 1)
              * K ** -0.5).to(torch.bfloat16)
        ops = (x, gamma.to(torch.bfloat16), beta.to(torch.bfloat16), wt, res,
               res)
        rec["merge_ms"].append(median_ms(lambda: ln_lora.merge_ln_fwd(*ops)))
        del x, ops


# kernel 6's merges of the batch-32 step, then chip_smoke.py's coverage
# shapes (path B's 14 -> 7, Swin-B's K = 2048, the batch-2 step's ragged
# 392 rows, six tasks): (T, B, res, C) of the task streams [T, B, res^2, C]
TASK_MERGE_SHAPES = (tuple((4, 32, 112 // 2 ** s, 96 * 2 ** s)
                           for s in range(3))
                     + ((4, 32, 14, 384), (4, 32, 28, 512), (4, 2, 28, 384),
                        (6, 32, 28, 384)))


def device_ms(fn, key: str, calls: int = 5) -> float:
    """Device ms a call of ``fn`` in the kernels whose name holds ``key``,
    from a ``torch.profiler`` trace of ``calls`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if str(e.device_type).endswith("CUDA") and key in e.name
               ) / 1e3 / calls


def host_ms(fn, calls: int = 20) -> float:
    """Host ms a call of ``fn``: the time to enqueue ``calls`` calls on an
    idle card (the card's work queues, the host does not wait on it)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def time_task_merge(rec: dict):
    """Kernel 6 at ``TASK_MERGE_SHAPES``: ms a merge of the tree's
    ``task_merge_fwd`` (CUDA events, its operand preparation and host time
    included), the kernel's own device ms and the wrapper's host ms
    (drop-path coefficients on, scales 4; no checks: a tree of PARTS
    computes a wrong y)."""
    import torch
    from mtlora_tpu_torch.ops import task_merge
    from mtlora_tpu_torch.tools import median_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    for key in ("task_merge_ms", "task_merge_device_ms",
                "task_merge_host_ms"):
        rec[key] = []

    def uniform(shape, bound):
        return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1)
                * bound).to(torch.bfloat16)

    for T, B, res, C in TASK_MERGE_SHAPES:
        L, K, O = res * res, 4 * C, 2 * C
        base, pre, p2 = (torch.randn(B, L, C, generator=gen, device="cuda")
                         .to(torch.bfloat16) for _ in range(3))
        mid1T, mid2T = ((0.5 * torch.randn(T, 4, B * L, generator=gen,
                                           device="cuda")).to(torch.bfloat16)
                        for _ in range(2))
        b1, b2 = uniform((T, 4, C), 0.1), uniform((T, 4, C), 0.1)
        c1, c2 = ((torch.rand(T, B, generator=gen, device="cuda") < 0.9)
                  .float() / 0.9 for _ in range(2))
        gamma = (0.9 + 0.2 * torch.rand(K, generator=gen, device="cuda"))
        beta = 0.02 * torch.randn(K, generator=gen, device="cuda")
        args = (base, pre, p2, mid1T, b1, mid2T, b2, c1, c2, (4.0,) * T,
                (4.0,) * T, gamma.to(torch.bfloat16), beta.to(torch.bfloat16),
                uniform((O, K), K ** -0.5), res, res)
        rec["task_merge_ms"].append(median_ms(
            lambda: task_merge.task_merge_fwd(*args)))
        rec["task_merge_device_ms"].append(device_ms(
            lambda: task_merge.task_merge_fwd(*args), "task_merge_fwd"))
        rec["task_merge_host_ms"].append(host_ms(
            lambda: task_merge.task_merge_fwd(*args)))
        del base, pre, p2, mid1T, mid2T, args


# kernel 5b's four stage shapes of the batch-32 step: (M, H4), T = 4
ADAPTER_STAGES = tuple((32 * (112 // 2 ** s) ** 2, 384 * 2 ** s)
                       for s in range(4))


def time_adapter_bwd(rec: dict):
    """Kernel 5b at ``ADAPTER_STAGES``: ms a call of the tree's
    ``adapter_mid_bwd`` (CUDA events around 20 calls back to back), the
    device ms of all its kernels (a profiler trace) and the wrapper's host
    ms a call on an idle card (unchecked: ``--checks check_adapter_mid``
    checks it)."""
    import torch
    from mtlora_tpu_torch.ops import adapter_mlp
    from mtlora_tpu_torch.tools import median_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    for key in ("adapter_bwd_ms", "adapter_bwd_device_ms",
                "adapter_bwd_host_ms"):
        rec[key] = []
    for M, H4 in ADAPTER_STAGES:
        mid1T, p1, g = (torch.randn(*shape, generator=gen, device="cuda")
                        .to(torch.bfloat16)
                        for shape in ((4, 4, M), (M, H4), (4, 4, M)))
        b1, a2T = ((0.1 * torch.randn(4, 4, H4, generator=gen,
                                      device="cuda")).to(torch.bfloat16)
                   for _ in range(2))
        args = (mid1T, p1, b1, a2T, (4.0,) * 4, g)
        rec["adapter_bwd_ms"].append(median_ms(
            lambda: adapter_mlp.adapter_mid_bwd(*args)))
        rec["adapter_bwd_device_ms"].append(device_ms(
            lambda: adapter_mlp.adapter_mid_bwd(*args), ""))
        rec["adapter_bwd_host_ms"].append(host_ms(
            lambda: adapter_mlp.adapter_mid_bwd(*args)))
        del mid1T, p1, g, args


def time_adapter_fwd(rec: dict):
    """Kernel 5 at ``ADAPTER_STAGES``: ms a call of the tree's
    ``adapter_mid_fwd`` (CUDA events around 20 calls back to back) and the
    device ms of its kernels (a profiler trace), unchecked, so that the
    trees of ``PARTS`` with a part of kernel 5 taken out run beside it;
    and the SM clock (MHz, ``nvidia-smi``, the median of its samples)
    under a second of stage-0 calls."""
    import statistics
    import torch
    from mtlora_tpu_torch.ops import adapter_mlp
    from mtlora_tpu_torch.tools import median_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    rec["adapter_fwd_ms"], rec["adapter_fwd_device_ms"] = [], []
    for M, H4 in ADAPTER_STAGES:
        mid1T, p1 = (torch.randn(*shape, generator=gen, device="cuda")
                     .to(torch.bfloat16) for shape in ((4, 4, M), (M, H4)))
        b1, a2T = ((0.1 * torch.randn(4, 4, H4, generator=gen,
                                      device="cuda")).to(torch.bfloat16)
                   for _ in range(2))
        args = (mid1T, p1, b1, a2T, (4.0,) * 4)
        rec["adapter_fwd_ms"].append(median_ms(
            lambda: adapter_mlp.adapter_mid_fwd(*args)))
        rec["adapter_fwd_device_ms"].append(device_ms(
            lambda: adapter_mlp.adapter_mid_fwd(*args), ""))
        if M == ADAPTER_STAGES[0][0]:
            smi = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm",
                 "--format=csv,noheader,nounits", "-lms", "50"],
                stdout=subprocess.PIPE, text=True)
            median_ms(lambda: adapter_mlp.adapter_mid_fwd(*args), reps=200,
                      rounds=5)
            smi.terminate()
            mhz = [float(v) for v in smi.communicate()[0].split()]
            rec["adapter_fwd_sm_mhz"] = statistics.median(mhz)
        del mid1T, p1, args


TIMERS = {"qkv": time_qkv, "merge": time_merge,
          "task_merge": time_task_merge, "adapter_bwd": time_adapter_bwd,
          "adapter_fwd": time_adapter_fwd}


def worker(tree: str, checks: str, timer: str = ""):
    import torch
    from mtlora_tpu_torch.ops import _build, ln_mlp
    from mtlora_tpu_torch.tools import card_line, median_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    rec = {"tree": tree, "card": card_line()}
    if timer:
        TIMERS[timer](rec)
        print(json.dumps(rec), flush=True)
        return
    if checks:
        import chip_smoke
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rec["checks"] = {
                fn: {k: t.json()
                     for k, t in getattr(chip_smoke, fn)(gen).items()}
                for fn in checks.split(",")}
        sys.stdout.write(out.getvalue())
        rec["lines"] = kernel_lines(out.getvalue())
        print(json.dumps(rec), flush=True)
        return
    gen = torch.Generator(device="cuda").manual_seed(0)
    ms, fwd_ms, bad = [], [], {}
    for s in (0, 1, 2, 3, "ragged"):
        args, gy = (_operands(gen, 3, RAGGED_ROWS) if s == "ragged"
                    else _operands(gen, s))
        errors = _errors([ln_mlp.ln_mlp_fwd(*args)],
                         [ln_mlp.ln_mlp_plain(*args)], FWD_NAMES)
        errors += _errors(ln_mlp.ln_mlp_bwd(*args, gy),
                          ln_mlp.ln_mlp_bwd_plain(*args, gy))
        if errors:
            bad[s] = errors
        if s != "ragged":
            # a wrong kernel is not timed
            fwd_ms.append(None if errors else median_ms(
                lambda: ln_mlp.ln_mlp_fwd(*args), reps=10))
            ms.append(None if errors else median_ms(
                lambda: ln_mlp.ln_mlp_bwd(*args, gy), reps=10))
        del args, gy
    rec["failed"] = bad
    rec["fwd_stage_ms"] = fwd_ms
    rec["fwd_pass_ms"] = (None if bad else
                          sum(w * t for w, t in zip(STAGE_WEIGHTS, fwd_ms)))
    rec["stage_ms"] = ms
    rec["step_ms"] = (None if bad else
                      sum(w * t for w, t in zip(STAGE_WEIGHTS, ms)))
    print(json.dumps(rec), flush=True)


# ---------------------------------------------------------------------------
# The parent process: every tree in turn
# ---------------------------------------------------------------------------

def _run(name: str, root: Path, checks: str, timer: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--worker", name,
         *(["--checks", checks] if checks else []),
         *([f"--time-{timer.replace('_', '-')}"] if timer else [])],
        cwd=root, env=env, capture_output=True, text=True)
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr)
        raise SystemExit(f"{name}: exit code {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="",
                    help=f"comma-separated, of {sorted(VARIANTS)} (and, "
                         f"with --time-qkv, --time-merge, "
                         f"--time-task-merge or --time-adapter-fwd, of "
                         f"{sorted(PARTS)})")
    ap.add_argument("--against", action="append", default=[],
                    help="root of another checkout (repeatable; named by "
                         "its directory)")
    ap.add_argument("--checks", default="",
                    help="check_* functions of each tree's chip_smoke.py")
    ap.add_argument("--time-qkv", action="store_true",
                    help="time kernel 2 at the qkv sites in each tree, "
                         "unchecked (the trees of PARTS)")
    ap.add_argument("--time-merge", action="store_true",
                    help="time kernel 3 at the merges in each tree, "
                         "unchecked (the trees of PARTS)")
    ap.add_argument("--time-task-merge", action="store_true",
                    help="time kernel 6 at the merges in each tree, "
                         "unchecked (the trees of PARTS)")
    ap.add_argument("--time-adapter-bwd", action="store_true",
                    help="time kernel 5b at its four stage shapes in each "
                         "tree: events, device and host ms, unchecked")
    ap.add_argument("--time-adapter-fwd", action="store_true",
                    help="time kernel 5 at its four stage shapes in each "
                         "tree, unchecked (the trees of PARTS), and the SM "
                         "clock")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--build", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.build:
        build()
        return
    timer = next((k for k in TIMERS if getattr(a, f"time_{k}")), "")
    if a.worker:
        worker(a.worker, a.checks, timer)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ln_mlp_bwd_variants: no CUDA device")
    trees = [("this", ROOT)]
    trees += [(v, variant_tree(v)) for v in a.variants.split(",") if v]
    trees += [(Path(d).name, Path(d).resolve()) for d in a.against]
    # build every tree's kernels at once (each build runs its nvcc
    # processes in parallel too)
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--build"], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root)), stdout=subprocess.PIPE,
        text=True) for _, root in trees]
    ptxas = {}
    for (name, _), proc in zip(trees, procs):
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: the kernels did not build")
        ptxas[name] = json.loads(out.strip().splitlines()[-1])
        print(json.dumps({"tree": name, "ptxas": ptxas[name]}), flush=True)
    order = []
    for i in range(a.passes):
        order += trees if i % 2 == 0 else trees[::-1]
    results = {}
    for name, root in order:
        results.setdefault(name, []).append(_run(name, root, a.checks,
                                                 timer))
    summary = {}
    for name, recs in results.items():
        if a.time_qkv:
            summary[name] = {k: [r[k] for r in recs] for k in (
                "qkv_ms", "qkv_ms_no_dropout", "tail_mode_ms")}
        elif timer:
            summary[name] = {k: [r[k] for r in recs] for k in recs[0]
                             if k.startswith(timer) and k.endswith("_ms")}
        elif a.checks:
            summary[name] = {fn: {k: [r["checks"][fn][k]["ms"] for r in recs]
                                  for k in recs[0]["checks"][fn]}
                             for fn in recs[0]["checks"]}
            summary[name]["lines"] = {k: [r["lines"].get(k) for r in recs]
                                      for k in recs[0]["lines"]}
        else:
            summary[name] = {
                "fwd_stage_ms": [r["fwd_stage_ms"] for r in recs],
                "fwd_pass_ms": [r["fwd_pass_ms"] for r in recs],
                "stage_ms": [r["stage_ms"] for r in recs],
                "step_ms": [r["step_ms"] for r in recs],
                "failed": recs[0]["failed"]}
    print(json.dumps({"summary": summary,
                      "card": results["this"][0]["card"]}))
    if not (a.checks or timer) and any(
            r["failed"] for recs in results.values() for r in recs):
        raise SystemExit("ln_mlp_bwd_variants: a tree's kernel 4 or 4b "
                         "missed its bounds")


if __name__ == "__main__":
    main()
