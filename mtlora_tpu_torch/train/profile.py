"""Device-time breakdown of a ``torch.profiler`` trace, by kernel class.

Reads the Chrome trace that ``prof.export_chrome_trace`` writes, takes
every device kernel event (``"cat": "kernel"``), and sums their times by
class of kernel name; the device's busy time is the union of the kernel
intervals, and the idle share is ``1 - busy / span`` over the window from
the first kernel's start to the last one's end. The kernels left in
"other" are listed by name, so the classes can be checked.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

# first match wins; matched against the lower-cased kernel name
CLASSES: List[Tuple[str, Tuple[str, ...]]] = [
    # the products over rows and fixed-order sums of ln_common.cuh (the
    # LN-family kernels and the head backward 7b), ahead of the attention
    # backward's own sum_groups
    ("weight-gradient passes of 2b, 3b, 4b, 5b, 6b, 7b",
     ("wgrad_kernel", "lnk::sum_")),
    ("window attention kernel 1c (fwd)", ("window_attn_fwd_rows<true>",)),
    ("window attention kernel 1c (bwd)", ("window_attn_bwd_kernel<true>",)),
    ("LoRA GEMM kernel 8", ("lora_matmul",)),
    ("window attention kernel (fwd)", ("window_attn_fwd",)),
    ("window attention kernel (bwd)", ("window_attn_bwd", "sum_groups")),
    ("HRNet head kernel (fwd)", ("head_fwd_",)),
    ("HRNet head kernel (bwd)", ("head_bwd_",)),
    ("LN+LoRA kernel 2, qkv sites (fwd)", ("ln_lora_qkv_fwd_kernel",)),
    ("LN+LoRA kernel 2b, qkv sites (bwd rows)", ("ln_lora_qkv_bwd_rows",)),
    ("patch merge kernel 3 (fwd)", ("patch_merge_fwd_rows",)),
    ("patch merge kernel 3b (bwd rows)", ("patch_merge_bwd_rows",)),
    ("whole-MLP kernel 4 (fwd)", ("ln_mlp_fwd_kernel",)),
    ("whole-MLP kernel 4b (bwd rows)", ("ln_mlp_bwd_",)),
    ("LN+LoRA kernel 2, tail mode (fwd)", ("ln_lora_tail_fwd_kernel",)),
    ("LN+LoRA kernel 2b, tail mode (fused rows)",
     ("ln_lora_tail_bwd_rows",)),
    ("adapter MLP-tail kernel 5 (fwd)",
     ("adapter_mid_fwd", "mid2_sum_kernel")),
    ("adapter MLP-tail kernel 5b (fused bwd, dmid1 chunk sums)",
     ("adapter_mid_bwd_fused", "dmid_sum_kernel")),
    ("task-merge kernel 6 (fwd)", ("task_merge_fwd_rows",)),
    ("task-merge kernel 6b (bwd rows)", ("task_merge_bwd",)),
    ("optimizer (foreach AdamW, clipping)", ("multi_tensor",)),
    ("GEMMs (cuBLAS / CUTLASS)", ("gemm", "gemv", "cutlass", "xmma",
                                  "nvjet", "splitk", "s16816", "s1688")),
    ("convolutions", ("conv", "cudnn", "winograd")),
    ("bilinear upsampling", ("upsample",)),
    ("softmax / log-softmax", ("softmax",)),
    ("gathers, scatters, index", ("index", "gather", "scatter")),
    ("reductions", ("reduce",)),
    ("random draws (dropout, drop-path)", ("distribution", "philox",
                                           "uniform", "bernoulli")),
    ("concat, copies and dtype casts", ("cat", "copy", "memcpy",
                                         "memset")),
    ("elementwise", ("elementwise",)),
]


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def breakdown(trace_path: str, steps: int) -> Dict:
    """Device ms by class, busy ms and span ms, each per step (or per
    forward: ``steps`` is the number of iterations the trace holds), and
    the idle share."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        raise RuntimeError("the trace holds no device kernel")
    by_class: Dict[str, float] = {}
    other: Dict[str, float] = {}
    for e in kernels:
        cls = classify(e["name"])
        by_class[cls] = by_class.get(cls, 0.0) + e["dur"] / 1e3
        if cls == "other":
            other[e["name"]] = other.get(e["name"], 0.0) + e["dur"] / 1e3
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    total = sum(by_class.values())
    return {
        "steps": steps,
        "ms_per_step": {k: v / steps for k, v in
                        sorted(by_class.items(), key=lambda kv: -kv[1])},
        "share_of_kernel_time": {k: v / total for k, v in by_class.items()},
        "busy_ms_per_step": busy / 1e3 / steps,
        "span_ms_per_step": span / 1e3 / steps,
        "idle_share": 1.0 - busy / span,
        "other_top": [(name[:120], ms / steps) for name, ms in
                      sorted(other.items(), key=lambda kv: -kv[1])[:8]],
    }
