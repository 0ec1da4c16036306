"""Launch counts of the port's kernels, by the name chip_smoke reports.

Each kernel wrapper adds one to its own ``launches`` where it launches
its kernel on the card, and nowhere else; the CPU route counts nothing.
"""

from __future__ import annotations

from typing import Dict

from mtlora_tpu_torch.ops.head import head_mlp_bwd, head_mlp_fwd
from mtlora_tpu_torch.ops.window_attn import (
    window_attention_bwd,
    window_attention_fwd,
)

WRAPPERS = {
    "window_attention": window_attention_fwd,
    "window_attention_bwd": window_attention_bwd,
    "hrnet_head_mlp": head_mlp_fwd,
    "hrnet_head_mlp_bwd": head_mlp_bwd,
}


def reset():
    for fn in WRAPPERS.values():
        fn.launches = 0


def read() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
