"""Launch counts of the port's kernels, by the name chip_smoke reports.

Each kernel wrapper adds one to its own ``launches`` where it launches
its kernel on the card, and nowhere else; the CPU route counts nothing.
The probe wrappers count by mode (``launches[mode]``), read here as
``"<name>.<mode>"``.
"""

from __future__ import annotations

from typing import Dict

from mtlora_tpu_torch.ops.adapter_mlp import (
    adapter_mid_bwd,
    adapter_mid_bwd_probe,
    adapter_mid_fwd,
    adapter_mid_probe,
)
from mtlora_tpu_torch.ops.head import head_mlp_bwd, head_mlp_fwd
from mtlora_tpu_torch.ops.ln_lora import (
    ln_lora_bwd,
    ln_lora_fwd,
    ln_lora_tail_bwd,
    ln_lora_tail_fwd,
    merge_ln_bwd,
    merge_ln_fwd,
)
from mtlora_tpu_torch.ops.ln_mlp import ln_mlp_bwd, ln_mlp_fwd
from mtlora_tpu_torch.ops.lora_matmul import lora_matmul_dx, lora_matmul_fwd
from mtlora_tpu_torch.ops.quad_attn import quad_attention
from mtlora_tpu_torch.ops.task_merge import task_merge_bwd, task_merge_fwd
from mtlora_tpu_torch.ops.window_attn import (
    window_attention_bwd,
    window_attention_dense_bwd,
    window_attention_dense_fwd,
    window_attention_fwd,
    window_attention_probe,
)

WRAPPERS = {
    "window_attention": window_attention_fwd,
    "window_attention_bwd": window_attention_bwd,
    "hrnet_head_mlp": head_mlp_fwd,
    "hrnet_head_mlp_bwd": head_mlp_bwd,
    "ln_lora": ln_lora_fwd,
    "ln_lora_bwd": ln_lora_bwd,
    "patch_merge": merge_ln_fwd,
    "patch_merge_bwd": merge_ln_bwd,
    "ln_mlp": ln_mlp_fwd,
    "ln_mlp_bwd": ln_mlp_bwd,
    "ln_lora_tail": ln_lora_tail_fwd,
    "ln_lora_tail_bwd": ln_lora_tail_bwd,
    "adapter_mid": adapter_mid_fwd,
    "adapter_mid_bwd": adapter_mid_bwd,
    "task_merge": task_merge_fwd,
    "task_merge_bwd": task_merge_bwd,
    "window_attention_dense": window_attention_dense_fwd,
    "window_attention_dense_bwd": window_attention_dense_bwd,
    "lora_matmul": lora_matmul_fwd,
    "lora_matmul_dx": lora_matmul_dx,
    "quad_pre_attention": quad_attention,
}
# wrappers that count by mode
MODE_WRAPPERS = {
    "window_attention_probe": window_attention_probe,
    "adapter_mid_probe": adapter_mid_probe,
    "adapter_mid_bwd_probe": adapter_mid_bwd_probe,
}


def reset():
    for fn in WRAPPERS.values():
        fn.launches = 0
    for fn in MODE_WRAPPERS.values():
        fn.launches = dict.fromkeys(fn.launches, 0)


def read() -> Dict[str, int]:
    out = {name: fn.launches for name, fn in WRAPPERS.items()}
    for name, fn in MODE_WRAPPERS.items():
        out.update({f"{name}.{mode}": n for mode, n in fn.launches.items()})
    return out
