"""PyTorch / CUDA port of mtlora_tpu for NVIDIA Hopper (H100).

The JAX package ``mtlora_tpu`` is the reference; this package reproduces
its bf16 eval forward (Swin-T MTLoRA backbone, per-task downsamplers and
HRNet heads) with hand-written CUDA kernels for the two Pallas kernels on
that path: window attention (``ops/window_attn.py``) and the fused HRNet
head (``ops/head.py``). It imports torch and numpy only.
"""
