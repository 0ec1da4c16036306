"""PyTorch / CUDA port of mtlora_tpu for NVIDIA Hopper (H100).

The JAX package ``mtlora_tpu`` is the reference; this package reproduces
its bf16 forward and training step (Swin-T MTLoRA backbone, per-task
downsamplers and HRNet heads) with hand-written CUDA kernels for its
Pallas kernels (``ops/``), and its eval path: the meters
(``evaluation/meters.py``), ``validate`` and ``throughput``
(``train/loop.py``) and the fp32 eval clone (``models/mtl.py``), and its
MTL data pipeline (``data/``: the PASCAL-Context and NYUD datasets and
the synthetic set, the host-side transforms on the port's own C++ image
ops, and a sharded loader over worker processes with pinned batches). It
imports torch, numpy and scipy; PIL only where a dataset file is decoded.
"""
