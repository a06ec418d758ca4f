"""PyTorch/CUDA port of coati_tpu for NVIDIA Hopper GPUs.

Mirrors coati_tpu's module names. It imports nothing of JAX or of
coati_tpu; the attention kernels are hand-written CUDA under csrc/, built
with nvcc at first use (ops/kernels/build.py).
"""
