"""K2: fused causal attention, wrapper of csrc/flash_attention.cu.

Replaces the TPU kernel coati_tpu/ops/pallas/flash_attention.py
(flash_causal_attention, _flash_forward, _attn_kernel). It reads q, k, v
and writes o once, and keeps the (B, H, T, T) scores out of device memory;
the design note is at the top of the CUDA source. The input dtype picks
the body, inside the one entry point: bfloat16 runs on the tensor cores
(mma.sync, cp.async; P rounded to bf16 before P V, as on the TPU), float32
on CUDA cores in full float32 (the fidelity runs, held to 1e-5, which TF32
cannot meet). The bf16 body copies 16 bytes at a time, so it takes only
16-byte aligned q, k, v base pointers and batch and token strides
(`check_aligned`), as the model's views of its fused qkv projection are.

For a CPU tensor the wrapper runs the plain version,
ops/attention.causal_attention with a float32 softmax, which is what the
kernel computes. For a CUDA tensor it launches the kernel or raises:
there is no fallback. `flash_causal_attention.launches` counts launches.

q/k/v may be strided views (the slices of the fused qkv projection): the
kernel takes their batch and token strides and reads them in place; heads
must be packed (head stride Dh, element stride 1). The output is a new
contiguous (B, T, H, Dh) tensor in the input dtype.

`flash_causal_attention` goes through `FlashCausalAttention`, a
torch.autograd.Function whose forward is K2. K2 has no backward kernel: the
JAX package's VJP of its flash kernel (flash_attention.py, _bwd) replays the
plain attention under jax.vjp, and the backward here does the same with
ops/attention.causal_attention_backward, in batch chunks, on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from coati_tpu_torch.ops.attention import causal_attention, causal_attention_backward
from coati_tpu_torch.ops.kernels import build

HEAD_DIMS = (16, 32, 64)
DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = (
    [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 5
    + [ctypes.c_longlong] * 6
    + [ctypes.c_float, ctypes.c_void_p]
)


def _library():
    lib = build.load("flash_attention")
    fn = lib.flash_causal_attention
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def check_qkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str = "flash_causal_attention"
) -> None:
    """Raise on q, k, v that the attention kernels (this one and the
    short-sequence one, which shares the interface) do not take."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"{name} wants q, k, v of one (B, T, H, Dh) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(f"{name}: q, k, v must lie on one CUDA device")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"{name} takes float32 or bfloat16 q, k, v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    b, t, h, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {dh} not in {HEAD_DIMS}")
    if b > 65535 or h > 65535:
        raise ValueError(f"{name}: batch {b} or heads {h} above 65535")
    for arg, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or x.stride(2) != dh:
            raise ValueError(
                f"{name}: {arg} needs packed heads (strides (*, *, {dh}, 1)), "
                f"got {x.stride()}"
            )


def check_aligned(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str = "flash_causal_attention",
    g: torch.Tensor | None = None,
) -> None:
    """Raise on bfloat16 q, k, v (and the cotangent g of the short-sequence
    backward) that the tensor-core bodies (this kernel's and the
    short-sequence ones') cannot copy 16 bytes at a time: a base pointer, or
    a batch or token stride in bytes, that is not a multiple of 16. float32
    runs on CUDA cores and takes any strides."""
    if q.dtype != torch.bfloat16:
        return
    for arg, x in (("q", q), ("k", k), ("v", v), ("g", g)):
        if x is None:
            continue
        elt = x.element_size()
        if x.data_ptr() % 16 or (x.stride(0) * elt) % 16 or (x.stride(1) * elt) % 16:
            raise ValueError(
                f"{name}: bf16 {arg} needs a 16-byte aligned base and batch and token "
                f"strides of a multiple of 16 bytes, got address {x.data_ptr()} and "
                f"strides {x.stride()}"
            )


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K2 on CUDA tensors, its plain version on CPU tensors."""
    if q.device.type == "cpu":
        return causal_attention(q, k, v, softmax_dtype=torch.float32)
    check_qkv(q, k, v)
    check_aligned(q, k, v)
    b, t, h, dh = q.shape
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    err = _library()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, t, h, dh, build.DTYPE_CODES[q.dtype],
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        1.0 / math.sqrt(dh), build.stream_handle(q.device),
    )
    build.check(err, "flash_causal_attention kernel")
    flash_causal_attention.launches += 1
    return out


class FlashCausalAttention(torch.autograd.Function):
    """K2 forward; the backward replays the plain attention's gradient."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return causal_attention_backward(*ctx.saved_tensors, g)


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, T, H, Dh) -> (B, T, H, Dh), causal, softmax in float32.
    Differentiable (see FlashCausalAttention)."""
    return FlashCausalAttention.apply(q, k, v)


flash_causal_attention.launches = 0
