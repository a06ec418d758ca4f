"""K2: fused causal attention, wrapper of csrc/flash_attention.cu.

Replaces the TPU kernel coati_tpu/ops/pallas/flash_attention.py
(flash_causal_attention, _flash_forward, _attn_kernel). On an H100 it is
bound by bytes: it reads q, k, v and writes o once, and keeps the
(B, H, T, T) scores out of device memory; the design note is at the top
of the CUDA source.

For a CPU tensor the wrapper runs the plain version,
ops/attention.causal_attention with a float32 softmax, which is what the
kernel computes. For a CUDA tensor it launches the kernel or raises:
there is no fallback. `flash_causal_attention.launches` counts launches.

q/k/v may be strided views (the slices of the fused qkv projection): the
kernel takes their batch and token strides and reads them in place; heads
must be packed (head stride Dh, element stride 1). The output is a new
contiguous (B, T, H, Dh) tensor in the input dtype. Forward only: the
backward kernel comes with training.
"""

from __future__ import annotations

import ctypes
import math

import torch

from coati_tpu_torch.ops.attention import causal_attention
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


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash_causal_attention wants q, k, v of one (B, T, H, Dh) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("flash_causal_attention: q, k, v must lie on one CUDA device")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"flash_causal_attention takes float32 or bfloat16 q, k, v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    b, t, h, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_causal_attention: head dim {dh} not in {HEAD_DIMS}")
    if b > 65535 or h > 65535:
        raise ValueError(f"flash_causal_attention: batch {b} or heads {h} above 65535")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or x.stride(2) != dh:
            raise ValueError(
                f"flash_causal_attention: {name} needs packed heads (strides (*, *, {dh}, 1)), "
                f"got {x.stride()}"
            )


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, T, H, Dh) -> (B, T, H, Dh), causal, softmax in float32."""
    if q.device.type == "cpu":
        return causal_attention(q, k, v, softmax_dtype=torch.float32)
    _check_inputs(q, k, v)
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


flash_causal_attention.launches = 0
