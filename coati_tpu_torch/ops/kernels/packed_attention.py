"""K5f: causal attention for short sequences (T <= 128), wrapper of
csrc/packed_attention.cu.

Replaces the TPU kernel coati_tpu/ops/pallas/packed_attention.py
(packed_causal_attention, _packed_forward, _packed_kernel). Same function
and interface as K2 (ops/kernels/flash_attention.py); what differs is that
a block stages the K and V of its heads once, whole, and a query row's
scores are complete before its softmax. On an H100 it is bound by bytes;
the design note is at the top of the CUDA source.

For a CPU tensor the wrapper runs the plain version,
ops/attention.causal_attention with a float32 softmax. For a CUDA tensor it
launches the kernel or raises: there is no fallback.
`packed_causal_attention.launches` counts launches. Forward only: the
backward kernel comes with training.
"""

from __future__ import annotations

import ctypes
import math

import torch

from coati_tpu_torch.ops.attention import causal_attention
from coati_tpu_torch.ops.kernels import build
from coati_tpu_torch.ops.kernels.flash_attention import check_qkv

MAX_T = 128
MAX_SHARED_BYTES = 232448  # what one block may ask for on an H100
GROUP_BYTES = 28 * 1024  # staged K and V per block: eight blocks fill an SM's 64 warps
_ARGTYPES = (
    [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 6
    + [ctypes.c_float, ctypes.c_void_p]
)


def _library():
    lib = build.load("packed_attention")
    lib.packed_causal_attention.argtypes = _ARGTYPES
    lib.packed_causal_attention.restype = ctypes.c_int
    lib.packed_causal_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.packed_causal_attention_smem_bytes.restype = ctypes.c_longlong
    return lib


def head_group(t: int, h: int, dh: int) -> int:
    """Heads per block: the largest divisor of H whose staged K and V
    (float32, rows of Dh + 1) stay under GROUP_BYTES; at least one."""
    per_head = 2 * t * (dh + 1) * 4
    fits = [g for g in range(1, h + 1) if h % g == 0 and g * per_head <= GROUP_BYTES]
    return max(fits, default=1)


def packed_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, T, H, Dh) -> (B, T, H, Dh), causal, T <= 128, softmax
    in float32."""
    if q.dim() == 4 and q.shape[1] > MAX_T:
        raise ValueError(f"packed attention needs T <= {MAX_T}, got T={q.shape[1]}")
    if q.device.type == "cpu":
        return causal_attention(q, k, v, softmax_dtype=torch.float32)
    check_qkv(q, k, v, "packed_causal_attention")
    b, t, h, dh = q.shape
    group = head_group(t, h, dh)
    lib = _library()
    need = lib.packed_causal_attention_smem_bytes(t, group, dh)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"packed_causal_attention: T {t}, Dh {dh} need {need} bytes of shared memory "
            f"a block, above the card's {MAX_SHARED_BYTES}"
        )
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    err = lib.packed_causal_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, t, h, dh, group, build.DTYPE_CODES[q.dtype],
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        1.0 / math.sqrt(dh), build.stream_handle(q.device),
    )
    build.check(err, "packed_causal_attention kernel")
    packed_causal_attention.launches += 1
    return out


packed_causal_attention.launches = 0
