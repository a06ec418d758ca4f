"""K3: fused EGNN message aggregation, wrapper of csrc/egnn_messages.cu.

Replaces the TPU kernel coati_tpu/ops/pallas/egnn_messages.py
(egnn_messages / egnn_messages_bf16, _fwd_pallas, _fwd_kernel). On an H100
it is bound by operations (the inner product e1 @ w2 per live pair); the
(B, N, N, Hm) pairwise tensor never reaches device memory and pairs whose
weight is zero cost nothing. The design note is at the top of the CUDA
source.

For CPU tensors the wrapper runs the plain version,
ops/egnn_messages.egnn_messages. For CUDA tensors it launches the kernel
or raises: there is no fallback. `egnn_messages.launches` counts launches.

Inputs may be float32 or bfloat16 (one dtype for a, c, d2, w); as in the
JAX package they are cast to float32 for the kernel, which computes in
float32, and the result is cast back to a's dtype. mm_dtype bfloat16 is
the JAX package's egnn_messages_bf16: e1 and w2 are rounded to bf16 before
the inner product, which accumulates in float32. Forward only: the
backward kernel comes with training, so an input that requires grad is
refused on CUDA.
"""

from __future__ import annotations

import ctypes

import torch

from coati_tpu_torch.ops import egnn_messages as plain
from coati_tpu_torch.ops.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
MAX_SHARED_BYTES = 232448  # what one block may ask for on an H100
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _library():
    lib = build.load("egnn_messages")
    lib.egnn_messages.argtypes = _ARGTYPES
    lib.egnn_messages.restype = ctypes.c_int
    lib.egnn_messages_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.egnn_messages_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check_no_grad(tensors) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise RuntimeError(
            "egnn_messages: the CUDA kernel is forward only (its backward kernel comes "
            "with the training slice of the port); call it under torch.no_grad()"
        )


def _check_inputs(a, c, d2, w, wd, b1, w2, b2, mm_dtype) -> None:
    if mm_dtype not in DTYPES:
        raise TypeError(f"egnn_messages: mm_dtype must be float32 or bfloat16, got {mm_dtype}")
    if a.dim() != 3 or c.shape != a.shape:
        raise ValueError(
            f"egnn_messages wants a, c of one (B, N, Hm) shape, got {tuple(a.shape)}, "
            f"{tuple(c.shape)}"
        )
    b, n, hm = a.shape
    if d2.shape != (b, n, n) or w.shape != (b, n, n):
        raise ValueError(
            f"egnn_messages wants d2, w of shape {(b, n, n)}, got {tuple(d2.shape)}, "
            f"{tuple(w.shape)}"
        )
    for name, x, shape in (("wd", wd, (hm,)), ("b1", b1, (hm,)), ("b2", b2, (hm,)),
                           ("w2", w2, (hm, hm))):
        if x.shape != shape:
            raise ValueError(f"egnn_messages wants {name} of shape {shape}, got {tuple(x.shape)}")
    tensors = (a, c, d2, w, wd, b1, w2, b2)
    if a.device.type != "cuda" or any(x.device != a.device for x in tensors):
        raise ValueError("egnn_messages: all inputs must lie on one CUDA device")
    if any(x.dtype not in DTYPES for x in tensors) or not (a.dtype == c.dtype == d2.dtype == w.dtype):
        raise TypeError(
            "egnn_messages takes float32 or bfloat16 inputs, a, c, d2, w of one dtype, got "
            + ", ".join(str(x.dtype) for x in tensors)
        )
    if b < 1 or n < 1 or hm < 1 or b > 65535:
        raise ValueError(f"egnn_messages: empty input or batch above 65535: {tuple(a.shape)}")
    _check_no_grad(tensors)


def egnn_messages(
    a: torch.Tensor,
    c: torch.Tensor,
    d2: torch.Tensor,
    w: torch.Tensor,
    wd: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    mm_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """a, c: (B, N, Hm); d2, w: (B, N, N); wd, b1, b2: (Hm,); w2: (Hm, Hm)
    with z2 = e1 @ w2. Returns mi (B, N, Hm) in a's dtype."""
    if a.device.type == "cpu":
        return plain.egnn_messages(a, c, d2, w, wd, b1, w2, b2, mm_dtype=mm_dtype)
    _check_inputs(a, c, d2, w, wd, b1, w2, b2, mm_dtype)
    b, n, hm = a.shape
    lib = _library()
    need = lib.egnn_messages_smem_bytes(n, hm)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"egnn_messages: N {n}, Hm {hm} need {need} bytes of shared memory a block, "
            f"above the card's {MAX_SHARED_BYTES}"
        )
    args = [x.detach().float().contiguous() for x in (a, c, d2, w, wd, b1, w2, b2)]
    out = torch.empty((b, n, hm), dtype=torch.float32, device=a.device)
    err = lib.egnn_messages(
        *(x.data_ptr() for x in args), out.data_ptr(), b, n, hm,
        int(mm_dtype == torch.bfloat16), build.stream_handle(a.device),
    )
    build.check(err, "egnn_messages kernel")
    egnn_messages.launches += 1
    return out.to(a.dtype)


egnn_messages.launches = 0
