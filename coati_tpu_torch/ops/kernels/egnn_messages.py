"""K3 and K4: fused EGNN message aggregation and its backward, wrappers of
csrc/egnn_messages.cu and csrc/egnn_messages_bwd.cu.

Replaces the TPU kernels of coati_tpu/ops/pallas/egnn_messages.py:
egnn_messages / egnn_messages_bf16 with _fwd_pallas / _fwd_kernel (K3) and
their VJP _bwd_pallas / _bwd_kernel (K4). On an H100 both are bound by
operations (one Hm x Hm product per live pair forward, three backward); the
(B, N, N, Hm) pairwise tensors never reach device memory and pairs whose
weight is zero cost nothing. The design notes are at the top of the CUDA
sources.

`egnn_messages` goes through `EgnnMessages`, a torch.autograd.Function: the
forward is K3 and saves its eight inputs, the backward is K4 and returns
gradients for a, c, wd, b1, w2, b2 and none for d2 and w (the caller holds
the pair geometry without gradient, as the JAX package does). For CPU
tensors both run their plain versions, ops/egnn_messages.egnn_messages and
egnn_messages_backward. For CUDA tensors they launch the kernels or raise:
there is no fallback. `egnn_messages.launches` counts launches of K3,
`egnn_messages.bwd_launches` those of K4.

Inputs may be float32 or bfloat16 (one dtype for a, c, d2, w); as in the
JAX package they are cast to float32 for the kernels, which compute in
float32, and each result is cast back to its input's dtype. mm_dtype
bfloat16 is the JAX package's egnn_messages_bf16: the inputs of the inner
products are rounded to bf16 first, and the products accumulate in float32.
K4 adds its parameter gradients and dc with float32 atomics, so they may
differ in their last bits between two runs on the same inputs.
"""

from __future__ import annotations

import ctypes

import torch

from coati_tpu_torch.ops import egnn_messages as plain
from coati_tpu_torch.ops.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
MAX_SHARED_BYTES = 232448  # what one block may ask for on an H100
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


_BWD_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _library():
    lib = build.load("egnn_messages")
    lib.egnn_messages.argtypes = _ARGTYPES
    lib.egnn_messages.restype = ctypes.c_int
    lib.egnn_messages_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.egnn_messages_smem_bytes.restype = ctypes.c_longlong
    return lib


def _bwd_library():
    lib = build.load("egnn_messages_bwd")
    lib.egnn_messages_bwd.argtypes = _BWD_ARGTYPES
    lib.egnn_messages_bwd.restype = ctypes.c_int
    lib.egnn_messages_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.egnn_messages_bwd_smem_bytes.restype = ctypes.c_longlong
    return lib


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


def _check_shared(need: int, n: int, hm: int, what: str) -> None:
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"{what}: N {n}, Hm {hm} need {need} bytes of shared memory a block, "
            f"above the card's {MAX_SHARED_BYTES}"
        )


def _forward(a, c, d2, w, wd, b1, w2, b2, mm_dtype) -> torch.Tensor:
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if a.device.type == "cpu":
        return plain.egnn_messages(a, c, d2, w, wd, b1, w2, b2, mm_dtype=mm_dtype)
    _check_inputs(a, c, d2, w, wd, b1, w2, b2, mm_dtype)
    b, n, hm = a.shape
    lib = _library()
    _check_shared(lib.egnn_messages_smem_bytes(n, hm), n, hm, "egnn_messages")
    args = [x.detach().float().contiguous() for x in (a, c, d2, w, wd, b1, w2, b2)]
    out = torch.empty((b, n, hm), dtype=torch.float32, device=a.device)
    err = lib.egnn_messages(
        *(x.data_ptr() for x in args), out.data_ptr(), b, n, hm,
        int(mm_dtype == torch.bfloat16), build.stream_handle(a.device),
    )
    build.check(err, "egnn_messages kernel")
    egnn_messages.launches += 1
    return out.to(a.dtype)


def egnn_messages_backward(a, c, d2, w, wd, b1, w2, b2, g, mm_dtype=torch.float32):
    """(da, dc, dwd, db1, dw2, db2) of egnn_messages for the cotangent g
    (B, N, Hm) of its output, in float32: K4 on CUDA tensors, its plain
    version on CPU tensors."""
    if a.device.type == "cpu":
        return plain.egnn_messages_backward(a, c, d2, w, wd, b1, w2, b2, g, mm_dtype=mm_dtype)
    _check_inputs(a, c, d2, w, wd, b1, w2, b2, mm_dtype)
    if g.shape != a.shape or g.device != a.device:
        raise ValueError(
            f"egnn_messages_backward: g {tuple(g.shape)} on {g.device} does not match "
            f"a {tuple(a.shape)} on {a.device}"
        )
    b, n, hm = a.shape
    lib = _bwd_library()
    _check_shared(lib.egnn_messages_bwd_smem_bytes(n, hm), n, hm, "egnn_messages_backward")
    af, cf, d2f, wf, wdf, b1f, w2f, b2f, gf = (
        x.detach().float().contiguous() for x in (a, c, d2, w, wd, b1, w2, b2, g)
    )
    w2t = w2f.t().contiguous()  # the kernel streams W2^T row by row
    dev = a.device
    da = torch.empty((b, n, hm), dtype=torch.float32, device=dev)
    # the kernel adds into these
    dc = torch.zeros((b, n, hm), dtype=torch.float32, device=dev)
    dw2 = torch.zeros((hm, hm), dtype=torch.float32, device=dev)
    dwd, db1, db2 = torch.zeros((3, hm), dtype=torch.float32, device=dev).unbind(0)
    err = lib.egnn_messages_bwd(
        *(x.data_ptr() for x in (af, cf, d2f, wf, wdf, b1f, w2f, w2t, b2f, gf)),
        *(x.data_ptr() for x in (da, dc, dwd, db1, dw2, db2)),
        b, n, hm, int(mm_dtype == torch.bfloat16), build.stream_handle(dev),
    )
    build.check(err, "egnn_messages_backward kernel")
    egnn_messages.bwd_launches += 1
    return da, dc, dwd, db1, dw2, db2


class EgnnMessages(torch.autograd.Function):
    """K3 forward, K4 backward. Saves the eight inputs; d2 and w get no
    gradient."""

    @staticmethod
    def forward(ctx, a, c, d2, w, wd, b1, w2, b2, mm_dtype):
        ctx.save_for_backward(a, c, d2, w, wd, b1, w2, b2)
        ctx.mm_dtype = mm_dtype
        return _forward(a, c, d2, w, wd, b1, w2, b2, mm_dtype)

    @staticmethod
    def backward(ctx, g):
        a, c, d2, w, wd, b1, w2, b2 = ctx.saved_tensors
        da, dc, dwd, db1, dw2, db2 = egnn_messages_backward(
            a, c, d2, w, wd, b1, w2, b2, g, ctx.mm_dtype
        )
        return (da.to(a.dtype), dc.to(c.dtype), None, None, dwd.to(wd.dtype),
                db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype), None)


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
    with z2 = e1 @ w2. Returns mi (B, N, Hm) in a's dtype. Differentiable
    in a, c, wd, b1, w2, b2: the backward is K4."""
    return EgnnMessages.apply(a, c, d2, w, wd, b1, w2, b2, mm_dtype)


egnn_messages.launches = 0
egnn_messages.bwd_launches = 0
