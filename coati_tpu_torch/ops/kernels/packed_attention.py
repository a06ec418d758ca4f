"""K5f and K5b: causal attention for short sequences (T <= 128) and its
backward, wrappers of csrc/packed_attention.cu and
csrc/packed_attention_bwd.cu.

Replaces the TPU kernels of coati_tpu/ops/pallas/packed_attention.py:
packed_causal_attention with _packed_forward / _packed_kernel (K5f) and its
VJP _packed_backward / _packed_bwd_kernel (K5b). Same function and interface
as K2 (ops/kernels/flash_attention.py); what differs is that a block stages
the K and V of its heads once, whole, and a query row's scores are complete
before its softmax. On an H100 both are bound by bytes; the design notes
are at the top of the CUDA sources.
As in K2, the input dtype picks each kernel's body inside its one entry
point: bfloat16 on the tensor cores, float32 on CUDA cores (the fidelity
runs, held to 1e-5, which TF32 cannot meet). K5f's bf16 body normalizes P
and then rounds it to bf16 before P V, as on the TPU. K5b's recomputes P
and dP in float32, takes rowsum(P dP) from them unrounded, and rounds P and
dS to bf16 before the products that use them (dq = dS k, dk = dS^T q,
dv = P^T g), as on the TPU; it sums over query tiles in a fixed order, so
it repeats bit for bit. Both bf16 bodies copy 16 bytes at a time and take
only 16-byte aligned q, k, v (and g) bases and batch and token strides
(flash_attention.check_aligned). Each block takes a group of heads:
`head_group` for K5f, `bwd_head_group` for K5b.

`packed_causal_attention` goes through `PackedCausalAttention`, a
torch.autograd.Function: the forward is K5f and saves q, k, v (not the
output: K5b recomputes the probabilities, as the TPU kernel does); the
backward is K5b. For CPU tensors both run their plain versions,
ops/attention.causal_attention with a float32 softmax and
ops/attention.causal_attention_backward. For CUDA tensors they launch the
kernels or raise: there is no fallback. `packed_causal_attention.launches`
counts launches of K5f, `packed_causal_attention.bwd_launches` those of K5b.
"""

from __future__ import annotations

import ctypes
import math

import torch

from coati_tpu_torch.ops.attention import causal_attention, causal_attention_backward
from coati_tpu_torch.ops.kernels import build
from coati_tpu_torch.ops.kernels.flash_attention import (
    check_aligned,
    check_qkv,
    pad_heads,
    padded_width,
)

MAX_T = 128
MAX_SHARED_BYTES = 232448  # what one block may ask for on an H100
# staged K and V per block. float32: eight blocks of 8 warps fill an SM's
# 64 warps. bfloat16: blocks of 4 warps, which take the group's 16-row
# query tiles in pairs (i, n-1-i) of equal causal work, at most three
# pairs a warp: enough to share a block's staging, few enough that the
# blocks spread over the card (the fastest groups measured at T 32-128 on
# an H100 by scripts/torch_attention_variants.py; PERF.md)
GROUP_BYTES = {torch.float32: 28 * 1024, torch.bfloat16: 24 * 1024}
TC_WARPS = 4
MAX_PAIRS_PER_WARP = 3
_ARGTYPES = (
    [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 6
    + [ctypes.c_float, ctypes.c_void_p]
)


# K5b's staging (q, k, v, g) and its P and dS stashes per block, bf16: the
# budget that picks the fastest group measured at T 32, 48, 80, 96 and 128
# on an H100 by scripts/torch_attention_variants.py (PERF.md), with at most
# three tile pairs a warp in each of its two phases, as K5f
BWD_GROUP_BYTES = 32 * 1024
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 6
    + [ctypes.c_float, ctypes.c_void_p]
)


def _library():
    lib = build.load("packed_attention")
    lib.packed_causal_attention.argtypes = _ARGTYPES
    lib.packed_causal_attention.restype = ctypes.c_int
    lib.packed_causal_attention_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.packed_causal_attention_smem_bytes.restype = ctypes.c_longlong
    return lib


def _bwd_library():
    lib = build.load("packed_attention_bwd")
    lib.packed_causal_attention_bwd.argtypes = _BWD_ARGTYPES
    lib.packed_causal_attention_bwd.restype = ctypes.c_int
    lib.packed_causal_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.packed_causal_attention_bwd_smem_bytes.restype = ctypes.c_longlong
    return lib


def staged_bytes(t: int, dh: int, dtype: torch.dtype) -> int:
    """Shared memory that K5f stages for one head: K and V, in float32 with
    rows of Dh + 1, or in bfloat16 with T rounded up to 16 (the tensor
    cores' row tile)."""
    if dtype == torch.bfloat16:
        return 2 * (-(-t // 16) * 16) * dh * 2
    return 2 * t * (dh + 1) * 4


def tile_pairs(t: int) -> int:
    """Pairs of 16-row query tiles (i, n-1-i) of one head in the bf16 body;
    the middle tile of an odd count is a pair alone."""
    return (-(-t // 16) + 1) // 2


def head_group(t: int, h: int, dh: int, dtype: torch.dtype) -> int:
    """Heads per block: the largest divisor of H whose staged K and V stay
    under GROUP_BYTES[dtype] and, in bfloat16, whose tile pairs give each
    warp at most MAX_PAIRS_PER_WARP; at least one."""
    per_head = staged_bytes(t, dh, dtype)

    def fits(g: int) -> bool:
        if h % g or g * per_head > GROUP_BYTES[dtype]:
            return False
        return dtype != torch.bfloat16 or g * tile_pairs(t) <= MAX_PAIRS_PER_WARP * TC_WARPS

    return max((g for g in range(1, h + 1) if fits(g)), default=1)


def bwd_smem_bytes(t: int, dh: int, group: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of one K5b block (csrc/packed_attention_bwd.cu
    smem_bytes). bfloat16: q, k, v and g staged with T rounded up to 16,
    and P and dS as the 16 x 16 tiles of the lower triangle, for each of
    `group` heads; float32 (one head): q, k, v, g in rows of Dh + 1 and P,
    dS as two float triangles."""
    if dtype == torch.bfloat16:
        tiles = -(-t // 16)
        return 2 * group * (4 * tiles * 16 * dh + tiles * (tiles + 1) * 256)
    return (4 * t * (dh + 1) + t * (t + 1)) * 4


def bwd_head_group(t: int, h: int, dh: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Heads per K5b block: in bfloat16 the largest divisor of H whose
    block stays under BWD_GROUP_BYTES and gives each of the 4 warps at most
    MAX_PAIRS_PER_WARP tile pairs; at least one. float32 takes one head a
    block."""
    if dtype != torch.bfloat16:
        return 1

    def fits(g: int) -> bool:
        return (h % g == 0 and bwd_smem_bytes(t, dh, g) <= BWD_GROUP_BYTES
                and g * tile_pairs(t) <= MAX_PAIRS_PER_WARP * TC_WARPS)

    return max((g for g in range(1, h + 1) if fits(g)), default=1)


def _check_t(q: torch.Tensor) -> None:
    if q.dim() == 4 and q.shape[1] > MAX_T:
        raise ValueError(f"packed attention needs T <= {MAX_T}, got T={q.shape[1]}")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K5f on CUDA tensors, its plain version on CPU tensors."""
    if q.device.type == "cpu":
        return causal_attention(q, k, v, softmax_dtype=torch.float32)
    unpadded = q.shape[-1]
    width = padded_width(q, k, v)
    if width:
        q, k, v = pad_heads(width, q, k, v)
    check_qkv(q, k, v, "packed_causal_attention")
    check_aligned(q, k, v, "packed_causal_attention")
    b, t, h, dh = q.shape
    group = head_group(t, h, dh, q.dtype)
    lib = _library()
    need = lib.packed_causal_attention_smem_bytes(t, group, dh, build.DTYPE_CODES[q.dtype])
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
        1.0 / math.sqrt(unpadded), build.stream_handle(q.device),
    )
    build.check(err, "packed_causal_attention kernel")
    build.count_launch(packed_causal_attention)
    return out[..., :unpadded].contiguous() if width else out


def packed_causal_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor
):
    """(dq, dk, dv) of packed_causal_attention for the cotangent g of its
    output, each a new contiguous (B, T, H, Dh) tensor in the input dtype:
    K5b on CUDA tensors, its plain version on CPU tensors."""
    _check_t(q)
    if q.device.type == "cpu":
        return causal_attention_backward(q, k, v, g)
    unpadded = q.shape[-1]
    width = padded_width(q, k, v, g)
    if width:
        q, k, v, g = pad_heads(width, q, k, v, g)
    check_qkv(q, k, v, "packed_causal_attention_backward")
    if g.shape != q.shape or g.device != q.device:
        raise ValueError(
            f"packed_causal_attention_backward: g {tuple(g.shape)} on {g.device} does not "
            f"match q {tuple(q.shape)} on {q.device}"
        )
    g = g.to(q.dtype).contiguous()  # autograd hands g over with any strides
    check_aligned(q, k, v, "packed_causal_attention_backward", g)
    b, t, h, dh = q.shape
    group = bwd_head_group(t, h, dh, q.dtype)
    lib = _bwd_library()
    code = build.DTYPE_CODES[q.dtype]
    need = lib.packed_causal_attention_bwd_smem_bytes(t, dh, group, code)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"packed_causal_attention_backward: T {t}, Dh {dh} need {need} bytes of shared "
            f"memory a block, above the card's {MAX_SHARED_BYTES}"
        )
    dq, dk, dv = (torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device) for _ in range(3))
    err = lib.packed_causal_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, t, h, dh, group, code,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        1.0 / math.sqrt(unpadded), build.stream_handle(q.device),
    )
    build.check(err, "packed_causal_attention_backward kernel")
    build.count_launch(packed_causal_attention, "bwd_launches")
    if width:
        return tuple(x[..., :unpadded].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv


class PackedCausalAttention(torch.autograd.Function):
    """K5f forward, K5b backward. Saves q, k, v only."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return packed_causal_attention_backward(*ctx.saved_tensors, g)


def packed_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, T, H, Dh) -> (B, T, H, Dh), causal, T <= 128, softmax
    in float32. Differentiable: the backward is K5b."""
    _check_t(q)
    return PackedCausalAttention.apply(q, k, v)


packed_causal_attention.launches = 0
packed_causal_attention.bwd_launches = 0
