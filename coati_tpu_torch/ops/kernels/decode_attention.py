"""K1: masked-read decode attention, wrappers of csrc/decode_attention.cu.

Replaces the TPU kernel coati_tpu/ops/pallas/decode_attention.py
(decode_attention_pallas and decode_attention_pallas_quant,
_decode_pallas, _kernel). On an H100 it is bound by bytes: the cache
positions [0, pos] it must read; positions past pos are never loaded.
The design note is at the top of the CUDA source: a thread holds 16
bytes of one head's vectors (the whole head for an int8 cache at Dh 16)
and takes (row, head, position) items, one 16-byte load of K and one of V
each, its part of the dot in registers; a row's positions are spread over
groups of threads whose states are merged in a fixed order, so the output
repeats bit for bit.

One source, templated over the cache type, serves both wrappers:
`decode_attention` for a float32 or bfloat16 cache of the query's dtype,
and `decode_attention_quant` for an int8 cache with float32 or bfloat16
per-(token, head) scales. For CPU tensors they run the plain versions
(ops/attention.py); for CUDA tensors they launch the kernel or raise, with
no fallback: an int8 cache given to `decode_attention`, or one without
scales, is an error, never a silent detour. Each wrapper counts its
launches in `.launches` (`build.count_launch`: a launch made while the
stream is being captured into a CUDA graph is counted in the capture's
recording, `build.recording_launches`, whose owner adds those counts at
each replay, models/decode_graph.py).

The cache slice of one layer, `data[l, 0]` of the (L, 2, B, T, H, Dh)
cache, is a contiguous (B, T, H, Dh) view and is read in place; q and
the cache slices must start on a 16-byte boundary. `pos` is either a
host int, passed by value, so a launch needs no device sync; or a
one-element int32 tensor on the query's device, which the kernel reads
when it runs (the C entry `decode_attention_at`), so that one captured
CUDA graph replays the step at every position (models/decode_graph.py).
The host int picks the row's groups G for pos itself; a tensor position
takes them for the cache's last position, and groups past pos merge as
empty states: where G is the same, both forms give the same bits.
`groups(...)` reports G. The kernel has bodies for Dh 16 and 32; a head
below 32 of another width (24) is read from copies zero-padded to the
next, at the cost of a copy of the cache a launch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from coati_tpu_torch.ops import attention as plain
from coati_tpu_torch.ops.kernels import build
from coati_tpu_torch.ops.kernels.flash_attention import pad_heads, padded_width

HEAD_DIMS = (16, 32)  # a head's vector is whole 16-byte loads, unrolled in registers
DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
_AT_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
                + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
_GROUPS_ARGTYPES = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
def _entry(name: str, argtypes):
    fn = getattr(build.load("decode_attention"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _library():
    return _entry("decode_attention", _ARGTYPES)


def groups(batch: int, heads: int, head_dim: int, pos: int, q_dtype: torch.dtype,
           kv_dtype: torch.dtype, scale_dtype: torch.dtype = torch.float32) -> int:
    """The groups G a row takes at position `pos` in the form (query, cache
    and scale dtypes) and shape given, on the current card."""
    out = ctypes.c_int(0)
    err = _entry("decode_attention_groups", _GROUPS_ARGTYPES)(
        batch, heads, head_dim, pos, build.DTYPE_CODES[q_dtype], build.DTYPE_CODES[kv_dtype],
        build.DTYPE_CODES[scale_dtype], ctypes.byref(out),
    )
    build.check(err, "decode_attention_groups")
    return out.value


def _check_common(q1: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos) -> None:
    if q1.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"decode attention wants q1 (B, H, Dh) and caches (B, T, H, Dh), got "
            f"{tuple(q1.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, t, h, dh = k.shape
    if tuple(q1.shape) != (b, h, dh):
        raise ValueError(f"decode attention: q1 {tuple(q1.shape)} does not match cache {tuple(k.shape)}")
    if not (q1.device == k.device == v.device) or q1.device.type != "cuda":
        raise ValueError("decode attention: q1 and the caches must lie on one CUDA device")
    if q1.dtype not in DTYPES:
        raise TypeError(f"decode attention takes a float32 or bfloat16 query, got {q1.dtype}")
    width = padded_width(q1, k, v, head_dims=HEAD_DIMS) or dh  # the head dim it runs at
    if width not in HEAD_DIMS:
        raise ValueError(f"decode attention: head dim {dh} above {HEAD_DIMS[-1]} or not in "
                         f"{HEAD_DIMS}")
    if (h * width) % 32 or h * width > 1024:
        raise ValueError(f"decode attention: H*Dh = {h * width} must be a multiple of 32, "
                         "at most 1024")
    if not all(x.is_contiguous() for x in (q1, k, v)):
        raise ValueError("decode attention: q1 and the cache slices must be contiguous")
    if isinstance(pos, torch.Tensor):
        if pos.shape != (1,) or pos.dtype != torch.int32 or pos.device != q1.device:
            raise ValueError(
                "decode attention: a position tensor must be one int32 on the query's device, "
                f"got {tuple(pos.shape)} {pos.dtype} on {pos.device}"
            )
    elif not isinstance(pos, int) or not 0 <= pos < t:
        raise ValueError(f"decode attention: pos must be a host int in [0, {t}), got {pos!r}")
    check_aligned(q1, k, v)


def check_aligned(*tensors: torch.Tensor) -> None:
    """Raise on a query or cache slice that the kernel cannot read 16 bytes
    at a time: a base address that is not a multiple of 16. (Every head's
    vector, Dh >= 16 elements of at least a byte, then starts aligned.)"""
    for name, x in zip(("q1", "k", "v"), tensors):
        if x.data_ptr() % 16:
            raise ValueError(
                f"decode attention: {name} must start on a 16-byte boundary, got address "
                f"{x.data_ptr()}"
            )


def _launch(q1, k, v, ks: Optional[torch.Tensor], vs: Optional[torch.Tensor], pos,
            scale_code: int):
    """The kernel on checked tensors, through the entry that takes `pos`
    (a host int, or a one-element int32 tensor read on the card with G
    chosen for the cache's last position); a head dim without a body runs
    on copies zero-padded to the next (flash_attention.padded_width: for an
    int8 cache too, whose per-(token, head) scales the zeros leave as they
    are), the scale kept at the unpadded Dh's."""
    dh = q1.shape[-1]
    width = padded_width(q1, k, v, head_dims=HEAD_DIMS)
    if width:
        q1, k, v = pad_heads(width, q1, k, v)
    b, t, h, w = k.shape
    out = torch.empty_like(q1)
    args = [
        q1.data_ptr(), k.data_ptr(), v.data_ptr(),
        ks.data_ptr() if ks is not None else None,
        vs.data_ptr() if vs is not None else None,
        out.data_ptr(), b, t, h, w,
    ]
    if isinstance(pos, torch.Tensor):
        fn, args = _entry("decode_attention_at", _AT_ARGTYPES), args + [pos.data_ptr(), t - 1]
    else:
        fn, args = _library(), args + [pos]
    err = fn(
        *args, build.DTYPE_CODES[q1.dtype], build.DTYPE_CODES[k.dtype], scale_code,
        1.0 / math.sqrt(dh), build.stream_handle(q1.device),
    )
    build.check(err, "decode_attention kernel")
    return out[..., :dh].contiguous() if width else out


def decode_attention(q1: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos) -> torch.Tensor:
    """q1 (B, H, Dh) attends to k/v caches (B, T, H, Dh) of its dtype over
    positions [0, pos], `pos` a host int or a one-element int32 tensor on
    the query's device. Returns (B, H, Dh)."""
    if q1.device.type == "cpu":
        return plain.decode_attention(q1, k_cache, v_cache, pos)
    _check_common(q1, k_cache, v_cache, pos)
    if k_cache.dtype != q1.dtype or v_cache.dtype != q1.dtype:
        raise TypeError(
            f"decode_attention takes caches of the query's dtype {q1.dtype}, got "
            f"{k_cache.dtype}/{v_cache.dtype} (an int8 cache goes to decode_attention_quant)"
        )
    out = _launch(q1, k_cache, v_cache, None, None, pos, 0)
    build.count_launch(decode_attention)
    return out


def decode_attention_quant(
    q1: torch.Tensor,
    k_data: torch.Tensor,
    k_scale: torch.Tensor,
    v_data: torch.Tensor,
    v_scale: torch.Tensor,
    pos,
) -> torch.Tensor:
    """decode_attention over an int8 cache (B, T, H, Dh) with per-(token,
    head) scales (B, T, H), float32 or bfloat16; `pos` as there. Returns
    (B, H, Dh) in q1's dtype."""
    if q1.device.type == "cpu":
        return plain.decode_attention_quant(q1, k_data, k_scale, v_data, v_scale, pos)
    _check_common(q1, k_data, v_data, pos)
    if k_data.dtype != torch.int8 or v_data.dtype != torch.int8:
        raise TypeError(f"decode_attention_quant takes int8 caches, got {k_data.dtype}/{v_data.dtype}")
    if k_scale is None or v_scale is None:
        raise ValueError("decode_attention_quant: an int8 cache needs its k and v scales")
    if k_scale.shape != k_data.shape[:3] or v_scale.shape != k_scale.shape:
        raise ValueError(
            f"decode_attention_quant: scales must be (B, T, H) = {tuple(k_data.shape[:3])}, got "
            f"{tuple(k_scale.shape)}, {tuple(v_scale.shape)}"
        )
    if k_scale.dtype not in DTYPES or v_scale.dtype != k_scale.dtype:
        raise TypeError(
            f"decode_attention_quant takes float32 or bfloat16 scales of one dtype, got "
            f"{k_scale.dtype}/{v_scale.dtype}"
        )
    if k_scale.device != q1.device or v_scale.device != q1.device:
        raise ValueError("decode_attention_quant: the scales must lie on the query's device")
    if not (k_scale.is_contiguous() and v_scale.is_contiguous()):
        raise ValueError("decode_attention_quant: the scales must be contiguous")
    out = _launch(q1, k_data, v_data, k_scale, v_scale, pos, build.DTYPE_CODES[k_scale.dtype])
    build.count_launch(decode_attention_quant)
    return out


decode_attention.launches = 0
decode_attention_quant.launches = 0
