"""K7: the exact top k of each row of float32 logits, sorted, the wrapper
of csrc/top_k.cu.

Replaces no TPU kernel: the JAX package takes `lax.top_k` in its sampler,
which XLA lowers itself. The port's sampler (ops/sampling.py
`top_k_candidates`) needs, every decode step, each row's k (100) largest
logits in descending order, the lower index first among equal values; a
stable sort of the whole (B, vocabulary) block gives that and sorts every
value. Bound: bytes, one read of the logits. The design note is at the top
of the CUDA source: a block a row with the row's keys in shared memory, a
floor from the threads' maxima that about 1.2 k values reach, their ranks
among each other, and a radix select where too many values reach the floor;
for k above 128 (the examples' bulk draws, not the decode loop of the
benchmarked round trips) a second kernel sorts the whole row in shared
memory by a bitonic network and keeps the first k.

`top_k(logits, k)` returns (values, indices), each (..., k), contiguous,
float32 and int64, equal bit for bit to `top_k_plain` (a stable descending
sort and a slice) as PyTorch's sort orders on the card: -0.0 ties +0.0 (the
lower index first), NaN above +inf and ordered by its bits, negative NaN
below -inf (the CPU's sort puts every NaN first, in index order). CPU
tensors take `top_k_plain`, the stable sort. On the card the kernels take
float32 rows, each contiguous and evenly spaced, with 1 <= k <= width <=
32,768, and `top_k` raises ValueError for any other input (`_check`) rather
than sort it; `sample_top_k` casts to float32 and clamps k to the width, so
every path of the port meets that. Launches are counted in
`top_k.launches`, or in a capture's recording (build.recording_launches).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from coati_tpu_torch.ops.kernels import build

MAX_K = 128  # past it, the whole row sorted
MIN_THREADS, MAX_THREADS = 128, 512  # a block a row (at least MAX_K threads)
VALUES_PER_THREAD = 16
SORT_THREADS = 1024
MAX_WIDTH = 32768  # 128 KB of keys; for the sort 192 KB of keys and 16-bit indices
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3


def top_k_plain(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices), each (..., k): the k largest logits, sorted
    descending, ties ordered by lower index first. torch.topk leaves the
    order of ties unspecified, so this takes a stable sort."""
    vals, idxs = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idxs[..., :k]


def padded_width(width: int) -> int:
    """The row padded to a power of two, as the sort takes it."""
    return 1 << max(0, width - 1).bit_length()


def row_threads(width: int, k: int = MAX_K) -> int:
    """Threads of the block that takes a row of `width`: for k <= MAX_K,
    about VALUES_PER_THREAD values each, whole warps, within [MIN_THREADS,
    MAX_THREADS]; for the sort, one a compare-exchange of the padded row,
    at most SORT_THREADS."""
    if k > MAX_K:
        return min(SORT_THREADS, padded_width(width) // 2)
    return min(MAX_THREADS, max(MIN_THREADS, (-(-width // VALUES_PER_THREAD) + 31) // 32 * 32))


def row_stride(logits: torch.Tensor) -> Optional[int]:
    """The elements between consecutive rows when the tensor is a stack of
    contiguous, evenly spaced rows of its last dimension, else None."""
    if logits.dim() == 0 or logits.stride(-1) != 1:
        return None
    dims = [(size, step) for size, step in zip(logits.shape[:-1], logits.stride()[:-1]) if size > 1]
    if not dims:
        return logits.shape[-1]
    expected = dims[-1][1]  # each leading dimension steps over the whole of the ones inside it
    for size, step in reversed(dims):
        if step != expected:
            return None
        expected = step * size
    return dims[-1][1]


def _check(logits: torch.Tensor, k: int) -> None:
    """Raise ValueError unless the kernel takes these logits with this k."""
    if logits.dtype != torch.float32:
        raise ValueError(f"top_k: the kernel takes float32 logits, got {logits.dtype}")
    stride = row_stride(logits)
    if stride is None:
        raise ValueError("top_k: each row must be contiguous and the rows evenly spaced, got "
                         f"shape {tuple(logits.shape)} strides {logits.stride()}")
    width = logits.shape[-1]
    if not 1 <= k <= width:
        raise ValueError(f"top_k: k must lie in [1, width {width}], got {k}")
    if width > MAX_WIDTH:
        raise ValueError(f"top_k: a row of {width} logits is past the kernel's {MAX_WIDTH}")
    if width > stride:
        raise ValueError(f"top_k: rows of {width} logits {stride} apart overlap")


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("top_k").top_k
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values (..., k) float32, indices (..., k) int64), each row's k
    largest logits, descending, the lower index first among equal values:
    `top_k_plain` for CPU tensors, else the kernels (the sort for k past
    MAX_K)."""
    if logits.device.type == "cpu":
        return top_k_plain(logits, k)
    _check(logits, k)
    *lead, width = logits.shape
    vals = torch.empty((*lead, k), dtype=torch.float32, device=logits.device)
    idxs = torch.empty((*lead, k), dtype=torch.int64, device=logits.device)
    rows = vals.numel() // k
    if rows == 0:
        return vals, idxs
    err = _entry()(logits.data_ptr(), row_stride(logits), rows, width, k,
                   row_threads(width, k), vals.data_ptr(), idxs.data_ptr(),
                   build.stream_handle(logits.device))
    build.check(err, "top_k kernel")
    build.count_launch(top_k)
    return vals, idxs


top_k.launches = 0
