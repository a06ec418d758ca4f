"""K6: absorbed multi-head latent attention for one decode step, the
wrapper of csrc/mla_decode.cu.

Replaces no TPU kernel: the JAX package has no latent attention. It serves
the DeepSeek-V2 trunk (models/mla_moe.py), whose decode reads a latent
cache (B, T, 576) a layer: the normalised 512-wide latent c and the
64-wide rotated key k_pe of each position, one row shared by all heads.
Each head's query is [q_lat (512) | q_pe (64)], its score against
position t is scale * q . cache[t], and its output o_lat = sum_t p(t) c_t
sums the latents alone (the first 512 values of each row): multi-query
attention at widths K1's bodies (head dims 16 and 32) do not reach.

Bound: bytes, (pos + 1) cache rows of 1,152 bytes a batch row. The design
note is at the top of the CUDA source: one block a batch row with all 16
heads as the M of the tensor-core products, so each cache row is read once
a row and not once a head; tiles of 32 positions through shared memory,
two in flight; an online softmax in float32; the output repeats bit for
bit. `pos` is a host int, or a one-element int32 tensor on the card read
by the kernel when it runs (the C entry `mla_decode_at`), so that a
captured CUDA graph replays the step at every position
(models/decode_graph.py).

`mla_decode` runs the plain version (`mla_decode_plain`) for CPU tensors
and the kernel for CUDA tensors of the configuration's form (bfloat16, 16
heads, rows of 576 with a 512-wide latent), with no fallback: any other
CUDA input raises. Launches are counted in `mla_decode.launches`, or in a
capture's recording (build.recording_launches), as K1's are.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from coati_tpu_torch.ops.kernels import build

LATENT = 512  # the width of c (DeepSeek-V2's); the rest of a row is the rotated key
HEADS, WIDTH = 16, 576  # the kernel's query heads and cache row (csrc/mla_decode.cu)
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 4
             + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_AT_ARGTYPES = _ARGTYPES[:9] + [ctypes.c_void_p] + _ARGTYPES[10:]


def mla_decode_plain(q: torch.Tensor, cache: torch.Tensor, pos, scale: float,
                     latent: int = LATENT) -> torch.Tensor:
    """q (B, H, W) against cache (B, T, W) over positions [0, pos], W =
    latent + rope width; the values are each row's first `latent` entries.
    Scores, softmax and the weighted sum in float32. Returns (B, H, latent)
    in q's dtype."""
    p = int(pos) if not isinstance(pos, torch.Tensor) else int(pos.reshape(-1)[0])
    kv = cache[:, : p + 1].float()
    s = torch.einsum("bhw,btw->bht", q.float(), kv) * scale
    return torch.einsum("bht,btc->bhc", s.softmax(-1), kv[..., :latent]).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(build.load("mla_decode"), name)
    fn.argtypes = _AT_ARGTYPES if name == "mla_decode_at" else _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, cache: torch.Tensor, pos, latent: int) -> None:
    if q.dim() != 3 or cache.dim() != 3 or q.shape[0] != cache.shape[0] \
            or q.shape[2] != cache.shape[2]:
        raise ValueError(f"mla_decode wants q (B, H, W) and a cache (B, T, W), got "
                         f"{tuple(q.shape)}, {tuple(cache.shape)}")
    if q.shape[1:] != (HEADS, WIDTH) or latent != LATENT:
        raise ValueError(f"mla_decode: the kernel takes {HEADS} heads of {WIDTH} with a "
                         f"{LATENT}-wide latent, got H {q.shape[1]}, W {q.shape[2]}, latent {latent}")
    if q.dtype != torch.bfloat16 or cache.dtype != q.dtype:
        raise TypeError(f"mla_decode takes a bfloat16 query and cache on the card, got {q.dtype} / "
                        f"{cache.dtype}")
    if not (q.device == cache.device) or q.device.type != "cuda":
        raise ValueError("mla_decode: q and the cache must lie on one CUDA device")
    if q.stride(-1) != 1 or cache.stride(-1) != 1 \
            or any(x % 8 for x in (*q.stride()[:2], *cache.stride()[:2])) \
            or q.data_ptr() % 16 or cache.data_ptr() % 16:
        raise ValueError("mla_decode: every row of q and of the cache must be contiguous and "
                         "start on a 16-byte boundary")
    t = cache.shape[1]
    if isinstance(pos, torch.Tensor):
        if pos.shape != (1,) or pos.dtype != torch.int32 or pos.device != q.device:
            raise ValueError("mla_decode: a position tensor must be one int32 on the query's "
                             f"device, got {tuple(pos.shape)} {pos.dtype} on {pos.device}")
    elif not isinstance(pos, int) or not 0 <= pos < t:
        raise ValueError(f"mla_decode: pos must be a host int in [0, {t}), got {pos!r}")


def mla_decode(q: torch.Tensor, cache: torch.Tensor, pos, scale: float,
               latent: int = LATENT) -> torch.Tensor:
    """Absorbed-MLA decode attention: q (B, H, 576) against the latent cache
    slice (B, T, 576) of one layer over positions [0, pos], `pos` a host int
    or a one-element int32 tensor on the query's device. Returns o_lat
    (B, H, 512) in q's dtype (512: `latent`)."""
    if q.device.type == "cpu":
        return mla_decode_plain(q, cache, pos, scale, latent)
    _check(q, cache, pos, latent)
    b, h, _ = q.shape
    out = torch.empty((b, h, latent), dtype=q.dtype, device=q.device)
    on_card = isinstance(pos, torch.Tensor)
    err = _entry("mla_decode_at" if on_card else "mla_decode")(
        q.data_ptr(), cache.data_ptr(), out.data_ptr(), b, cache.shape[1],
        q.stride(0), q.stride(1), cache.stride(0), cache.stride(1),
        pos.data_ptr() if on_card else pos, scale, build.stream_handle(q.device),
    )
    build.check(err, "mla_decode kernel")
    build.count_launch(mla_decode)
    return out


mla_decode.launches = 0
