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
K3's bf16-product mode runs on the tensor cores in a persistent grid with W2
resident in each block (`fwd_work_split`, `fwd_smem_bytes`); its output
repeats bit for bit. Its float32 mode runs on CUDA cores and adds each
tile's partial sums by shared-memory atomics. K4's bf16-product mode runs on
the tensor cores, in persistent clusters of
4 blocks that each own a quarter of W2's columns (`bwd_work_split`); da and
its parameter gradients are summed in a fixed order and repeat bit for bit,
while dc (float32 atomics, one per run of pairs with one partner) may
differ in its last bits between two runs on the same inputs. Its float32
mode runs on CUDA cores and adds dc and every parameter gradient by float32
atomics.
"""

from __future__ import annotations

import ctypes

import torch

from coati_tpu_torch.ops import egnn_messages as plain
from coati_tpu_torch.ops.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
MAX_SHARED_BYTES = 232448  # what one block may ask for on an H100
_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# K3's bf16-product body keeps W2 (Hp x Hp, Hp: Hm rounded up to 64) in
# shared memory, so Hm <= 256
FWD_MAX_HM = 256


_BWD_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# K4's bf16-product body: clusters of 4 blocks, each owning SW = Hp / 4
# columns of W2 (Hp: Hm rounded up to 128 or 256), so Hm <= 256
BWD_CLUSTER = 4
BWD_MAX_HM = 256
_SPLITS: dict = {}


def _library():
    lib = build.load("egnn_messages")
    lib.egnn_messages.argtypes = _ARGTYPES
    lib.egnn_messages.restype = ctypes.c_int
    lib.egnn_messages_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.egnn_messages_smem_bytes.restype = ctypes.c_longlong
    return lib


def _bwd_library():
    lib = build.load("egnn_messages_bwd")
    lib.egnn_messages_bwd.argtypes = _BWD_ARGTYPES
    lib.egnn_messages_bwd.restype = ctypes.c_int
    lib.egnn_messages_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.egnn_messages_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.egnn_messages_bwd_clusters.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.egnn_messages_bwd_clusters.restype = ctypes.c_int
    return lib


def fwd_padded_width(hm: int) -> int:
    """Width of the W2 and e1 tiles of K3's bf16 body: Hm rounded up to
    64; 0 above 256, which it refuses."""
    return -(-hm // 64) * 64 if hm <= FWD_MAX_HM else 0


def fwd_smem_bytes(n: int, hm: int) -> int:
    """Shared memory of one block of K3's bf16 body (csrc/egnn_messages.cu
    bf16_smem_bytes): W2 (Hp x Hp) and two 64-pair e1 tiles (64 x Hp) in
    bf16; in float32 the sums of the first and last atom of each of the 8
    row ranges (2 x 8 x Hp; the item's rows of w, 8 x N, while its pairs are
    listed), the item's a rows (8 x Hp), its pair list (8 N ints), the two
    chunks' row atoms and weights (2 x 64 each), and 24 counters."""
    hp = fwd_padded_width(hm)
    return 2 * hp * hp + 2 * 2 * 64 * hp + 4 * (max(16 * hp, 8 * n) + 8 * hp + 8 * n + 256 + 24)


def fwd_work_split(b: int, n: int, hm: int) -> dict:
    """How K3's bf16 body splits its work: the work items (molecule, 8
    atoms i), which the blocks of a persistent grid (as many as fit the card;
    one an SM at Hm 256) take in ranges of equal cost; the padded width; the
    warps of a block (one per 16 columns of z2); and the int64 costs, one an
    item, in the scratch the launch needs."""
    hp = fwd_padded_width(hm)
    items = b * -(-n // 8)
    return {"items": items, "padded_width": hp, "warps": hp // 16, "scratch_int64": items}


def bwd_slice_width(hm: int) -> int:
    """Columns of W2 one block of K4's bf16 body owns: a quarter of Hm
    rounded up to 128 (32) or 256 (64); 0 above 256, which it refuses."""
    return 32 if hm <= 128 else (64 if hm <= BWD_MAX_HM else 0)


def bwd_warps(hm: int) -> int:
    """Warps of a block of K4's bf16 body (csrc tc_warps): 16 when a block
    owns 64 columns, 8 when it owns 32."""
    return 16 if bwd_slice_width(hm) == 64 else 8


def bwd_smem_bytes(n: int, hm: int) -> int:
    """Shared memory of one block of K4's bf16 body
    (csrc/egnn_messages_bwd.cu bf16_smem_bytes): W2's column and row slices
    and the e1 and dz2 tiles of a 64-pair chunk in bf16; two buffers of the
    slice of c of a chunk's partners (rows padded by 8 floats), the work
    item's a and g rows, da's accumulators of each of the walk's row groups
    (one a slice width of threads) and the slice's vectors in float32; two
    buffers of a chunk's pairs; the item's rows of w and d2 and its list of
    live pairs."""
    sw = bwd_slice_width(hm)
    hp, groups = 4 * sw, 32 * bwd_warps(hm) // sw
    return (2 * (2 * hp * sw + 2 * 64 * hp)
            + 4 * (2 * 64 * (sw + 8) + (2 + groups) * 8 * sw + 3 * sw + 8 * 64) + 12 * 8 * n)


def bwd_work_split(b: int, n: int, hm: int, clusters: int) -> dict:
    """How K4's bf16 body splits its work when `clusters` clusters of 4
    blocks run at once: the work items (molecule, 8 atoms i), which the
    clusters take in ranges of equal cost, the columns a block owns, its
    warps, and the float32 scratch: the clusters' partial parameter
    gradients (Hp x Hp for dW2, then db2, db1, dwd), then an int64 cost an
    item (two floats)."""
    sw = bwd_slice_width(hm)
    hp = 4 * sw
    items = b * -(-n // 8)
    return {"items": items, "slice_width": sw, "padded_width": hp,
            "blocks": BWD_CLUSTER * clusters, "warps": bwd_warps(hm),
            "scratch_floats": clusters * (hp * hp + 3 * hp) + 2 * items}


def _bwd_clusters(lib, b: int, n: int, hm: int) -> int:
    """Clusters of K4's bf16 body that the card runs at once (the C side's
    occupancy query), cached by (device, N, Hm)."""
    key = (torch.cuda.current_device(), n, hm)
    if key not in _SPLITS:
        floats = ctypes.c_longlong(0)
        clusters = lib.egnn_messages_bwd_clusters(b, n, hm, ctypes.byref(floats))
        if clusters < 1:
            raise RuntimeError(
                f"egnn_messages_backward: no cluster of {BWD_CLUSTER} blocks fits the card at "
                f"N {n}, Hm {hm}")
        assert floats.value == bwd_work_split(b, n, hm, clusters)["scratch_floats"]
        _SPLITS[key] = clusters
    return _SPLITS[key]


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


def _check_bf16_width(a, mm_dtype, what: str, most: int) -> None:
    if mm_dtype == torch.bfloat16 and a.dim() == 3 and a.shape[-1] > most:
        raise ValueError(f"{what}: the bf16-product kernel takes Hm <= {most}, got {a.shape[-1]}")


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
    _check_bf16_width(a, mm_dtype, "egnn_messages", FWD_MAX_HM)  # before anything is built
    _check_inputs(a, c, d2, w, wd, b1, w2, b2, mm_dtype)
    b, n, hm = a.shape
    bf16 = mm_dtype == torch.bfloat16
    lib = _library()
    _check_shared(lib.egnn_messages_smem_bytes(n, hm, int(bf16)), n, hm, "egnn_messages")
    args = [x.detach().float().contiguous() for x in (a, c, d2, w, wd, b1, w2, b2)]
    extra = (None, None)
    if bf16:
        if args[1].data_ptr() % 16:  # the bf16 body reads rows of c 16 bytes at a time
            args[1] = args[1].clone()
        cost = torch.empty(fwd_work_split(b, n, hm)["scratch_int64"], dtype=torch.int64,
                           device=a.device)
        done = torch.zeros(1, dtype=torch.int32, device=a.device)
        extra = (cost.data_ptr(), done.data_ptr())
    out = torch.empty((b, n, hm), dtype=torch.float32, device=a.device)
    err = lib.egnn_messages(
        *(x.data_ptr() for x in args), out.data_ptr(), *extra, b, n, hm, int(bf16),
        build.stream_handle(a.device),
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
    bf16 = mm_dtype == torch.bfloat16
    _check_bf16_width(a, mm_dtype, "egnn_messages_backward", BWD_MAX_HM)
    lib = _bwd_library()
    _check_shared(lib.egnn_messages_bwd_smem_bytes(n, hm, int(bf16)), n, hm,
                  "egnn_messages_backward")
    af, cf, d2f, wf, wdf, b1f, w2f, b2f, gf = (
        x.detach().float().contiguous() for x in (a, c, d2, w, wd, b1, w2, b2, g)
    )
    if cf.data_ptr() % 16:  # the bf16 body copies rows of c 16 bytes at a time
        cf = cf.clone()
    dev = a.device
    da = torch.empty((b, n, hm), dtype=torch.float32, device=dev)
    dc = torch.zeros((b, n, hm), dtype=torch.float32, device=dev)  # the kernel adds into it
    if bf16:  # written once each, by the last block of each column slice
        dw2 = torch.empty((hm, hm), dtype=torch.float32, device=dev)
        dwd, db1, db2 = torch.empty((3, hm), dtype=torch.float32, device=dev).unbind(0)
        clusters = _bwd_clusters(lib, b, n, hm)
        scratch = torch.empty(bwd_work_split(b, n, hm, clusters)["scratch_floats"],
                              dtype=torch.float32, device=dev)
        done = torch.zeros(BWD_CLUSTER + 1, dtype=torch.int32, device=dev)
        extra = (scratch.data_ptr(), done.data_ptr(), clusters)
    else:  # added into by atomics
        dw2 = torch.zeros((hm, hm), dtype=torch.float32, device=dev)
        dwd, db1, db2 = torch.zeros((3, hm), dtype=torch.float32, device=dev).unbind(0)
        extra = (None, None, 0)
    err = lib.egnn_messages_bwd(
        *(x.data_ptr() for x in (af, cf, d2f, wf, wdf, b1f, w2f, b2f, gf)),
        *(x.data_ptr() for x in (da, dc, dwd, db1, dw2, db2)),
        *extra, b, n, hm, int(bf16), build.stream_handle(dev),
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
