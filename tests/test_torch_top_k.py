"""K7, the sampler's exact top k (coati_tpu_torch/ops/kernels/top_k.py,
csrc/top_k.cu), on the CPU: the kernel's algorithm emulated step for step
(the order keys, the floor from the warps' maxima, the list of values at or
above it and its sort, the radix select where the list overflows, the ties
taken in index order) against the plain version, the stable sort, on
adversarial rows; for k past 128, the bitonic sort of the whole row
emulated stage by stage; the inputs the kernels take on the card and those
they refuse; and the wrapper's stable sort on the CPU. The kernel itself is
held to the stable sort on the card by `chip_smoke.py top_k`."""

import numpy as np
import pytest
import torch

from coati_tpu_torch.ops.kernels import build
from coati_tpu_torch.ops.kernels import top_k as k7
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIGN, ALL = np.uint32(0x80000000), np.uint32(0xFFFFFFFF)
LIST_CAP = 512  # values at or above the floor the kernel ranks directly (csrc/top_k.cu kCap)


def order_keys(row: np.ndarray) -> np.ndarray:
    """csrc/top_k.cu `order_key` of each float32 value."""
    bits = row.view(np.uint32).copy()
    bits[bits == SIGN] = 0  # -0.0 is +0.0
    return np.where(bits & SIGN, bits ^ ALL, bits ^ SIGN).astype(np.uint32)


def k7_floor(keys: np.ndarray, k: int, off: int) -> np.uint32:
    """The kernel's floor: the row's keys in shared memory from position
    `off` (the row's start in 4-byte words modulo 4), thread t holding the
    16-byte groups t, t + threads, ...; of each warp's q-th largest thread
    maximum, the largest that at least k thread maxima reach."""
    width = keys.size
    threads = k7.row_threads(width)
    n_groups = (width + off + 3) // 4
    shared = np.zeros(-(-n_groups // threads) * threads * 4, np.uint32)
    shared[off:off + width] = keys  # 0 elsewhere: the least key, as the kernel's maxima start
    top = shared.reshape(-1, threads, 4).max(axis=(0, 2))
    n_warps = threads // 32
    q = -(-k // n_warps)
    offers = np.sort(top.reshape(n_warps, 32), axis=1)[:, ::-1][:, q - 1]
    return max(w for w in offers if (top >= w).sum() >= k)


def emulate_k7(row: np.ndarray, k: int, cap: int = LIST_CAP, off: int = 0):
    """One block of the kernel on one row: (values, indices, whether the
    radix select took the row: the floor the least key, or the list
    overflowed)."""
    width = row.size
    keys = order_keys(row)
    index = np.arange(width, dtype=np.uint64)
    composite = (keys.astype(np.uint64) << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - index)
    floor = k7_floor(keys, k, off)
    reach = keys >= floor
    overflow = floor == 0 or int(reach.sum()) > cap
    if not overflow:
        listed = composite[reach]
    else:
        prefix, mask, remaining = np.uint32(0), np.uint32(0), k
        for shift in (24, 16, 8, 0):
            live = keys[reach & ((keys & mask) == prefix)]
            hist = np.bincount((live >> np.uint32(shift)) & np.uint32(0xFF), minlength=256)
            above = 0
            for digit in range(255, -1, -1):
                if above + hist[digit] >= remaining:
                    break
                above += hist[digit]
            prefix |= np.uint32(digit << shift)
            mask |= np.uint32(0xFF << shift)
            remaining -= above
        ties = np.flatnonzero(keys == prefix)[:remaining]  # index order
        listed = np.concatenate([composite[keys > prefix], composite[ties]])
        assert listed.size == k
    first = np.sort(listed)[::-1][:k]
    idxs = (np.uint64(0xFFFFFFFF) - (first & np.uint64(0xFFFFFFFF))).astype(np.int64)
    return row[idxs], idxs, overflow


def emulate_sort(row: np.ndarray, k: int):
    """csrc/top_k.cu `top_k_sort_kernel` on one row: (values, indices)."""
    width = row.size
    n = k7.padded_width(width)
    keys = np.zeros(n, np.uint32)
    keys[:width] = order_keys(row)
    index = np.arange(n, dtype=np.uint16)
    size = 2
    while size <= n:
        stride = size // 2
        while stride > 0:
            i = np.arange(n // 2)
            lo = 2 * i - (i & (stride - 1))
            hi = lo + stride
            hi_first = (keys[hi] > keys[lo]) | ((keys[hi] == keys[lo]) & (index[hi] < index[lo]))
            swap = np.flatnonzero(hi_first == ((lo & size) == 0))
            keys[lo[swap]], keys[hi[swap]] = keys[hi[swap]], keys[lo[swap]].copy()
            index[lo[swap]], index[hi[swap]] = index[hi[swap]], index[lo[swap]].copy()
            stride //= 2
        size *= 2
    idxs = index[:k].astype(np.int64)
    return row[idxs], idxs


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _row(case: str, width: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    row = rng.normal(size=width).astype(np.float32) * 3
    if case == "tie_across_kth":  # 7 equal values straddle the 100th place
        row[:] = -rng.random(width).astype(np.float32) - 1
        row[rng.choice(width, 95, replace=False)] = 10 + rng.random(95).astype(np.float32)
        row[rng.choice(np.flatnonzero(row < 0), 7, replace=False)] = 5.0
    elif case == "signed_zeros":  # +0.0 and -0.0 across the cut: the index decides
        row[:] = -np.abs(row) - 1
        spots = rng.choice(width, min(150, width), replace=False)
        row[spots[::2]] = 0.0
        row[spots[1::2]] = -0.0
    elif case == "nan_inf":
        spots = rng.choice(width, min(40, width), replace=False)
        row[spots[::4]] = np.nan
        row[spots[1::4]] = np.inf
        row[spots[2::4]] = -np.inf
    elif case == "all_equal":
        row[:] = 1.5
    elif case == "all_neg_inf":
        row[:] = -np.inf
    elif case == "few_levels":  # ties everywhere (quantized logits)
        row = rng.integers(0, 6, size=width).astype(np.float32)
    elif case == "ascending":  # the largest values all in the last threads' chunks
        row = np.sort(row)
    return row


CASES = ("normal", "tie_across_kth", "signed_zeros", "nan_inf", "all_equal", "all_neg_inf",
         "few_levels", "ascending")


@pytest.mark.parametrize("width", [13603, 4266, 300])
@pytest.mark.parametrize("case", CASES)
def test_k7_emulation_equals_the_stable_sort(case, width):
    """Values (as bits) and indices equal the stable sort's on rows of
    COATI's and COATI2's vocabularies and a short one, k 100; with the list
    as the kernel sizes it, from each start modulo 16 bytes, and with a list
    of 100, which sends every row down the radix select."""
    row = _row(case, width, seed=width)
    ref_vals, ref_idxs = k7.top_k_plain(torch.from_numpy(row), 100)
    for cap, off in ((LIST_CAP, 0), (LIST_CAP, 1), (LIST_CAP, 3), (100, 2)):
        vals, idxs, overflow = emulate_k7(row, 100, cap, off)
        np.testing.assert_array_equal(_bits(vals), _bits(ref_vals.numpy()))
        np.testing.assert_array_equal(idxs, ref_idxs.numpy())
    assert overflow  # the list of 100 overflowed: the radix select took the row


@pytest.mark.parametrize("width,k", [(100, 100), (128, 128), (129, 128), (40, 7), (3, 2)])
@pytest.mark.parametrize("case", ["normal", "few_levels", "nan_inf", "signed_zeros"])
def test_k7_emulation_at_k_up_to_the_width(case, width, k):
    """k equal to the width, the largest k, and rows narrower than a block."""
    row = _row(case, width, seed=k)
    vals, idxs, _ = emulate_k7(row, k)
    ref_vals, ref_idxs = k7.top_k_plain(torch.from_numpy(row), k)
    np.testing.assert_array_equal(_bits(vals), _bits(ref_vals.numpy()))
    np.testing.assert_array_equal(idxs, ref_idxs.numpy())


@pytest.mark.parametrize("width,k", [(13603, 1000), (13603, 13603), (4266, 4266), (300, 129),
                                     (256, 200)])
@pytest.mark.parametrize("case", CASES)
def test_the_sort_past_128_equals_the_stable_sort(case, width, k):
    """k past 128, as the examples' bulk draws take (1,000, or the whole
    vocabulary): the bitonic network's first k equal the stable sort's, on
    rows padded to a power of two and on one that is not."""
    row = _row(case, width, seed=k)
    vals, idxs = emulate_sort(row, k)
    ref_vals, ref_idxs = k7.top_k_plain(torch.from_numpy(row), k)
    np.testing.assert_array_equal(_bits(vals), _bits(ref_vals.numpy()))
    np.testing.assert_array_equal(idxs, ref_idxs.numpy())


@pytest.mark.parametrize("width", [12, 100, 200, 13603])
def test_k7_orders_nan_by_its_bits_as_the_card_s_sort(width):
    """PyTorch's sort on the card orders by cub's radix keys at every width
    (held on the card from 8 values to 13,603): positive NaN above +inf,
    the higher payload first, negative NaN below -inf; the CPU's sort puts
    every NaN first, in index order, so only a row whose NaNs are all
    positive with one payload sorts alike on both."""
    specials = np.array([0x3F800000, 0xFFC00000, 0x7FC00000, 0xFF800000, 0x7F800000, 0x00000000,
                         0x80000000, 0x7FC00001, 0x80000000, 0x00000000], np.uint32).view(np.float32)
    row = np.full(width, -5.0, np.float32)
    row[:10] = specials
    _, idxs, _ = emulate_k7(row, 10)
    # +NaN (payload 1, then 0), +inf, 1.0, the four zeros by index, -5.0 ...
    assert idxs.tolist() == [7, 2, 4, 0, 5, 6, 8, 9, 10, 11][:10]
    _, idxs = emulate_sort(row, width)  # the sort orders them alike, -inf and -NaN last
    assert idxs.tolist()[:10] == [7, 2, 4, 0, 5, 6, 8, 9, 10, 11][:10]
    assert idxs.tolist()[-2:] == [3, 1]
    _, idxs, _ = emulate_k7(row, min(width, 128))
    if width <= 128:  # the whole row: -inf, then -NaN, last
        assert idxs.tolist()[-2:] == [3, 1]
    else:
        assert 3 not in idxs and 1 not in idxs
    assert k7.top_k_plain(torch.from_numpy(row), 3)[1].tolist() == [1, 2, 7]  # the CPU's order


def test_k7_floor_keeps_a_short_list_on_logit_like_rows():
    """The floor leaves 100 to about 200 values of a row to rank, under the
    list's 512, at COATI's and COATI2's widths."""
    for width in (13603, 4266):
        rng = np.random.default_rng(width)
        for row in (rng.normal(size=width), rng.gumbel(size=width), rng.standard_t(2, size=width)):
            keys = order_keys(row.astype(np.float32))
            for off in range(4):
                assert 100 <= int((keys >= k7_floor(keys, 100, off)).sum()) <= 250


def test_row_threads_are_whole_warps_about_16_values_each():
    assert k7.row_threads(13603) == 512
    assert k7.row_threads(4266) == 288
    assert k7.row_threads(13603, 1000) == 1024 and k7.padded_width(13603) == 16384
    assert k7.row_threads(300, 129) == 256 and k7.row_threads(256, 200) == 128
    assert k7.padded_width(k7.MAX_WIDTH) == k7.MAX_WIDTH == 32768
    for width in (1, 100, 128, 4096, 4097, 13603, 20000, k7.MAX_WIDTH):
        threads = k7.row_threads(width)
        assert threads % 32 == 0 and k7.MIN_THREADS <= threads <= k7.MAX_THREADS
        assert threads == k7.MAX_THREADS or threads * k7.VALUES_PER_THREAD >= width


def _meta(*shape):  # shapes and strides without memory
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("logits,k,rows_at,refused", [
    (_meta(1024, 13603), 100, 13603, None),  # COATI's decode step
    (_meta(1024, 4266), 100, 4266, None),  # COATI2's
    (_meta(65, 13603), 100, 13603, None),  # the serving engine's pool
    (_meta(2, 3, 300), 100, 300, None),  # 3-D: rows evenly spaced
    (_meta(8, 400)[:, :300], 100, 400, None),  # rows padded: a row stride of its own
    (_meta(4, k7.MAX_WIDTH), 128, k7.MAX_WIDTH, None),
    (_meta(4, 300), 129, 300, None),  # past 128: the sort
    (_meta(1024, 13603), 1000, 13603, None),  # the examples' bulk draws
    (_meta(4, k7.MAX_WIDTH), k7.MAX_WIDTH, k7.MAX_WIDTH, None),
    (_meta(2, 5, 300)[:, 1:3], 100, None, "evenly spaced"),
    (_meta(300, 8).t(), 100, None, "contiguous"),  # the last dimension not contiguous
    (_meta(8, 300)[:, ::2], 100, None, "contiguous"),
    (_meta(1, 300).expand(4, 300), 100, 0, "overlap"),  # every row the same memory
    (_meta(4, 300), 0, 300, "k must lie"),
    (_meta(4, 50), 100, 50, "k must lie"),  # k past the width (sample_top_k clamps it)
    (_meta(4, k7.MAX_WIDTH + 1), 100, k7.MAX_WIDTH + 1, "past the kernel"),  # past shared memory
    (_meta(), 1, None, "evenly spaced"),
    (_meta(1024, 13603).to(torch.bfloat16), 100, 13603, "float32"),
    (_meta(1024, 13603).to(torch.float64), 100, 13603, "float32"),
])
def test_the_kernels_take_or_refuse_by_shape(logits, k, rows_at, refused):
    """The inputs the kernels take on the card; for any other `top_k`
    raises a ValueError naming the limit, rather than sort the rows."""
    assert k7.row_stride(logits) == rows_at
    if refused is None:
        k7._check(logits, k)
    else:
        with pytest.raises(ValueError, match=refused):
            k7._check(logits, k)


def test_the_wrapper_on_the_cpu_is_the_stable_sort_and_builds_nothing(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a CPU call reached the CUDA build")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "load", no_build)
    before = k7.top_k.launches
    x = torch.from_numpy(np.random.default_rng(7).integers(0, 4, size=(6, 200)).astype(np.float32))
    for logits, k in ((x, 30), (x.view(2, 3, 200), 30), (x[:, 20:], 30),
                      (x.t().contiguous().t(), 30), (x[:, ::2], 30), (x.double(), 30), (x, 150)):
        vals, idxs = k7.top_k(logits, k)  # the card would refuse the strided and float64 rows
        ref_vals, ref_idxs = torch.sort(logits, dim=-1, descending=True, stable=True)
        assert torch.equal(vals, ref_vals[..., :k]) and torch.equal(idxs, ref_idxs[..., :k])
    assert k7.top_k.launches == before
