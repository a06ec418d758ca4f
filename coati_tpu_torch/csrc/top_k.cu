// K7: the exact k largest values of each row of a float32 matrix, sorted,
// for the sampler's top-k (coati_tpu_torch/ops/sampling.py).
//
// Replaces no TPU kernel: the JAX package takes lax.top_k there (or the
// TPU's lax.approx_max_k), which XLA lowers itself. The port's sampler
// needs, every decode step, the k (100) largest of each row's logits in
// descending order, the lower index first among equal values, exactly; a
// stable sort of the whole row gives that, and sorts the thousands of
// values that nobody reads.
//
// What bounds it on an H100: bytes. The useful work is one read of the
// logits (4 bytes a value) and k values and indices written a row; a few
// comparisons a value are far under the card's balance. At B 1024 x 13,603
// that read is 55.7 MB, about 0.017 ms at 3.35 TB/s.
//
// Order: the keys order as the stable radix sort PyTorch runs on the card
// (cub's) orders float32: each value's bits mapped to an unsigned key whose
// order is the values' (sign bit flipped for positives, every bit for
// negatives), -0.0 taken as +0.0 so that the index decides between them,
// NaN above +inf (negative NaN below -inf) and ordered by its bits, at every
// width (held against torch.sort on the card from 8 values to 13,603). The
// values written are the row's own, never the keys.
//
// Design (one block a row; its threads, a multiple of 32 from 128 to 512,
// about 16 values a thread, chosen by the wrapper from the width,
// ops/kernels/top_k.py `row_threads`):
//  * the row goes once from memory into shared memory as keys, in 16-byte
//    loads (the row's 16-byte-aligned groups of four values; the partial
//    groups at its two ends value by value), four groups a thread in
//    flight. The row (54 KB at 13,603 values) is the block's memory: three
//    blocks an SM at COATI's width, eight at COATI2's, so one block's load
//    overlaps another's work;
//  * a floor that at least k keys reach, from the threads' maxima: each
//    warp sorts its 32 maxima (bitonic, by shuffles) and offers its q-th
//    largest, q = ceil(k / warps); the floor is the largest offer that at
//    least k thread maxima reach, so at least k distinct values. The least
//    offer always qualifies: q threads of every warp reach it. On logits
//    about 1.2 k values of a row reach the floor;
//  * the keys at or above the floor go to a list in shared memory as 64-bit
//    composites (key << 32 | ~index): unique, and a larger composite is a
//    larger value or, between equal values, the lower index. Only threads
//    whose maximum reaches the floor look again at their groups, and each
//    value they keep takes a slot by a shared atomic;
//  * each composite's rank is counted against the whole list, and the k of
//    rank < k are written at their rank: values (read back from the row by
//    index) and indices, sorted;
//  * when the floor is the least key, or more than kCap keys reach it (rows
//    of many equal values), a radix select over the keys in shared memory,
//    8-bit digits most significant first with warp-aggregated shared
//    histograms, finds the k-th largest key; every key above it and the
//    first keys equal to it in index order (a block-wide count a chunk of
//    `threads` indices) make the k composites ranked as above.
// The atomics decide only where a composite sits in the list, not its
// rank: the output is the same bits every run. The kernel allocates nothing.
//
// k above 128 (the examples' bulk draws: k 1,000, or the whole vocabulary)
// is rare and not on the decode loop of the benchmarked round trips; there
// a second kernel, `top_k_sort_kernel`, sorts the whole row in shared memory
// by a bitonic network over (key, 16-bit index) pairs, the row padded to a
// power of two with pairs that order last, and writes the first k. The pairs
// are unique, so the network's order is the stable sort's. 6 bytes a value
// of the padded row: 96 KB at COATI's width, 192 KB at the widest, 32,768.
#include "common.cuh"

namespace {

constexpr int kMaxK = 128;        // the most values a row returns without the sort
constexpr int kMinThreads = 128;  // >= kMaxK: every warp's share of k fits its 32 lanes
constexpr int kMaxThreads = 512;
constexpr int kCap = 512;         // composites the floor's pass keeps in shared memory
constexpr int kDigits = 256;      // 8-bit digits: four passes of the radix select
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr size_t kMaxSharedBytes = 227 * 1024;  // a block's shared memory on an H100

static_assert(kMinThreads >= kMaxK && kCap >= kMaxK, "k fits the threads and the list");

// The order of `x` among float32 values as cub's radix sort keys it.
__device__ __forceinline__ unsigned order_key(float x) {
  unsigned b = __float_as_uint(x);
  if (b == 0x80000000u) b = 0u;  // -0.0 is +0.0
  return b ^ ((b & 0x80000000u) ? 0xFFFFFFFFu : 0x80000000u);
}

__device__ __forceinline__ unsigned long long compose(unsigned key, int index) {
  return (static_cast<unsigned long long>(key) << 32) | (kFull - static_cast<unsigned>(index));
}

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// Appends the items of the lanes that `take` to `list` at the shared
// `count`, one atomic a warp; slots from `cap` on are counted, not written.
__device__ __forceinline__ void append(bool take, unsigned long long item,
                                       unsigned long long* list, unsigned* count, unsigned cap,
                                       int lane) {
  const unsigned ballot = __ballot_sync(kFull, take);
  if (ballot == 0) return;
  const int leader = __ffs(ballot) - 1;
  unsigned base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(ballot));
  base = __shfl_sync(kFull, base, leader);
  const unsigned slot = base + __popc(ballot & lanes_below(lane));
  if (take && slot < cap) list[slot] = item;
}

// The warp's 32 values sorted descending, lane l holding the (l+1)-th.
__device__ __forceinline__ unsigned warp_sort_desc(unsigned v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned other = __shfl_xor_sync(kFull, v, stride);
      const bool descending = (lane & size) == 0;
      const bool low = (lane & stride) == 0;
      v = (low == descending) ? max(v, other) : min(v, other);
    }
  }
  return v;
}

struct Shared {
  unsigned long long list[kCap];
  unsigned hist[kDigits];
  unsigned warp_part[2][kMaxThreads / 32];
  unsigned reach[kMaxThreads / 32];  // the thread maxima at or above each warp's q-th
  unsigned pick[3];  // the chosen digit, the keys above it, the keys on it
  unsigned count;
};

// The row's keys in shared memory: the key of value j at keys[j + off],
// `off` the row's start in 4-byte words modulo 4, so that 16-byte groups of
// the row in memory are 16-byte groups here.
struct Row {
  const unsigned* keys;
  int width, off;
  __device__ __forceinline__ unsigned key(int j) const { return keys[j + off]; }
};

// The four values of group g (row positions 4 g - off ...), 0.0 outside the
// row: one 16-byte load for a whole group, else value by value.
__device__ __forceinline__ float4 load_group(const float* row, int g, int off, int width) {
  const int j = 4 * g - off;
  if (j >= 0 && j + 3 < width) return __ldg(reinterpret_cast<const float4*>(row + j));
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = j + e >= 0 && j + e < width ? __ldg(row + j + e) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The k composites of a row whose keys at or above `floor_key` overflowed
// the list: every key above the k-th largest and the first keys equal to it
// in index order, written to list[0, k).
__device__ void select_by_radix(const Row& r, int k, unsigned floor_key, Shared& sh) {
  const int nt = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5, n_warps = nt >> 5;
  unsigned prefix = 0, mask = 0, remaining = k, equal = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int d = t; d < kDigits; d += nt) sh.hist[d] = 0;
    __syncthreads();
    for (int base = 0; base < r.width; base += nt) {
      const int j = base + t;
      const unsigned key = j < r.width ? r.key(j) : 0u;
      const bool in = j < r.width && key >= floor_key && (key & mask) == prefix;
      if (__any_sync(kFull, in)) {
        const unsigned digit = in ? (key >> shift) & 0xFFu : kDigits;
        const unsigned peers = __match_any_sync(kFull, digit);
        if (in && lane == __ffs(peers) - 1) atomicAdd(&sh.hist[digit], __popc(peers));
      }
    }
    __syncthreads();
    if (warp == 0) {  // the digit holding the remaining-th largest: lane l reads digits 255 - 8l down
      unsigned c[8], sum = 0;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        c[s] = sh.hist[kDigits - 1 - 8 * lane - s];
        sum += c[s];
      }
      unsigned upto = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(kFull, upto, o);
        if (lane >= o) upto += v;
      }
      unsigned above = upto - sum;
      if (above < remaining && remaining <= upto) {
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          if (above + c[s] >= remaining) {
            sh.pick[0] = kDigits - 1 - 8 * lane - s;
            sh.pick[1] = above;
            sh.pick[2] = c[s];
            break;
          }
          above += c[s];
        }
      }
    }
    __syncthreads();
    prefix |= sh.pick[0] << shift;
    mask |= 0xFFu << shift;
    remaining -= sh.pick[1];
    equal = sh.pick[2];
  }
  // prefix is the k-th largest key; `remaining` keys equal to it are taken
  if (t == 0) sh.count = 0;
  __syncthreads();
  for (int base = 0; base < r.width; base += nt) {
    const int j = base + t;
    const unsigned key = j < r.width ? r.key(j) : 0u;
    append(j < r.width && key > prefix, compose(key, j), sh.list, &sh.count, kMaxK, lane);
    if (equal == remaining)  // all of them, in any slots
      append(j < r.width && key == prefix, compose(key, j), sh.list, &sh.count, kMaxK, lane);
  }
  // else the first `remaining` in index order, a chunk of nt indices at a time
  unsigned need = equal == remaining ? 0u : remaining;
  for (int base = 0, chunk = 0; need > 0 && base < r.width; base += nt, chunk ^= 1) {
    const int j = base + t;
    const bool tie = j < r.width && r.key(j) == prefix;
    const unsigned ballot = __ballot_sync(kFull, tie);
    if (lane == 0) sh.warp_part[chunk][warp] = __popc(ballot);
    __syncthreads();
    unsigned before = __popc(ballot & lanes_below(lane)), total = 0;
    for (int w = 0; w < n_warps; ++w) {
      const unsigned v = sh.warp_part[chunk][w];
      before += w < warp ? v : 0u;
      total += v;
    }
    if (tie && before < need) sh.list[k - need + before] = compose(r.key(j), j);
    need -= min(need, total);
  }
  __syncthreads();
}

constexpr int kBatch = 4;  // groups a thread loads before it converts any

__global__ void __launch_bounds__(kMaxThreads, 3)
top_k_kernel(const float* __restrict__ logits, long long row_stride, int width, int k,
             float* __restrict__ vals, long long* __restrict__ idxs) {
  extern __shared__ uint4 groups[];
  __shared__ Shared sh;
  const int nt = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5, n_warps = nt >> 5;
  const float* row = logits + static_cast<long long>(blockIdx.x) * row_stride;
  const int off = static_cast<int>((reinterpret_cast<unsigned long long>(row) >> 2) & 3);
  const int n_groups = (width + off + 3) / 4;
  if (t == 0) sh.count = 0;

  // the row into shared memory as keys (0, the least key, outside the row);
  // each thread's largest key
  unsigned top = 0;
  for (int base = t; base < n_groups; base += kBatch * nt) {
    float4 v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int g = base + b * nt;
      v[b] = g < n_groups ? load_group(row, g, off, width) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int g = base + b * nt;
      if (g >= n_groups) break;
      uint4 key = make_uint4(order_key(v[b].x), order_key(v[b].y), order_key(v[b].z),
                             order_key(v[b].w));
      const int j = 4 * g - off;
      if (j < 0 || j + 3 >= width) {  // a partial group at an end of the row
        key.x = j >= 0 && j < width ? key.x : 0u;
        key.y = j + 1 >= 0 && j + 1 < width ? key.y : 0u;
        key.z = j + 2 >= 0 && j + 2 < width ? key.z : 0u;
        key.w = j + 3 >= 0 && j + 3 < width ? key.w : 0u;
      }
      groups[g] = key;
      top = max(top, max(max(key.x, key.y), max(key.z, key.w)));
    }
  }

  // the floor: of the warps' q-th largest thread maxima, the largest that
  // at least k thread maxima reach (the least of them always does)
  const int q = (k + n_warps - 1) / n_warps;
  const unsigned warp_q = __shfl_sync(kFull, warp_sort_desc(top, lane), q - 1);
  if (lane == 0) sh.warp_part[0][warp] = warp_q;
  if (t < n_warps) sh.reach[t] = 0;
  __syncthreads();
  for (int w = 0; w < n_warps; ++w) {
    const unsigned reach = __popc(__ballot_sync(kFull, top >= sh.warp_part[0][w]));
    if (lane == 0) atomicAdd(&sh.reach[w], reach);
  }
  __syncthreads();
  unsigned floor_key = 0;
  for (int w = 0; w < n_warps; ++w)
    if (sh.reach[w] >= static_cast<unsigned>(k)) floor_key = max(floor_key, sh.warp_part[0][w]);

  // the keys at or above a floor above 0 (so no padding) into the list, by
  // the threads that hold any
  if (floor_key > 0 && top >= floor_key) {
    for (int g = t; g < n_groups; g += nt) {
      const uint4 key = groups[g];
      const unsigned four[4] = {key.x, key.y, key.z, key.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (four[e] >= floor_key) {
          const unsigned slot = atomicAdd(&sh.count, 1u);
          if (slot < kCap) sh.list[slot] = compose(four[e], 4 * g - off + e);
        }
      }
    }
  }
  __syncthreads();
  unsigned n = sh.count;
  if (floor_key == 0 || n > kCap) {
    __syncthreads();  // every thread has read the count
    const Row r{reinterpret_cast<const unsigned*>(groups), width, off};
    select_by_radix(r, k, floor_key, sh);
    n = k;
  }

  // each composite's rank among the n; the k first are written at their rank
  const long long out = static_cast<long long>(blockIdx.x) * k;
  for (unsigned p = t; p < n; p += nt) {
    const unsigned long long mine = sh.list[p];
    unsigned rank = 0;
#pragma unroll 4
    for (unsigned s = 0; s < n; ++s) rank += sh.list[s] > mine;
    if (rank < static_cast<unsigned>(k)) {
      const int i = static_cast<int>(kFull - static_cast<unsigned>(mine));
      vals[out + rank] = row[i];
      idxs[out + rank] = i;
    }
  }
}

constexpr int kSortThreads = 1024;
constexpr int kMaxSortWidth = 32768;  // 16-bit indices, padding included

// Whether pair a orders before pair b: the larger key, or between equal
// keys the lower index.
__device__ __forceinline__ bool before(unsigned key_a, unsigned index_a, unsigned key_b,
                                       unsigned index_b) {
  return key_a > key_b || (key_a == key_b && index_a < index_b);
}

// k > kMaxK: the row's (key, index) pairs, padded to `n` (a power of two)
// with key 0 and the indices past the row, sorted descending by a bitonic
// network in shared memory, a thread for each compare-exchange of a stage;
// the first k written.
__global__ void __launch_bounds__(kSortThreads)
top_k_sort_kernel(const float* __restrict__ logits, long long row_stride, int width, int n, int k,
                  float* __restrict__ vals, long long* __restrict__ idxs) {
  extern __shared__ unsigned keys[];  // n keys, then n 16-bit indices
  unsigned short* index = reinterpret_cast<unsigned short*>(keys + n);
  const int nt = blockDim.x, t = threadIdx.x;
  const float* row = logits + static_cast<long long>(blockIdx.x) * row_stride;
  for (int j = t; j < n; j += nt) {
    keys[j] = j < width ? order_key(__ldg(row + j)) : 0u;
    index[j] = static_cast<unsigned short>(j);
  }
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < n / 2; i += nt) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const unsigned key_lo = keys[lo], key_hi = keys[hi], index_lo = index[lo],
                       index_hi = index[hi];
        // descending where lo's bit `size` is clear (always at size n)
        if (before(key_hi, index_hi, key_lo, index_lo) == ((lo & size) == 0)) {
          keys[lo] = key_hi;
          keys[hi] = key_lo;
          index[lo] = static_cast<unsigned short>(index_hi);
          index[hi] = static_cast<unsigned short>(index_lo);
        }
      }
      __syncthreads();
    }
  }
  const long long out = static_cast<long long>(blockIdx.x) * k;
  for (int p = t; p < k; p += nt) {
    const int i = index[p];
    vals[out + p] = row[i];
    idxs[out + p] = i;
  }
}

// Shared memory for a row's keys: its 16-byte groups, a partial one at each end.
size_t key_bytes(int width) { return static_cast<size_t>(width + 6) / 4 * sizeof(uint4); }

// Allows `kernel` `bytes` of dynamic shared memory, once a device.
int allow_shared(const void* kernel, int bytes, bool* ready) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// logits: `rows` rows of `width` contiguous float32 values, row r at
// r * row_stride elements. vals (rows, k) float32 and idxs (rows, k) int64,
// contiguous: each row's k largest values, descending, the lower index
// first among equal values. 1 <= k <= width. For k <= 128: `threads` a
// multiple of 32 in [128, 512], and the row's keys must fit the block's
// shared memory; for k > 128, width <= 32,768 and `threads` the half of the
// row padded to a power of two, at most 1024. Returns a cudaError_t.
extern "C" int top_k(const void* logits, long long row_stride, int rows, int width, int k,
                     int threads, void* vals, void* idxs, void* stream) {
  if (rows < 1 || k < 1 || k > width || row_stride < width)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto in = static_cast<const float*>(logits);
  const auto out_vals = static_cast<float*>(vals);
  const auto out_idxs = static_cast<long long*>(idxs);
  if (k > kMaxK) {
    int n = 1;
    while (n < width) n <<= 1;
    if (width > kMaxSortWidth || threads != (n / 2 < kSortThreads ? n / 2 : kSortThreads))
      return static_cast<int>(cudaErrorInvalidValue);
    static bool ready[64] = {};
    const int err = allow_shared(reinterpret_cast<const void*>(top_k_sort_kernel),
                                 kMaxSortWidth * 6, ready);
    if (err != static_cast<int>(cudaSuccess)) return err;
    top_k_sort_kernel<<<rows, threads, static_cast<size_t>(n) * 6, s>>>(
        in, row_stride, width, n, k, out_vals, out_idxs);
    return static_cast<int>(cudaGetLastError());
  }
  if (threads < kMinThreads || threads > kMaxThreads || threads % 32 != 0 ||
      key_bytes(width) + sizeof(Shared) > kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  // rows past 48 KB of keys: allow a block all it may take
  static bool ready[64] = {};
  const int err = allow_shared(reinterpret_cast<const void*>(top_k_kernel),
                               static_cast<int>(kMaxSharedBytes - sizeof(Shared)), ready);
  if (err != static_cast<int>(cudaSuccess)) return err;
  top_k_kernel<<<rows, threads, key_bytes(width), s>>>(in, row_stride, width, k, out_vals,
                                                       out_idxs);
  return static_cast<int>(cudaGetLastError());
}
