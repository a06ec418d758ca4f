// K1: masked-read decode attention over a KV cache (one query per row).
//
// Replaces the TPU kernel coati_tpu/ops/pallas/decode_attention.py
// (decode_attention_pallas / decode_attention_pallas_quant ->
// _decode_pallas -> _kernel). Same function: the query of each batch row
// attends to cache positions [0, pos] only, with an online softmax in
// float32. For an int8 cache, per-(token, head) k-scales multiply the
// scores and v-scales fold into the probabilities before the value sum:
//   q . (k8 * ks) = (q . k8) * ks,  sum_s p_s (v8_s vs_s) = sum_s (p_s vs_s) v8_s.
//
// What bounds it on an H100: bytes. One query per row makes it a
// matrix-vector product a row: 4 * (pos+1) * H * Dh operations against
// (pos+1) * H * (2 Dh + 2 scales) bytes of an int8 cache, about one
// operation per byte, where the bf16 ridge is near 300. Tensor cores do
// not help; what the card needs is wide, coalesced loads and enough bytes
// in flight on every SM. Positions past pos are never loaded.
//
// Design:
//  * the unit of work is (row, head, position). A thread holds 16 bytes of
//    one head's vectors: a whole head at int8 and Dh 16 (16 elements), half
//    of one in bf16, a quarter in float32 (twice as many threads at Dh
//    32). It loads its K and V segments of a position with one 16-byte load
//    each, and the position's scales; its part of the dot is a chain of
//    FMAs in registers, summed over the item's threads by xor shuffles
//    (none at int8 and Dh 16), and it takes one exponential an item;
//  * int8 becomes float by a byte permute into the mantissa of 2^23 and
//    one subtraction (exact), not by the quarter-rate conversion unit;
//  * a row's threads are G groups of H * Dh / (16-byte segment) threads:
//    group g takes positions g, g + G, g + 2G, ..., so the lanes of a warp
//    read consecutive 16-byte segments of (position, head) pairs, 512
//    contiguous bytes of the row's cache a load, and its scales alike;
//  * each thread loads a chunk of 2 positions before it uses any, and the
//    next chunk before it works on this one (its first chunk before its
//    query): 4 positions in flight. It keeps its own (m, l, acc) and
//    rescales once per chunk;
//  * the states are merged in a fixed order, with no atomics: xor shuffles
//    between the lanes of one segment in a warp (when a group is a power
//    of two below 32 lanes), then shared memory across the row's warps,
//    summed in warp order. The output repeats bit for bit;
//  * G grows (doubling, at most 256 threads a row) while every group still
//    has a position and all rows' threads fit on the card at once, by the
//    kernel's occupancy (at least two blocks an SM: at most 128 registers):
//    one wave at B 1024 (G 4 for int8 at H 16, Dh 16). Rows of fewer than
//    256 threads share a block;
//  * two entries. `decode_attention` takes pos as a host int passed by
//    value: launching needs no device sync. `decode_attention_at` reads pos
//    from one int32 on the card (each thread loads it once, clamped to the
//    cache), so that a captured CUDA graph serves every position: there G
//    is chosen by the same rule for a position the caller names
//    (`group_pos`, the last one the graph runs), not for pos. A group
//    with no position at or below pos takes no items and merges as an
//    empty state (m = kNegInf, l = 0, acc = 0), which adds nothing: where
//    both entries take the same G they give the same bits. The kernel
//    allocates nothing.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBlock = 256;       // threads a block at most (whole rows)
constexpr int kChunkBytes = 32;   // bytes of K a thread loads a chunk: 2 positions
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The N elements of T held in N * sizeof(T) / 16 16-byte words, as floats.
template <int N>
__device__ __forceinline__ void unpack(const uint4* raw, float* out, int8_t) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    // b + 128 into the low mantissa byte of 2^23, then 2^23 + 128 off: exact
    const uint32_t x = word(raw[i / 4], i % 4) ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u + j)) - 8388736.f;
  }
}

template <int N>
__device__ __forceinline__ void unpack(const uint4* raw, float* out, __nv_bfloat16) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const uint32_t x = word(raw[i / 4], i % 4);
    out[2 * i] = __uint_as_float(x << 16);
    out[2 * i + 1] = __uint_as_float(x & 0xFFFF0000u);
  }
}

template <int N>
__device__ __forceinline__ void unpack(const uint4* raw, float* out, float) {
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = __uint_as_float(word(raw[i / 4], i % 4));
}

// One 16-byte segment of a head's vector: 16 int8, 8 bf16 or 4 float32
// elements. A (row, head, position) item is Dh / kE segments, one a thread
// (one thread an item at int8 and Dh 16).
template <typename KT>
__host__ __device__ constexpr int elems() {
  return 16 / static_cast<int>(sizeof(KT));
}

// A chunk of positions of one thread's segment: its K and V words and, for
// an int8 cache, their scales (the same for all segments of an item)
template <typename KT, typename ST, bool QUANT>
struct Chunk {
  static constexpr int kSize = kChunkBytes / 16;  // positions loaded before any is used
  uint4 k[kSize], v[kSize];
  float ks[kSize], vs[kSize];

  // items i0 .. i0 + kSize - 1 of the thread: item i's segment at element
  // first + i * step of the cache, its scales at scale_first + i *
  // scale_step; none at n or past it is read
  __device__ __forceinline__ void load(const KT* kc, const KT* vc, const ST* ksc,
                                       const ST* vsc, long long first, long long step,
                                       long long scale_first, long long scale_step, int i0,
                                       int n) {
#pragma unroll
    for (int j = 0; j < kSize; ++j) {
      const bool ok = i0 + j < n;
      const long long at = first + (i0 + j) * step;
      k[j] = ok ? __ldg(reinterpret_cast<const uint4*>(kc + at)) : make_uint4(0, 0, 0, 0);
      v[j] = ok ? __ldg(reinterpret_cast<const uint4*>(vc + at)) : make_uint4(0, 0, 0, 0);
      if (QUANT) {
        const long long sat = scale_first + (i0 + j) * scale_step;
        ks[j] = ok ? coati::to_float(__ldg(ksc + sat)) : 0.f;
        vs[j] = ok ? coati::to_float(__ldg(vsc + sat)) : 0.f;
      }
    }
  }

  // the online softmax over the chunk's items below n: the segments' dots
  // summed over the item's `split` lanes (xor shuffles within `mask`), one
  // rescale of (m, l, acc), one exponential an item
  template <int E>
  __device__ __forceinline__ void consume(const float (&qf)[E], int split, unsigned mask,
                                          int i0, int n, float& m, float& l,
                                          float (&acc)[E]) const {
    float sc[kSize];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kSize; ++j) {
      float kf[E];
      unpack<E>(&k[j], kf, KT());
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < E; ++d) dot = fmaf(qf[d], kf[d], dot);
      for (int off = split / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(mask, dot, off);
      sc[j] = i0 + j < n ? (QUANT ? dot * ks[j] : dot) : coati::kNegInf;
      m_new = fmaxf(m_new, sc[j]);
    }
    const float alpha = coati::exp2_fast(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < E; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kSize; ++j) {
      const float p = coati::exp2_fast(sc[j] - m_new);
      l += p;
      const float w = QUANT ? p * vs[j] : p;
      float vf[E];
      unpack<E>(&v[j], vf, KT());
#pragma unroll
      for (int d = 0; d < E; ++d) acc[d] = fmaf(w, vf[d], acc[d]);
    }
    m = m_new;
  }
};

// two blocks an SM at least: at most 128 registers a thread
template <typename QT, typename KT, typename ST, int DH, bool QUANT>
__global__ void __launch_bounds__(kBlock, 2)
    decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                  const KT* __restrict__ v, const ST* __restrict__ k_scale,
                  const ST* __restrict__ v_scale, QT* __restrict__ o, int batch, int width,
                  int heads, int groups, int pos, const int* __restrict__ pos_at,
                  float scale_log2) {
  using Items = Chunk<KT, ST, QUANT>;
  constexpr int kC = Items::kSize;
  constexpr int kE = elems<KT>();   // elements a thread holds of a head
  constexpr int kSplit = DH / kE;   // threads an item
  constexpr int kQWords = kE * static_cast<int>(sizeof(QT)) / 16;  // 16-byte loads of q
  constexpr int kStride = kE + 3;  // a state in shared memory: m, l, acc, one pad (odd)
  __shared__ float states[kBlock * kStride];

  const int span = heads * kSplit;  // threads a group
  const int row_threads = groups * span;
  const int r = threadIdx.x / row_threads;  // row of the block
  const int t = threadIdx.x - r * row_threads;
  const int part = t % kSplit;  // the thread's segment of its head
  const int h = t / kSplit % heads;
  const int g = t / span;
  const int b = blockIdx.x * (kBlock / row_threads) + r;
  const bool live = b < batch;
  // an item's lanes: kSplit consecutive lanes of one warp
  const int lane = threadIdx.x % 32;
  const unsigned mask = ((1u << kSplit) - 1) << (lane / kSplit * kSplit);
  if (pos_at != nullptr) pos = min(max(__ldg(pos_at), 0), width - 1);

  // positions g, g + G, ... <= pos; segment `part` of item (b, s, h)
  const int n = (live && g <= pos) ? (pos - g) / groups + 1 : 0;
  const long long scale_first = (static_cast<long long>(b) * width + g) * heads + h;
  const long long scale_step = static_cast<long long>(groups) * heads;
  const long long first = scale_first * DH + part * kE;
  const long long step = scale_step * DH;

  // the first chunk and q in flight together; two chunks in flight after
  Items a, c;
  a.load(k, v, k_scale, v_scale, first, step, scale_first, scale_step, 0, n);
  float qf[kE];
  {
    uint4 raw[kQWords];
    const long long row = live ? b : 0;
    const uint4* qp = reinterpret_cast<const uint4*>(q + (row * heads + h) * DH + part * kE);
#pragma unroll
    for (int u = 0; u < kQWords; ++u) raw[u] = __ldg(qp + u);
    unpack<kE>(raw, qf, QT());
#pragma unroll
    for (int d = 0; d < kE; ++d) qf[d] *= scale_log2;  // scores in base 2
  }

  float m = coati::kNegInf, l = 0.f, acc[kE];
#pragma unroll
  for (int d = 0; d < kE; ++d) acc[d] = 0.f;
  for (int i0 = 0; i0 < n; i0 += 2 * kC) {
    c.load(k, v, k_scale, v_scale, first, step, scale_first, scale_step, i0 + kC, n);
    a.consume(qf, kSplit, mask, i0, n, m, l, acc);
    a.load(k, v, k_scale, v_scale, first, step, scale_first, scale_step, i0 + 2 * kC, n);
    if (i0 + kC < n) c.consume(qf, kSplit, mask, i0 + kC, n, m, l, acc);
  }

  // merge 1: the lanes of one segment in a warp (span a power of two below
  // 32; then a row is whole warps), by xor shuffles
  int lanes = 1;  // groups merged into each state
  if (span < 32 && (span & (span - 1)) == 0) {
    for (int off = 16; off >= span; off >>= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
      const float m_n = fmaxf(m, m_o);
      const float c0 = coati::exp2_fast(m - m_n), c1 = coati::exp2_fast(m_o - m_n);
      l = l * c0 + l_o * c1;
#pragma unroll
      for (int d = 0; d < kE; ++d) {
        const float a_o = __shfl_xor_sync(0xffffffffu, acc[d], off);
        acc[d] = acc[d] * c0 + a_o * c1;
      }
      m = m_n;
    }
    lanes = 32 / span;
  }
  // merge 2: the row's states in shared memory, state (r, k, h, part) for
  // the k-th warp (or group) of the row; summed in k order
  const int per_segment = groups / lanes;
  if (g % lanes == 0) {
    float* st = states + ((r * per_segment + g / lanes) * span + h * kSplit + part) * kStride;
    st[0] = m;
    st[1] = l;
#pragma unroll
    for (int d = 0; d < kE; ++d) st[2 + d] = acc[d];
  }
  __syncthreads();
  if (!live) return;
  for (int e = t; e < heads * DH; e += row_threads) {
    const int hh = e / DH, d = e % DH;
    const float* st = states + (r * per_segment * span + hh * kSplit + d / kE) * kStride;
    const int next = span * kStride;
    float m_all = coati::kNegInf;
    for (int kk = 0; kk < per_segment; ++kk) m_all = fmaxf(m_all, st[kk * next]);
    float l_all = 0.f, a_all = 0.f;
    for (int kk = 0; kk < per_segment; ++kk) {
      const float c0 = coati::exp2_fast(st[kk * next] - m_all);
      l_all += st[kk * next + 1] * c0;
      a_all += st[kk * next + 2 + d % kE] * c0;
    }
    o[(static_cast<long long>(b) * heads + hh) * DH + d] = coati::from_float<QT>(a_all / l_all);
  }
}

// Groups G of a row of `span` threads a group: the least that makes whole
// warps (32 / span for span a power of two below 32, else 1), doubled while
// a row stays within a block, every group has a position in [0, pos], and
// all rows' threads fit on the card at once (`resident` threads).
int row_groups(int batch, int span, int pos, long long resident) {
  int g = (span < 32 && (span & (span - 1)) == 0) ? 32 / span : 1;
  while (2 * g * span <= kBlock && 2 * g <= pos + 1 &&
         static_cast<long long>(batch) * 2 * g * span <= resident)
    g *= 2;
  return g;
}

// A call of either entry: the tensors, the shape, the position (`pos`, or
// the int32 at `pos_at` on the card), the position G is chosen for, and
// the stream. With `groups_out` set, G is written there and nothing runs.
struct Call {
  const void *q, *k, *v, *ks, *vs;
  void* o;
  int batch, width, heads, head_dim, pos;
  const int* pos_at;
  int group_pos;
  float scale;
  cudaStream_t stream;
  int* groups_out;
};

template <typename QT, typename KT, typename ST, int DH, bool QUANT>
int launch_dh(const Call& c) {
  auto kernel = decode_kernel<QT, KT, ST, DH, QUANT>;
  static long long resident = 0;  // threads of this kernel the card holds at once
  if (resident == 0) {
    int device = 0, sms = 0, blocks = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kBlock, 0);
    resident = static_cast<long long>(sms) * blocks * kBlock;
  }
  const int span = c.heads * DH / elems<KT>();  // threads a group: one a 16-byte segment
  const int groups = row_groups(c.batch, span, c.group_pos, resident);
  if (c.groups_out != nullptr) {
    *c.groups_out = groups;
    return 0;
  }
  const int rows = kBlock / (groups * span);  // rows a block
  const int grid = (c.batch + rows - 1) / rows;
  kernel<<<grid, rows * groups * span, 0, c.stream>>>(
      static_cast<const QT*>(c.q), static_cast<const KT*>(c.k), static_cast<const KT*>(c.v),
      static_cast<const ST*>(c.ks), static_cast<const ST*>(c.vs), static_cast<QT*>(c.o),
      c.batch, c.width, c.heads, groups, c.pos, c.pos_at, c.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT, typename ST, bool QUANT>
int launch(const Call& c) {
  if (c.heads < 1 || c.heads * c.head_dim > 1024) return static_cast<int>(cudaErrorInvalidValue);
  switch (c.head_dim) {
    case 16:
      return launch_dh<QT, KT, ST, 16, QUANT>(c);
    case 32:
      return launch_dh<QT, KT, ST, 32, QUANT>(c);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename QT>
int launch_quant(const Call& c, int scale_dtype) {
  if (scale_dtype == coati::kF32) return launch<QT, int8_t, float, true>(c);
  if (scale_dtype == coati::kBF16) return launch<QT, int8_t, __nv_bfloat16, true>(c);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(const Call& c, int q_dtype, int kv_dtype, int scale_dtype) {
  if (kv_dtype == coati::kI8) {
    if (q_dtype == coati::kF32) return launch_quant<float>(c, scale_dtype);
    if (q_dtype == coati::kBF16) return launch_quant<__nv_bfloat16>(c, scale_dtype);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kv_dtype != q_dtype) return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == coati::kF32) return launch<float, float, float, false>(c);
  if (q_dtype == coati::kBF16) return launch<__nv_bfloat16, __nv_bfloat16, float, false>(c);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (B, H, Dh) contiguous; k, v: contiguous (B, width, H, Dh) cache slices;
// ks, vs: contiguous (B, width, H) scales for an int8 cache, else null;
// o: (B, H, Dh) in q's dtype. q, k, v must be 16-byte aligned. Attends
// positions [0, pos]. Returns a cudaError_t.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs, void* o, int batch,
                                int width, int heads, int head_dim, int pos, int q_dtype,
                                int kv_dtype, int scale_dtype, float scale,
                                void* stream) {
  const Call c{q, k, v, ks, vs, o, batch, width, heads, head_dim, pos, nullptr, pos,
               scale, static_cast<cudaStream_t>(stream), nullptr};
  return dispatch(c, q_dtype, kv_dtype, scale_dtype);
}

// decode_attention with pos read on the card from the int32 at `pos` (as
// it is when the kernel runs: a captured graph replays it at each step's
// position) and G chosen for the host int `group_pos`.
extern "C" int decode_attention_at(const void* q, const void* k, const void* v,
                                   const void* ks, const void* vs, void* o, int batch,
                                   int width, int heads, int head_dim, const int* pos,
                                   int group_pos, int q_dtype, int kv_dtype, int scale_dtype,
                                   float scale, void* stream) {
  const Call c{q, k, v, ks, vs, o, batch, width, heads, head_dim, 0, pos, group_pos,
               scale, static_cast<cudaStream_t>(stream), nullptr};
  return dispatch(c, q_dtype, kv_dtype, scale_dtype);
}

// The groups G a row takes at position `pos` (the host entry's rule) for
// this form and shape, in `*groups`; launches nothing. Returns a cudaError_t.
extern "C" int decode_attention_groups(int batch, int heads, int head_dim, int pos,
                                       int q_dtype, int kv_dtype, int scale_dtype,
                                       int* groups) {
  const Call c{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, batch, 0, heads,
               head_dim, pos, nullptr, pos, 0.f, nullptr, groups};
  return dispatch(c, q_dtype, kv_dtype, scale_dtype);
}
