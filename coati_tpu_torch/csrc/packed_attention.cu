// K5f: causal multi-head attention for short sequences, T <= 128 (forward).
//
// Replaces the TPU kernel coati_tpu/ops/pallas/packed_attention.py
// (packed_causal_attention -> _packed_forward -> _packed_kernel). Same
// function as K2 (flash_attention.cu): o = softmax(q k^T / sqrt(Dh) +
// causal mask) v per (row, head), softmax in float32, output in the input
// dtype, and no (B, H, T, T) tensor in device memory. The TPU kernel packed
// all heads into block-diagonal K/V to fill its 128 lanes; that layout
// answers the TPU's matrix unit and is not carried over.
//
// What it is against K2: the sequence is short enough that a block stages
// the K and V of its heads in shared memory once, whole, and a query row's
// scores (at most 128) fit in the registers of one warp, four per lane. So
// the scores of a row are complete before its softmax: no key tiles, no
// running maximum, no rescaling of a partial sum.
//
// What bounds it on an H100: bytes, as K2 (q, k, v read once, o written
// once; a few operations per byte at Dh = 16).
//
// Design:
//  * one block per (batch row, group of heads); the wrapper picks the group
//    so that the staged K and V (float32, rows padded by one float against
//    bank conflicts) stay under 28 KB and eight blocks share an SM;
//  * one warp per (head, query row) at a time: lane l owns keys l, l + 32,
//    l + 64, l + 96 up to the row's own position, computes their scores
//    against the row's q (read by broadcast), and the warp takes the
//    maximum and the sum by shuffles;
//  * the probabilities go to a per-warp strip of shared memory; for p @ v
//    the lanes split over the Dh output columns (and, where Dh < 32, over
//    32/Dh interleaved sets of keys that a shuffle then adds up);
//  * q, k, v are taken by (batch, token) strides with heads packed, so the
//    views split out of the fused qkv projection are read in place.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxT = 128;        // the longest sequence this kernel takes
constexpr int kChunks = kMaxT / 32;  // scores per lane
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block can ask for
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) packed_causal_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int seq, int heads, int group, long long q_sb, long long q_st,
    long long k_sb, long long k_st, long long v_sb, long long v_st, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DP = DH + 1;  // padded row of K and V
  float* ks = smem;                    // [group][seq][DP]
  float* vs = ks + group * seq * DP;   // [group][seq][DP]
  float* ps = vs + group * seq * DP;   // [kWarps][kMaxT]
  float* qs = ps + kWarps * kMaxT;     // [kWarps][DH]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int h0 = blockIdx.x * group;

  const T* qb = q + b * q_sb + h0 * DH;
  const T* kb = k + b * k_sb + h0 * DH;
  const T* vb = v + b * v_sb + h0 * DH;

  // stage K and V of the group's heads once: a token's group * DH elements
  // are contiguous in memory
  const int gw = group * DH;
  for (int e = tid; e < seq * gw; e += kThreads) {
    const int t = e / gw;
    const int x = e - t * gw;
    const int g = x / DH;
    const int d = x - g * DH;
    const int at = (g * seq + t) * DP + d;
    ks[at] = coati::to_float(kb[t * k_st + x]);
    vs[at] = coati::to_float(vb[t * v_st + x]);
  }
  __syncthreads();

  float* pw = ps + warp * kMaxT;
  float* qw = qs + warp * DH;
  constexpr int PARTS = DH < 32 ? 32 / DH : 1;  // key sets in p @ v
  constexpr int PER = DH > 32 ? DH / 32 : 1;    // output columns per lane
  const int part = DH < 32 ? lane / DH : 0;
  const int dl = DH < 32 ? lane % DH : lane;

  for (int idx = warp; idx < group * seq; idx += kWarps) {
    const int g = idx / seq;
    const int r = idx - g * seq;
    const float* kg = ks + g * seq * DP;
    const float* vg = vs + g * seq * DP;

    __syncwarp();  // the warp has finished with the previous row's q and p
    for (int d = lane; d < DH; d += 32) qw[d] = coati::to_float(qb[r * q_st + g * DH + d]);
    __syncwarp();

    // scores of keys lane + 32 c, c < nch, all at or before position r
    const int nch = r / 32 + 1;
    float s[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) s[c] = 0.f;
    int key[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) key[c] = min(lane + 32 * c, seq - 1) * DP;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      const float qd = qw[d];
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        if (c < nch) s[c] += qd * kg[key[c] + d];
    }
    float m = coati::kNegInf;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      s[c] = (lane + 32 * c <= r) ? s[c] * scale : coati::kNegInf;
      m = fmaxf(m, s[c]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    float l = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const float p = (lane + 32 * c <= r) ? expf(s[c] - m) : 0.f;
      l += p;
      if (c < nch) pw[lane + 32 * c] = p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(kFull, l, off);
    __syncwarp();  // the row's probabilities are in shared memory

    // o[r] = p @ v over keys [0, r]
    float acc[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) acc[u] = 0.f;
    for (int j = part; j <= r; j += PARTS) {
      const float pj = pw[j];
#pragma unroll
      for (int u = 0; u < PER; ++u) acc[u] += pj * vg[j * DP + dl + 32 * u];
    }
#pragma unroll
    for (int off = 16; off >= DH; off >>= 1)  // add up the key sets (Dh < 32)
      acc[0] += __shfl_xor_sync(kFull, acc[0], off);

    if (part == 0) {
      const float inv = 1.f / l;
      T* ob = o + ((static_cast<long long>(b) * seq + r) * heads + h0 + g) * DH;
#pragma unroll
      for (int u = 0; u < PER; ++u) ob[dl + 32 * u] = coati::from_float<T>(acc[u] * inv);
    }
  }
}

long long smem_bytes(int seq, int group, int head_dim) {
  return (2LL * group * seq * (head_dim + 1) + kWarps * kMaxT + kWarps * head_dim) * 4;
}

template <typename T, int DH>
int launch_dh(const T* q, const T* k, const T* v, T* o, int batch, int seq, int heads,
              int group, long long q_sb, long long q_st, long long k_sb, long long k_st,
              long long v_sb, long long v_st, float scale, cudaStream_t stream) {
  const long long bytes = smem_bytes(seq, group, DH);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(packed_causal_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(heads / group, batch);
  packed_causal_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, seq, heads, group, q_sb, q_st, k_sb, k_st, v_sb, v_st, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int seq,
           int heads, int head_dim, int group, long long q_sb, long long q_st,
           long long k_sb, long long k_st, long long v_sb, long long v_st, float scale,
           cudaStream_t stream) {
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  auto* op = static_cast<T*>(o);
  switch (head_dim) {
    case 16:
      return launch_dh<T, 16>(qp, kp, vp, op, batch, seq, heads, group, q_sb, q_st, k_sb,
                              k_st, v_sb, v_st, scale, stream);
    case 32:
      return launch_dh<T, 32>(qp, kp, vp, op, batch, seq, heads, group, q_sb, q_st, k_sb,
                              k_st, v_sb, v_st, scale, stream);
    case 64:
      return launch_dh<T, 64>(qp, kp, vp, op, batch, seq, heads, group, q_sb, q_st, k_sb,
                              k_st, v_sb, v_st, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Bytes of shared memory a block needs for `group` heads of a sequence.
extern "C" long long packed_causal_attention_smem_bytes(int seq, int group, int head_dim) {
  return smem_bytes(seq, group, head_dim);
}

// q, k, v: (B, T, H, Dh) with element strides (q_sb, q_st, Dh, 1) etc., T <=
// 128; o: contiguous (B, T, H, Dh) in the same dtype; `group` heads per
// block, a divisor of H. Returns a cudaError_t.
extern "C" int packed_causal_attention(const void* q, const void* k, const void* v, void* o,
                                       int batch, int seq, int heads, int head_dim,
                                       int group, int dtype, long long q_sb, long long q_st,
                                       long long k_sb, long long k_st, long long v_sb,
                                       long long v_st, float scale, void* stream) {
  if (seq < 1 || seq > kMaxT || group < 1 || heads % group != 0 || batch < 1 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == coati::kF32)
    return launch<float>(q, k, v, o, batch, seq, heads, head_dim, group, q_sb, q_st, k_sb,
                         k_st, v_sb, v_st, scale, s);
  if (dtype == coati::kBF16)
    return launch<__nv_bfloat16>(q, k, v, o, batch, seq, heads, head_dim, group, q_sb,
                                 q_st, k_sb, k_st, v_sb, v_st, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
