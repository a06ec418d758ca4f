// K5b: backward of causal multi-head attention for short sequences, T <= 128.
//
// Replaces the TPU kernel coati_tpu/ops/pallas/packed_attention.py
// (_packed_backward -> _packed_bwd_kernel), the VJP of K5f
// (packed_attention.cu). Given q, k, v and the cotangent g of the output it
// recomputes the probabilities (nothing but q, k, v is saved by the forward)
// and returns, per (row, head),
//
//   P  = softmax(q k^T * scale + causal mask)        float32
//   dP = g v^T                                        float32
//   dS = P * (dP - rowsum(P * dP)) * scale            rounded to the input type
//   dq = dS k      dk = dS^T q      dv = P^T g        (P rounded to the input type)
//
// with every product accumulated in float32 and the results stored in the
// input type: the arithmetic and the rounding points of the TPU kernel. No
// (B, H, T, T) tensor reaches device memory.
//
// What bounds it on an H100: bytes at the widths of the main path (q, k, v,
// g read once, dq, dk, dv written once; five products of 2*T*T*Dh/2 a head
// are a few operations per byte at Dh = 16).
//
// Design:
//  * one block per (batch row, head). It stages the head's q, k, v and g in
//    shared memory as float32 (rows padded by one float against bank
//    conflicts), so each is read from device memory once;
//  * phase 1, one warp per query row, as in K5f: lane l owns keys l, l + 32,
//    ... up to the row's own position, computes their scores and dP, and the
//    warp takes the maximum, the sum and rowsum(P * dP) by shuffles. The
//    row's P and dS go to shared memory, each as the lower triangle of a
//    T x T matrix (row r starts at r (r + 1) / 2), and dq of the row follows
//    from its own dS;
//  * phase 2, one warp per key row j: dk[j] and dv[j] are sums over the
//    query rows r >= j, which phase 1 spread over all warps; they are read
//    back from the two triangles, so no atomics are needed and the result
//    is the same from run to run;
//  * q, k, v are taken by (batch, token) strides with heads packed, so the
//    views split out of the fused qkv projection are read in place; g, dq,
//    dk and dv are contiguous (B, T, H, Dh).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxT = 128;           // the longest sequence this kernel takes
constexpr int kChunks = kMaxT / 32;  // keys per lane
constexpr int kMaxSmem = 232448;     // 227 KB, the most a block can ask for
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return coati::to_float(coati::from_float<T>(x));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) packed_causal_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    int seq, int heads, long long q_sb, long long q_st, long long k_sb, long long k_st,
    long long v_sb, long long v_st, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DP = DH + 1;  // padded row
  float* qs = smem;            // [seq][DP]
  float* ks = qs + seq * DP;   // [seq][DP]
  float* vs = ks + seq * DP;   // [seq][DP]
  float* gs = vs + seq * DP;   // [seq][DP]
  float* ptri = gs + seq * DP;                 // [seq (seq + 1) / 2], P rounded
  float* dstri = ptri + seq * (seq + 1) / 2;   // [seq (seq + 1) / 2], dS rounded

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int h = blockIdx.x;

  const T* qb = q + b * q_sb + h * DH;
  const T* kb = k + b * k_sb + h * DH;
  const T* vb = v + b * v_sb + h * DH;
  const long long out_st = static_cast<long long>(heads) * DH;  // token stride of g, dq, dk, dv
  const long long out_base = (static_cast<long long>(b) * seq * heads + h) * DH;
  const T* gb = g + out_base;

  for (int e = tid; e < seq * DH; e += kThreads) {
    const int t = e / DH;
    const int d = e - t * DH;
    const int at = t * DP + d;
    qs[at] = coati::to_float(qb[t * q_st + d]);
    ks[at] = coati::to_float(kb[t * k_st + d]);
    vs[at] = coati::to_float(vb[t * v_st + d]);
    gs[at] = coati::to_float(gb[t * out_st + d]);
  }
  __syncthreads();

  constexpr int PARTS = DH < 32 ? 32 / DH : 1;  // row sets a warp adds up
  constexpr int PER = DH > 32 ? DH / 32 : 1;    // output columns per lane
  const int part = DH < 32 ? lane / DH : 0;
  const int dl = DH < 32 ? lane % DH : lane;

  // phase 1: one warp per query row
  for (int r = warp; r < seq; r += kWarps) {
    const int nch = r / 32 + 1;
    float s[kChunks], dp[kChunks];
    int key[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      s[c] = 0.f;
      dp[c] = 0.f;
      key[c] = min(lane + 32 * c, seq - 1) * DP;
    }
    const float* qr = qs + r * DP;
    const float* gr = gs + r * DP;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      const float qd = qr[d];
      const float gd = gr[d];
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        if (c < nch) {
          s[c] += qd * ks[key[c] + d];
          dp[c] += gd * vs[key[c] + d];
        }
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
      s[c] = (lane + 32 * c <= r) ? expf(s[c] - m) : 0.f;
      l += s[c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(kFull, l, off);
    const float inv = 1.f / l;
    float rowsum = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      s[c] *= inv;  // the probability
      rowsum += s[c] * dp[c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) rowsum += __shfl_xor_sync(kFull, rowsum, off);

    const int base = r * (r + 1) / 2;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = lane + 32 * c;
      if (j <= r) {
        ptri[base + j] = round_to<T>(s[c]);
        dstri[base + j] = round_to<T>((s[c] * dp[c] - s[c] * rowsum) * scale);
      }
    }
    __syncwarp();  // the row's dS is in shared memory

    // dq[r] = dS[r] @ k over keys [0, r]
    float acc[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) acc[u] = 0.f;
    for (int j = part; j <= r; j += PARTS) {
      const float dsj = dstri[base + j];
#pragma unroll
      for (int u = 0; u < PER; ++u) acc[u] += dsj * ks[j * DP + dl + 32 * u];
    }
#pragma unroll
    for (int off = 16; off >= DH; off >>= 1)  // add up the key sets (Dh < 32)
      acc[0] += __shfl_xor_sync(kFull, acc[0], off);
    if (part == 0) {
      T* out = dq + out_base + r * out_st;
#pragma unroll
      for (int u = 0; u < PER; ++u) out[dl + 32 * u] = coati::from_float<T>(acc[u]);
    }
  }
  __syncthreads();  // both triangles are complete

  // phase 2: one warp per key row; sums over the query rows r >= j
  for (int j = warp; j < seq; j += kWarps) {
    float acc_k[PER], acc_v[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      acc_k[u] = 0.f;
      acc_v[u] = 0.f;
    }
    for (int r = j + part; r < seq; r += PARTS) {
      const int at = r * (r + 1) / 2 + j;
      const float dsr = dstri[at];
      const float pr = ptri[at];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        acc_k[u] += dsr * qs[r * DP + dl + 32 * u];
        acc_v[u] += pr * gs[r * DP + dl + 32 * u];
      }
    }
#pragma unroll
    for (int off = 16; off >= DH; off >>= 1) {  // add up the row sets (Dh < 32)
      acc_k[0] += __shfl_xor_sync(kFull, acc_k[0], off);
      acc_v[0] += __shfl_xor_sync(kFull, acc_v[0], off);
    }
    if (part == 0) {
      T* out_k = dk + out_base + j * out_st;
      T* out_v = dv + out_base + j * out_st;
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        out_k[dl + 32 * u] = coati::from_float<T>(acc_k[u]);
        out_v[dl + 32 * u] = coati::from_float<T>(acc_v[u]);
      }
    }
  }
}

long long smem_bytes(int seq, int head_dim) {
  return (4LL * seq * (head_dim + 1) + static_cast<long long>(seq) * (seq + 1)) * 4;
}

template <typename T, int DH>
int launch_dh(const T* q, const T* k, const T* v, const T* g, T* dq, T* dk, T* dv, int batch,
              int seq, int heads, long long q_sb, long long q_st, long long k_sb,
              long long k_st, long long v_sb, long long v_st, float scale,
              cudaStream_t stream) {
  const long long bytes = smem_bytes(seq, DH);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(packed_causal_bwd_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(heads, batch);
  packed_causal_bwd_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      q, k, v, g, dq, dk, dv, seq, heads, q_sb, q_st, k_sb, k_st, v_sb, v_st, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
           void* dv, int batch, int seq, int heads, int head_dim, long long q_sb,
           long long q_st, long long k_sb, long long k_st, long long v_sb, long long v_st,
           float scale, cudaStream_t stream) {
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* gp = static_cast<const T*>(g);
  auto* dqp = static_cast<T*>(dq);
  auto* dkp = static_cast<T*>(dk);
  auto* dvp = static_cast<T*>(dv);
  switch (head_dim) {
    case 16:
      return launch_dh<T, 16>(qp, kp, vp, gp, dqp, dkp, dvp, batch, seq, heads, q_sb, q_st,
                              k_sb, k_st, v_sb, v_st, scale, stream);
    case 32:
      return launch_dh<T, 32>(qp, kp, vp, gp, dqp, dkp, dvp, batch, seq, heads, q_sb, q_st,
                              k_sb, k_st, v_sb, v_st, scale, stream);
    case 64:
      return launch_dh<T, 64>(qp, kp, vp, gp, dqp, dkp, dvp, batch, seq, heads, q_sb, q_st,
                              k_sb, k_st, v_sb, v_st, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Bytes of shared memory a block needs for one head of a sequence.
extern "C" long long packed_causal_attention_bwd_smem_bytes(int seq, int head_dim) {
  return smem_bytes(seq, head_dim);
}

// q, k, v: (B, T, H, Dh) with element strides (q_sb, q_st, Dh, 1) etc., T <=
// 128; g, dq, dk, dv: contiguous (B, T, H, Dh), all of one dtype. Returns a
// cudaError_t.
extern "C" int packed_causal_attention_bwd(const void* q, const void* k, const void* v,
                                           const void* g, void* dq, void* dk, void* dv,
                                           int batch, int seq, int heads, int head_dim,
                                           int dtype, long long q_sb, long long q_st,
                                           long long k_sb, long long k_st, long long v_sb,
                                           long long v_st, float scale, void* stream) {
  if (seq < 1 || seq > kMaxT || heads < 1 || heads > 65535 || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == coati::kF32)
    return launch<float>(q, k, v, g, dq, dk, dv, batch, seq, heads, head_dim, q_sb, q_st,
                         k_sb, k_st, v_sb, v_st, scale, s);
  if (dtype == coati::kBF16)
    return launch<__nv_bfloat16>(q, k, v, g, dq, dk, dv, batch, seq, heads, head_dim, q_sb,
                                 q_st, k_sb, k_st, v_sb, v_st, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
