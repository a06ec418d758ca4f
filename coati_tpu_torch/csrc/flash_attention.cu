// K2: fused causal multi-head attention over a full sequence (forward).
//
// Replaces the TPU kernel coati_tpu/ops/pallas/flash_attention.py
// (flash_causal_attention -> _flash_forward -> _attn_kernel). Same
// function: o = softmax(q k^T / sqrt(Dh) + causal mask) v per (row, head),
// softmax in float32, output in the input dtype; the (B, H, T, T) scores
// never reach device memory.
//
// What bounds it on an H100: bytes. It must read q, k, v and write o,
// 4 * B*T*H*Dh elements; its FLOPs are about 4 * B*H*(T^2/2)*Dh. At the
// main-path shapes (Dh = 16, T <= 250) that is a few operations per byte,
// far below the ~295 FLOP/byte where bf16 tensor cores become the limit.
//
// Design (simple and right first; wgmma/TMA come later):
//  * one block per (tile of 64 query rows, head, batch row); one thread per
//    query row, whose q row, running max, denominator and f32 accumulator
//    (Dh values) live in registers;
//  * the block walks key tiles of 64 rows up to its last query row, staging
//    K and V in shared memory (converted to f32) so each is read from
//    memory once per block; every thread reads them by broadcast;
//  * keys are consumed in chunks of 16: one running-max rescale per chunk,
//    not per key (online softmax, -1e30 mask, so no row yields NaN);
//  * q, k, v are taken by (batch, token) strides with heads packed
//    (head stride Dh, element stride 1), so the q/k/v views split out of
//    the fused qkv projection are read in place, with no copy.
#include "common.cuh"

namespace {

constexpr int kBlockM = 64;  // query rows per block (one per thread)
constexpr int kBlockN = 64;  // keys per shared-memory tile
constexpr int kChunk = 16;   // keys per online-softmax update

template <typename T, int DH>
__global__ void __launch_bounds__(kBlockM) flash_causal_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int seq, int heads, long long q_sb, long long q_st,
    long long k_sb, long long k_st, long long v_sb, long long v_st, float scale) {
  __shared__ float ks[kBlockN][DH];
  __shared__ float vs[kBlockN][DH];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kBlockM;
  const int r = row0 + threadIdx.x;
  const bool live = r < seq;

  const T* qb = q + b * q_sb + h * DH;
  const T* kb = k + b * k_sb + h * DH;
  const T* vb = v + b * v_sb + h * DH;

  float qr[DH];
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = live ? coati::to_float(qb[r * q_st + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = coati::kNegInf;
  float l = 0.f;

  // the block's last query row bounds the keys any of its rows can see
  const int last_row = min(row0 + kBlockM, seq) - 1;
  for (int n0 = 0; n0 <= last_row; n0 += kBlockN) {
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < kBlockN * DH; i += kBlockM) {
      const int j = i / DH;
      const int d = i % DH;
      const int key = n0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < seq) {
        kv = coati::to_float(kb[key * k_st + d]);
        vv = coati::to_float(vb[key * v_st + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
    if (live) {
      // keys n0 .. n0 + kend - 1 of this tile are visible to row r
      const int kend = min(r + 1, n0 + kBlockN) - n0;
      for (int c = 0; c < kend; c += kChunk) {
        float s[kChunk];
        float cmax = coati::kNegInf;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) dot += qr[d] * ks[c + j][d];
          s[j] = (c + j < kend) ? dot * scale : coati::kNegInf;
          cmax = fmaxf(cmax, s[j]);
        }
        const float m_new = fmaxf(m, cmax);
        const float alpha = expf(m - m_new);
        l *= alpha;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const float p = expf(s[j] - m_new);
          l += p;
#pragma unroll
          for (int d = 0; d < DH; ++d) acc[d] += p * vs[c + j][d];
        }
        m = m_new;
      }
    }
  }
  if (live) {
    const float inv = 1.f / l;
    T* ob = o + ((static_cast<long long>(b) * seq + r) * heads + h) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) ob[d] = coati::from_float<T>(acc[d] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int seq,
           int heads, int head_dim, long long q_sb, long long q_st, long long k_sb,
           long long k_st, long long v_sb, long long v_st, float scale,
           cudaStream_t stream) {
  const dim3 grid((seq + kBlockM - 1) / kBlockM, heads, batch);
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  auto* op = static_cast<T*>(o);
  switch (head_dim) {
    case 16:
      flash_causal_kernel<T, 16><<<grid, kBlockM, 0, stream>>>(
          qp, kp, vp, op, seq, heads, q_sb, q_st, k_sb, k_st, v_sb, v_st, scale);
      break;
    case 32:
      flash_causal_kernel<T, 32><<<grid, kBlockM, 0, stream>>>(
          qp, kp, vp, op, seq, heads, q_sb, q_st, k_sb, k_st, v_sb, v_st, scale);
      break;
    case 64:
      flash_causal_kernel<T, 64><<<grid, kBlockM, 0, stream>>>(
          qp, kp, vp, op, seq, heads, q_sb, q_st, k_sb, k_st, v_sb, v_st, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: (B, T, H, Dh) with element strides (q_sb, q_st, Dh, 1) etc.;
// o: contiguous (B, T, H, Dh) in the same dtype. Returns a cudaError_t.
extern "C" int flash_causal_attention(const void* q, const void* k, const void* v,
                                      void* o, int batch, int seq, int heads,
                                      int head_dim, int dtype, long long q_sb,
                                      long long q_st, long long k_sb, long long k_st,
                                      long long v_sb, long long v_st, float scale,
                                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == coati::kF32)
    return launch<float>(q, k, v, o, batch, seq, heads, head_dim, q_sb, q_st, k_sb,
                         k_st, v_sb, v_st, scale, s);
  if (dtype == coati::kBF16)
    return launch<__nv_bfloat16>(q, k, v, o, batch, seq, heads, head_dim, q_sb, q_st,
                                 k_sb, k_st, v_sb, v_st, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
