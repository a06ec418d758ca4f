// K2: fused causal multi-head attention over a full sequence (forward).
//
// Replaces the TPU kernel coati_tpu/ops/pallas/flash_attention.py
// (flash_causal_attention -> _flash_forward -> _attn_kernel). Same
// function: o = softmax(q k^T / sqrt(Dh) + causal mask) v per (row, head),
// softmax in float32, output in the input dtype; the (B, H, T, T) scores
// never reach device memory. q, k, v are taken by (batch, token) strides
// with heads packed (head stride Dh, element stride 1), so the views split
// out of the fused qkv projection are read in place, with no copy.
//
// Two bodies behind one entry point, chosen by the input dtype:
//
// bf16: tensor cores (flash_causal_bf16_kernel).
//  What bounds it on an H100: bytes and the exponentials, of the same
//  size at Dh 16. It must read q, k, v and write o once (4 B T H Dh
//  elements: 0.157 ms at B 1024, T 250, H 16, at 3.35 TB/s), and it takes
//  one exponential per (query, key) pair it computes: with 64-key tiles
//  and 16-row warps, and two a lane per tile to rescale, 0.61 G at that
//  shape, 0.146 ms on the special-function units (132 SMs x 16 a clock
//  at 1.98 GHz). Its products (33 GFLOP) take 0.033 ms at the bf16
//  tensor-core peak.
//  Design:
//   * one block per (64-row query tile, head, batch row), 4 warps, each
//     owning 16 query rows; the query tile is the fastest grid index (so
//     the K and V of one (row, head) come from device memory once and
//     from L2 after that), longest tiles first;
//   * Q goes to registers once as mma A fragments (ldmatrix); K and V
//     tiles of 64 keys go to shared memory as bf16 with 16-byte cp.async
//     copies, double-buffered (tile j+1 loads while tile j computes),
//     zero-filled past T, rows XOR-swizzled so ldmatrix has no bank
//     conflicts;
//   * S = Q K^T by mma.sync m16n8k16 (bf16 in, float32 out), K's B
//     fragments by ldmatrix; online softmax in registers, in base 2 with
//     scale * log2(e) folded into one multiply-add, the row max and sum
//     shared by the four lanes of a row by shuffles; the causal mask only
//     on the diagonal tile, where a warp also skips the 16-key chunks
//     wholly above its last row;
//   * P V: the unnormalized P, rounded to bf16 (the TPU kernel rounds P to
//     the value type before its product too), goes from the C fragments
//     of S straight into A fragments, V's B fragments by ldmatrix.trans,
//     float32 accumulation; 1/l at the end, bf16 pairs stored 4 bytes at
//     a time.
//  Why mma.sync and not wgmma/TMA: at Dh 16 a product has one k-step and
//  the tensor-core time is a fifth of the byte floor, so mma.sync's rate
//  is far more than enough; wgmma's 64-row minimum per warpgroup would
//  coarsen the causal skipping and needs shared-memory descriptors for
//  both operands; TMA would need a tensor map per strided view. Measured
//  on an H100 (PERF.md), the kernel is held by the latency of its loads,
//  not by the exponentials or the tensor cores: without any arithmetic it
//  keeps three quarters of its time.
//
// float32: CUDA cores (flash_causal_f32_kernel), for the fidelity runs.
//  TF32 tensor cores keep ten mantissa bits and cannot meet the 1e-5
//  tolerance against the plain version that the float32 path is held to,
//  so the float32 body stays as it was: one thread per query row, whose q
//  row, running max, denominator and accumulator live in registers; K and
//  V tiles of 64 keys staged in shared memory; keys in chunks of 16, one
//  running-max rescale a chunk.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kTile = 64;  // query rows per block, keys per K/V tile

// ------------------------------------------------------------ bf16 body

constexpr int kWarps = 4;  // a warp per 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

// One 64-row tile of q, k or v (rows t0 .. t0 + 63 of one head) into a
// swizzled shared tile, one 16-byte cp.async per (row, chunk); rows at or
// past `seq` are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int t0, int seq) {
  constexpr int kChunks = DH / 8;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int t = t0 + r;
    const bool ok = t < seq;
    coati::cp_async_16(dst + coati::swizzle<DH>(r, c), src + (ok ? t : 0) * stride + c * 8,
                       ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_causal_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int seq, int heads,
    long long q_sb, long long q_st, long long k_sb, long long k_st, long long v_sb,
    long long v_st, float scale_log2) {
  constexpr int kSteps = DH / 16;  // k-steps of Q K^T
  constexpr int kOut = DH / 8;     // n8 tiles of the output
  __shared__ __align__(128) __nv_bfloat16 qs[kTile * DH];
  __shared__ __align__(128) __nv_bfloat16 ks[2][kTile * DH];
  __shared__ __align__(128) __nv_bfloat16 vs[2][kTile * DH];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = gridDim.x - 1 - blockIdx.x;  // the longest tiles start first
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int row0 = tile * kTile;
  const __nv_bfloat16* qb = q + b * q_sb + h * DH;
  const __nv_bfloat16* kb = k + b * k_sb + h * DH;
  const __nv_bfloat16* vb = v + b * v_sb + h * DH;

  load_tile<DH>(qs, qb, q_st, row0, seq);
  load_tile<DH>(ks[0], kb, k_st, 0, seq);
  load_tile<DH>(vs[0], vb, v_st, 0, seq);
  coati::cp_async_commit();

  const int wrow0 = row0 + 16 * warp;  // the warp's first query row
  const bool live = wrow0 < seq;
  const int r_lo = wrow0 + (lane >> 2);  // rows of c0, c1 and of c2, c3
  const int r_hi = r_lo + 8;
  const int col = 2 * (lane & 3);  // first column of a lane's C pair

  uint32_t qf[kSteps][4];
  float acc[kOut][4];
#pragma unroll
  for (int d = 0; d < kOut; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  // running max of the raw scores and partial sum of the lane's columns,
  // for rows r_lo and r_hi
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int j = 0; j <= tile; ++j) {
    if (j < tile) {  // the next tile loads while this one computes
      load_tile<DH>(ks[(j + 1) & 1], kb, k_st, (j + 1) * kTile, seq);
      load_tile<DH>(vs[(j + 1) & 1], vb, v_st, (j + 1) * kTile, seq);
      coati::cp_async_commit();
      coati::cp_async_wait<1>();
    } else {
      coati::cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
          coati::ldmatrix_x4(qf[kk], qs + coati::swizzle<DH>(16 * warp + (lane & 15),
                                                            2 * kk + (lane >> 4)));
      }
      const __nv_bfloat16* kt = ks[j & 1];
      const __nv_bfloat16* vt = vs[j & 1];
      const bool diag = j == tile;
      // 16-key chunks the warp needs: all four, or on the diagonal tile
      // those at or below its last row
      const int nch = diag ? warp + 1 : 4;

      float s[8][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c < nch) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[2 * c][e] = s[2 * c + 1][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk) {
            uint32_t kf[4];  // b0, b1 of keys 16c .. +7, then of 16c + 8 .. +15
            coati::ldmatrix_x4(
                kf, kt + coati::swizzle<DH>(16 * c + (lane & 7) + ((lane >> 4) << 3),
                                            2 * kk + ((lane >> 3) & 1)));
            coati::mma_bf16(s[2 * c], qf[kk], kf[0], kf[1]);
            coati::mma_bf16(s[2 * c + 1], qf[kk], kf[2], kf[3]);
          }
        }
      }

      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n / 2 < nch) {
          const int key = j * kTile + 8 * n + col;
          if (diag) {
            if (key > r_lo) s[n][0] = -INFINITY;
            if (key + 1 > r_lo) s[n][1] = -INFINITY;
            if (key > r_hi) s[n][2] = -INFINITY;
            if (key + 1 > r_hi) s[n][3] = -INFINITY;
          }
          mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      }
      // mx is finite: every row, padding rows too, sees the tile's first
      // key. The scale is positive, so the max of the raw scores is that of
      // the scaled ones; alpha is 0 on the first tile, where m = -inf.
      float alpha[2], mscaled[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        alpha[i] = coati::exp2_fast((m[i] - mx[i]) * scale_log2);
        m[i] = mx[i];
        mscaled[i] = mx[i] * scale_log2;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int d = 0; d < kOut; ++d) {
        acc[d][0] *= alpha[0];
        acc[d][1] *= alpha[0];
        acc[d][2] *= alpha[1];
        acc[d][3] *= alpha[1];
      }

#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c < nch) {
          float p[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[u][e] = coati::exp2_fast(fmaf(s[2 * c + u][e], scale_log2, -mscaled[e >> 1]));
            l[0] += p[u][0] + p[u][1];
            l[1] += p[u][2] + p[u][3];
          }
          // C fragments of keys 16c .. +15 as the A fragment of P V
          const uint32_t pa[4] = {coati::pack_bf16(p[0][0], p[0][1]),
                                  coati::pack_bf16(p[0][2], p[0][3]),
                                  coati::pack_bf16(p[1][0], p[1][1]),
                                  coati::pack_bf16(p[1][2], p[1][3])};
#pragma unroll
          for (int dp = 0; dp < kOut / 2; ++dp) {
            uint32_t vf[4];  // b0, b1 of columns 16dp .. +7, then of 16dp + 8 .. +15
            coati::ldmatrix_x4_trans(
                vf, vt + coati::swizzle<DH>(16 * c + (lane & 7) + (((lane >> 3) & 1) << 3),
                                            2 * dp + (lane >> 4)));
            coati::mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
            coati::mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();  // the tile has been consumed: its buffer loads again
  }

  if (!live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv_lo = 1.f / l[0];
  const float inv_hi = 1.f / l[1];
  const long long ob_lo = ((b * seq + r_lo) * heads + h) * DH + col;
  const long long ob_hi = ((b * seq + r_hi) * heads + h) * DH + col;
#pragma unroll
  for (int d = 0; d < kOut; ++d) {
    if (r_lo < seq)
      *reinterpret_cast<uint32_t*>(o + ob_lo + 8 * d) =
          coati::pack_bf16(acc[d][0] * inv_lo, acc[d][1] * inv_lo);
    if (r_hi < seq)
      *reinterpret_cast<uint32_t*>(o + ob_hi + 8 * d) =
          coati::pack_bf16(acc[d][2] * inv_hi, acc[d][3] * inv_hi);
  }
}

// --------------------------------------------------------- float32 body

constexpr int kChunk = 16;  // keys per online-softmax update

template <int DH>
__global__ void __launch_bounds__(kTile) flash_causal_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int seq, int heads, long long q_sb, long long q_st,
    long long k_sb, long long k_st, long long v_sb, long long v_st, float scale) {
  __shared__ float ks[kTile][DH];
  __shared__ float vs[kTile][DH];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kTile;
  const int r = row0 + threadIdx.x;
  const bool live = r < seq;

  const float* qb = q + b * q_sb + h * DH;
  const float* kb = k + b * k_sb + h * DH;
  const float* vb = v + b * v_sb + h * DH;

  float qr[DH];
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = live ? qb[r * q_st + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = coati::kNegInf;
  float l = 0.f;

  // the block's last query row bounds the keys any of its rows can see
  const int last_row = min(row0 + kTile, seq) - 1;
  for (int n0 = 0; n0 <= last_row; n0 += kTile) {
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < kTile * DH; i += kTile) {
      const int j = i / DH;
      const int d = i % DH;
      const int key = n0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < seq) {
        kv = kb[key * k_st + d];
        vv = vb[key * v_st + d];
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
    if (live) {
      // keys n0 .. n0 + kend - 1 of this tile are visible to row r
      const int kend = min(r + 1, n0 + kTile) - n0;
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
    float* ob = o + ((static_cast<long long>(b) * seq + r) * heads + h) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) ob[d] = acc[d] * inv;
  }
}

template <int DH>
int launch_dh(int dtype, const void* q, const void* k, const void* v, void* o, int batch,
              int seq, int heads, long long q_sb, long long q_st, long long k_sb,
              long long k_st, long long v_sb, long long v_st, float scale,
              cudaStream_t stream) {
  const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
  if (dtype == coati::kBF16) {
    flash_causal_bf16_kernel<DH><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), seq, heads,
        q_sb, q_st, k_sb, k_st, v_sb, v_st, scale * kLog2e);
  } else if (dtype == coati::kF32) {
    flash_causal_f32_kernel<DH><<<grid, kTile, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), seq, heads, q_sb, q_st, k_sb,
        k_st, v_sb, v_st, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: (B, T, H, Dh) with element strides (q_sb, q_st, Dh, 1) etc.;
// o: contiguous (B, T, H, Dh) in the same dtype. bf16 runs the tensor-core
// body and needs 16-byte aligned base pointers and batch and token strides
// (the wrapper checks); float32 runs the CUDA-core body. Returns a
// cudaError_t.
extern "C" int flash_causal_attention(const void* q, const void* k, const void* v,
                                      void* o, int batch, int seq, int heads,
                                      int head_dim, int dtype, long long q_sb,
                                      long long q_st, long long k_sb, long long k_st,
                                      long long v_sb, long long v_st, float scale,
                                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch_dh<16>(dtype, q, k, v, o, batch, seq, heads, q_sb, q_st, k_sb, k_st,
                           v_sb, v_st, scale, s);
    case 32:
      return launch_dh<32>(dtype, q, k, v, o, batch, seq, heads, q_sb, q_st, k_sb, k_st,
                           v_sb, v_st, scale, s);
    case 64:
      return launch_dh<64>(dtype, q, k, v, o, batch, seq, heads, q_sb, q_st, k_sb, k_st,
                           v_sb, v_st, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
