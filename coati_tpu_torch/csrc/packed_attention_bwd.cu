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
// (B, H, T, T) tensor reaches device memory, and no gradient is summed by
// atomics: the result is the same from run to run, bit for bit.
//
// What bounds it on an H100: bytes (q, k, v, g read once, dq, dk, dv written
// once; the five products are a few operations per byte at Dh 16).
//
// Two bodies behind one entry point, chosen by the input dtype:
//
// bf16: tensor cores (packed_causal_bwd_bf16_kernel).
//  * one block per (batch row, group of heads), 4 warps, as K5f. It stages
//    the group's q, k, v and g in bf16 with 16-byte cp.async copies, rows
//    XOR-swizzled for ldmatrix and zero-filled up to T rounded to 16 (q, k,
//    v are strided views of the fused qkv projection, read in place);
//  * phase 1, a warp per 16-row query tile, tiles i and n-1-i to the same
//    warp so that every warp gets the same causal work. S = q k^T and
//    dP = g v^T by mma.sync m16n8k16 (bf16 in, float32 out) over the 16-key
//    chunks up to the diagonal; the causal mask; the exact row max, then
//    the row sum and rowsum(p * dP) of the unnormalized float32 p, by quad
//    shuffles (rowsum(P * dP) = that sum / l: the unrounded float32 P and
//    dP, not the rowsum(g * o) identity). dS = P (dP - rowsum) scale is
//    rounded to bf16, passed from S's C fragments to A fragments in
//    registers, and dq = dS k accumulates in float32 on the tensor cores
//    (k by ldmatrix.trans). P rounded to bf16 and dS go to shared memory
//    as the 16 x 16 tiles of the lower triangle;
//  * phase 2, a warp per 16-row key tile (pairs j and n-1-j again):
//    dk = dS^T q and dv = P^T g, the stashed tiles read transposed by
//    ldmatrix.trans as A fragments, q and g as B fragments; the query
//    tiles are summed in a fixed order;
//  * registers: S and dP of up to four 16-key chunks (64 keys) at a time.
//    Up to T 64 a tile's S and dP are computed once; above, the keys are
//    taken in two 64-key halves and S is recomputed (three times) and dP
//    (twice), so that 128 keys never sit in registers at once. The group
//    of heads is packed_attention.bwd_head_group (a byte budget and at
//    most three tile pairs a warp).
//
// float32: CUDA cores (packed_causal_bwd_f32_kernel), for the fidelity
//  runs, which TF32 could not meet. One block per (batch row, head) stages
//  the head's q, k, v and g as float32 (rows padded by one float); phase 1
//  is a warp per query row (lane l owns keys l, l + 32, ...), which puts its
//  P and dS in shared memory as lower triangles and computes dq of the row;
//  phase 2 is a warp per key row j, summing over the query rows r >= j.
//
// g, dq, dk and dv are contiguous (B, T, H, Dh).
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kMaxT = 128;        // the longest sequence this kernel takes
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block can ask for
constexpr int kDefaultSmem = 48 * 1024;  // above it a kernel must opt in
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------ bf16 body

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 16 * 16;  // elements of one stashed tile

// element offset of tile (query tile i, key chunk c <= i) in a stash
__device__ __forceinline__ int tri_tile(int i, int c) { return (i * (i + 1) / 2 + c) * kTile; }

// c0, c1 = (the 16 rows of af) x (rows 16c .. 16c + 15 of a staged tile)^T:
// the n8 tiles of keys 16c .. +7 and 16c + 8 .. +15
template <int DH>
__device__ __forceinline__ void times_rows_t(float (&c0)[4], float (&c1)[4],
                                             const uint32_t (&af)[DH / 16][4],
                                             const __nv_bfloat16* tile, int c) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 4; ++e) c0[e] = c1[e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t kf[4];  // b0, b1 of rows 16c .. +7, then of 16c + 8 .. +15
    coati::ldmatrix_x4(kf, tile + coati::swizzle<DH>(16 * c + (lane & 7) + ((lane >> 4) << 3),
                                                     2 * kk + ((lane >> 3) & 1)));
    coati::mma_bf16(c0, af[kk], kf[0], kf[1]);
    coati::mma_bf16(c1, af[kk], kf[2], kf[3]);
  }
}

// acc += a (16 x 16) x (rows 16c .. 16c + 15 of a staged tile, all DH columns)
template <int DH>
__device__ __forceinline__ void times_rows(float (&acc)[DH / 8][4], const uint32_t (&a)[4],
                                           const __nv_bfloat16* tile, int c) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int dp = 0; dp < DH / 16; ++dp) {
    uint32_t f[4];  // b0, b1 of columns 16dp .. +7, then of 16dp + 8 .. +15
    coati::ldmatrix_x4_trans(f, tile + coati::swizzle<DH>(16 * c + (lane & 7) +
                                                              (((lane >> 3) & 1) << 3),
                                                          2 * dp + (lane >> 4)));
    coati::mma_bf16(acc[2 * dp], a, f[0], f[1]);
    coati::mma_bf16(acc[2 * dp + 1], a, f[2], f[3]);
  }
}

// the 16 rows 16 i .. of a tile's C fragments (float32) to bf16 rows of a
// (T, H, Dh) output with token stride `st`, rows past seq left out
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out, long long st,
                                           const float (&acc)[DH / 8][4], int i, int seq) {
  const int lane = threadIdx.x & 31;
  const int r_lo = 16 * i + (lane >> 2);
  const int r_hi = r_lo + 8;
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    if (r_lo < seq)
      *reinterpret_cast<uint32_t*>(out + r_lo * st + 8 * d + col) =
          coati::pack_bf16(acc[d][0], acc[d][1]);
    if (r_hi < seq)
      *reinterpret_cast<uint32_t*>(out + r_hi * st + 8 * d + col) =
          coati::pack_bf16(acc[d][2], acc[d][3]);
  }
}

// S of key chunk c for the warp's query tile i, masked on the diagonal
template <int DH>
__device__ __forceinline__ void scores(float (&s0)[4], float (&s1)[4],
                                       const uint32_t (&qf)[DH / 16][4],
                                       const __nv_bfloat16* ks, int i, int c) {
  times_rows_t<DH>(s0, s1, qf, ks, c);
  if (c == i) {  // keys past the row are masked
    const int lane = threadIdx.x & 31;
    const int r_lo = lane >> 2;  // within the tile
    const int key = 2 * (lane & 3);
    if (key > r_lo) s0[0] = -INFINITY;
    if (key + 1 > r_lo) s0[1] = -INFINITY;
    if (key > r_lo + 8) s0[2] = -INFINITY;
    if (key + 1 > r_lo + 8) s0[3] = -INFINITY;
    if (key + 8 > r_lo) s1[0] = -INFINITY;
    if (key + 9 > r_lo) s1[1] = -INFINITY;
    if (key + 8 > r_lo + 8) s1[2] = -INFINITY;
    if (key + 9 > r_lo + 8) s1[3] = -INFINITY;
  }
}

// Phase 1 for the 16 query rows 16 i .. 16 i + 15 of one head: dq of the
// rows, and the tiles (i, 0 .. i) of the two stashes (P and dS in bf16).
template <int DH, int NCH>
__device__ __forceinline__ void query_tile(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                                           const __nv_bfloat16* vs, const __nv_bfloat16* gs,
                                           __nv_bfloat16* p_st, __nv_bfloat16* ds_st,
                                           __nv_bfloat16* __restrict__ dqg, long long out_st,
                                           int i, int seq, float scale, float scale_log2) {
  constexpr int kSteps = DH / 16;
  constexpr int HC = NCH > 4 ? 4 : NCH;    // key chunks held in registers at once
  constexpr int NH = (NCH + HC - 1) / HC;  // 1, or 2 halves of 64 keys
  const int lane = threadIdx.x & 31;

  uint32_t qf[kSteps][4], gf[kSteps][4];  // A fragments of q and g rows 16 i ..
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int at = coati::swizzle<DH>(16 * i + (lane & 7) + (((lane >> 3) & 1) << 3),
                                      2 * kk + (lane >> 4));
    coati::ldmatrix_x4(qf[kk], qs + at);
    coati::ldmatrix_x4(gf[kk], gs + at);
  }

  float s[2 * HC][4], dp[2 * HC][4];
  // the exact row max
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int cc = 0; cc < HC; ++cc) {
      const int c = h * HC + cc;
      if (c < NCH && c <= i) {
        scores<DH>(s[2 * cc], s[2 * cc + 1], qf, ks, i, c);
#pragma unroll
        for (int n = 2 * cc; n < 2 * cc + 2; ++n) {
          mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
        }
      }
    }
  float msc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    msc[r] = mx[r] * scale_log2;  // finite: key 0 is visible to every row
  }

  // p = exp(s - max) unnormalized, dP, their row sums
  float l[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int cc = 0; cc < HC; ++cc) {
      const int c = h * HC + cc;
      if (c < NCH && c <= i) {
        if (NH > 1) scores<DH>(s[2 * cc], s[2 * cc + 1], qf, ks, i, c);
        times_rows_t<DH>(dp[2 * cc], dp[2 * cc + 1], gf, vs, c);
#pragma unroll
        for (int n = 2 * cc; n < 2 * cc + 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] = coati::exp2_fast(fmaf(s[n][e], scale_log2, -msc[e >> 1]));
            l[e >> 1] += s[n][e];
            pd[e >> 1] += s[n][e] * dp[n][e];
          }
      }
    }
  float inv[2], rowsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    pd[r] += __shfl_xor_sync(kFull, pd[r], 1);
    pd[r] += __shfl_xor_sync(kFull, pd[r], 2);
    inv[r] = 1.f / l[r];
    rowsum[r] = pd[r] * inv[r];
  }

  // P, dS; dq = dS k; the stashed tiles
  float dq[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;
  const int g_lo = lane >> 2;
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int cc = 0; cc < HC; ++cc) {
      const int c = h * HC + cc;
      if (c < NCH && c <= i) {
        if (NH > 1) {
          scores<DH>(s[2 * cc], s[2 * cc + 1], qf, ks, i, c);
          times_rows_t<DH>(dp[2 * cc], dp[2 * cc + 1], gf, vs, c);
        }
        float p[2][4], ds[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = 2 * cc + u;
            const float pe = NH > 1
                                 ? coati::exp2_fast(fmaf(s[n][e], scale_log2, -msc[e >> 1]))
                                 : s[n][e];
            p[u][e] = pe * inv[e >> 1];
            ds[u][e] = (p[u][e] * dp[n][e] - p[u][e] * rowsum[e >> 1]) * scale;
          }
        // rows g and g + 8, keys 16c + col .. and 16c + 8 + col ..: an A fragment
        const uint32_t pa[4] = {coati::pack_bf16(p[0][0], p[0][1]),
                                coati::pack_bf16(p[0][2], p[0][3]),
                                coati::pack_bf16(p[1][0], p[1][1]),
                                coati::pack_bf16(p[1][2], p[1][3])};
        const uint32_t da[4] = {coati::pack_bf16(ds[0][0], ds[0][1]),
                                coati::pack_bf16(ds[0][2], ds[0][3]),
                                coati::pack_bf16(ds[1][0], ds[1][1]),
                                coati::pack_bf16(ds[1][2], ds[1][3])};
        times_rows<DH>(dq, da, ks, c);
        __nv_bfloat16* pt = p_st + tri_tile(i, c);
        __nv_bfloat16* dt = ds_st + tri_tile(i, c);
#pragma unroll
        for (int f = 0; f < 4; ++f) {  // a0 (row g, keys 0-7), a1 (g + 8), a2, a3 (keys 8-15)
          const int at = coati::swizzle<16>(g_lo + 8 * (f & 1), f >> 1) + col;
          *reinterpret_cast<uint32_t*>(pt + at) = pa[f];
          *reinterpret_cast<uint32_t*>(dt + at) = da[f];
        }
      }
    }
  store_rows<DH>(dqg, out_st, dq, i, seq);
}

// Phase 2 for the 16 keys 16 j .. 16 j + 15 of one head: dk and dv, summed
// over the query tiles j .. ntile - 1 in that order.
template <int DH>
__device__ __forceinline__ void key_tile(const __nv_bfloat16* qs, const __nv_bfloat16* gs,
                                         const __nv_bfloat16* p_st, const __nv_bfloat16* ds_st,
                                         __nv_bfloat16* __restrict__ dkg,
                                         __nv_bfloat16* __restrict__ dvg, long long out_st,
                                         int j, int ntile, int seq) {
  const int lane = threadIdx.x & 31;
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
  // the transposed A fragment of a stashed tile: matrix m = lane / 8 holds
  // query rows 8 (m / 2) .., key chunk m % 2
  const int at = coati::swizzle<16>((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
  for (int i = j; i < ntile; ++i) {
    uint32_t da[4], pa[4];
    coati::ldmatrix_x4_trans(da, ds_st + tri_tile(i, j) + at);
    coati::ldmatrix_x4_trans(pa, p_st + tri_tile(i, j) + at);
    times_rows<DH>(dk, da, qs, i);
    times_rows<DH>(dv, pa, gs, i);
  }
  store_rows<DH>(dkg, out_st, dk, j, seq);
  store_rows<DH>(dvg, out_st, dv, j, seq);
}

template <int DH, int NCH>
__global__ void __launch_bounds__(kTcThreads) packed_causal_bwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
    __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int seq, int heads, int group, long long q_sb,
    long long q_st, long long k_sb, long long k_st, long long v_sb, long long v_st,
    float scale) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  constexpr int kChunks = DH / 8;
  const int tpad = (seq + 15) & ~15;
  const int ntile = tpad / 16;
  const int tri = ntile * (ntile + 1) / 2 * kTile;
  const int staged = tpad * DH;
  // per head: q, k, v, g staged (swizzled), then the P and dS stashes
  auto* base = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  const int per_head = 4 * staged + 2 * tri;

  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.y;
  const int h0 = blockIdx.x * group;
  const long long out_st = static_cast<long long>(heads) * DH;  // token stride of g, dq, dk, dv
  const long long out_b = (b * seq * heads + h0) * DH;
  const __nv_bfloat16* src[4] = {q + b * q_sb + h0 * DH, k + b * k_sb + h0 * DH,
                                 v + b * v_sb + h0 * DH, g + out_b};
  const long long st[4] = {q_st, k_st, v_st, out_st};

  // stage q, k, v, g of the group: a token's group * DH elements of each are
  // contiguous in memory, one 16-byte copy per chunk
  const int per_token = group * kChunks;
  for (int x = threadIdx.x; x < tpad * per_token; x += kTcThreads) {
    const int t = x / per_token;
    const int gh = (x - t * per_token) / kChunks;
    const int c = x % kChunks;
    const bool ok = t < seq;
    const long long row = ok ? t : 0;
    __nv_bfloat16* dst = base + gh * per_head + coati::swizzle<DH>(t, c);
#pragma unroll
    for (int m = 0; m < 4; ++m)
      coati::cp_async_16(dst + m * staged, src[m] + row * st[m] + gh * DH + c * 8, ok);
  }
  coati::cp_async_commit();
  coati::cp_async_wait<0>();
  __syncthreads();

  const float scale_log2 = scale * kLog2e;
  const int npair = (ntile + 1) / 2;  // tiles i and ntile-1-i: one item of equal work
  // phase 1 (tensor cores): a warp per pair of query tiles
  for (int item = warp; item < group * npair; item += kTcWarps) {
    const int gh = item / npair;
    const int pair = item - gh * npair;
    __nv_bfloat16* hs = base + gh * per_head;
    __nv_bfloat16* dqg = dq + out_b + gh * DH;
    query_tile<DH, NCH>(hs, hs + staged, hs + 2 * staged, hs + 3 * staged, hs + 4 * staged,
                        hs + 4 * staged + tri, dqg, out_st, pair, seq, scale, scale_log2);
    if (ntile - 1 - pair != pair)
      query_tile<DH, NCH>(hs, hs + staged, hs + 2 * staged, hs + 3 * staged, hs + 4 * staged,
                          hs + 4 * staged + tri, dqg, out_st, ntile - 1 - pair, seq, scale,
                          scale_log2);
  }
  __syncthreads();  // every stashed tile is written
  // phase 2 (tensor cores): a warp per pair of key tiles
  for (int item = warp; item < group * npair; item += kTcWarps) {
    const int gh = item / npair;
    const int pair = item - gh * npair;
    const __nv_bfloat16* hs = base + gh * per_head;
    const long long at = out_b + gh * DH;
    key_tile<DH>(hs, hs + 3 * staged, hs + 4 * staged, hs + 4 * staged + tri, dk + at, dv + at,
                 out_st, pair, ntile, seq);
    if (ntile - 1 - pair != pair)
      key_tile<DH>(hs, hs + 3 * staged, hs + 4 * staged, hs + 4 * staged + tri, dk + at,
                   dv + at, out_st, ntile - 1 - pair, ntile, seq);
  }
}

// --------------------------------------------------------- float32 body

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunks = kMaxT / 32;  // keys per lane

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return coati::to_float(coati::from_float<T>(x));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) packed_causal_bwd_f32_kernel(
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

// ------------------------------------------------------------- launch

long long smem_bytes(int seq, int head_dim, int group, int dtype) {
  if (dtype == coati::kBF16) {
    const long long tpad = (seq + 15) / 16 * 16;
    const long long ntile = tpad / 16;
    return 2LL * group * (4 * tpad * head_dim + ntile * (ntile + 1) * kTile);
  }
  return (4LL * seq * (head_dim + 1) + static_cast<long long>(seq) * (seq + 1)) * 4;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  void* dq;
  void* dk;
  void* dv;
  int batch, seq, heads, group;
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st;
  float scale;
  cudaStream_t stream;
};

// opt in to more than the default 48 KB of dynamic shared memory
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, long long bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DH, int NCH>
int launch_bf16(const Args& a, long long bytes) {
  const cudaError_t err = allow_smem(packed_causal_bwd_bf16_kernel<DH, NCH>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  using T = __nv_bfloat16;
  packed_causal_bwd_bf16_kernel<DH, NCH><<<dim3(a.heads / a.group, a.batch), kTcThreads, bytes,
                                           a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), static_cast<T*>(a.dq), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.seq, a.heads, a.group, a.q_sb, a.q_st, a.k_sb, a.k_st, a.v_sb,
      a.v_st, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_f32(const Args& a, long long bytes) {
  const cudaError_t err = allow_smem(packed_causal_bwd_f32_kernel<float, DH>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_causal_bwd_f32_kernel<float, DH><<<dim3(a.heads, a.batch), kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g),
      static_cast<float*>(a.dq), static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.seq,
      a.heads, a.q_sb, a.q_st, a.k_sb, a.k_st, a.v_sb, a.v_st, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dh(const Args& a, int dtype) {
  const long long bytes = smem_bytes(a.seq, DH, a.group, dtype);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == coati::kF32)
    return a.group == 1 ? launch_f32<DH>(a, bytes) : static_cast<int>(cudaErrorInvalidValue);
  if (dtype != coati::kBF16) return static_cast<int>(cudaErrorInvalidValue);
  // the 16-key chunks of the longest row: T rounded up to 32, 64, 96, 128
  if (a.seq <= 32) return launch_bf16<DH, 2>(a, bytes);
  if (a.seq <= 64) return launch_bf16<DH, 4>(a, bytes);
  if (a.seq <= 96) return launch_bf16<DH, 6>(a, bytes);
  return launch_bf16<DH, 8>(a, bytes);
}

}  // namespace

// Bytes of shared memory a block needs for `group` heads of a sequence, in
// the body that `dtype` selects (float32 takes one head a block).
extern "C" long long packed_causal_attention_bwd_smem_bytes(int seq, int head_dim, int group,
                                                            int dtype) {
  return smem_bytes(seq, head_dim, group, dtype);
}

// q, k, v: (B, T, H, Dh) with element strides (q_sb, q_st, Dh, 1) etc., T <=
// 128; g, dq, dk, dv: contiguous (B, T, H, Dh), all of one dtype; `group`
// heads per block, a divisor of H (1 in float32). bf16 runs the tensor-core
// body and needs 16-byte aligned base pointers and batch and token strides
// (the wrapper checks); float32 runs the CUDA-core body. Returns a
// cudaError_t.
extern "C" int packed_causal_attention_bwd(const void* q, const void* k, const void* v,
                                           const void* g, void* dq, void* dk, void* dv,
                                           int batch, int seq, int heads, int head_dim,
                                           int group, int dtype, long long q_sb,
                                           long long q_st, long long k_sb, long long k_st,
                                           long long v_sb, long long v_st, float scale,
                                           void* stream) {
  if (seq < 1 || seq > kMaxT || heads < 1 || group < 1 || heads % group != 0 || batch < 1 ||
      batch > 65535 || heads / group > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,    k,    v,    g,    dq,   dk,   dv,    batch, seq, heads,
               group, q_sb, q_st, k_sb, k_st, v_sb, v_st, scale, static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 16:
      return launch_dh<16>(a, dtype);
    case 32:
      return launch_dh<32>(a, dtype);
    case 64:
      return launch_dh<64>(a, dtype);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
