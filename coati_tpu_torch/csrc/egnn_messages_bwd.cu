// K4: backward of the fused EGNN message aggregation.
//
// Replaces the TPU kernel coati_tpu/ops/pallas/egnn_messages.py
// (_bwd_pallas -> _bwd_kernel), the VJP of K3 (egnn_messages.cu). Given the
// inputs of K3 and the cotangent g (B, N, Hm) of its output it recomputes,
// per pair (i, j) of a molecule b,
//
//   z1 = a[b,i] + c[b,j] + d2[b,i,j]*wd + b1     e1 = silu(z1)
//   z2 = e1 @ W2 + b2
//
// and returns
//
//   dz2 = w[b,i,j] * g[b,i] * silu'(z2)          dz1 = (dz2 @ W2^T) * silu'(z1)
//   da[b,i] = sum_j dz1      dc[b,j] = sum_i dz1
//   dwd = sum dz1 * d2       db1 = sum dz1       db2 = sum dz2
//   dW2 = e1^T @ dz2
//
// without the (B, N, N, Hm) pairwise tensors ever reaching device memory; d2
// and w get no gradient. All arithmetic is float32; in the bf16 mode e1, W2
// and dz2 are rounded to bf16 before each of the three products (z2, dz2 @
// W2^T, e1^T @ dz2), which still accumulate in float32, and db2 sums the
// unrounded dz2: the rounding points of the TPU kernel.
//
// What bounds it on an H100: operations. Per live pair it does three Hm x Hm
// products (6*Hm^2 operations, three times K3) on values that stay in shared
// memory and cache. All three run on the CUDA cores.
//
// Design:
//  * K3's decomposition: one block per (molecule, tile of 8 atoms i) lists by
//    a ballot scan the pairs of its tile whose weight is not zero and walks
//    that list 64 pairs at a time, so a pair with w = 0 costs nothing (there
//    dz2 is zero, and with it every term above);
//  * per chunk of 64 pairs the block keeps e1 and dz2 (64 x Hm each) in
//    shared memory and runs three tiled products on them, each thread with an
//    8 x 8 register tile: z2 = e1 @ W2 (W2 streamed through shared memory in
//    16-deep tiles), dW2 += e1^T @ dz2 (both operands already in shared
//    memory; 64 rows of dW2 at a time, since the whole Hm x Hm tile fits
//    neither the registers nor the shared memory of a block), and
//    de1 = dz2 @ W2^T (the wrapper passes W2^T contiguous, streamed like W2);
//  * where sums cross threads and blocks. The TPU kernel ran its grid in
//    order and added into resident output blocks; a CUDA grid has no order,
//    so: da stays inside the block (shared-memory accumulators, as K3's
//    output); dc[b, j], which sums over the i-tiles of a molecule, and dW2,
//    dwd, db1, db2, which sum over every block, are float32 atomic adds into
//    outputs that the wrapper zeroed (dwd, db1, db2 once per block from
//    shared-memory accumulators; dc and dW2 once per chunk, four floats per
//    instruction where the toolkit has the vector form). Atomic adds arrive
//    in an order that changes from run to run, so these gradients can differ
//    in their last bits between two runs on the same inputs;
//  * rows i and columns j without a live pair get exactly zero da and dc;
//  * no padding of B, N or Hm is needed: ragged edges are masked here.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileI = 8;   // atoms i per block
constexpr int kBM = 64;     // pairs (GEMM rows) per chunk
constexpr int kBN = 256;    // output columns per pass
constexpr int kBK = 16;     // depth of one streamed tile of W2 or W2^T
constexpr int kRM = 8;      // rows per thread: kBM / (kThreads / 32)
constexpr int kRN = 8;      // columns per thread: kBN / 32
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block can ask for

#if __CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)
#define COATI_VECTOR_ATOMICS 1
#else
#define COATI_VECTOR_ATOMICS 0
#endif

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float dsilu(float x) {
  const float s = 1.f / (1.f + expf(-x));
  return s * (1.f + x * (1.f - s));
}

template <bool BF16>
__device__ __forceinline__ float mm_round(float x) {
  if (BF16) return __bfloat162float(__float2bfloat16(x));
  return x;
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// dst[0..3] += x[0..3] in device memory, for the columns col..col+3 that lie
// below `width`; `vector_ok` says that dst is 16-byte aligned
__device__ __forceinline__ void add4(float* dst, const float* x, int col, int width,
                                     bool vector_ok) {
#if COATI_VECTOR_ATOMICS
  if (vector_ok && col + 3 < width) {
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(x[0], x[1], x[2], x[3]));
    return;
  }
#endif
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (col + u < width) atomicAdd(dst + u, x[u]);
}

// floats of dynamic shared memory, in the order the kernel lays them out
__host__ __device__ inline long long smem_floats(int n, int hm) {
  const int kp = round_up(hm, kBM) + 4;
  return 2LL * kBM * kp                     // e1 and dz2 tiles
         + kBK * kBN                        // streamed tile of W2 or W2^T
         + 3LL * kTileI * hm                // a rows, g rows, da accumulators
         + 6LL * hm                         // wd, b1, b2; dwd, db1, db2 accumulators
         + 2 * kBM                          // pair weight, pair d2
         + 2 * kBM                          // pair atom i (local), pair atom j
         + static_cast<long long>(kTileI) * n;  // list of live pairs
}

// acc[r][q] = sum_k lhs[m0 + r][k] * rhs[k][n0 + column q] over k < hm, for
// the thread's 8 rows and 8 columns; lhs is a [kBM][kp] tile in shared
// memory, rhs a contiguous (hm, hm) matrix in device memory that streams
// through `tile`, rounded to bf16 on the way in the bf16 mode.
template <bool BF16>
__device__ __forceinline__ void streamed_product(const float* lhs, int kp,
                                                 const float* __restrict__ rhs, int hm,
                                                 int n0, float* tile, int tid, int m0,
                                                 int col_lo, int col_hi,
                                                 float (&acc)[kRM][kRN]) {
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int q = 0; q < kRN; ++q) acc[r][q] = 0.f;
  const int kr = round_up(hm, kBK);
  for (int k0 = 0; k0 < kr; k0 += kBK) {
    __syncthreads();  // the tile is free (and lhs is complete)
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int k = k0 + e / kBN;
      const int col = n0 + e % kBN;
      tile[e] = (k < hm && col < hm)
                    ? mm_round<BF16>(rhs[static_cast<long long>(k) * hm + col])
                    : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float av[kRM][4];
#pragma unroll
      for (int r = 0; r < kRM; ++r) {
        const float4 t = *reinterpret_cast<const float4*>(&lhs[(m0 + r) * kp + k0 + kk]);
        av[r][0] = t.x;
        av[r][1] = t.y;
        av[r][2] = t.z;
        av[r][3] = t.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 lo = *reinterpret_cast<const float4*>(&tile[(kk + u) * kBN + col_lo]);
        const float4 hi = *reinterpret_cast<const float4*>(&tile[(kk + u) * kBN + col_hi]);
#pragma unroll
        for (int r = 0; r < kRM; ++r) {
          const float x = av[r][u];
          acc[r][0] += x * lo.x;
          acc[r][1] += x * lo.y;
          acc[r][2] += x * lo.z;
          acc[r][3] += x * lo.w;
          acc[r][4] += x * hi.x;
          acc[r][5] += x * hi.y;
          acc[r][6] += x * hi.z;
          acc[r][7] += x * hi.w;
        }
      }
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads) egnn_messages_bwd_kernel(
    const float* __restrict__ a, const float* __restrict__ c,
    const float* __restrict__ d2, const float* __restrict__ w,
    const float* __restrict__ wd, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ w2t,
    const float* __restrict__ b2, const float* __restrict__ g,
    float* __restrict__ da, float* __restrict__ dc, float* __restrict__ dwd,
    float* __restrict__ db1, float* __restrict__ dw2, float* __restrict__ db2, int n,
    int hm) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_total;

  const int kw = round_up(hm, kBM);  // written width of the e1 and dz2 tiles
  const int kp = kw + 4;             // their row stride, a multiple of 4 floats
  float* e1s = smem;                  // [kBM][kp]
  float* dz2s = e1s + kBM * kp;       // [kBM][kp]
  float* tile = dz2s + kBM * kp;      // [kBK][kBN]
  float* a_s = tile + kBK * kBN;      // [kTileI][hm]
  float* g_s = a_s + kTileI * hm;     // [kTileI][hm]
  float* da_s = g_s + kTileI * hm;    // [kTileI][hm]
  float* wd_s = da_s + kTileI * hm;   // [hm]
  float* b1_s = wd_s + hm;            // [hm]
  float* b2_s = b1_s + hm;            // [hm]
  float* dwd_s = b2_s + hm;           // [hm]
  float* db1_s = dwd_s + hm;          // [hm]
  float* db2_s = db1_s + hm;          // [hm]
  float* row_w = db2_s + hm;          // [kBM]
  float* row_d = row_w + kBM;         // [kBM]
  int* row_i = reinterpret_cast<int*>(row_d + kBM);  // [kBM]
  int* row_j = row_i + kBM;                           // [kBM], -1 = no pair
  int* pairs = row_j + kBM;                           // [kTileI * n]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kTileI;
  const int rows = min(kTileI, n - i0);
  const long long tile_at = (static_cast<long long>(b) * n + i0);
  const float* wb = w + tile_at * n;    // this tile's rows of w and d2
  const float* d2b = d2 + tile_at * n;
  const float* ab = a + tile_at * hm;
  const float* gb = g + tile_at * hm;
  const float* cb = c + static_cast<long long>(b) * n * hm;
  float* dab = da + tile_at * hm;
  float* dcb = dc + static_cast<long long>(b) * n * hm;
  const bool vector_ok = (hm & 3) == 0;  // rows of dc and dW2 start 16-byte aligned

  // list the pairs with a nonzero weight, in (i, j) order: warp 0, by ballot
  if (warp == 0) {
    int count = 0;
    const int cells = rows * n;
    for (int base = 0; base < cells; base += 32) {
      const int e = base + lane;
      const bool live = e < cells && wb[e] != 0.f;
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) pairs[count + __popc(mask & ((1u << lane) - 1u))] = e;
      count += __popc(mask);
    }
    if (lane == 0) s_total = count;
  }
  for (int e = tid; e < kTileI * hm; e += kThreads) da_s[e] = 0.f;
  for (int e = tid; e < rows * hm; e += kThreads) {
    a_s[e] = ab[e];
    g_s[e] = gb[e];
  }
  for (int e = tid; e < hm; e += kThreads) {
    wd_s[e] = wd[e];
    b1_s[e] = b1[e];
    b2_s[e] = b2[e];
    dwd_s[e] = 0.f;
    db1_s[e] = 0.f;
    db2_s[e] = 0.f;
  }
  __syncthreads();
  const int total = s_total;
  if (total == 0) {  // a tile of padding atoms
    for (int e = tid; e < rows * hm; e += kThreads) dab[e] = 0.f;
    return;
  }

  // the 8 columns of a thread within a pass: two runs of 4, so that a warp
  // reads 512 contiguous bytes of a tile row at a time
  const int col_lo = lane * 4;
  const int col_hi = kBN / 2 + lane * 4;
  const int m0 = warp * kRM;

  for (int p0 = 0; p0 < total; p0 += kBM) {
    __syncthreads();  // the previous chunk's tiles have been consumed
    if (tid < kBM) {
      const int p = p0 + tid;
      if (p < total) {
        const int e = pairs[p];
        row_i[tid] = e / n;
        row_j[tid] = e % n;
        row_w[tid] = wb[e];
        row_d[tid] = d2b[e];
      } else {
        row_i[tid] = 0;
        row_j[tid] = -1;
        row_w[tid] = 0.f;
        row_d[tid] = 0.f;
      }
    }
    __syncthreads();
    // e1 = silu(a_i + c_j + d2_ij * wd + b1) for the chunk's pairs, zero
    // beyond hm and for the rows past the list's end
    for (int e = tid; e < kBM * kw; e += kThreads) {
      const int m = e / kw;
      const int k = e - m * kw;
      const int j = row_j[m];
      float val = 0.f;
      if (j >= 0 && k < hm) {
        const float z = a_s[row_i[m] * hm + k] + cb[static_cast<long long>(j) * hm + k] +
                        row_d[m] * wd_s[k] + b1_s[k];
        val = mm_round<BF16>(silu(z));
      }
      e1s[m * kp + k] = val;
    }

    // z2 = e1 @ W2 + b2, then dz2 = w * g_i * silu'(z2) into shared memory
    for (int n0 = 0; n0 < kw; n0 += kBN) {
      float acc[kRM][kRN];
      streamed_product<BF16>(e1s, kp, w2, hm, n0, tile, tid, m0, col_lo, col_hi, acc);
      float part[kRN];
#pragma unroll
      for (int q = 0; q < kRN; ++q) part[q] = 0.f;
#pragma unroll
      for (int r = 0; r < kRM; ++r) {
        const int m = m0 + r;
        const bool live = row_j[m] >= 0;
        const int il = row_i[m];
        const float wgt = row_w[m];
#pragma unroll
        for (int q = 0; q < kRN; ++q) {
          const int col = n0 + (q < 4 ? col_lo + q : col_hi + q - 4);
          float val = 0.f;
          if (live && col < hm) {
            val = wgt * g_s[il * hm + col] * dsilu(acc[r][q] + b2_s[col]);
            part[q] += val;
          }
          if (col < kw) dz2s[m * kp + col] = mm_round<BF16>(val);
        }
      }
#pragma unroll
      for (int q = 0; q < kRN; ++q) {
        const int col = n0 + (q < 4 ? col_lo + q : col_hi + q - 4);
        if (col < hm) atomicAdd(&db2_s[col], part[q]);
      }
    }
    __syncthreads();  // the dz2 tile is complete

    // dW2[k][col] += sum over the chunk's pairs of e1[pair][k] * dz2[pair][col],
    // 64 rows k at a time
    for (int k0 = 0; k0 < hm; k0 += kBM) {
      for (int n0 = 0; n0 < kw; n0 += kBN) {
        const bool lo_in = n0 + col_lo < kw;  // kw is a multiple of 4: all four or none
        const bool hi_in = n0 + col_hi < kw;
        float acc[kRM][kRN];
#pragma unroll
        for (int r = 0; r < kRM; ++r)
#pragma unroll
          for (int q = 0; q < kRN; ++q) acc[r][q] = 0.f;
#pragma unroll 4
        for (int p = 0; p < kBM; ++p) {
          const float4 x0 = *reinterpret_cast<const float4*>(&e1s[p * kp + k0 + m0]);
          const float4 x1 = *reinterpret_cast<const float4*>(&e1s[p * kp + k0 + m0 + 4]);
          const float xs[kRM] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
          float4 lo = make_float4(0.f, 0.f, 0.f, 0.f);
          float4 hi = lo;
          if (lo_in) lo = *reinterpret_cast<const float4*>(&dz2s[p * kp + n0 + col_lo]);
          if (hi_in) hi = *reinterpret_cast<const float4*>(&dz2s[p * kp + n0 + col_hi]);
#pragma unroll
          for (int r = 0; r < kRM; ++r) {
            acc[r][0] += xs[r] * lo.x;
            acc[r][1] += xs[r] * lo.y;
            acc[r][2] += xs[r] * lo.z;
            acc[r][3] += xs[r] * lo.w;
            acc[r][4] += xs[r] * hi.x;
            acc[r][5] += xs[r] * hi.y;
            acc[r][6] += xs[r] * hi.z;
            acc[r][7] += xs[r] * hi.w;
          }
        }
#pragma unroll
        for (int r = 0; r < kRM; ++r) {
          const int k = k0 + m0 + r;
          if (k >= hm) continue;
          float* out = dw2 + static_cast<long long>(k) * hm + n0;
          add4(out + col_lo, &acc[r][0], n0 + col_lo, hm, vector_ok);
          add4(out + col_hi, &acc[r][4], n0 + col_hi, hm, vector_ok);
        }
      }
    }

    // de1 = dz2 @ W2^T, then dz1 = de1 * silu'(z1) and its five sums
    for (int n0 = 0; n0 < hm; n0 += kBN) {
      float acc[kRM][kRN];
      streamed_product<BF16>(dz2s, kp, w2t, hm, n0, tile, tid, m0, col_lo, col_hi, acc);
      int cols[kRN];
#pragma unroll
      for (int q = 0; q < kRN; ++q) cols[q] = n0 + (q < 4 ? col_lo + q : col_hi + q - 4);
      float sum_b1[kRN], sum_wd[kRN], sum_a[kRN];
#pragma unroll
      for (int q = 0; q < kRN; ++q) {
        sum_b1[q] = 0.f;
        sum_wd[q] = 0.f;
        sum_a[q] = 0.f;
      }
      int cur = -1;
#pragma unroll
      for (int r = 0; r < kRM; ++r) {
        const int m = m0 + r;
        const int j = row_j[m];
        if (j < 0) continue;
        const int il = row_i[m];
        if (il != cur) {
          if (cur >= 0) {
#pragma unroll
            for (int q = 0; q < kRN; ++q) {
              if (cols[q] < hm) atomicAdd(&da_s[cur * hm + cols[q]], sum_a[q]);
              sum_a[q] = 0.f;
            }
          }
          cur = il;
        }
        const float dist = row_d[m];
        const float* cj = cb + static_cast<long long>(j) * hm;
        float dz1[kRN];
#pragma unroll
        for (int q = 0; q < kRN; ++q) {
          dz1[q] = 0.f;
          if (cols[q] < hm) {
            const float z = a_s[il * hm + cols[q]] + cj[cols[q]] + dist * wd_s[cols[q]] +
                            b1_s[cols[q]];
            dz1[q] = acc[r][q] * dsilu(z);
          }
          sum_a[q] += dz1[q];
          sum_b1[q] += dz1[q];
          sum_wd[q] += dz1[q] * dist;
        }
        float* out = dcb + static_cast<long long>(j) * hm + n0;
        add4(out + col_lo, &dz1[0], n0 + col_lo, hm, vector_ok);
        add4(out + col_hi, &dz1[4], n0 + col_hi, hm, vector_ok);
      }
#pragma unroll
      for (int q = 0; q < kRN; ++q) {
        if (cols[q] >= hm) continue;
        if (cur >= 0) atomicAdd(&da_s[cur * hm + cols[q]], sum_a[q]);
        atomicAdd(&db1_s[cols[q]], sum_b1[q]);
        atomicAdd(&dwd_s[cols[q]], sum_wd[q]);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < rows * hm; e += kThreads) dab[e] = da_s[e];
  for (int e = tid; e < hm; e += kThreads) {
    atomicAdd(&dwd[e], dwd_s[e]);
    atomicAdd(&db1[e], db1_s[e]);
    atomicAdd(&db2[e], db2_s[e]);
  }
}

template <bool BF16>
int launch(const float* a, const float* c, const float* d2, const float* w, const float* wd,
           const float* b1, const float* w2, const float* w2t, const float* b2,
           const float* g, float* da, float* dc, float* dwd, float* db1, float* dw2,
           float* db2, int batch, int n, int hm, cudaStream_t stream) {
  const long long bytes = smem_floats(n, hm) * 4;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(egnn_messages_bwd_kernel<BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTileI - 1) / kTileI, batch);
  egnn_messages_bwd_kernel<BF16><<<grid, kThreads, bytes, stream>>>(
      a, c, d2, w, wd, b1, w2, w2t, b2, g, da, dc, dwd, db1, dw2, db2, n, hm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of shared memory a block needs at these sizes; the wrapper refuses
// sizes above the card's 232448.
extern "C" long long egnn_messages_bwd_smem_bytes(int n, int hm) {
  return smem_floats(n, hm) * 4;
}

// a, c, g, da, dc: (B, N, Hm); d2, w: (B, N, N); wd, b1, b2, dwd, db1, db2:
// (Hm,); w2, w2t, dw2: (Hm, Hm) with z2 = e1 @ w2 and w2t its transpose. All
// contiguous float32. dc, dwd, db1, dw2 and db2 must arrive zeroed: the
// kernel adds into them. bf16_product != 0 rounds e1, w2 and dz2 to bf16
// before the products. Returns a cudaError_t.
extern "C" int egnn_messages_bwd(const void* a, const void* c, const void* d2, const void* w,
                                 const void* wd, const void* b1, const void* w2,
                                 const void* w2t, const void* b2, const void* g, void* da,
                                 void* dc, void* dwd, void* db1, void* dw2, void* db2,
                                 int batch, int n, int hm, int bf16_product, void* stream) {
  if (batch <= 0 || n <= 0 || hm <= 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (bf16_product)
    return launch<true>(f(a), f(c), f(d2), f(w), f(wd), f(b1), f(w2), f(w2t), f(b2), f(g),
                        o(da), o(dc), o(dwd), o(db1), o(dw2), o(db2), batch, n, hm, s);
  return launch<false>(f(a), f(c), f(d2), f(w), f(wd), f(b1), f(w2), f(w2t), f(b2), f(g),
                       o(da), o(dc), o(dwd), o(db1), o(dw2), o(db2), batch, n, hm, s);
}
