// K3: fused EGNN message aggregation (forward).
//
// Replaces the TPU kernel coati_tpu/ops/pallas/egnn_messages.py
// (egnn_messages -> _fwd_pallas -> _fwd_kernel). Same function, for every
// atom i of every molecule b:
//
//   out[b,i] = sum_j w[b,i,j] * silu( silu(a[b,i] + c[b,j] + d2[b,i,j]*wd + b1)
//                                     @ W2 + b2 )
//
// the two-layer edge MLP of an e_gcl layer with the cutoff/pair mask folded
// into the sum, without the (B, N, N, Hm) pairwise tensor ever reaching
// device memory. All arithmetic is float32; in the bf16 mode the two inputs
// of the inner product (e1 and W2) are rounded to bf16 first and the
// product still accumulates in float32.
//
// What bounds it on an H100: operations. Per live pair it does 2*Hm^2
// multiply-adds' worth of work on 3*Hm loaded values that stay in cache, so
// the float32 FMA rate of the CUDA cores is the limit (the bf16 mode
// multiplies on CUDA cores too; tensor cores are later work).
//
// Design:
//  * one block per (molecule, tile of 8 atoms i). It first lists the pairs
//    (i, j) of its tile whose weight is not zero, in (i, j) order, by a
//    ballot scan; every later step walks that list, so a pair with w = 0
//    (padding atoms, the atom itself, partners beyond the cutoff) costs
//    nothing, and a tile of padding atoms writes zeros and returns;
//  * the listed pairs are the rows of a tiled SGEMM, 64 rows at a time:
//    the block computes the 64 x Hm tile of e1 into shared memory, then
//    streams W2 through shared memory in 16-deep tiles; each thread keeps
//    an 8 x 8 register tile of z2 (8 pairs of one warp's rows, 8 columns);
//  * the epilogue applies b2, SiLU and the pair weight in registers, sums a
//    thread's rows of one atom i, and adds the partial sums to a per-tile
//    accumulator in shared memory (shared-memory atomics: the order of
//    those few float adds may differ from run to run);
//  * no padding of B, N or Hm is needed: ragged edges are masked here.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileI = 8;   // atoms i per block
constexpr int kBM = 64;     // pairs (GEMM rows) per chunk
constexpr int kBN = 256;    // output columns per pass
constexpr int kBK = 16;     // depth of one W2 tile
constexpr int kRM = 8;      // rows per thread: kBM / (kThreads / 32)
constexpr int kRN = 8;      // columns per thread: kBN / 32
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block can ask for

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

template <bool BF16>
__device__ __forceinline__ float mm_round(float x) {
  if (BF16) return __bfloat162float(__float2bfloat16(x));
  return x;
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// floats of dynamic shared memory, in the order the kernel lays them out
__host__ __device__ inline long long smem_floats(int n, int hm) {
  const int kp = round_up(hm, kBK) + 4;
  return static_cast<long long>(kBM) * kp   // e1 tile
         + kBK * kBN                        // W2 tile
         + 2LL * kTileI * hm                // a rows, accumulators
         + 3LL * hm                         // wd, b1, b2
         + 2 * kBM                          // pair weight, pair d2
         + 2 * kBM                          // pair atom i (local), pair atom j
         + static_cast<long long>(kTileI) * n;  // list of live pairs
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads, 2) egnn_messages_kernel(
    const float* __restrict__ a, const float* __restrict__ c,
    const float* __restrict__ d2, const float* __restrict__ w,
    const float* __restrict__ wd, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ out, int n, int hm) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_total;

  const int kr = round_up(hm, kBK);
  const int kp = kr + 4;  // row stride of the e1 tile, a multiple of 4 floats
  float* e1s = smem;                  // [kBM][kp]
  float* w2s = e1s + kBM * kp;        // [kBK][kBN]
  float* a_s = w2s + kBK * kBN;       // [kTileI][hm]
  float* acc_s = a_s + kTileI * hm;   // [kTileI][hm]
  float* wd_s = acc_s + kTileI * hm;  // [hm]
  float* b1_s = wd_s + hm;            // [hm]
  float* b2_s = b1_s + hm;            // [hm]
  float* row_w = b2_s + hm;           // [kBM]
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
  const long long tile = (static_cast<long long>(b) * n + i0);
  const float* wb = w + tile * n;    // this tile's rows of w and d2
  const float* d2b = d2 + tile * n;
  const float* ab = a + tile * hm;
  const float* cb = c + static_cast<long long>(b) * n * hm;
  float* ob = out + tile * hm;

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
  for (int e = tid; e < kTileI * hm; e += kThreads) acc_s[e] = 0.f;
  for (int e = tid; e < rows * hm; e += kThreads) a_s[e] = ab[e];
  for (int e = tid; e < hm; e += kThreads) {
    wd_s[e] = wd[e];
    b1_s[e] = b1[e];
    b2_s[e] = b2[e];
  }
  __syncthreads();
  const int total = s_total;
  if (total == 0) {  // a tile of padding atoms
    for (int e = tid; e < rows * hm; e += kThreads) ob[e] = 0.f;
    return;
  }

  // the 8 columns of a thread within a pass: two runs of 4, so that a warp
  // reads 512 contiguous bytes of a W2 tile row at a time
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
    // e1 = silu(a_i + c_j + d2_ij * wd + b1) for the chunk's pairs
    for (int e = tid; e < kBM * kr; e += kThreads) {
      const int m = e / kr;
      const int k = e - m * kr;
      const int j = row_j[m];
      float val = 0.f;
      if (j >= 0 && k < hm) {
        const float z = a_s[row_i[m] * hm + k] + cb[static_cast<long long>(j) * hm + k] +
                        row_d[m] * wd_s[k] + b1_s[k];
        val = mm_round<BF16>(silu(z));
      }
      e1s[m * kp + k] = val;
    }

    for (int n0 = 0; n0 < hm; n0 += kBN) {
      float acc[kRM][kRN];
#pragma unroll
      for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int q = 0; q < kRN; ++q) acc[r][q] = 0.f;

      for (int k0 = 0; k0 < kr; k0 += kBK) {
        __syncthreads();  // the W2 tile is free (and e1s is complete)
        for (int e = tid; e < kBK * kBN; e += kThreads) {
          const int k = k0 + e / kBN;
          const int col = n0 + e % kBN;
          w2s[e] = (k < hm && col < hm)
                       ? mm_round<BF16>(w2[static_cast<long long>(k) * hm + col])
                       : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 4) {
          float av[kRM][4];
#pragma unroll
          for (int r = 0; r < kRM; ++r) {
            const float4 t =
                *reinterpret_cast<const float4*>(&e1s[(m0 + r) * kp + k0 + kk]);
            av[r][0] = t.x;
            av[r][1] = t.y;
            av[r][2] = t.z;
            av[r][3] = t.w;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 lo =
                *reinterpret_cast<const float4*>(&w2s[(kk + u) * kBN + col_lo]);
            const float4 hi =
                *reinterpret_cast<const float4*>(&w2s[(kk + u) * kBN + col_hi]);
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

      // epilogue: m = silu(z2 + b2), weighted, summed over a thread's rows
      // of one atom i, then added to that atom's accumulator
      int cols[kRN];
      float bias[kRN];
#pragma unroll
      for (int q = 0; q < kRN; ++q) {
        cols[q] = n0 + (q < 4 ? col_lo + q : col_hi + q - 4);
        bias[q] = cols[q] < hm ? b2_s[cols[q]] : 0.f;
      }
      float part[kRN];
#pragma unroll
      for (int q = 0; q < kRN; ++q) part[q] = 0.f;
      int cur = -1;
#pragma unroll
      for (int r = 0; r < kRM; ++r) {
        const int m = m0 + r;
        if (row_j[m] < 0) continue;
        const int il = row_i[m];
        if (il != cur) {
          if (cur >= 0) {
#pragma unroll
            for (int q = 0; q < kRN; ++q) {
              if (cols[q] < hm) atomicAdd(&acc_s[cur * hm + cols[q]], part[q]);
              part[q] = 0.f;
            }
          }
          cur = il;
        }
        const float wgt = row_w[m];
#pragma unroll
        for (int q = 0; q < kRN; ++q) part[q] += wgt * silu(acc[r][q] + bias[q]);
      }
      if (cur >= 0) {
#pragma unroll
        for (int q = 0; q < kRN; ++q)
          if (cols[q] < hm) atomicAdd(&acc_s[cur * hm + cols[q]], part[q]);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < rows * hm; e += kThreads) ob[e] = acc_s[e];
}

template <bool BF16>
int launch(const float* a, const float* c, const float* d2, const float* w,
           const float* wd, const float* b1, const float* w2, const float* b2,
           float* out, int batch, int n, int hm, cudaStream_t stream) {
  const long long bytes = smem_floats(n, hm) * 4;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(egnn_messages_kernel<BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTileI - 1) / kTileI, batch);
  egnn_messages_kernel<BF16><<<grid, kThreads, bytes, stream>>>(a, c, d2, w, wd, b1, w2,
                                                                  b2, out, n, hm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of shared memory a block needs at these sizes; the wrapper refuses
// sizes above the card's 232448.
extern "C" long long egnn_messages_smem_bytes(int n, int hm) {
  return smem_floats(n, hm) * 4;
}

// a, c: (B, N, Hm); d2, w: (B, N, N); wd, b1, b2: (Hm,); w2: (Hm, Hm) with
// z2 = e1 @ w2; out: (B, N, Hm). All contiguous float32. bf16_product != 0
// rounds e1 and w2 to bf16 before the product. Returns a cudaError_t.
extern "C" int egnn_messages(const void* a, const void* c, const void* d2, const void* w,
                             const void* wd, const void* b1, const void* w2,
                             const void* b2, void* out, int batch, int n, int hm,
                             int bf16_product, void* stream) {
  if (batch <= 0 || n <= 0 || hm <= 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (bf16_product)
    return launch<true>(f(a), f(c), f(d2), f(w), f(wd), f(b1), f(w2), f(b2),
                        static_cast<float*>(out), batch, n, hm, s);
  return launch<false>(f(a), f(c), f(d2), f(w), f(wd), f(b1), f(w2), f(b2),
                       static_cast<float*>(out), batch, n, hm, s);
}
