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
// products (6*Hm^2 operations, three times K3) on values that stay on chip.
// A pair with zero weight costs nothing: its dz2, and with it every term
// above, is zero. Both bodies share K3's decomposition into work items of
// (molecule, tile of 8 atoms i), whose live pairs are listed by a ballot
// scan and walked 64 at a time, and both sum da in shared memory.
//
// bf16 mode: tensor cores (egnn_messages_bwd_bf16_kernel).
//  * clusters of 4 blocks (16 warps each at Hm > 128, else 8), persistent:
//    Q clusters, as many as fit on the card at once. A first small kernel
//    (egnn_item_costs_kernel, egnn_items.cuh, shared with K3's bf16 body)
//    counts each work item's live pairs
//    and sums the items' costs (8 a chunk of 64 pairs, 1 an item); cluster
//    q takes the items whose cost starts in the q-th of Q equal ranges of
//    the sum. Items differ up to 16x in pairs (molecules of 15-98 atoms,
//    empty tiles of padding): handed out round robin, the most loaded of
//    an H100's 30 clusters made the launch 15% longer. The ranges leave at
//    most an item over, and depend only on w: the assignment is the same
//    on every launch;
//  * the block of rank r in its cluster owns a slice of SW = Hp / 4 columns
//    (Hp: Hm rounded up to 128 or 256): the columns r SW .. of z2, dz2 and
//    dW2 and the rows r SW .. of W2 (the columns of e1, de1 and dz1). It
//    keeps its two slices of W2, in bf16, in shared memory for the whole
//    launch (Hp x SW and SW x Hp: 64 KB at Hm 256): W2 is read once a
//    block, and W2^T is the same data read the other way by ldmatrix;
//  * the item's live pairs are listed by partner j, then atom i, and
//    walked 64 at a time; while a chunk is computed, the next chunk's slice
//    of c (the rows of its partners) arrives by 16-byte cp.async copies in
//    a second buffer;
//  * per chunk a block computes its columns of e1 (and keeps silu'(z1) in
//    place of c), takes the other three slices from the other blocks'
//    shared memory (distributed shared memory, after a cluster barrier),
//    and then on the tensor cores (mma.sync m16n8k16, bf16 in, float32
//    out, operands by ldmatrix from XOR-swizzled tiles): z2 = e1 W2[:, slice]
//    (64 x SW), dz2 of its columns, dW2[:, slice] += e1^T dz2[:, slice]
//    (Hp x SW, in registers: 32 floats a thread at Hm 256, for the whole
//    launch), then, with the other blocks' columns of dz2 taken the same
//    way after a second barrier, de1[:, slice] = dz2 W2[slice, :]^T and
//    dz1 of its columns, into the chunk's buffer;
//  * a walk then sums dz1 without contention: each thread takes one column
//    and 64 SW / (threads a block) consecutive pairs (8 at Hm 256). It
//    adds da of each pair's atom into its own accumulator row (summed in
//    group order at the item's end), db1 and dwd into registers, and each
//    run of pairs with one partner j (up to 8: the atoms of the item) into
//    dc[j] by one float32 atomic add;
//  * so dW2 leaves the registers once a launch. Every block writes its
//    partial dW2, db2, db1 and dwd to a scratch row of its cluster, and the
//    last block of each rank to finish (a counter) adds the clusters' rows
//    in cluster order: da and the parameter gradients repeat bit for bit
//    from run to run; dc, summed by atomics, may differ in its last bits.
//
// float32 mode: CUDA cores (egnn_messages_bwd_f32_kernel), for the fidelity
//  runs, which TF32 could not meet. A block per work item; per chunk of 64
//  pairs the block keeps e1 and dz2 in shared memory and runs the three
//  products with an 8 x 8 register tile a thread, W2 (for z2) and W2^T (for
//  de1, read column by column from W2) streamed through 16-deep tiles;
//  dW2 is added by float32 atomics once a chunk, dc, dwd, db1, db2 by
//  atomics too, so all of these may differ in their last bits.
//
// Rows i and columns j without a live pair get exactly zero da and dc; no
// padding of B, N or Hm is needed: ragged edges are masked here.
#include <cooperative_groups.h>

#include "common.cuh"
#include "egnn_items.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTileI = 8;   // atoms i per work item
constexpr int kBM = 64;     // pairs (GEMM rows) per chunk
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block can ask for

#if __CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)
#define COATI_VECTOR_ATOMICS 1
#else
#define COATI_VECTOR_ATOMICS 0
#endif

// ------------------------------------------------------ float32 body

constexpr int kBN = 256;    // output columns per pass
constexpr int kBNP = kBN + 4;  // row of a streamed tile (padded: W2^T is stored by columns)
constexpr int kBK = 16;     // depth of one streamed tile of W2 or W2^T
constexpr int kRM = 8;      // rows per thread: kBM / (kThreads / 32)
constexpr int kRN = 8;      // columns per thread: kBN / 32

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float dsilu(float x) {
  const float s = 1.f / (1.f + expf(-x));
  return s * (1.f + x * (1.f - s));
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
         + kBK * kBNP                       // streamed tile of W2 or W2^T
         + 3LL * kTileI * hm                // a rows, g rows, da accumulators
         + 6LL * hm                         // wd, b1, b2; dwd, db1, db2 accumulators
         + 2 * kBM                          // pair weight, pair d2
         + 2 * kBM                          // pair atom i (local), pair atom j
         + static_cast<long long>(kTileI) * n;  // list of live pairs
}

// acc[r][q] = sum_k lhs[m0 + r][k] * rhs[k][n0 + column q] over k < hm, for
// the thread's 8 rows and 8 columns; lhs is a [kBM][kp] tile in shared
// memory, rhs the contiguous (hm, hm) W2 in device memory (TRANS: its
// transpose, read column by column), streamed through `tile` in 16-deep
// tiles with rows of kBNP floats.
template <bool TRANS>
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
      // W2^T: neighbouring threads take neighbouring k of one column of W2
      const int kk = TRANS ? e % kBK : e / kBN;
      const int cc = TRANS ? e / kBK : e % kBN;
      const int k = k0 + kk;
      const int col = n0 + cc;
      const long long at = TRANS ? static_cast<long long>(col) * hm + k
                                 : static_cast<long long>(k) * hm + col;
      tile[kk * kBNP + cc] = (k < hm && col < hm) ? rhs[at] : 0.f;
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
        const float4 lo = *reinterpret_cast<const float4*>(&tile[(kk + u) * kBNP + col_lo]);
        const float4 hi = *reinterpret_cast<const float4*>(&tile[(kk + u) * kBNP + col_hi]);
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

__global__ void __launch_bounds__(kThreads) egnn_messages_bwd_f32_kernel(
    const float* __restrict__ a, const float* __restrict__ c,
    const float* __restrict__ d2, const float* __restrict__ w,
    const float* __restrict__ wd, const float* __restrict__ b1,
    const float* __restrict__ w2,
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
  float* tile = dz2s + kBM * kp;      // [kBK][kBNP]
  float* a_s = tile + kBK * kBNP;     // [kTileI][hm]
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
        val = silu(z);
      }
      e1s[m * kp + k] = val;
    }

    // z2 = e1 @ W2 + b2, then dz2 = w * g_i * silu'(z2) into shared memory
    for (int n0 = 0; n0 < kw; n0 += kBN) {
      float acc[kRM][kRN];
      streamed_product<false>(e1s, kp, w2, hm, n0, tile, tid, m0, col_lo, col_hi, acc);
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
          if (col < kw) dz2s[m * kp + col] = val;
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
      streamed_product<true>(dz2s, kp, w2, hm, n0, tile, tid, m0, col_lo, col_hi, acc);
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


// --------------------------------------------------------- bf16 body

constexpr int kCluster = 4;   // blocks of a cluster; one column slice each

// warps of a block that owns SW columns: 16 at SW 64 (a warp then keeps 32
// floats of the dW2 slice), 8 at SW 32
__host__ __device__ constexpr int tc_warps(int sw) { return sw == 64 ? 16 : 8; }

// Element offset of the 8-element chunk `c` of row `r` in a shared tile
// whose rows are HP bf16 values (HP >= 64): the chunk is XORed with the
// row's low three bits, as coati::swizzle does for rows of 128 bytes.
template <int HP>
__device__ __forceinline__ int wide(int r, int c) {
  return r * HP + ((c ^ (r & 7)) << 3);
}

// Row stride, in floats, of a chunk's buffer of c (then silu'(z1), then
// dz1): SW + 8, so that the float2 accesses of a C fragment's 8 rows fall
// in distinct banks.
__host__ __device__ constexpr int c_stride(int sw) { return sw + 8; }

// Shared memory of the bf16 body, in bytes, in the order the kernel lays
// it out: W2's column slice (Hp x SW) and row slice (SW x Hp), the e1 and
// dz2 tiles (64 x Hp), all bf16; two buffers of the slice of c of a chunk's
// partners (64 rows of c_stride(SW) float32); the a and g rows of the work
// item's 8 atoms and da's accumulators of each row group of the walk
// (32 tc_warps(SW) / SW groups), SW float32 a row; wd, b1, b2 of the slice; two
// buffers of a chunk's pairs (weight, d2, atom i, atom j); the item's rows
// of w and d2 and its list of live pairs (8 x N each).
__host__ __device__ inline long long bf16_smem_bytes(int n, int sw) {
  const long long hp = 4LL * sw;
  const long long groups = 32 * tc_warps(sw) / sw;
  return 2 * (2 * hp * sw + 2 * kBM * hp) +
         4 * (2LL * kBM * c_stride(sw) + (2 + groups) * kTileI * sw + 3 * sw + 8 * kBM) +
         12LL * kTileI * n;
}

template <int SW>
__global__ void __launch_bounds__(32 * tc_warps(SW), 1) egnn_messages_bwd_bf16_kernel(
    const float* __restrict__ a, const float* __restrict__ c, const float* __restrict__ d2,
    const float* __restrict__ w, const float* __restrict__ wd, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, const float* __restrict__ g,
    float* __restrict__ da, float* __restrict__ dc, float* __restrict__ dwd,
    float* __restrict__ db1, float* __restrict__ dw2, float* __restrict__ db2,
    float* __restrict__ scratch, const long long* __restrict__ cost, unsigned* __restrict__ done,
    int batch, int n, int hm) {
  constexpr int W = tc_warps(SW);
  constexpr int THREADS = 32 * W;
  constexpr int HP = 4 * SW;        // padded width of e1 and dz2
  constexpr int WC = SW / (W / 4);  // columns of a warp's tile of z2 and de1 (16 rows)
  constexpr int NT = WC / 8;        // its n8 tiles
  constexpr int MT = HP / W / 16;   // m16 tiles of a warp's HP / W rows of dW2
  constexpr int NW = SW / 8;        // n8 tiles of dW2's slice
  constexpr int CS = c_stride(SW);  // row of a buffer of c
  constexpr int G = THREADS / SW;   // row groups of the walk
  constexpr int RG = kBM / G;       // rows of a group
  static_assert(NT % 2 == 0 && MT >= 1, "warp tiles of whole ldmatrix_x4 loads");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int s_total;
  __shared__ bool s_last;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_clusters = gridDim.x / kCluster;
  const int cl = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;        // the row of a C fragment (and that row + 8)
  const int tq = 2 * (lane & 3);   // the first of its two columns
  const int s0 = rank * SW;        // the block's slice of columns

  auto* w2c = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [HP][SW]: W2[:, slice]
  __nv_bfloat16* w2r = w2c + HP * SW;                       // [SW][HP]: W2[slice, :]
  __nv_bfloat16* e1s = w2r + SW * HP;                       // [kBM][HP]
  __nv_bfloat16* dz2s = e1s + kBM * HP;                     // [kBM][HP]
  auto* c_buf = reinterpret_cast<float*>(dz2s + kBM * HP);  // [2][kBM][CS]
  float* a_s = c_buf + 2 * kBM * CS;                        // [kTileI][SW]
  float* g_s = a_s + kTileI * SW;                           // [kTileI][SW]
  float* da_g = g_s + kTileI * SW;                          // [G][kTileI][SW]
  float* wd_s = da_g + G * kTileI * SW;                     // [SW]
  float* b1_s = wd_s + SW;                                  // [SW]
  float* b2_s = b1_s + SW;                                  // [SW]
  float* row_w2 = b2_s + SW;                                // [2][kBM]: pair weight
  float* row_d2 = row_w2 + 2 * kBM;                         // [2][kBM]: pair d2
  int* row_i2 = reinterpret_cast<int*>(row_d2 + 2 * kBM);   // [2][kBM]: atom i (local)
  int* row_j2 = row_i2 + 2 * kBM;                           // [2][kBM]: atom j, -1 = no pair
  auto* w_s = reinterpret_cast<float*>(row_j2 + 2 * kBM);   // [kTileI * n]: the item's w
  float* d2_s = w_s + kTileI * n;                           // [kTileI * n]: and d2
  auto* pairs = reinterpret_cast<int*>(d2_s + kTileI * n);  // [kTileI * n]

  // W2's two slices, rounded to bf16, zero beyond hm; the slice's vectors
  for (int e = tid; e < HP * SW; e += THREADS) {
    const int k = e / SW, col = e % SW;  // W2[k][s0 + col]
    const bool ok = k < hm && s0 + col < hm;
    w2c[coati::swizzle<SW>(k, col / 8) + col % 8] =
        __float2bfloat16(ok ? w2[static_cast<long long>(k) * hm + s0 + col] : 0.f);
  }
  for (int e = tid; e < SW * HP; e += THREADS) {
    const int r = e / HP, col = e % HP;  // W2[s0 + r][col]
    const bool ok = s0 + r < hm && col < hm;
    w2r[wide<HP>(r, col / 8) + col % 8] =
        __float2bfloat16(ok ? w2[static_cast<long long>(s0 + r) * hm + col] : 0.f);
  }
  for (int e = tid; e < SW; e += THREADS) {
    const bool ok = s0 + e < hm;
    wd_s[e] = ok ? wd[s0 + e] : 0.f;
    b1_s[e] = ok ? b1[s0 + e] : 0.f;
    b2_s[e] = ok ? b2[s0 + e] : 0.f;
  }

  // the parameter gradients of the block's slice, summed over its pairs:
  // dW2 and db2 in the C fragments' layout, db1 and dwd by the walk
  float acc_w2[MT][NW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_w2[mt][nt][e] = 0.f;
  float p_db2[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) p_db2[nt][0] = p_db2[nt][1] = 0.f;
  float w_db1 = 0.f, w_dwd = 0.f;
  const int wk = tid % SW;  // the walk's column of the slice
  const int wq = tid / SW;  // and its group of RG rows of a chunk

  // a warp's tile of z2 and de1: rows m0 .., columns c0 .. c0 + WC of the slice
  const int m0 = 16 * (warp & 3);
  const int c0 = (warp >> 2) * WC;
  const int tiles = (n + kTileI - 1) / kTileI;
  const int items = batch * tiles;

  // the cluster's items: those whose cost starts in its range of the
  // costs' sum, the same in every block of the cluster and on every launch
  // with the same w
  int first, end;
  coati::item_range(cost, items, cl, n_clusters, &first, &end);
  for (int item = first; item < end; ++item) {
    const int b = item / tiles;
    const int i0 = (item - b * tiles) * kTileI;
    const int rows = min(kTileI, n - i0);
    const long long tile_at = static_cast<long long>(b) * n + i0;
    const float* cb = c + static_cast<long long>(b) * n * hm;
    float* dcb = dc + static_cast<long long>(b) * n * hm;
    if (cost[item] - coati::item_start(cost, item) == 1) {  // no live pair: da is zero
      for (int e = tid; e < rows * SW; e += THREADS) {
        const int k = s0 + e % SW;
        if (k < hm) da[(tile_at + e / SW) * hm + k] = 0.f;
      }
      continue;
    }

    __syncthreads();  // the previous item's lists and rows are consumed
    for (int e = tid; e < rows * n; e += THREADS) {
      w_s[e] = w[tile_at * n + e];
      d2_s[e] = d2[tile_at * n + e];
    }
    __syncthreads();
    if (warp == 0) {  // the live pairs by partner j, then atom i, by ballot
      int count = 0;
      const int cells = rows * n;
      for (int base = 0; base < cells; base += 32) {
        const int e = base + lane;
        const int j = e / rows, il = e - j * rows;
        const bool live = e < cells && w_s[il * n + j] != 0.f;
        const unsigned mask = __ballot_sync(0xffffffffu, live);
        if (live) pairs[count + __popc(mask & ((1u << lane) - 1u))] = il * n + j;
        count += __popc(mask);
      }
      if (lane == 0) s_total = count;
    }
    for (int e = tid; e < kTileI * SW; e += THREADS) {
      const int il = e / SW, k = s0 + e % SW;
      const bool ok = il < rows && k < hm;
      a_s[e] = ok ? a[(tile_at + il) * hm + k] : 0.f;
      g_s[e] = ok ? g[(tile_at + il) * hm + k] : 0.f;
    }
    for (int e = tid; e < G * kTileI * SW; e += THREADS) da_g[e] = 0.f;
    __syncthreads();
    const int total = s_total;  // the same in every block of the cluster

    // the pairs p .. p + 63 of the list into buffer `buf`: their weight,
    // d2 and atoms, and the slice of c of their partners (zero beyond hm
    // and past the list's end) by 16-byte copies, in flight until waited for
    auto stage = [&](int p, int buf) {
      if (tid < kBM) {
        const bool ok = p + tid < total;
        const int e = ok ? pairs[p + tid] : 0;
        row_w2[buf * kBM + tid] = ok ? w_s[e] : 0.f;
        row_d2[buf * kBM + tid] = ok ? d2_s[e] : 0.f;
        row_i2[buf * kBM + tid] = e / n;
        row_j2[buf * kBM + tid] = ok ? e % n : -1;
      }
      float* cs = c_buf + buf * kBM * CS;
      if ((hm & 3) == 0) {
#pragma unroll
        for (int it = 0; it < kBM * SW / 4 / THREADS; ++it) {
          const int e = tid + it * THREADS;
          const int m = e / (SW / 4), q = 4 * (e % (SW / 4));
          const int j = p + m < total ? pairs[p + m] % n : -1;
          const bool ok = j >= 0 && s0 + q < hm;
          coati::cp_async_16(cs + m * CS + q,
                             ok ? cb + static_cast<long long>(j) * hm + s0 + q : cb, ok);
        }
      } else {
        for (int e = tid; e < kBM * SW; e += THREADS) {
          const int m = e / SW, q = e % SW;
          const int j = p + m < total ? pairs[p + m] % n : -1;
          cs[m * CS + q] = j >= 0 && s0 + q < hm ? cb[static_cast<long long>(j) * hm + s0 + q] : 0.f;
        }
      }
      coati::cp_async_commit();
    };
    if (total > 0) stage(0, 0);

    for (int p0 = 0, cur = 0; p0 < total; p0 += kBM, cur ^= 1) {
      // the next chunk goes to the other buffer, free since the barrier
      // that closed the previous chunk; an empty group when there is none
      if (p0 + kBM < total)
        stage(p0 + kBM, cur ^ 1);
      else
        coati::cp_async_commit();
      coati::cp_async_wait<1>();
      __syncthreads();  // this chunk's pairs and rows of c are here
      const float* row_w = row_w2 + cur * kBM;
      const float* row_d = row_d2 + cur * kBM;
      const int* row_i = row_i2 + cur * kBM;
      const int* row_j = row_j2 + cur * kBM;
      float* cs = c_buf + cur * kBM * CS;

      // the slice's columns of e1 = silu(z1), z1 = a_i + c_j + d2 wd + b1,
      // in bf16 (zero beyond hm and for rows past the list's end); silu'(z1)
      // replaces c in the buffer
#pragma unroll
      for (int it = 0; it < kBM * SW / 2 / THREADS; ++it) {
        const int e = tid + it * THREADS;
        const int m = e / (SW / 2);
        const int kk = 2 * (e - m * (SW / 2));
        float v[2] = {0.f, 0.f}, ds[2] = {0.f, 0.f};
        if (row_j[m] >= 0) {
          const int il = row_i[m];
          const float dist = row_d[m];
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (s0 + kk + u < hm) {
              const float z = a_s[il * SW + kk + u] + cs[m * CS + kk + u] +
                              dist * wd_s[kk + u] + b1_s[kk + u];
              const float sg = 1.f / (1.f + expf(-z));
              v[u] = z * sg;
              ds[u] = sg * (1.f + z * (1.f - sg));
            }
        }
        *reinterpret_cast<uint32_t*>(e1s + wide<HP>(m, (s0 + kk) / 8) + kk % 8) =
            coati::pack_bf16(v[0], v[1]);
        *reinterpret_cast<float2*>(cs + m * CS + kk) = make_float2(ds[0], ds[1]);
      }
      cluster.sync();  // every block's slice of e1 is written
#pragma unroll
      for (int it = 0; it < (kCluster - 1) * kBM * (SW / 8) / THREADS; ++it) {
        const int e = tid + it * THREADS;
        const int other = (rank + 1 + e / (kBM * (SW / 8))) % kCluster;
        const int x = e % (kBM * (SW / 8));
        const int at = wide<HP>(x / (SW / 8), other * (SW / 8) + x % (SW / 8));
        const int4* src = cluster.map_shared_rank(reinterpret_cast<int4*>(e1s + at), other);
        *reinterpret_cast<int4*>(e1s + at) = *src;
      }
      __syncthreads();  // the whole of e1 is here

      // z2 = e1 W2[:, slice]: the warp's 16 rows and WC columns
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < HP / 16; ++kk) {
        uint32_t af[4];
        coati::ldmatrix_x4(af, e1s + wide<HP>(m0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                              2 * kk + (lane >> 4)));
#pragma unroll
        for (int dp = 0; dp < NT / 2; ++dp) {
          uint32_t bf[4];  // rows k 16 kk .., columns c0 + 16 dp ..: W2 read as stored
          coati::ldmatrix_x4_trans(
              bf, w2c + coati::swizzle<SW>(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                                           c0 / 8 + 2 * dp + (lane >> 4)));
          coati::mma_bf16(acc[2 * dp], af, bf[0], bf[1]);
          coati::mma_bf16(acc[2 * dp + 1], af, bf[2], bf[3]);
        }
      }
      // dz2 = w g_i silu'(z2 + b2) of the slice's columns; db2 sums it
      // unrounded, dz2 goes to the tile in bf16
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + gq + 8 * h;
        const bool live = row_j[m] >= 0;
        const int il = row_i[m];
        const float wgt = row_w[m];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int lc = c0 + 8 * nt + tq;
          float v[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            v[u] = 0.f;
            if (live && s0 + lc + u < hm)
              v[u] = wgt * g_s[il * SW + lc + u] * dsilu(acc[nt][2 * h + u] + b2_s[lc + u]);
            p_db2[nt][u] += v[u];
          }
          *reinterpret_cast<uint32_t*>(dz2s + wide<HP>(m, (s0 + lc) / 8) + lc % 8) =
              coati::pack_bf16(v[0], v[1]);
        }
      }
      __syncthreads();  // the slice's dz2 is complete

      // dW2[:, slice] += e1^T dz2[:, slice]: the warp's HP/W rows k, all SW columns
#pragma unroll
      for (int ps = 0; ps < kBM / 16; ++ps) {
        uint32_t bfr[NW / 2][4];  // pairs 16 ps .., the slice's columns 16 dp ..
#pragma unroll
        for (int dp = 0; dp < NW / 2; ++dp)
          coati::ldmatrix_x4_trans(
              bfr[dp], dz2s + wide<HP>(16 * ps + (lane & 7) + (((lane >> 3) & 1) << 3),
                                       s0 / 8 + 2 * dp + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t af[4];  // e1^T: rows k of the warp, pairs 16 ps .. (e1 read transposed)
          const int k0 = warp * (HP / W) + 16 * mt;
          coati::ldmatrix_x4_trans(af, e1s + wide<HP>(16 * ps + (lane & 7) + ((lane >> 4) << 3),
                                                      k0 / 8 + ((lane >> 3) & 1)));
#pragma unroll
          for (int dp = 0; dp < NW / 2; ++dp) {
            coati::mma_bf16(acc_w2[mt][2 * dp], af, bfr[dp][0], bfr[dp][1]);
            coati::mma_bf16(acc_w2[mt][2 * dp + 1], af, bfr[dp][2], bfr[dp][3]);
          }
        }
      }

      cluster.sync();  // every block's slice of dz2 is written, e1 copies are done
#pragma unroll
      for (int it = 0; it < (kCluster - 1) * kBM * (SW / 8) / THREADS; ++it) {
        const int e = tid + it * THREADS;
        const int other = (rank + 1 + e / (kBM * (SW / 8))) % kCluster;
        const int x = e % (kBM * (SW / 8));
        const int at = wide<HP>(x / (SW / 8), other * (SW / 8) + x % (SW / 8));
        const int4* src = cluster.map_shared_rank(reinterpret_cast<int4*>(dz2s + at), other);
        *reinterpret_cast<int4*>(dz2s + at) = *src;
      }
      __syncthreads();  // the whole of dz2 is here

      // de1[:, slice] = dz2 W2[slice, :]^T: the warp's 16 rows and WC columns
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < HP / 16; ++kk) {
        uint32_t af[4];
        coati::ldmatrix_x4(af, dz2s + wide<HP>(m0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                               2 * kk + (lane >> 4)));
#pragma unroll
        for (int dp = 0; dp < NT / 2; ++dp) {
          uint32_t bf[4];  // W2 rows c0 + 16 dp .. of the slice, columns 16 kk ..
          coati::ldmatrix_x4(bf, w2r + wide<HP>(c0 + 16 * dp + (lane & 7) + ((lane >> 4) << 3),
                                                2 * kk + ((lane >> 3) & 1)));
          coati::mma_bf16(acc[2 * dp], af, bf[0], bf[1]);
          coati::mma_bf16(acc[2 * dp + 1], af, bf[2], bf[3]);
        }
      }
      // dz1 = de1 silu'(z1) of the slice's columns, over silu'(z1) in the buffer
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* cm = cs + (m0 + gq + 8 * h) * CS;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float2* at = reinterpret_cast<float2*>(cm + c0 + 8 * nt + tq);
          const float2 s = *at;
          *at = make_float2(acc[nt][2 * h] * s.x, acc[nt][2 * h + 1] * s.y);
        }
      }
      __syncthreads();  // the chunk's dz1 is complete

      // the walk: a thread takes one column and RG consecutive pairs, in
      // order. da of the pair's atom i goes to the group's accumulator (no
      // other thread writes it), db1 and dwd to registers, and a run of
      // pairs with one partner j to dc[j] by one atomic add
      {
        const float* dz1 = cs + wk;
        float* dag = da_g + wq * kTileI * SW + wk;
        float* dcw = dcb + s0 + wk;
        const bool col_ok = s0 + wk < hm;
        int run_j = -1;
        float run = 0.f;
#pragma unroll 4
        for (int r = 0; r < RG; ++r) {
          const int m = wq * RG + r;
          const int j = row_j[m];
          if (j < 0) break;  // the list has ended
          const float v = dz1[m * CS];
          dag[row_i[m] * SW] += v;
          w_db1 += v;
          w_dwd += v * row_d[m];
          if (j != run_j) {
            if (run_j >= 0 && col_ok) atomicAdd(dcw + static_cast<long long>(run_j) * hm, run);
            run_j = j;
            run = 0.f;
          }
          run += v;
        }
        if (run_j >= 0 && col_ok) atomicAdd(dcw + static_cast<long long>(run_j) * hm, run);
      }
      __syncthreads();  // the chunk's buffer is consumed
    }
    // da of the item's atoms, the slice's columns: the walk's groups in
    // order (zero without a live pair)
    for (int e = tid; e < rows * SW; e += THREADS) {
      const int il = e / SW, k = e % SW;
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < G; ++q) sum += da_g[(q * kTileI + il) * SW + k];
      if (s0 + k < hm) da[(tile_at + il) * hm + s0 + k] = sum;
    }
  }
  cluster.sync();  // no block leaves while another may read its shared memory

  // the block's partial parameter gradients to its cluster's scratch row:
  // dW2 (HP x HP, the slice's columns), then db2, db1, dwd (HP each)
  float* row = scratch + static_cast<long long>(cl) * (HP * HP + 3 * HP);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NW; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = warp * (HP / W) + 16 * mt + gq + 8 * h;
        *reinterpret_cast<float2*>(row + k * HP + s0 + 8 * nt + tq) =
            make_float2(acc_w2[mt][nt][2 * h], acc_w2[mt][nt][2 * h + 1]);
      }
  // the column sums, in shared memory (e1 is no longer needed): db2 over
  // the 8 rows of a fragment by shuffles, then over the 4 warps of a column
  // group; db1 and dwd over the walk's groups; each in a fixed order
  float* red_db2 = reinterpret_cast<float*>(e1s);  // [4][SW]
  float* red_db1 = red_db2 + 4 * SW;               // [G][SW]
  float* red_dwd = red_db1 + G * SW;               // [G][SW]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float x = p_db2[nt][u];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (gq == 0) red_db2[(warp & 3) * SW + c0 + 8 * nt + tq + u] = x;
    }
  red_db1[wq * SW + wk] = w_db1;
  red_dwd[wq * SW + wk] = w_dwd;
  __syncthreads();
  for (int col = tid; col < SW; col += THREADS) {
    const float* r4 = red_db2 + col;
    float s1 = 0.f, sd = 0.f;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      s1 += red_db1[q * SW + col];
      sd += red_dwd[q * SW + col];
    }
    row[HP * HP + s0 + col] = ((r4[0] + r4[SW]) + r4[2 * SW]) + r4[3 * SW];
    row[HP * HP + HP + s0 + col] = s1;
    row[HP * HP + 2 * HP + s0 + col] = sd;
  }

  // the last block of this rank adds the clusters' rows, in cluster order
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&done[rank], 1u) == static_cast<unsigned>(n_clusters - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int e = tid; e < (HP + 3) * SW; e += THREADS) {
    const int r = e / SW, col = s0 + e % SW;  // rows 0 .. HP-1 of dW2, then the vectors
    const long long off = r < HP ? static_cast<long long>(r) * HP + col : HP * HP + (r - HP) * HP + col;
    float sum = 0.f;
    for (int q = 0; q < n_clusters; ++q)
      sum += __ldcg(scratch + static_cast<long long>(q) * (HP * HP + 3 * HP) + off);
    if (col >= hm) continue;
    if (r < HP) {
      if (r < hm) dw2[static_cast<long long>(r) * hm + col] = sum;
    } else {
      float* out = r == HP ? db2 : (r == HP + 1 ? db1 : dwd);
      out[col] = sum;
    }
  }
}

// ------------------------------------------------------------- launch

// floats of the clusters' partial parameter gradients in the scratch: a
// dW2 (Hp x Hp) and db2, db1, dwd (Hp each) a cluster
long long partials_floats(int clusters, int sw) {
  const long long hp = 4LL * sw;
  return clusters * (hp * hp + 3 * hp);
}

// the slice width of the bf16 body: Hm <= 128 takes 32 columns a block,
// Hm <= 256 takes 64; 0 above
int slice_width(int hm) { return hm <= 128 ? 32 : (hm <= 256 ? 64 : 0); }

template <int SW>
cudaError_t bf16_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int n,
                        cudaStream_t stream, int* clusters) {
  const long long bytes = bf16_smem_bytes(n, SW);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(egnn_messages_bwd_bf16_kernel<SW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(32 * tc_warps(SW));
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(clusters, egnn_messages_bwd_bf16_kernel<SW>, &cfg);
  if (err == cudaSuccess && *clusters < 1) err = cudaErrorInvalidValue;
  return err;
}

template <int SW>
int launch_bf16(const float* const* in, float* const* out, float* scratch, unsigned* done,
                int clusters, int batch, int n, int hm, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int most = 0;
  cudaError_t err = bf16_config<SW>(cfg, attr, n, stream, &most);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1 || clusters > most) return static_cast<int>(cudaErrorInvalidValue);
  // the items' costs follow the clusters' partial gradients in the scratch
  auto* cost = reinterpret_cast<long long*>(scratch + partials_floats(clusters, SW));
  const int items = batch * ((n + kTileI - 1) / kTileI);
  coati::egnn_item_costs_kernel<<<coati::item_cost_blocks(items), 32 * coati::kCostWarps, 0,
                                  stream>>>(in[3], cost, done + kCluster, batch, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.gridDim = dim3(kCluster * clusters);
  err = cudaLaunchKernelEx(&cfg, egnn_messages_bwd_bf16_kernel<SW>, in[0], in[1], in[2], in[3],
                           in[4], in[5], in[6], in[7], in[8], out[0], out[1], out[2], out[3],
                           out[4], out[5], scratch, static_cast<const long long*>(cost), done,
                           batch, n, hm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const float* const* in, float* const* out, int batch, int n, int hm,
               cudaStream_t stream) {
  const long long bytes = smem_floats(n, hm) * 4;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(egnn_messages_bwd_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTileI - 1) / kTileI, batch);
  egnn_messages_bwd_f32_kernel<<<grid, kThreads, bytes, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], out[0], out[1], out[2],
      out[3], out[4], out[5], n, hm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of shared memory a block needs at these sizes, in the mode that
// bf16_product selects; the wrapper refuses sizes above the card's 232448
// (and the bf16-product mode refuses Hm above 256: 0 is returned there).
extern "C" long long egnn_messages_bwd_smem_bytes(int n, int hm, int bf16_product) {
  if (!bf16_product) return smem_floats(n, hm) * 4;
  const int sw = slice_width(hm);
  return sw ? bf16_smem_bytes(n, sw) : 0;
}

// The work split of the bf16-product mode at these sizes: the number of
// clusters of 4 blocks that the card runs at once (the launch's size; 0 if
// it cannot run), and through `scratch_floats` the float32 scratch the
// launch needs, which the caller allocates: clusters x (Hp^2 + 3 Hp) for
// the partial gradients, then an int64 cost a work item (2 floats each).
extern "C" int egnn_messages_bwd_clusters(int batch, int n, int hm, long long* scratch_floats) {
  const int sw = slice_width(hm);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (sw == 32) err = bf16_config<32>(cfg, attr, n, nullptr, &clusters);
  if (sw == 64) err = bf16_config<64>(cfg, attr, n, nullptr, &clusters);
  if (err != cudaSuccess) return 0;
  const long long items = static_cast<long long>(batch) * ((n + kTileI - 1) / kTileI);
  *scratch_floats = partials_floats(clusters, sw) + 2 * items;
  return clusters;
}

// a, c, g, da, dc: (B, N, Hm); d2, w: (B, N, N); wd, b1, b2, dwd, db1, db2:
// (Hm,); w2, dw2: (Hm, Hm) with z2 = e1 @ w2. All contiguous float32. dc
// must arrive zeroed (both modes add into it), and in the float32 mode dwd,
// db1, dw2 and db2 too. bf16_product != 0 rounds e1, w2 and dz2 to bf16
// before the products and runs the tensor-core body, which takes Hm <= 256,
// `clusters` from egnn_messages_bwd_clusters, a float32 scratch of the size
// it gave and 5 zeroed unsigned counters `done` (one a rank of the
// cluster, one for the work split); the float32 mode ignores those three.
// Returns a cudaError_t.
extern "C" int egnn_messages_bwd(const void* a, const void* c, const void* d2, const void* w,
                                 const void* wd, const void* b1, const void* w2,
                                 const void* b2, const void* g, void* da, void* dc, void* dwd,
                                 void* db1, void* dw2, void* db2, void* scratch, void* done,
                                 int clusters, int batch, int n, int hm, int bf16_product,
                                 void* stream) {
  if (batch <= 0 || n <= 0 || hm <= 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const float* in[9] = {static_cast<const float*>(a),  static_cast<const float*>(c),
                        static_cast<const float*>(d2), static_cast<const float*>(w),
                        static_cast<const float*>(wd), static_cast<const float*>(b1),
                        static_cast<const float*>(w2), static_cast<const float*>(b2),
                        static_cast<const float*>(g)};
  float* out[6] = {static_cast<float*>(da),  static_cast<float*>(dc),
                   static_cast<float*>(dwd), static_cast<float*>(db1),
                   static_cast<float*>(dw2), static_cast<float*>(db2)};
  if (!bf16_product) return launch_f32(in, out, batch, n, hm, s);
  auto* f = static_cast<float*>(scratch);
  auto* u = static_cast<unsigned*>(done);
  switch (slice_width(hm)) {
    case 32:
      return launch_bf16<32>(in, out, f, u, clusters, batch, n, hm, s);
    case 64:
      return launch_bf16<64>(in, out, f, u, clusters, batch, n, hm, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
