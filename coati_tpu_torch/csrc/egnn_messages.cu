// K3: fused EGNN message aggregation (forward).
//
// Replaces the TPU kernel coati_tpu/ops/pallas/egnn_messages.py
// (egnn_messages / egnn_messages_bf16 -> _fwd_pallas -> _fwd_kernel). Same
// function, for every atom i of every molecule b:
//
//   out[b,i] = sum_j w[b,i,j] * silu( silu(a[b,i] + c[b,j] + d2[b,i,j]*wd + b1)
//                                     @ W2 + b2 )
//
// the two-layer edge MLP of an e_gcl layer with the cutoff/pair mask folded
// into the sum, without the (B, N, N, Hm) pairwise tensor ever reaching
// device memory. z1 and its SiLU are float32; in the bf16 mode e1 and W2
// are rounded to bf16 and the product accumulates in float32 (the TPU
// kernel's rounding points); b2, the second SiLU, the pair weight and the
// sum over j are float32. Pairs with w = 0 cost nothing, and atoms without
// a live pair (padding) get exactly zero.
//
// What bounds it on an H100: operations. Per live pair it does an Hm x Hm
// product (2 Hm^2 operations) on 3 Hm values that stay on chip, and 2 Hm
// SiLUs, each an exponential and a reciprocal on the special-function
// units (SFUs): at Hm 256 the tensor-core and the SFU floors are close.
//
// bf16 mode: tensor cores (egnn_messages_bf16_kernel).
//  * W2 resident: each block rounds W2 to bf16 once, into an XOR-swizzled
//    shared tile of Hp x Hp (Hp: Hm rounded up to 64; 128 KB at Hm 256,
//    which is the most it takes: Hm > 256 is refused), and keeps it for the
//    whole launch. The forward has one product a pair, so no block needs
//    another's data: no cluster, unlike K4;
//  * a persistent grid, as many blocks as fit (one an SM at Hm 256), of
//    Hp / 16 warps. Work items are (molecule, tile of 8 atoms i), priced and
//    split into ranges of equal cost by K4's costs kernel (egnn_items.cuh);
//  * an item lists its live pairs by atom i, then partner j (a ballot a row
//    of w), and cuts the list into 8 contiguous row ranges of L = ceil(P / 8)
//    pairs. A chunk takes the next 8 pairs of every range: range g, slot s
//    is row 8 s + g of the chunk's 64 x Hp tile of e1, which the block
//    builds (z1 in float32, the SiLU, bf16), the rows of c read by 16-byte
//    loads from L2. Not staged by cp.async, as K4 does with its slices: 64
//    float32 rows of c (64 KB) do not fit beside W2 and two e1 tiles, and
//    on an H100 the loads cost 5% of the launch (scripts/
//    torch_egnn_variants.py, noc). The chunk's last m16 tiles are skipped
//    when the ranges have fewer than 8 pairs left;
//  * z2 = e1 W2 by mma.sync m16n8k16 (bf16 in, float32 out, operands by
//    ldmatrix): warp k owns columns 16 k .. 16 k + 15 of all 64 rows, so in
//    its C fragments a thread holds, for 4 columns, the 8 rows 8 s + g: the
//    8 pairs of one range. b2, SiLU and the pair weight are applied in
//    registers and each thread sums its range's pairs in list order, atom by
//    atom, with no float atomics and no stage of z2 in shared memory (a
//    float32 64 x 256 stage would not fit beside W2). An atom whose pairs
//    lie inside one range is complete when its run ends and goes to device
//    memory; the first and last atom of a range may continue in the
//    neighbouring ranges, and their sums wait in shared memory until the
//    item's end, when they are added in range order. Each item owns its 8
//    output rows and every sum has a fixed order: the output repeats bit for
//    bit;
//  * two e1 tiles: a warp builds its share of the next chunk once its
//    products and epilogue are done, while the other warps may still
//    multiply; one block barrier a chunk.
//  What holds it (scripts/torch_egnn_phases.py): the products, near
//  mma.sync's rate, the build and the epilogue run one after the other in
//  all 16 warps, and each item costs about two chunks' worth of listing,
//  first tile and combine. Two designs that overlapped them with fewer
//  warps were slower: producer warps building e1 beside consumer warps
//  multiplying (the producers could not run their SiLUs fast enough), and
//  8 warps of 64 x 32 tiles with the next tile built between the k steps
//  (the build and epilogue are latency-bound and need the 16 warps).
//  Shared memory at Hm 256, N 128 (bf16_smem_bytes): W2 131,072 bytes, two
//  e1 tiles 65,536, the ranges' first and last sums 16,384 (the item's rows
//  of w while its pairs are listed), the item's a rows 8,192, the pair list
//  4,096, the chunks' row atoms and weights 1,024, counters 96: 226,400 of
//  the 232,448 a block may have.
//  The SiLUs take the SFU's exponential and reciprocal (__expf,
//  __fdividef): a few float32 ulps from the plain version's, which now and
//  then rounds an e1 to the neighbouring bf16 value, as the tolerance
//  allows.
//
// float32 mode: CUDA cores (egnn_messages_f32_kernel), for the fidelity
//  runs, which TF32 could not meet. One block per (molecule, tile of 8
//  atoms i); it lists the tile's live pairs in (i, j) order by a ballot
//  scan, and runs them as the rows of a tiled SGEMM, 64 at a time: the 64 x
//  Hm tile of e1 in shared memory, W2 streamed through 16-deep tiles, an 8 x
//  8 register tile of z2 a thread. The epilogue applies b2, SiLU and the
//  pair weight in registers, sums a thread's rows of one atom and adds them
//  into the tile's accumulator in shared memory by atomics: the order of
//  those few float adds may differ from run to run.
//
// No padding of B, N or Hm is needed: ragged edges are masked here.
#include "common.cuh"
#include "egnn_items.cuh"
#include "mma.cuh"

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

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// ------------------------------------------------------ float32 body

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

__global__ void __launch_bounds__(kThreads, 2) egnn_messages_f32_kernel(
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
        val = silu(z);
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
          w2s[e] = (k < hm && col < hm) ? w2[static_cast<long long>(k) * hm + col] : 0.f;
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

// --------------------------------------------------------- bf16 body

constexpr int kMaxHm = 256;    // the widest W2 a block keeps
constexpr int kWarpCols = 16;  // columns of z2 a warp owns

// Hm rounded up to 64: the width of the W2 and e1 tiles
__host__ __device__ constexpr int padded_width(int hm) { return (hm + 63) / 64 * 64; }

// warps of a block of the bf16 body: one per 16 columns
__host__ __device__ constexpr int tc_warps(int hp) { return hp / kWarpCols; }

// Element offset of the 8-element chunk `c` of row `r` in a shared tile
// whose rows are HP bf16 values (HP a multiple of 64): the chunk is XORed
// with the row's low three bits, so that the 8 rows of an ldmatrix matrix
// fall in 8 different 16-byte bank groups.
template <int HP>
__device__ __forceinline__ int wide(int r, int c) {
  return r * HP + ((c ^ (r & 7)) << 3);
}

// SiLU on the special-function units: an exponential and a reciprocal
__device__ __forceinline__ float silu_fast(float x) { return __fdividef(x, 1.f + __expf(-x)); }

// Floats of the region that holds the ranges' first and last sums (2 x 8
// rows of Hp), and before them the item's rows of w while its pairs are
// listed (8 x N).
__host__ __device__ inline int part_floats(int n, int hp) {
  return 2 * kTileI * hp > kTileI * n ? 2 * kTileI * hp : kTileI * n;
}

// Shared memory of the bf16 body, in bytes, in the order the kernel lays it
// out: W2 (Hp x Hp) and two e1 tiles (64 x Hp), bf16; the ranges' sums (or
// the item's w); the item's a rows (8 x Hp); its pair list (8 N); the two
// chunks' row atoms and weights (2 x 64 each); the atoms' pair counts and
// the ranges' first and last atoms (8 each).
__host__ __device__ inline long long bf16_smem_bytes(int n, int hp) {
  return 2LL * hp * hp + 2LL * 2 * kBM * hp +
         4LL * (part_floats(n, hp) + kTileI * hp + kTileI * n + 2 * 2 * kBM + 3 * kTileI);
}

template <int HP>
__global__ void __launch_bounds__(32 * tc_warps(HP), 1) egnn_messages_bf16_kernel(
    const float* __restrict__ a, const float* __restrict__ c, const float* __restrict__ d2,
    const float* __restrict__ w, const float* __restrict__ wd, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ out,
    const long long* __restrict__ cost, int batch, int n, int hm) {
  constexpr int W = tc_warps(HP);
  constexpr int THREADS = 32 * W;
  constexpr int CH = HP / 8;               // 16-byte chunks of an e1 row
  constexpr int NT = kWarpCols / 8;        // n8 tiles of a warp
  constexpr int MT = kBM / 16;             // m16 tiles of a chunk
  static_assert(THREADS % CH == 0 && (kBM * CH) % THREADS == 0, "whole rows a pass");
  static_assert(NT == 2 && MT * 2 == kTileI, "a warp's C fragments hold 8 slots of one range");
  extern __shared__ __align__(128) unsigned char smem_raw[];

  auto* w2s = reinterpret_cast<__nv_bfloat16*>(smem_raw);      // [HP][HP]
  __nv_bfloat16* e1s = w2s + HP * HP;                           // [2][kBM][HP]
  auto* part = reinterpret_cast<float*>(e1s + 2 * kBM * HP);    // [2][kTileI][HP]: first, last
  float* w_s = part;                                            // [kTileI][n], while listing
  float* a_s = part + part_floats(n, HP);                       // [kTileI][HP]
  auto* pairs = reinterpret_cast<int*>(a_s + kTileI * HP);      // [kTileI * n]: (il << 16) | j
  int* row_i2 = pairs + kTileI * n;                             // [2][kBM]: atom of a row, -1 none
  auto* row_w2 = reinterpret_cast<float*>(row_i2 + 2 * kBM);    // [2][kBM]: weight of a row
  auto* cnt = reinterpret_cast<int*>(row_w2 + 2 * kBM);         // [kTileI]: live pairs an atom
  int* first_atom = cnt + kTileI;                               // [kTileI]: a range's first atom
  int* last_atom = first_atom + kTileI;                         // [kTileI]: and last, -1 none

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;        // the range of the thread's C fragment rows
  const int tq = 2 * (lane & 3);   // the first of its two columns of an n8 tile
  const int col0 = warp * kWarpCols;
  const int bch = tid % CH;        // the 8 columns 8 bch .. the thread builds in each e1 row
  const bool vec = (hm & 7) == 0;  // rows of c in whole 16-byte pairs

  // W2 rounded to bf16, zero beyond hm
  for (int e = tid; e < HP * CH; e += THREADS) {
    const int k = e / CH, ch = e % CH;
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int col = 8 * ch + u;
      v[u] = k < hm && col < hm ? w2[static_cast<long long>(k) * hm + col] : 0.f;
    }
    *reinterpret_cast<uint4*>(w2s + wide<HP>(k, ch)) =
        make_uint4(coati::pack_bf16(v[0], v[1]), coati::pack_bf16(v[2], v[3]),
                   coati::pack_bf16(v[4], v[5]), coati::pack_bf16(v[6], v[7]));
  }
  // the thread's columns of wd, b1 (e1) and b2 (z2), zero beyond hm
  float wd_r[8], b1_r[8], b2_r[NT][2];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int col = 8 * bch + u;
    wd_r[u] = col < hm ? wd[col] : 0.f;
    b1_r[u] = col < hm ? b1[col] : 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int col = col0 + 8 * nt + tq + u;
      b2_r[nt][u] = col < hm ? b2[col] : 0.f;
    }

  const int tiles = (n + kTileI - 1) / kTileI;
  const int items = batch * tiles;
  int first, end;
  coati::item_range(cost, items, blockIdx.x, gridDim.x, &first, &end);

  for (int item = first; item < end; ++item) {
    const int b = item / tiles;
    const int i0 = (item - b * tiles) * kTileI;
    const int rows = min(kTileI, n - i0);
    const long long tile_at = static_cast<long long>(b) * n + i0;
    float* ob = out + tile_at * hm;
    if (cost[item] - coati::item_start(cost, item) == 1) {  // no live pair: zeros
      for (int e = tid; e < rows * hm; e += THREADS) ob[e] = 0.f;
      continue;
    }
    const float* cb = c + static_cast<long long>(b) * n * hm;
    const float* wb = w + tile_at * n;
    const float* d2b = d2 + tile_at * n;

    __syncthreads();  // the previous item's sums, lists and rows are consumed
    for (int e = tid; e < rows * n; e += THREADS) w_s[e] = wb[e];
    for (int e = tid; e < kTileI * HP; e += THREADS) {
      const int il = e / HP, k = e % HP;
      a_s[e] = il < rows && k < hm ? a[(tile_at + il) * hm + k] : 0.f;
    }
    __syncthreads();
    for (int il = warp; il < kTileI; il += W) {  // live pairs of each atom: a warp a row
      int count = 0;
      if (il < rows)
        for (int j0 = 0; j0 < n; j0 += 32)
          count += __popc(__ballot_sync(0xffffffffu, j0 + lane < n && w_s[il * n + j0 + lane] != 0.f));
      if (lane == 0) cnt[il] = count;
    }
    __syncthreads();
    for (int il = warp; il < rows; il += W) {  // the list, by atom i, then partner j
      int at = 0;
      for (int q = 0; q < il; ++q) at += cnt[q];
      for (int j0 = 0; j0 < n; j0 += 32) {
        const int j = j0 + lane;
        const bool live = j < n && w_s[il * n + j] != 0.f;
        const unsigned mask = __ballot_sync(0xffffffffu, live);
        if (live) pairs[at + __popc(mask & ((1u << lane) - 1u))] = (il << 16) | j;
        at += __popc(mask);
      }
    }
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int q = 0; q < kTileI; ++q) total += cnt[q];
    const int span = (total + kTileI - 1) / kTileI;  // pairs of a range (the last may have fewer)
    const int chunks = (span + kTileI - 1) / kTileI;
    const int my_len = min(span, max(0, total - gq * span));  // pairs of the thread's range

    // chunk `chunk` into e1 tile `buf`: row 8 s + g is the pair g span + 8
    // chunk + s of the list (zero past its range's end), e1 = silu(z1) in
    // bf16, z1 = a_i + c_j + d2 wd + b1 in float32, added in that order
    auto build = [&](int chunk, int buf) {
      __nv_bfloat16* e1 = e1s + buf * kBM * HP;
#pragma unroll
      for (int it = 0; it < kBM * CH / THREADS; ++it) {
        const int r = (tid + it * THREADS) / CH;
        const int k = chunk * kTileI + (r >> 3);
        const int p = (r & 7) * span + k;
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        int il = -1;
        float wgt = 0.f;
        if (k < span && p < total) {
          const int pr = pairs[p];
          il = pr >> 16;
          const int j = pr & 0xffff;
          wgt = wb[il * n + j];
          const float dist = d2b[il * n + j];
          const float* crow = cb + static_cast<long long>(j) * hm + 8 * bch;
          const float* arow = a_s + il * HP + 8 * bch;
          float cv[8];
          if (vec) {
            if (8 * bch < hm) {
              const float4 c0 = __ldg(reinterpret_cast<const float4*>(crow));
              const float4 c1 = __ldg(reinterpret_cast<const float4*>(crow) + 1);
              cv[0] = c0.x, cv[1] = c0.y, cv[2] = c0.z, cv[3] = c0.w;
              cv[4] = c1.x, cv[5] = c1.y, cv[6] = c1.z, cv[7] = c1.w;
            }
          } else {
#pragma unroll
            for (int u = 0; u < 8; ++u) cv[u] = 8 * bch + u < hm ? crow[u] : 0.f;
          }
          if (8 * bch < hm) {
            const float4 a0 = *reinterpret_cast<const float4*>(arow);
            const float4 a1 = *reinterpret_cast<const float4*>(arow + 4);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (8 * bch + u < hm) {
                const float z = __fadd_rn(__fadd_rn(__fadd_rn(av[u], cv[u]), __fmul_rn(dist, wd_r[u])),
                                          b1_r[u]);
                v[u] = silu_fast(z);
              }
          }
        }
        *reinterpret_cast<uint4*>(e1 + wide<HP>(r, bch)) =
            make_uint4(coati::pack_bf16(v[0], v[1]), coati::pack_bf16(v[2], v[3]),
                       coati::pack_bf16(v[4], v[5]), coati::pack_bf16(v[6], v[7]));
        if (bch == 0) {
          row_i2[buf * kBM + r] = il;
          row_w2[buf * kBM + r] = wgt;
        }
      }
    };

    // the running sum of the thread's range over its current atom `cur`
    float run[NT][2] = {{0.f, 0.f}, {0.f, 0.f}};
    int cur = -1;
    bool seen = false;  // the range's first atom has ended
    auto store = [&](float* dst) {  // run's 4 columns at dst (a row of Hp or Hm floats)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = col0 + 8 * nt + tq + u;
          if (col < hm) dst[col] = run[nt][u];
          run[nt][u] = 0.f;
        }
    };

    build(0, 0);
    __syncthreads();
    for (int chunk = 0; chunk < chunks; ++chunk) {
      const int buf = chunk & 1;
      const __nv_bfloat16* e1 = e1s + buf * kBM * HP;
      const int mts = (min(kTileI, span - chunk * kTileI) + 1) / 2;  // m16 tiles with a live row

      // z2 = e1 W2: all 64 rows, the warp's 16 columns
      float acc[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < HP / 16; ++kk) {
        uint32_t bf[4];  // W2 rows 16 kk .., the warp's columns: read as stored
        coati::ldmatrix_x4_trans(
            bf, w2s + wide<HP>(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3), col0 / 8 + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if (mt < mts) {
            uint32_t af[4];
            coati::ldmatrix_x4(af, e1 + wide<HP>(16 * mt + (lane & 7) + (((lane >> 3) & 1) << 3),
                                                 2 * kk + (lane >> 4)));
            coati::mma_bf16(acc[mt][0], af, bf[0], bf[1]);
            coati::mma_bf16(acc[mt][1], af, bf[2], bf[3]);
          }
      }

      // m = w silu(z2 + b2), summed over the range's pairs in list order:
      // slot s of the range is row 8 s + gq, m16 tile s / 2, half s % 2
#pragma unroll
      for (int s = 0; s < kTileI; ++s) {
        if (chunk * kTileI + s >= my_len) continue;
        const int row = 8 * s + gq;
        const int il = row_i2[buf * kBM + row];
        const float wgt = row_w2[buf * kBM + row];
        if (il != cur) {
          if (cur >= 0) {
            if (!seen) {  // the range's first atom: it may have begun in the range before
              store(part + gq * HP);
              if (warp == 0 && (lane & 3) == 0) first_atom[gq] = cur;
              seen = true;
            } else {  // an atom wholly inside the range: complete
              store(ob + cur * hm);
            }
          }
          cur = il;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            run[nt][u] += wgt * silu_fast(acc[s / 2][nt][2 * (s % 2) + u] + b2_r[nt][u]);
      }

      if (chunk + 1 < chunks) build(chunk + 1, buf ^ 1);
      __syncthreads();  // the chunk's tile and rows are consumed; the next chunk's are built
    }
    // the range's last atom (its only one if none ended): it may go on in
    // the next range
    if (cur >= 0) store(part + ((seen ? kTileI : 0) + gq) * HP);
    if (warp == 0 && (lane & 3) == 0) {
      if (!seen) first_atom[gq] = cur;
      last_atom[gq] = seen ? cur : -1;
    }
    __syncthreads();
    // the atoms that touch a range's ends: their pieces in range order; an
    // atom without a live pair gets zero (those wholly inside a range are
    // written)
    for (int e = tid; e < rows * hm; e += THREADS) {
      const int il = e / hm, col = e - il * hm;
      float sum = 0.f;
      bool any = false;
#pragma unroll
      for (int g = 0; g < kTileI; ++g) {
        if (first_atom[g] == il) {
          sum += part[g * HP + col];
          any = true;
        }
        if (last_atom[g] == il) {
          sum += part[(kTileI + g) * HP + col];
          any = true;
        }
      }
      if (any || cnt[il] == 0) ob[e] = sum;
    }
  }
}

// ------------------------------------------------------------- launch

int launch_f32(const float* const* in, float* out, int batch, int n, int hm,
               cudaStream_t stream) {
  const long long bytes = smem_floats(n, hm) * 4;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(egnn_messages_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTileI - 1) / kTileI, batch);
  egnn_messages_f32_kernel<<<grid, kThreads, bytes, stream>>>(in[0], in[1], in[2], in[3], in[4],
                                                              in[5], in[6], in[7], out, n, hm);
  return static_cast<int>(cudaGetLastError());
}

template <int HP>
int launch_bf16(const float* const* in, float* out, long long* cost, unsigned* done, int batch,
                int n, int hm, cudaStream_t stream) {
  const long long bytes = bf16_smem_bytes(n, HP);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = egnn_messages_bf16_kernel<HP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * tc_warps(HP),
                                                      static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int items = batch * ((n + kTileI - 1) / kTileI);
  coati::egnn_item_costs_kernel<<<coati::item_cost_blocks(items), 32 * coati::kCostWarps, 0,
                                  stream>>>(in[3], cost, done, batch, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<per_sm * sms, 32 * tc_warps(HP), bytes, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], out, cost, batch, n, hm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of shared memory a block needs at these sizes, in the mode that
// bf16_product selects; the wrapper refuses sizes above the card's 232448
// (and the bf16-product mode refuses Hm above 256: 0 is returned there).
extern "C" long long egnn_messages_smem_bytes(int n, int hm, int bf16_product) {
  if (!bf16_product) return smem_floats(n, hm) * 4;
  return hm <= kMaxHm ? bf16_smem_bytes(n, padded_width(hm)) : 0;
}

// a, c: (B, N, Hm); d2, w: (B, N, N); wd, b1, b2: (Hm,); w2: (Hm, Hm) with
// z2 = e1 @ w2; out: (B, N, Hm). All contiguous float32. bf16_product != 0
// rounds e1 and w2 to bf16 before the product and runs the tensor-core body,
// which takes Hm <= 256, c 16-byte aligned, an int64 scratch `cost` of one
// entry a work item (B x ceil(N / 8)) and one zeroed unsigned counter
// `done`; the float32 mode ignores those two. Returns a cudaError_t.
extern "C" int egnn_messages(const void* a, const void* c, const void* d2, const void* w,
                             const void* wd, const void* b1, const void* w2,
                             const void* b2, void* out, void* cost, void* done, int batch,
                             int n, int hm, int bf16_product, void* stream) {
  if (batch <= 0 || n <= 0 || hm <= 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const float* in[8] = {static_cast<const float*>(a),  static_cast<const float*>(c),
                        static_cast<const float*>(d2), static_cast<const float*>(w),
                        static_cast<const float*>(wd), static_cast<const float*>(b1),
                        static_cast<const float*>(w2), static_cast<const float*>(b2)};
  auto* o = static_cast<float*>(out);
  if (!bf16_product) return launch_f32(in, o, batch, n, hm, s);
  auto* k = static_cast<long long*>(cost);
  auto* u = static_cast<unsigned*>(done);
  switch (hm > kMaxHm ? 0 : padded_width(hm)) {
    case 64:
      return launch_bf16<64>(in, o, k, u, batch, n, hm, s);
    case 128:
      return launch_bf16<128>(in, o, k, u, batch, n, hm, s);
    case 192:
      return launch_bf16<192>(in, o, k, u, batch, n, hm, s);
    case 256:
      return launch_bf16<256>(in, o, k, u, batch, n, hm, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
