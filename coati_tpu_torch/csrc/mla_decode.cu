// K6: absorbed multi-head latent attention for one decode step.
//
// Replaces no TPU kernel: the JAX package has no latent attention. It serves
// the DeepSeek-V2 trunk (models/mla_moe.py), whose decode reads a latent
// cache (B, T, 576) a layer: the normalised 512-wide latent c and the
// 64-wide rotated key k_pe of each position, one row shared by all heads.
// In the absorbed form each head's query is [q_lat (512) | q_pe (64)]
// (q_lat = W_UK^T q_nope), its score against position t is
// scale * q . cache[t], and its output o_lat = sum_t p(t) c_t is the
// softmax-weighted sum of the latents alone (the first 512 values of each
// row). So this is attention with one key/value head of width 576 / 512
// against 16 query heads: multi-query attention at widths K1's bodies (head
// dims 16 and 32) do not reach.
//
// What bounds it on an H100: bytes. A launch at position pos reads
// (pos + 1) cache rows of 1,152 bytes for every batch row; the operations,
// 2 * 16 * (576 + 512) a row and position, are about 30 a byte, far under
// the card's balance. But 16 heads sharing one key row make each position
// a (16 x 576) x (576) product for the whole row: tensor cores take it, and
// the row's cache is read once, not once a head.
//
// Design:
//  * one block of 4 warps a batch row, all 16 heads at once: the heads are
//    the M = 16 of mma.m16n8k16 (bf16 inputs, float32 sums);
//  * the positions [0, pos] go by in tiles of 32 cache rows, copied to
//    shared memory by cp.async (16 bytes a copy, rows past pos zero-filled
//    and never read from memory), two tiles in flight: the next tile loads
//    while the warps work on this one. Rows are padded by 16 bytes in
//    shared memory, so the 8 row addresses of an ldmatrix fall in 8
//    different bank groups;
//  * scores S = Q K^T (16 x 32 a tile): each warp takes a quarter of the
//    576-wide depth (9 of its 36 k-steps), its query fragments loaded once
//    into registers (ldmatrix from the query tile staged in shared memory);
//    the 4 partial tiles are summed through shared memory in warp order, so
//    every warp holds the same S, bit for bit;
//  * an online softmax in float32 on the exponential unit (base 2, the
//    scale folded in), repeated by each warp on its copy of S; masked
//    positions (past pos) score -inf;
//  * O += P V: each warp owns 128 of the 512 output columns (16 tiles of 8,
//    64 float32 accumulators a thread), P in bf16 straight from the score
//    registers (the C fragments of two n-tiles are the A fragment of one
//    k-step), V from the same cache tile by transposed ldmatrix;
//  * the output is divided by the row sums, staged through shared memory
//    and written in 16-byte stores. No atomics: the output repeats bit for
//    bit;
//  * two entries. `mla_decode` takes pos as a host int passed by value;
//    `mla_decode_at` reads it from one int32 on the card (clamped to the
//    cache) when the kernel runs, so that a captured CUDA graph replays the
//    step at every position (models/decode_graph.py). Both do the same
//    work for the same position and give the same bits. The kernel
//    allocates nothing.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kHeads = 16;                 // query heads: the M of one mma tile
constexpr int kLatent = 512;               // values: the first kLatent of a cache row
constexpr int kWidth = 576;                // a cache row: latent + rotated key
constexpr int kTile = 32;                  // positions a tile
constexpr int kStages = 2;                 // tile buffers: kStages - 1 tiles in flight
constexpr int kMinBlocks = 2;              // blocks an SM at least
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRow = kWidth + 8;           // a row in shared memory, padded by 16 bytes
constexpr int kChunks = kWidth / 8;        // 16-byte chunks a row
constexpr int kKSteps = kWidth / 16 / kWarps;  // QK k-steps a warp: 9
constexpr int kSTiles = kTile / 8;         // n-tiles of S: 4
constexpr int kOTiles = kLatent / kWarps / 8;  // n-tiles of O a warp: 16
constexpr int kOutRow = kLatent + 8;       // a staged output row, padded by 16 bytes
constexpr int kTileElems = kTile * kRow;
constexpr int kPartFloats = kWarps * kSTiles * 4 * 32;
constexpr size_t kSmemBytes =
    kStages * kTileElems * sizeof(__nv_bfloat16) + kPartFloats * sizeof(float);
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kWidth % (16 * kWarps) == 0 && kLatent % (16 * kWarps) == 0, "widths");
static_assert(kTile % 16 == 0 && kStages >= 2, "tiles of whole k-steps, at least two buffers");
static_assert(kHeads <= kTile && kHeads * kOutRow <= kTileElems, "staging fits a tile buffer");

// rows [t0, t0 + rows) of `src` (row stride `stride` elements, each kWidth
// wide) into `dst` (rows of kRow); rows at or past `live` are zero-filled
// without a read (their address clamped to row 0)
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int t0, int rows, int live) {
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = t0 + r < live;
    const __nv_bfloat16* from = src + (ok ? static_cast<long long>(t0 + r) * stride : 0) + 8 * c;
    coati::cp_async_16(dst + r * kRow + 8 * c, from, ok);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    mla_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ cache,
                      __nv_bfloat16* __restrict__ out, long long q_stride_b, long long q_stride_h,
                      long long c_stride_b, long long c_stride_t, int width, int pos,
                      const int* __restrict__ pos_at, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  float* part = reinterpret_cast<float*>(tiles + kStages * kTileElems);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // the fragment's row and column pair
  const int mi = lane / 8, mr = lane % 8;  // the ldmatrix matrix this lane addresses, and its row
  const long long b = blockIdx.x;
  if (pos_at != nullptr) pos = min(max(__ldg(pos_at), 0), width - 1);
  const int n_tiles = pos / kTile + 1;
  const __nv_bfloat16* rows = cache + b * c_stride_b;

  // the query tile (16 x 576) into the last buffer with the first cache
  // tile into buffer 0, then tiles 1 .. kStages - 2: one commit group each
  __nv_bfloat16* q_tile = tiles + (kStages - 1) * kTileElems;
  for (int i = threadIdx.x; i < kHeads * kChunks; i += kThreads) {
    const int h = i / kChunks, c = i - h * kChunks;
    coati::cp_async_16(q_tile + h * kRow + 8 * c, q + b * q_stride_b + h * q_stride_h + 8 * c, true);
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_rows(tiles + i * kTileElems, rows, c_stride_t, i * kTile, kTile, pos + 1);
    coati::cp_async_commit();
  }
  coati::cp_async_wait<kStages - 2>();
  __syncthreads();

  // this warp's query fragments: k-steps warp * 9 .. warp * 9 + 8
  uint32_t qa[kKSteps][4];
#pragma unroll
  for (int j = 0; j < kKSteps; ++j) {
    const int k0 = 16 * (warp * kKSteps + j);
    coati::ldmatrix_x4(qa[j], q_tile + (mr + 8 * (mi % 2)) * kRow + k0 + 8 * (mi / 2));
  }

  float o[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  const int col0 = warp * (kLatent / kWarps);

  for (int i = 0; i < n_tiles; ++i) {
    // tile i has landed and every warp is done with the buffer that tile
    // i + kStages - 1 takes (tile i - 1's, or the query's)
    coati::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = i + kStages - 1;
    if (next < n_tiles)
      load_rows(tiles + (next % kStages) * kTileElems, rows, c_stride_t, next * kTile, kTile,
                pos + 1);
    coati::cp_async_commit();
    const __nv_bfloat16* kv = tiles + (i % kStages) * kTileElems;

    // this warp's part of S over its quarter of the depth
    float s[kSTiles][4];
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int j = 0; j < kKSteps; ++j) {
      const int k0 = 16 * (warp * kKSteps + j);
#pragma unroll
      for (int n = 0; n < kSTiles; n += 2) {
        uint32_t kb[4];
        coati::ldmatrix_x4(kb, kv + (8 * (n + mi / 2) + mr) * kRow + k0 + 8 * (mi % 2));
        coati::mma_bf16(s[n], qa[j], kb[0], kb[1]);
        coati::mma_bf16(s[n + 1], qa[j], kb[2], kb[3]);
      }
    }
    // the four parts summed in warp order: the same S in every warp
#pragma unroll
    for (int n = 0; n < kSTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[((warp * kSTiles + n) * 4 + e) * 32 + lane] = s[n][e];
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kSTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += part[((w * kSTiles + n) * 4 + e) * 32 + lane];
        const int at = i * kTile + 8 * n + 2 * t + (e & 1);
        s[n][e] = at <= pos ? sum * scale_log2 : -INFINITY;
      }

    // online softmax of rows g (e 0, 1) and g + 8 (e 2, 3)
    float x0 = m0, x1 = m1;
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
      x0 = fmaxf(x0, fmaxf(s[n][0], s[n][1]));
      x1 = fmaxf(x1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
    }
    const float a0 = coati::exp2_fast(m0 - x0), a1 = coati::exp2_fast(m1 - x1);
    m0 = x0;
    m1 = x1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
      s[n][0] = coati::exp2_fast(s[n][0] - m0);
      s[n][1] = coati::exp2_fast(s[n][1] - m0);
      s[n][2] = coati::exp2_fast(s[n][2] - m1);
      s[n][3] = coati::exp2_fast(s[n][3] - m1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int j = 0; j < kOTiles; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }

    // O += P V over this warp's columns, 16 positions a k-step
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t pa[4] = {
          coati::pack_bf16(s[2 * kk][0], s[2 * kk][1]), coati::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          coati::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          coati::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vrow = kv + (16 * kk + 8 * (mi % 2) + mr) * kRow + col0 + 8 * (mi / 2);
#pragma unroll
      for (int j = 0; j < kOTiles; j += 2) {
        uint32_t vb[4];
        coati::ldmatrix_x4_trans(vb, vrow + 8 * j);
        coati::mma_bf16(o[j], pa, vb[0], vb[1]);
        coati::mma_bf16(o[j + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // the row sums over the row's 4 lanes, then O / l staged in buffer 0
  // (free once every warp is past its last tile) and written 16 bytes a store
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float r0 = 1.f / l0, r1 = 1.f / l1;
  coati::cp_async_wait<0>();
  __syncthreads();
  uint32_t* staged = reinterpret_cast<uint32_t*>(tiles);
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    const int col = col0 + 8 * j + 2 * t;
    staged[(g * kOutRow + col) / 2] = coati::pack_bf16(o[j][0] * r0, o[j][1] * r0);
    staged[((g + 8) * kOutRow + col) / 2] = coati::pack_bf16(o[j][2] * r1, o[j][3] * r1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kHeads * kLatent / 8; i += kThreads) {
    const int h = i / (kLatent / 8), c = i - h * (kLatent / 8);
    *reinterpret_cast<uint4*>(out + (b * kHeads + h) * kLatent + 8 * c) =
        *reinterpret_cast<const uint4*>(tiles + h * kOutRow + 8 * c);
  }
}

int launch(const void* q, const void* cache, void* out, int batch, int width, long long q_stride_b,
           long long q_stride_h, long long c_stride_b, long long c_stride_t, int pos,
           const int* pos_at, float scale, void* stream) {
  if (batch < 1 || width < 1) return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB of shared memory a block: set once a device
  static bool ready[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[device]) {
    err = cudaFuncSetAttribute(mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  mla_decode_kernel<<<batch, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(cache),
      static_cast<__nv_bfloat16*>(out), q_stride_b, q_stride_h, c_stride_b, c_stride_t, width, pos,
      pos_at, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, 16, 576) bf16, rows at q_stride_b / heads at q_stride_h elements;
// cache: (B, width, 576) bf16 latent rows at c_stride_b / c_stride_t
// elements; every row contiguous and 16-byte aligned (strides multiples of
// 8). out: (B, 16, 512) bf16, contiguous. Attends positions [0, pos].
// Returns a cudaError_t.
extern "C" int mla_decode(const void* q, const void* cache, void* out, int batch, int width,
                          long long q_stride_b, long long q_stride_h, long long c_stride_b,
                          long long c_stride_t, int pos, float scale, void* stream) {
  if (pos < 0 || pos >= width) return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, cache, out, batch, width, q_stride_b, q_stride_h, c_stride_b, c_stride_t, pos,
                nullptr, scale, stream);
}

// mla_decode with pos read on the card from the int32 at `pos` (as it is
// when the kernel runs: a captured graph replays it at each step's position).
extern "C" int mla_decode_at(const void* q, const void* cache, void* out, int batch, int width,
                             long long q_stride_b, long long q_stride_h, long long c_stride_b,
                             long long c_stride_t, const int* pos, float scale, void* stream) {
  return launch(q, cache, out, batch, width, q_stride_b, q_stride_h, c_stride_b, c_stride_t, 0, pos,
                scale, stream);
}
