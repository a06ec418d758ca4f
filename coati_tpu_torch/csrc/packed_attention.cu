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
// the K and V of a group of heads in shared memory once, whole, and a
// query row's scores (at most 128) fit in registers. So the scores of a
// row are complete before its softmax: no key tiles, no running maximum,
// no rescaling of a partial sum. q, k, v are taken by (batch, token)
// strides with heads packed, so the views split out of the fused qkv
// projection are read in place.
//
// Two bodies behind one entry point, chosen by the input dtype:
//
// bf16: tensor cores (packed_causal_bf16_kernel).
//  What bounds it on an H100: bytes and the exponentials, as K2. At B 1024,
//  T 96, H 16, Dh 16 it reads q, k, v and writes o once (0.060 ms at 3.35
//  TB/s) and takes one exponential per (query, key) pair of its 16 x 16
//  tiles on or below the diagonal (0.088 G, 0.021 ms on the
//  special-function units).
//  Design:
//   * one block per (batch row, group of heads), 4 warps; it stages the
//     group's K and V whole, in bf16, with 16-byte cp.async copies, rows
//     XOR-swizzled for ldmatrix and zero-filled up to T rounded to 16 (4
//     KB a head a tensor at T 128, Dh 16); the wrapper picks the group so
//     that both stay under 24 KB and no warp gets more than three tile
//     pairs (below);
//   * a warp owns a 16-row query tile of one head at a time, its Q read
//     straight from device memory into mma A fragments; tiles i and n-1-i
//     go to the same warp, so every warp gets the same causal work;
//   * S = Q K^T by mma.sync m16n8k16 up to the tile's diagonal (at most 16
//     n8 tiles: 64 float32 registers a lane), K's fragments by ldmatrix;
//     the exact row max and sum by quad shuffles, in base 2 with
//     scale * log2(e) folded into one multiply-add;
//   * P is normalized and then rounded to bf16 (the TPU kernel's rounding
//     point), passed from S's C fragments to A fragments in registers, and
//     multiplied by V (ldmatrix.trans) with float32 accumulation.
//  The registers that hold S are sized by a template bucket of T (32, 64,
//  96, 128), so short sequences, the trainer's, do not pay for 128 keys.
//
// float32: CUDA cores (packed_causal_f32_kernel), for the fidelity runs.
//  TF32 tensor cores cannot meet the 1e-5 tolerance against the plain
//  version that the float32 path is held to, so the float32 body stays as
//  it was: the group's K and V staged in float32 (rows padded by one
//  float, under 28 KB a block), one warp per (head, query row), lane l
//  scoring keys l, l + 32, ... by scalar FMAs, p @ v by a shuffle
//  reduction over the Dh columns.
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

// Attention of the 16 query rows 16 i .. 16 i + 15 of one head against its
// staged, swizzled K and V (kg, vg): the warp's whole share of one tile.
template <int DH, int NCH>
__device__ __forceinline__ void attend_tile(const __nv_bfloat16* __restrict__ qg,
                                            long long q_st, const __nv_bfloat16* kg,
                                            const __nv_bfloat16* vg,
                                            __nv_bfloat16* __restrict__ og, long long o_st,
                                            int i, int seq, float scale_log2) {
  constexpr int kSteps = DH / 16;
  constexpr int kOut = DH / 8;
  const int lane = threadIdx.x & 31;
  const int r_lo = 16 * i + (lane >> 2);  // rows of c0, c1 and of c2, c3
  const int r_hi = r_lo + 8;
  const int col = 2 * (lane & 3);

  // Q's A fragments straight from device memory, 4 bytes a register
  uint32_t qf[kSteps][4];
  const bool lo_ok = r_lo < seq;
  const bool hi_ok = r_hi < seq;
  const uint32_t* q_lo = reinterpret_cast<const uint32_t*>(qg + r_lo * q_st + col);
  const uint32_t* q_hi = reinterpret_cast<const uint32_t*>(qg + r_hi * q_st + col);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    qf[kk][0] = lo_ok ? q_lo[8 * kk] : 0u;  // 8 words = 16 bf16 columns
    qf[kk][1] = hi_ok ? q_hi[8 * kk] : 0u;
    qf[kk][2] = lo_ok ? q_lo[8 * kk + 4] : 0u;
    qf[kk][3] = hi_ok ? q_hi[8 * kk + 4] : 0u;
  }

  // S over the 16-key chunks 0 .. i, the last one on the diagonal
  float s[2 * NCH][4];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (c <= i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * c][e] = s[2 * c + 1][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t kf[4];  // b0, b1 of keys 16c .. +7, then of 16c + 8 .. +15
        coati::ldmatrix_x4(kf, kg + coati::swizzle<DH>(16 * c + (lane & 7) + ((lane >> 4) << 3),
                                                       2 * kk + ((lane >> 3) & 1)));
        coati::mma_bf16(s[2 * c], qf[kk], kf[0], kf[1]);
        coati::mma_bf16(s[2 * c + 1], qf[kk], kf[2], kf[3]);
      }
    }
  }

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 2 * NCH; ++n) {
    if (n / 2 <= i) {
      if (n / 2 == i) {  // the diagonal chunk: keys past the row are masked
        const int key = 8 * n + col;
        if (key > r_lo) s[n][0] = -INFINITY;
        if (key + 1 > r_lo) s[n][1] = -INFINITY;
        if (key > r_hi) s[n][2] = -INFINITY;
        if (key + 1 > r_hi) s[n][3] = -INFINITY;
      }
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
  }
  float l[2] = {0.f, 0.f};
  float mscaled[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    mscaled[r] = mx[r] * scale_log2;  // finite: key 0 is visible to every row
  }
#pragma unroll
  for (int n = 0; n < 2 * NCH; ++n) {
    if (n / 2 <= i) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = coati::exp2_fast(fmaf(s[n][e], scale_log2, -mscaled[e >> 1]));
      l[0] += s[n][0] + s[n][1];
      l[1] += s[n][2] + s[n][3];
    }
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    inv[r] = 1.f / l[r];
  }

  float acc[kOut][4];
#pragma unroll
  for (int d = 0; d < kOut; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (c <= i) {
      // normalized, then rounded to bf16: the A fragment of keys 16c .. +15
      const uint32_t pa[4] = {
          coati::pack_bf16(s[2 * c][0] * inv[0], s[2 * c][1] * inv[0]),
          coati::pack_bf16(s[2 * c][2] * inv[1], s[2 * c][3] * inv[1]),
          coati::pack_bf16(s[2 * c + 1][0] * inv[0], s[2 * c + 1][1] * inv[0]),
          coati::pack_bf16(s[2 * c + 1][2] * inv[1], s[2 * c + 1][3] * inv[1])};
#pragma unroll
      for (int dp = 0; dp < kOut / 2; ++dp) {
        uint32_t vf[4];  // b0, b1 of columns 16dp .. +7, then of 16dp + 8 .. +15
        coati::ldmatrix_x4_trans(
            vf, vg + coati::swizzle<DH>(16 * c + (lane & 7) + (((lane >> 3) & 1) << 3),
                                        2 * dp + (lane >> 4)));
        coati::mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        coati::mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int d = 0; d < kOut; ++d) {
    if (lo_ok)
      *reinterpret_cast<uint32_t*>(og + r_lo * o_st + 8 * d + col) =
          coati::pack_bf16(acc[d][0], acc[d][1]);
    if (hi_ok)
      *reinterpret_cast<uint32_t*>(og + r_hi * o_st + 8 * d + col) =
          coati::pack_bf16(acc[d][2], acc[d][3]);
  }
}

template <int DH, int NCH>
__global__ void __launch_bounds__(kTcThreads) packed_causal_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int seq, int heads,
    int group, long long q_sb, long long q_st, long long k_sb, long long k_st, long long v_sb,
    long long v_st, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  constexpr int kChunks = DH / 8;
  const int tpad = (seq + 15) & ~15;
  auto* ks = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // [group][tpad * DH], swizzled
  __nv_bfloat16* vs = ks + group * tpad * DH;

  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.y;
  const int h0 = blockIdx.x * group;
  const __nv_bfloat16* kb = k + b * k_sb + h0 * DH;
  const __nv_bfloat16* vb = v + b * v_sb + h0 * DH;

  // stage K and V of the group: a token's group * DH elements are
  // contiguous in memory, one 16-byte copy per chunk
  const int per_token = group * kChunks;
  for (int x = threadIdx.x; x < tpad * per_token; x += kTcThreads) {
    const int t = x / per_token;
    const int g = (x - t * per_token) / kChunks;
    const int c = x % kChunks;
    const bool ok = t < seq;
    const long long src = (ok ? t : 0);
    const int at = g * tpad * DH + coati::swizzle<DH>(t, c);
    coati::cp_async_16(ks + at, kb + src * k_st + g * DH + c * 8, ok);
    coati::cp_async_16(vs + at, vb + src * v_st + g * DH + c * 8, ok);
  }
  coati::cp_async_commit();
  coati::cp_async_wait<0>();
  __syncthreads();

  // tiles i and ntile-1-i make one item of equal causal work
  const int ntile = tpad / 16;
  const int npair = (ntile + 1) / 2;
  for (int item = warp; item < group * npair; item += kTcWarps) {
    const int g = item / npair;
    const int pair = item - g * npair;
    const __nv_bfloat16* qg = q + b * q_sb + (h0 + g) * DH;
    __nv_bfloat16* og = o + (b * seq * heads + h0 + g) * DH;
    const __nv_bfloat16* kg = ks + g * tpad * DH;
    const __nv_bfloat16* vg = vs + g * tpad * DH;
    attend_tile<DH, NCH>(qg, q_st, kg, vg, og, static_cast<long long>(heads) * DH, pair, seq,
                         scale_log2);
    if (ntile - 1 - pair != pair)
      attend_tile<DH, NCH>(qg, q_st, kg, vg, og, static_cast<long long>(heads) * DH,
                           ntile - 1 - pair, seq, scale_log2);
  }
}

// --------------------------------------------------------- float32 body

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLaneChunks = kMaxT / 32;  // scores per lane

template <int DH>
__global__ void __launch_bounds__(kThreads) packed_causal_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int seq, int heads, int group, long long q_sb, long long q_st,
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

  const float* qb = q + b * q_sb + h0 * DH;
  const float* kb = k + b * k_sb + h0 * DH;
  const float* vb = v + b * v_sb + h0 * DH;

  // stage K and V of the group's heads once: a token's group * DH elements
  // are contiguous in memory
  const int gw = group * DH;
  for (int e = tid; e < seq * gw; e += kThreads) {
    const int t = e / gw;
    const int x = e - t * gw;
    const int g = x / DH;
    const int d = x - g * DH;
    const int at = (g * seq + t) * DP + d;
    ks[at] = kb[t * k_st + x];
    vs[at] = vb[t * v_st + x];
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
    for (int d = lane; d < DH; d += 32) qw[d] = qb[r * q_st + g * DH + d];
    __syncwarp();

    // scores of keys lane + 32 c, c < nch, all at or before position r
    const int nch = r / 32 + 1;
    float s[kLaneChunks];
#pragma unroll
    for (int c = 0; c < kLaneChunks; ++c) s[c] = 0.f;
    int key[kLaneChunks];
#pragma unroll
    for (int c = 0; c < kLaneChunks; ++c) key[c] = min(lane + 32 * c, seq - 1) * DP;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      const float qd = qw[d];
#pragma unroll
      for (int c = 0; c < kLaneChunks; ++c)
        if (c < nch) s[c] += qd * kg[key[c] + d];
    }
    float m = coati::kNegInf;
#pragma unroll
    for (int c = 0; c < kLaneChunks; ++c) {
      s[c] = (lane + 32 * c <= r) ? s[c] * scale : coati::kNegInf;
      m = fmaxf(m, s[c]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    float l = 0.f;
#pragma unroll
    for (int c = 0; c < kLaneChunks; ++c) {
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
      float* ob = o + ((static_cast<long long>(b) * seq + r) * heads + h0 + g) * DH;
#pragma unroll
      for (int u = 0; u < PER; ++u) ob[dl + 32 * u] = acc[u] * inv;
    }
  }
}

// ------------------------------------------------------------- launch

long long smem_bytes(int seq, int group, int head_dim, int dtype) {
  if (dtype == coati::kBF16) return 2LL * group * ((seq + 15) / 16 * 16) * head_dim * 2;
  return (2LL * group * seq * (head_dim + 1) + kWarps * kMaxT + kWarps * head_dim) * 4;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
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
  const cudaError_t err = allow_smem(packed_causal_bf16_kernel<DH, NCH>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_causal_bf16_kernel<DH, NCH><<<dim3(a.heads / a.group, a.batch), kTcThreads, bytes,
                                       a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.o), a.seq,
      a.heads, a.group, a.q_sb, a.q_st, a.k_sb, a.k_st, a.v_sb, a.v_st, a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_f32(const Args& a, long long bytes) {
  const cudaError_t err = allow_smem(packed_causal_f32_kernel<DH>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_causal_f32_kernel<DH><<<dim3(a.heads / a.group, a.batch), kThreads, bytes,
                                 a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.seq, a.heads, a.group,
      a.q_sb, a.q_st, a.k_sb, a.k_st, a.v_sb, a.v_st, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dh(const Args& a, int dtype) {
  const long long bytes = smem_bytes(a.seq, a.group, DH, dtype);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == coati::kF32) return launch_f32<DH>(a, bytes);
  if (dtype != coati::kBF16) return static_cast<int>(cudaErrorInvalidValue);
  // the registers that hold a row's scores: T rounded up to 32, 64, 96, 128
  if (a.seq <= 32) return launch_bf16<DH, 2>(a, bytes);
  if (a.seq <= 64) return launch_bf16<DH, 4>(a, bytes);
  if (a.seq <= 96) return launch_bf16<DH, 6>(a, bytes);
  return launch_bf16<DH, 8>(a, bytes);
}

}  // namespace

// Bytes of shared memory a block needs for `group` heads of a sequence, in
// the body that `dtype` selects.
extern "C" long long packed_causal_attention_smem_bytes(int seq, int group, int head_dim,
                                                        int dtype) {
  return smem_bytes(seq, group, head_dim, dtype);
}

// q, k, v: (B, T, H, Dh) with element strides (q_sb, q_st, Dh, 1) etc., T <=
// 128; o: contiguous (B, T, H, Dh) in the same dtype; `group` heads per
// block, a divisor of H. bf16 runs the tensor-core body and needs 16-byte
// aligned base pointers and batch and token strides (the wrapper checks);
// float32 runs the CUDA-core body. Returns a cudaError_t.
extern "C" int packed_causal_attention(const void* q, const void* k, const void* v, void* o,
                                       int batch, int seq, int heads, int head_dim,
                                       int group, int dtype, long long q_sb, long long q_st,
                                       long long k_sb, long long k_st, long long v_sb,
                                       long long v_st, float scale, void* stream) {
  if (seq < 1 || seq > kMaxT || group < 1 || heads % group != 0 || batch < 1 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,    k,    v,    o,    batch, seq,   heads, group,
               q_sb, q_st, k_sb, k_st, v_sb,  v_st, scale, static_cast<cudaStream_t>(stream)};
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
