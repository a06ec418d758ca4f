// K1: masked-read decode attention over a KV cache (one query per row).
//
// Replaces the TPU kernel coati_tpu/ops/pallas/decode_attention.py
// (decode_attention_pallas / decode_attention_pallas_quant ->
// _decode_pallas -> _kernel). Same function: the query of each batch row
// attends to cache positions [0, pos] only, with an online softmax in
// float32. For an int8 cache, per-(token, head) k-scales multiply the
// scores and v-scales fold into the probabilities before the value sum:
//   q . (k8 * ks) = (q . k8) * ks,  sum_s p_s (v8_s vs_s) = sum_s (p_s vs_s) v8_s.
//
// What bounds it on an H100: bytes. The work is 4 * B*H*(pos+1)*Dh FLOPs
// against B*(pos+1)*H*Dh*2 cache elements (plus scales) read once: about
// one operation per byte. The masked read is the point: positions past
// pos are never loaded, so the traffic scales with pos, not with the
// cache width.
//
// Design (simple and right first):
//  * one block per batch row, H*Dh threads; thread (h, d) owns one
//    element of the query and of the f32 accumulator, so each cache
//    position is one coalesced row of H*Dh elements read by the block;
//  * the q.k dot of a head is reduced across its Dh lanes with warp
//    shuffles (Dh in {16, 32}: a head never straddles a warp);
//  * positions are processed in chunks of 8 whose loads all start before
//    any of them is used, keeping several reads in flight per thread;
//    one running-max rescale per chunk;
//  * pos is a host int passed by value: launching needs no device sync.
#include "common.cuh"

namespace {

constexpr int kChunk = 8;

template <typename QT, typename KT, typename ST, int DH, bool QUANT>
__global__ void decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                              const KT* __restrict__ v, const ST* __restrict__ k_scale,
                              const ST* __restrict__ v_scale, QT* __restrict__ o,
                              int width, int heads, int pos, float scale) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;  // = h * DH + d
  const int h = tid / DH;
  const int hd = heads * DH;
  const long long row = static_cast<long long>(b) * width;

  const float qd = coati::to_float(q[static_cast<long long>(b) * hd + tid]);
  const KT* kb = k + row * hd + tid;
  const KT* vb = v + row * hd + tid;
  const ST* ksb = QUANT ? k_scale + row * heads + h : nullptr;
  const ST* vsb = QUANT ? v_scale + row * heads + h : nullptr;

  float m = coati::kNegInf;
  float l = 0.f;
  float acc = 0.f;
  for (int s0 = 0; s0 <= pos; s0 += kChunk) {
    float kv[kChunk], vv[kChunk], kscale[kChunk], vscale[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int s = s0 + j;
      const bool ok = s <= pos;
      kv[j] = ok ? coati::to_float(kb[static_cast<long long>(s) * hd]) : 0.f;
      vv[j] = ok ? coati::to_float(vb[static_cast<long long>(s) * hd]) : 0.f;
      if (QUANT) {
        kscale[j] = ok ? coati::to_float(ksb[static_cast<long long>(s) * heads]) : 0.f;
        vscale[j] = ok ? coati::to_float(vsb[static_cast<long long>(s) * heads]) : 0.f;
      }
    }
    float sc[kChunk];
    float cmax = coati::kNegInf;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      float part = qd * kv[j];
#pragma unroll
      for (int off = DH / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const float score = QUANT ? part * kscale[j] * scale : part * scale;
      sc[j] = (s0 + j <= pos) ? score : coati::kNegInf;
      cmax = fmaxf(cmax, sc[j]);
    }
    const float m_new = fmaxf(m, cmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
    acc *= alpha;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float p = expf(sc[j] - m_new);
      l += p;
      acc += (QUANT ? p * vscale[j] : p) * vv[j];
    }
    m = m_new;
  }
  o[static_cast<long long>(b) * hd + tid] = coati::from_float<QT>(acc / l);
}

template <typename QT, typename KT, typename ST, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           void* o, int batch, int width, int heads, int head_dim, int pos, float scale,
           cudaStream_t stream) {
  const int threads = heads * head_dim;
  const auto* qp = static_cast<const QT*>(q);
  const auto* kp = static_cast<const KT*>(k);
  const auto* vp = static_cast<const KT*>(v);
  const auto* ksp = static_cast<const ST*>(ks);
  const auto* vsp = static_cast<const ST*>(vs);
  auto* op = static_cast<QT*>(o);
  switch (head_dim) {
    case 16:
      decode_kernel<QT, KT, ST, 16, QUANT><<<batch, threads, 0, stream>>>(
          qp, kp, vp, ksp, vsp, op, width, heads, pos, scale);
      break;
    case 32:
      decode_kernel<QT, KT, ST, 32, QUANT><<<batch, threads, 0, stream>>>(
          qp, kp, vp, ksp, vsp, op, width, heads, pos, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_quant(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, void* o, int batch, int width, int heads, int head_dim,
                 int pos, int scale_dtype, float scale, cudaStream_t stream) {
  if (scale_dtype == coati::kF32)
    return launch<QT, int8_t, float, true>(q, k, v, ks, vs, o, batch, width, heads,
                                           head_dim, pos, scale, stream);
  if (scale_dtype == coati::kBF16)
    return launch<QT, int8_t, __nv_bfloat16, true>(q, k, v, ks, vs, o, batch, width,
                                                   heads, head_dim, pos, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (B, H, Dh) contiguous; k, v: contiguous (B, width, H, Dh) cache slices;
// ks, vs: contiguous (B, width, H) scales for an int8 cache, else null;
// o: (B, H, Dh) in q's dtype. Attends positions [0, pos]. Returns a
// cudaError_t.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs, void* o, int batch,
                                int width, int heads, int head_dim, int pos, int q_dtype,
                                int kv_dtype, int scale_dtype, float scale,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == coati::kI8) {
    if (q_dtype == coati::kF32)
      return launch_quant<float>(q, k, v, ks, vs, o, batch, width, heads, head_dim, pos,
                                 scale_dtype, scale, s);
    if (q_dtype == coati::kBF16)
      return launch_quant<__nv_bfloat16>(q, k, v, ks, vs, o, batch, width, heads,
                                         head_dim, pos, scale_dtype, scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kv_dtype != q_dtype) return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == coati::kF32)
    return launch<float, float, float, false>(q, k, v, ks, vs, o, batch, width, heads,
                                              head_dim, pos, scale, s);
  if (q_dtype == coati::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, float, false>(
        q, k, v, ks, vs, o, batch, width, heads, head_dim, pos, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
