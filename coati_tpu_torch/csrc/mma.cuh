// Tensor-core and asynchronous-copy helpers shared by the bf16 attention
// kernels (flash_attention.cu, packed_attention.cu): 16-byte cp.async
// copies with zero fill, ldmatrix (plain and transposed), the bf16
// mma.sync m16n8k16 with float32 accumulation, bf16 packing, the fast
// base-2 exponential and the XOR swizzle of a shared-memory tile.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), which the kernels rely on:
//   A (16 x 16, row-major), 4 registers of two bf16:
//     a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//     a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8, k x n), 2 registers: b0 (k 2t, 2t+1; col g), b1 (k 2t+8, 2t+9);
//   C (16 x 8 float32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So two C tiles of 8 columns make one A fragment of 16 (the P of P V),
// with no trip through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <math.h>  // INFINITY, the kernels' mask value
#include <stdint.h>

namespace coati {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; with `valid` false nothing is
// read and the 16 bytes are zero-filled (src-size 0). src must still be a
// mapped address: callers clamp it into the tensor.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i, and r[i] receives (row lane / 4, cols 2 (lane % 4), +1) of it
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// the same, each matrix transposed: r[i] = (rows 2 (lane % 4), +1; col lane / 4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// d += a b: bf16 inputs, float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> two bf16 (round to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit (2 ulp; -inf and large negatives give 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Element offset of the 8-element (16-byte) chunk `c` of row `r` in a
// shared tile whose rows are DH bf16 values. The chunk index is XORed with
// a function of the row so that the 8 row addresses of one ldmatrix
// matrix (8 consecutive rows, one chunk, first row a multiple of 8) fall
// in 8 different 16-byte bank groups: unswizzled, rows of 32 bytes (Dh
// 16) would conflict 2-way, of 64 bytes 4-way, of 128 bytes 8-way.
template <int DH>
__device__ __forceinline__ int swizzle(int r, int c) {
  constexpr int kChunks = DH / 8;          // chunks per row: 2, 4 or 8
  constexpr int kRowsPer128 = 8 / kChunks;  // rows in one 128-byte bank period
  return r * DH + ((c ^ ((r / kRowsPer128) % kChunks)) << 3);
}

}  // namespace coati
