// bf16 tile products on the H100's tensor cores, f32 accumulation, by
// mma.sync. Used by the bf16 forms of K1 (diffnet_block.cu) and K5
// (diffnet_block_bwd.cu), which take the cp.async ring, the tiling and the
// window rows of tf32x3.cuh as they are. (The bf16 K3 and K4 run on wgmma,
// wgmma.cuh.)
//
// A bf16 product is exact in f32, so one mma.sync.m16n8k16 a k16 step gives
// what the Pallas kernel's jnp.dot(..., preferred_element_type=f32) gives,
// up to the order of the f32 sums: one product where 3xTF32 needs three.
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (PTX ISA;
// CUTLASS's SM80_16x8x16_F32BF16BF16F32_TN), for lane = 4 * g + t, each
// register two bf16, the lower k in the low half:
//   A [16 x 16]: a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..), a3 (g + 8, 2t+8..)
//   B [16 x 8]:  b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
//   C [16 x 8]:  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// C is laid out as the m16n8k8 TF32 accumulator of tf32x3.cuh, so the
// kernels' epilogues index it the same way.
//
// A is row-major in shared memory (a[m * lda + k]): each register is one
// 32-bit load. At a row stride of 4 mod 32 words (lda = 8 mod 64 bf16) the
// warp's 32 loads fall on 32 distinct banks. B comes in two layouts:
//  * k-major (b[k * ldb + n], a weight [K, N] as it lies in device memory):
//    the pair of k for one n sits in two rows, so ldmatrix .trans gathers it,
//    four 8 x 8 matrices (two n8 tiles) a warp instruction. Rows of
//    4 NC + 16 bytes (16 mod 128) keep its eight row reads a matrix on
//    distinct banks.
//  * n-major (b[n * ldb + k], a weight read transposed): one 32-bit load a
//    register, at a row stride of 4 mod 32 words.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace bf16mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// a, b rounded to nearest into two consecutive bf16 (a at p)
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of the 16 x 16 tile at a (row-major, row stride lda).
__device__ __forceinline__ void load_a(const bf16* a, int lda, int lane, uint32_t* r) {
  const int g = lane >> 2, t = lane & 3;
  r[0] = ld32(a + g * lda + 2 * t);
  r[1] = ld32(a + (g + 8) * lda + 2 * t);
  r[2] = ld32(a + g * lda + 2 * t + 8);
  r[3] = ld32(a + (g + 8) * lda + 2 * t + 8);
}

// The B fragments of two n8 tiles, stored k-major at b0 and b1 (row stride
// ldb, 16-byte aligned rows): lanes 8m .. 8m + 7 address the rows of matrix
// m (tile m / 2, k rows 8 (m % 2) ..), which .trans hands out as (k pair, n).
__device__ __forceinline__ void load_b_kmajor_x2(const bf16* b0, const bf16* b1, int ldb,
                                                 int lane, uint32_t* f0, uint32_t* f1) {
  const int m = lane >> 3, r = lane & 7;
  const bf16* p = (m < 2 ? b0 : b1) + ((m & 1) * 8 + r) * ldb;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(f0[0]), "=r"(f0[1]), "=r"(f1[0]), "=r"(f1[1])
               : "r"(tf32x3::smem_u32(p))
               : "memory");
}

// The B fragment of the n8 tile stored n-major at b (row stride ldb).
__device__ __forceinline__ void load_b_nmajor(const bf16* b, int ldb, int lane, uint32_t* f) {
  const int g = lane >> 2, t = lane & 3;
  f[0] = ld32(b + g * ldb + 2 * t);
  f[1] = ld32(b + g * ldb + 2 * t + 8);
}

// acc[MT][NT] += A x B over one chunk of BK columns of K (BK % 16 == 0).
// A: MT m16 tiles from a (row-major, stride lda, tile mt at row 16 mt).
// B: NT n8 tiles (NT even where KMAJOR), tile nt at b + bofs(nt). between(j)
// runs after the fragment loads of k16 step j, before its products.
template <int BK, bool KMAJOR, int MT, int NT, typename BOfs, typename Between>
__device__ __forceinline__ void chunk_mma(float (&acc)[MT][NT][4], const bf16* a, int lda,
                                          const bf16* b, int ldb, BOfs bofs, int lane,
                                          Between between) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) load_a(a + mt * 16 * lda + kk, lda, lane, af[mt]);
    if constexpr (KMAJOR) {
      static_assert(NT % 2 == 0, "k-major B loads n8 tiles in pairs");
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2)
        load_b_kmajor_x2(b + bofs(nt) + kk * ldb, b + bofs(nt + 1) + kk * ldb, ldb, lane,
                         bfr[nt], bfr[nt + 1]);
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) load_b_nmajor(b + bofs(nt) + kk, ldb, lane, bfr[nt]);
    }
    between(kk / 16);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt]);
  }
}

}  // namespace bf16mma
