// Float32-accurate tile products on the H100's tensor cores (3xTF32), and the
// copies that feed them. Shared by K1 (diffnet_block.cu), K5
// (diffnet_block_bwd.cu), K3 (flash_attention.cu) and K4
// (flash_attention_bwd.cu).
//
// Each operand is split as a = hi + lo: hi = tf32(a), rounded to nearest
// (cvt.rna's rounding), and lo = a - hi, the fp32 residual, which the
// tensor core reads as TF32 by dropping its low 13 bits. A product of two split operands is
// hi*hi + hi*lo + lo*hi, three TF32 mma.sync products accumulated in fp32
// (lo*lo, about 2^-22 of the product, is dropped). That keeps float32
// accuracy at 495 / 3 = 165 TFLOP/s, against the 67 TFLOP/s of the float32
// CUDA cores.
//
// The tensor cores' fp32 accumulation does not round to nearest, so its
// error grows with the number of steps summed into one accumulator (over
// K1's 360 products it came near the 1e-4 allowed). So chunk_mma sums one
// ring chunk (BK / 8 steps) into fresh temporaries, one per product
// where SEP = 3, and adds them to the running sum with fp32 adds, which do
// round to nearest. Separate temporaries also make the three
// products of a step independent, so a warp with few tiles still keeps the
// tensor cores busy.
//
// Fragments of mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 (PTX ISA; CUTLASS's
// SM80_16x8x8_F32TF32TF32F32_TN), for lane = 4 * g + t:
//   A [16 x 8]: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B [8 x 8]:  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C [16 x 8]: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// Shared-memory rows are padded so that a warp's fragment loads fall on 32
// distinct banks: a row stride of 4 mod 32 floats where lanes step along K
// (A, and B stored n-major), 8 mod 32 where they step along N (B stored
// k-major).
//
// The weights stream through a ring of S stages in shared memory, filled by
// cp.async, with two mbarriers a stage instead of a block barrier a chunk:
// "full" completes when every thread's copies into the stage have landed
// (cp.async.mbarrier.arrive.noinc), "empty" when every warp has read it.
// Warps then drift apart, and one warp's copies and fragment loads overlap
// another's tensor-core products, where a block barrier a chunk would drain
// them all together.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// A CTA of 8 warps over a tile of M rows and NC columns: WM warps along the
// rows with MW m16 tiles each, WN along the columns with NW n8 tiles each.
// SEP: the temporaries per chunk of chunk_mma (three at 16 rows, where a
// warp has few tiles, one at more).
template <int M, int NC>
struct Tiling {
  static constexpr int WM = M >= 32 ? M / 32 : 1;
  static constexpr int MW = M / (16 * WM);
  static constexpr int WN = 8 / WM;
  static constexpr int NW = NC / (8 * WN);
  static constexpr int SEP = M >= 32 ? 1 : 3;
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// The dynamic shared memory a block of kernel can take on the current
// device, or 0 if it cannot be read.
template <typename Kernel>
size_t max_dynamic_smem(Kernel kernel) {
  int dev = 0, limit = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess)
    return 0;
  return (size_t)limit > attr.sharedSizeBytes ? (size_t)limit - attr.sharedSizeBytes : 0;
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), on the integer ALU: add half a TF32 unit to the magnitude's
// bits, then drop the 13 low mantissa bits. The conversion instruction
// itself made K1 markedly slower on the H100.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = __float_as_uint(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b, the accumulator's first product (no zeroed registers needed).
__device__ __forceinline__ void mma_tf32_first(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// A fragment of the 16 x 8 tile at a (row-major, row stride lda), split.
__device__ __forceinline__ void load_a(const float* a, int lda, int lane,
                                       uint32_t* hi, uint32_t* lo) {
  const int g = lane >> 2, t = lane & 3;
  split(a[g * lda + t], hi[0], lo[0]);
  split(a[(g + 8) * lda + t], hi[1], lo[1]);
  split(a[g * lda + t + 4], hi[2], lo[2]);
  split(a[(g + 8) * lda + t + 4], hi[3], lo[3]);
}

// B fragment of the 8 x 8 tile at b, stored k-major (b[k * ldb + n]) or
// n-major (b[n * ldb + k]), split.
template <bool KMAJOR>
__device__ __forceinline__ void load_b(const float* b, int ldb, int lane,
                                       uint32_t* hi, uint32_t* lo) {
  const int g = lane >> 2, t = lane & 3;
  if (KMAJOR) {
    split(b[t * ldb + g], hi[0], lo[0]);
    split(b[(t + 4) * ldb + g], hi[1], lo[1]);
  } else {
    split(b[g * ldb + t], hi[0], lo[0]);
    split(b[g * ldb + t + 4], hi[1], lo[1]);
  }
}

// d += a * b for one k8 step, float32-accurate: the three TF32 products of
// the split operands, the two small ones first.
__device__ __forceinline__ void mma3(float* d, const uint32_t* ahi, const uint32_t* alo,
                                     const uint32_t* bhi, const uint32_t* blo) {
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

// The same three products into three accumulators, so that a run of k8
// steps into one tile is three independent mma.sync chains, a third as long;
// sum3 joins them (small terms first).
__device__ __forceinline__ void mma3_sep(float (&d)[3][4], const uint32_t* ahi,
                                         const uint32_t* alo, const uint32_t* bhi,
                                         const uint32_t* blo) {
  mma_tf32(d[0], alo, bhi);
  mma_tf32(d[1], ahi, blo);
  mma_tf32(d[2], ahi, bhi);
}

__device__ __forceinline__ void sum3(const float (&d)[3][4], float* out) {
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = d[2][e] + (d[0][e] + d[1][e]);
}

// Fragments with the k index of a k8 step permuted, in A and B alike (a
// product sums over k, so one permutation applied to both leaves it
// unchanged): slot t holds column 2t and slot t + 4 column 2t + 1. Then an
// accumulator fragment (c0..c3: columns 2t, 2t + 1 of rows g, g + 8) is an A
// fragment as it stands (a_from_acc), and the rows 2t, 2t + 1 that a lane
// reads of a k-major operand fall on 32 distinct banks at a row stride of 4
// mod 32.
//
// A, row-major (a[m * lda + k]), split.
__device__ __forceinline__ void load_a_kp(const float* a, int lda, int lane,
                                          uint32_t* hi, uint32_t* lo) {
  const int g = lane >> 2, t = lane & 3;
  split(a[g * lda + 2 * t], hi[0], lo[0]);
  split(a[(g + 8) * lda + 2 * t], hi[1], lo[1]);
  split(a[g * lda + 2 * t + 1], hi[2], lo[2]);
  split(a[(g + 8) * lda + 2 * t + 1], hi[3], lo[3]);
}

// A stored k-major (a[k * lda + m]: the transpose of a row-major tile), split.
__device__ __forceinline__ void load_at_kp(const float* a, int lda, int lane,
                                           uint32_t* hi, uint32_t* lo) {
  const int g = lane >> 2, t = lane & 3;
  split(a[2 * t * lda + g], hi[0], lo[0]);
  split(a[2 * t * lda + g + 8], hi[1], lo[1]);
  split(a[(2 * t + 1) * lda + g], hi[2], lo[2]);
  split(a[(2 * t + 1) * lda + g + 8], hi[3], lo[3]);
}

// B stored k-major (b[k * ldb + n]), split.
__device__ __forceinline__ void load_b_kp(const float* b, int ldb, int lane,
                                          uint32_t* hi, uint32_t* lo) {
  const int g = lane >> 2, t = lane & 3;
  split(b[2 * t * ldb + g], hi[0], lo[0]);
  split(b[(2 * t + 1) * ldb + g], hi[1], lo[1]);
}

// The A fragment, k permuted, of the m16 x k8 tile held in accumulator c.
__device__ __forceinline__ void a_from_acc(const float* c, uint32_t* hi, uint32_t* lo) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// acc[MT][NT] += A x B over one chunk of BK columns of K, float32-accurate.
// A: MT m16 tiles from a (row-major, stride lda, tile mt at row 16 mt).
// B: NT n8 tiles, tile nt at b + bofs(nt), stored k-major or n-major.
template <int BK, int SEP, bool KMAJOR, int MT, int NT, typename BOfs, typename Between>
__device__ __forceinline__ void chunk_mma(float (&acc)[MT][NT][4], const float* a, int lda,
                                          const float* b, int ldb, BOfs bofs, int lane,
                                          Between between) {
  float tmp[SEP][MT][NT][4];
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t ahi[MT][4], alo[MT][4], bhi[NT][2], blo[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) load_a(a + mt * 16 * lda + kk, lda, lane, ahi[mt], alo[mt]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      load_b<KMAJOR>(b + bofs(nt) + (KMAJOR ? kk * ldb : kk), ldb, lane, bhi[nt], blo[nt]);
    between(kk / 8);
    // the three products go to tmp[0], tmp[SEP / 2], tmp[SEP - 1]; each
    // temporary's first product of the chunk starts it from zero
    constexpr bool first1 = SEP / 2 != 0, first2 = SEP - 1 != SEP / 2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (kk == 0)
          mma_tf32_first(tmp[0][mt][nt], alo[mt], bhi[nt]);
        else
          mma_tf32(tmp[0][mt][nt], alo[mt], bhi[nt]);
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (kk == 0 && first1)
          mma_tf32_first(tmp[SEP / 2][mt][nt], ahi[mt], blo[nt]);
        else
          mma_tf32(tmp[SEP / 2][mt][nt], ahi[mt], blo[nt]);
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (kk == 0 && first2)
          mma_tf32_first(tmp[SEP - 1][mt][nt], ahi[mt], bhi[nt]);
        else
          mma_tf32(tmp[SEP - 1][mt][nt], ahi[mt], bhi[nt]);
      }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sum = tmp[0][mt][nt][e];
#pragma unroll
        for (int s = 1; s < SEP; ++s) sum += tmp[s][mt][nt][e];
        acc[mt][nt][e] += sum;
      }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// One float, for rows whose width or address rules out 16-byte copies.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// The row stride of a staged [rows][8 NDT] tile: 4 mod 32 floats, the
// stride at which the k-permuted fragment loads above hit 32 banks.
template <int NDT>
__host__ __device__ constexpr int row_ld() {
  return (NDT * 8 + 31) / 32 * 32 + 4;
}

// Stages rows [t0, t0 + R) of head hh of batch row b of x [B, T, H, D] into
// dst [R][LD]: copied where t < T and c < D, zero up to DP columns and past
// T, so that every k8 step and every m16 tile reads finite values. vec: D %
// 4 == 0 and x 16-byte aligned (16-byte copies), else one float a copy.
template <int DP, int LD>
__device__ __forceinline__ void stage_rows(float* dst, const float* x, int b, int t0, int R,
                                           int T, int H, int D, int hh, bool vec, int tid,
                                           int nthreads) {
  const size_t rs = (size_t)H * D;
  const float* src = x + (size_t)b * T * rs + (size_t)hh * D;
  if (vec) {
    constexpr int cv = DP / 4;
    for (int e = tid; e < R * cv; e += nthreads) {
      const int r = e / cv, c = e % cv * 4, t = t0 + r;
      float* d = dst + r * LD + c;
      if (t < T && c < D)
        cp_async16(d, src + (size_t)t * rs + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = tid; e < R * DP; e += nthreads) {
      const int r = e / DP, c = e % DP, t = t0 + r;
      float* d = dst + r * LD + c;
      if (t < T && c < D)
        cp_async4(d, src + (size_t)t * rs + c);
      else
        *d = 0.f;
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// An arrival on bar once all of this thread's earlier cp.async have landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The ring's two mbarriers a stage. Chunk c sits in stage c % S, in phase
// (c / S) & 1 of both.
template <int S, int NWARPS>
struct Ring {
  uint64_t full[S], empty[S];

  __device__ void init() {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], NWARPS * 32);
      mbar_init(&empty[s], NWARPS);
    }
  }
  // before this thread's copies of chunk c: wait until every warp has read
  // chunk c - S out of the stage
  __device__ void acquire(int c) {
    if (c >= S) mbar_wait(&empty[c % S], (c / S - 1) & 1);
  }
  // after them
  __device__ void commit(int c) { mbar_arrive_cp_async(&full[c % S]); }
  __device__ void wait(int c) { mbar_wait(&full[c % S], (c / S) & 1); }
  // one lane a warp, once the warp has read chunk c
  __device__ void release(int c, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[c % S]);
  }
};

// The time of row w of a tile's staged window, for the tile of m rows at t0
// read at offsets -d, 0, +d. Where d <= m the window is the m + 2d rows from
// t0 - d, and offset k*d reads its rows from k*d on; where d > m it is three
// blocks of m rows, one per offset, and offset k*d reads block k. Either way
// the window has m + 2 * min(d, m) rows and offset k*d starts at row
// k * min(d, m).
__device__ __forceinline__ int window_time(int w, int t0, int m, int d) {
  return d <= m ? t0 - d + w : t0 + (w / m - 1) * d + w % m;
}

}  // namespace tf32x3
