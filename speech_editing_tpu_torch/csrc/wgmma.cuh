// Hopper's warpgroup products (wgmma) in bf16 with f32 accumulation, and
// the shared-memory tile layout they read. Used by the bf16 forms of K3
// (flash_attention.cu) and K4 (flash_attention_bwd.cu), and of K1 and K5
// (diffnet_bf16.cuh: weight tiles of 64 k rows, or K-major tiles of N
// rows, filled by TMA in the same layout).
//
// A warpgroup is four consecutive warps (128 threads, warp % 4 == 0 first).
// wgmma.mma_async.m64nNk16 multiplies a 64 x 16 A by a 16 x N B into a
// 64 x N f32 accumulator held in registers, N / 2 a thread; B is read from
// shared memory through a descriptor, A from shared memory (mma_ss) or
// from registers (mma_rs). The products are asynchronous: fence() before a
// batch whose accumulators or A registers other instructions wrote,
// commit() after it, wait<n>() before its results are read, and
// fence_operands() on those registers after the wait, so the compiler does
// not move their reads above it.
//
// Register layouts (PTX ISA; CUTLASS's CLayout_64xN and ALayout_64x16),
// for warp w of the warpgroup and lane = 4 g + t:
//   accumulator d[4 j + e], j < N / 8: row 16 w + g + 8 (e >> 1), column
//     8 j + 2 t + (e & 1), as mma.sync.m16n8's C tiles side by side;
//   register A a[0..3], two bf16 each (the lower k in the low half): rows
//     16 w + g (a0, a2) and + 8 (a1, a3), k 2t..2t+1 (a0, a1) and 2t+8..
//     (a2, a3), as mma.sync.m16n8k16's A.
// So the accumulator tiles j = 2s and 2s + 1 of one product, rounded in
// pairs to bf16, are the A operand of k16 step s of the next (acc_to_a).
//
// Shared-memory tiles: a [64][DP] bf16 tile (DP a multiple of 32) lies in
// DP / 32 column blocks of 4096 bytes; in block c / 32, row r is the 64
// bytes at 64 r, and its 16-byte chunk (c % 32) / 8 sits at chunk
// ((c % 32) / 8) ^ ((r / 2) % 4): the 64-byte swizzle (layout type 2 of
// the descriptor, Swizzle<2,4,3> in CuTe: byte-address bits 4-5 XOR bits
// 7-8), which keeps eight rows' 16-byte chunks on distinct banks. Tile
// bases are 1024-byte aligned. That one layout serves both operand forms:
//  * K-major (the contraction dimension along a row: Q and K in Q K^T,
//    K and Q in K Q^T): the k16 step s starts at block s / 2, 32 (s % 2)
//    bytes into each row; eight-row groups are 512 bytes apart (SBO), and
//    the leading offset is unused (1, as CUTLASS writes it);
//  * MN-major (the contraction dimension down the rows, transpose bit 1,
//    legal for 16-bit types: V in P V, dO and Q in dV and dK, K in dQ): the
//    k16 step s starts at row 16 s of block 0 (byte 1024 s); eight-row
//    groups 512 bytes apart (SBO), 32-column atoms 4096 apart (LBO).
// A d that is not a multiple of 32 is zero-filled to DP in shared memory.
// Copies into a tile (cp.async or st.shared) must be followed, in the
// writing thread, by fence_proxy_async() before the barrier after which a
// wgmma reads it: wgmma reads shared memory through the async proxy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace wgmma {

constexpr int ROWS = 64;              // rows of a tile and of a warpgroup's product
constexpr int BLOCK_BYTES = 4096;     // one 32-column block of a 64-row tile

template <int DP>
struct Tile {
  static_assert(DP % 32 == 0 && DP >= 32 && DP <= 128, "DP: 32, 64, 96 or 128");
  static constexpr int BYTES = ROWS * DP * 2;
  // byte offset of the 16-byte chunk holding columns c..c+7 (c % 8 == 0) of row r
  static __device__ __forceinline__ int chunk(int r, int c) {
    return (c >> 5) * BLOCK_BYTES + r * 64 + ((((c >> 3) & 3) ^ ((r >> 1) & 3)) << 4);
  }
};

// p advanced to the next 1024-byte boundary of the shared window (dynamic
// shared memory gets 1024 bytes more than its tiles need).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (tf32x3::smem_u32(p) & 1023u)) & 1023u);
}

// Stages rows [t0, t0 + 64) of head hh of batch row b of x [B, T, H, D]
// (bf16) into the tile at dst: copied where t < T and c < D, zero up to DP
// columns and past T, so every product reads finite values. vec: D % 8 ==
// 0 and x 16-byte aligned (16-byte cp.async copies, which the caller
// commits); else element by element, synchronously.
template <int DP>
__device__ __forceinline__ void stage_tile(uint8_t* dst, const __nv_bfloat16* x, int b, int t0,
                                           int T, int H, int D, int hh, bool vec, int tid,
                                           int nthreads) {
  constexpr int CPR = DP / 8;   // 16-byte chunks a row
  const size_t rs = (size_t)H * D;
  const __nv_bfloat16* src = x + (size_t)b * T * rs + (size_t)hh * D;
  for (int e = tid; e < ROWS * CPR; e += nthreads) {
    const int r = e / CPR, c = e % CPR * 8, t = t0 + r;
    uint8_t* d = dst + Tile<DP>::chunk(r, c);
    if (vec && t < T && c < D) {
      tf32x3::cp_async16(d, src + (size_t)t * rs + c);
    } else {
      unsigned short h[8] = {};
      for (int i = 0; i < 8 && t < T && c + i < D; ++i)
        h[i] = __bfloat16_as_ushort(src[(size_t)t * rs + c + i]);
      *reinterpret_cast<uint4*>(d) =
          make_uint4(h[0] | (uint32_t)h[1] << 16, h[2] | (uint32_t)h[3] << 16,
                     h[4] | (uint32_t)h[5] << 16, h[6] | (uint32_t)h[7] << 16);
    }
  }
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), layout type 2 (64-byte swizzle).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | (uint64_t)((lbo >> 4) & 0x3fffu) << 16 |
         (uint64_t)((sbo >> 4) & 0x3fffu) << 32 | (uint64_t)2 << 62;
}

// k16 step s of a tile at shared address tile, read K-major / MN-major
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int s) {
  return desc(tile + (s >> 1) * BLOCK_BYTES + (s & 1) * 32, 16, 512);
}

// the same for a K-major tile of N rows (N a multiple of 8), whose 32-column
// blocks are block = N * 64 bytes apart
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int s, uint32_t block) {
  return desc(tile + (s >> 1) * block + (s & 1) * 32, 16, 512);
}

__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int s) {
  return desc(tile + s * 1024, BLOCK_BYTES, 512);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory writes of this thread (st.shared, cp.async landed) made
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a, b rounded to nearest into one register of a bf16 fragment (a in the
// low half)
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int R>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// k16 step s of a product's A operand from accumulator tiles 2s and 2s + 1
// of another (64 columns a step of 16), rounded to bf16.
template <int R>
__device__ __forceinline__ void acc_to_a(const float (&d)[R], int s, uint32_t (&a)[4]) {
  a[0] = pack2(d[8 * s], d[8 * s + 1]);
  a[1] = pack2(d[8 * s + 2], d[8 * s + 3]);
  a[2] = pack2(d[8 * s + 4], d[8 * s + 5]);
  a[3] = pack2(d[8 * s + 6], d[8 * s + 7]);
}

// d (+)= A B: mma_ss, A and B from shared memory (TA, TB: 0 K-major, 1
// MN-major); mma_rs, A from registers. scale_d = 0 overwrites d.

template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[48], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, %51, %52;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void mma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

}  // namespace wgmma
