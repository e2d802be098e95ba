// Pieces shared by the bf16 forms of K3 (flash_attention.cu) and K4
// (flash_attention_bwd.cu): which keys of a 64-key tile are valid, the walk
// over the tiles with any through a two-stage ring, 2^x, and the bf16
// stores of an accumulator's column pairs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace attention_bf16 {

// Key tiles whose masks a CTA holds at a time (16,384 keys); longer rows
// take their tiles in chunks of this many.
constexpr int MASK_TILES = 256;

// masks[i], for key tiles j = j0 + i < j0 + n: bit c set where key 64 j + c
// is below Tk and not padding (key_pad [B, Tk] bytes, nonzero = pad, or
// null). A warp a tile; the caller synchronises before reading them.
__device__ __forceinline__ void tile_masks(uint64_t* masks, const unsigned char* key_pad, int b,
                                           int Tk, int j0, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const unsigned char* row = key_pad == nullptr ? nullptr : key_pad + (size_t)b * Tk;
  for (int i = warp; i < n; i += nw) {
    const int k0 = (j0 + i) * 64 + lane, k1 = k0 + 32;
    const unsigned lo = __ballot_sync(0xffffffffu, k0 < Tk && (row == nullptr || !row[k0]));
    const unsigned hi = __ballot_sync(0xffffffffu, k1 < Tk && (row == nullptr || !row[k1]));
    if (lane == 0) masks[i] = (uint64_t)hi << 32 | lo;
  }
}

// The first tile from i on (below n) with a valid key: a tile of only pad
// keys adds p = 0 to every row, so it is neither staged nor computed.
__device__ __forceinline__ int next_live(const uint64_t* masks, int i, int n) {
  while (i < n && masks[i] == 0) ++i;
  return i;
}

// Walks the 64-key tiles of batch row b that hold a valid key, in order,
// through a two-stage ring: stage(j, s) copies tile j into ring stage s and
// commits; compute(s, valid) runs once the tile has landed in stage s and
// is visible to wgmma (valid: its bits, tile_masks'), while the next live
// tile copies into the other stage. Every thread of the CTA calls it, after committing its own earlier
// copies; one barrier a tile.
template <typename Stage, typename Compute>
__device__ __forceinline__ void for_live_tiles(uint64_t* masks, const unsigned char* key_pad,
                                               int b, int Tk, Stage stage, Compute compute) {
  const int n_tiles = (Tk + 63) / 64;
  for (int c0 = 0; c0 < n_tiles; c0 += MASK_TILES) {
    const int nc = min(MASK_TILES, n_tiles - c0);
    __syncthreads();   // the last chunk's masks and ring stages are no longer read
    tile_masks(masks, key_pad, b, Tk, c0, nc);
    __syncthreads();
    int i = next_live(masks, 0, nc), s = 0;
    if (i < nc) stage(c0 + i, 0);
    while (i < nc) {
      const int next = next_live(masks, i + 1, nc);
      tf32x3::cp_async_wait_all();
      wgmma::fence_proxy_async();
      __syncthreads();   // tile i landed; the other stage is no longer read
      if (next < nc) stage(c0 + next, s ^ 1);
      compute(s, masks[i]);
      s ^= 1;
      i = next;
    }
  }
}

// 2^x by the SFU's ex2.approx.ftz (relative error about 2^-22; 2^-inf = 0,
// a result below the normal range 0): exp2f's handling of subnormal
// results cost K4 a fifth of its time on the H100.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// row[c], row[c + 1] = a, b rounded to bf16, the columns below D.
__device__ __forceinline__ void store2(__nv_bfloat16* row, int c, int D, float a, float b) {
  if (D % 2 == 0) {
    if (c < D) *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(a, b);
  } else {
    if (c < D) row[c] = __float2bfloat16_rn(a);
    if (c + 1 < D) row[c + 1] = __float2bfloat16_rn(b);
  }
}

// The current device's SM count, read once.
inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 132;
    return sms;
  }();
  return n;
}

}  // namespace attention_bf16
