// DiffNet gated residual block, backward, float32 and bf16, for sm_90a.
//
// Replaces the backward Pallas TPU kernel of
// speech_editing_tpu/ops/pallas/diffnet_block.py (_bwd_call, body
// _bwd_kernel). From the forward's saved pre-activation h [B, T, 2C] and the
// output gradients dx', dskip [B, T, C]:
//   do  = [dx' / sqrt(2) | dskip]                          [T, 2C]
//   dg  = do @ Wo^T                                        [T, C]
//   s   = sigmoid(h[:, :C]),  th = tanh(h[:, C:])
//   g   = s * th                                           (for dWo)
//   dh  = [dg * th * s * (1 - s) | dg * s * (1 - th^2)]    [T, 2C]
//   dy[t] = dh[t + d] @ Wd^T[:, 0:C] + dh[t] @ Wd^T[:, C:2C]
//           + dh[t - d] @ Wd^T[:, 2C:3C]        (zero rows outside [0, T))
//   dx  = dy * mask + dx' / sqrt(2)
// The weight, bias, cond and step gradients are plain products of dh, g and
// do with the inputs, left to cuBLAS by the caller, as _vjp_bwd leaves them
// to XLA. Unlike the Pallas kernel (dilation 1, no mask) this one takes the
// [B, T] nonpadding mask of the forward (y = (x + step) * mask) and any
// dilation d, so the denoiser's default masked path trains through it.
//
// Bound on the H100: operations. 2*T*2C*C (dg) + 2*T*2C*3C (dy) = 16*T*C^2
// FLOP per batch row (41.9 GFLOP at B=78, T=512, C=256), float32-accurate
// on the tensor cores as 3xTF32 (tf32x3.cuh) at 495 / 3 = 165 TFLOP/s:
// 0.254 ms.
//
// Design: two passes, built as K1 is: one CTA of 8 warps per tile of M time
// rows (64 at the train shape, 16 at small B·T), mma.sync m16n8k8 TF32 with
// each operand split into hi + lo (tf32x3.cuh), the weights streamed through
// a ring of S cp.async stages in shared memory guarded by mbarriers and
// read from L2 once per M rows.
//  1. Row-local: do [M, 2C] is staged in shared memory; dg = do @ Wo^T
//     takes Wo in its natural [C, 2C] layout, which is the n-major
//     (".col") B operand. The epilogue reads h, does the gate backward in
//     registers and writes dh and g.
//  2. Shift-scatter: the dh rows [t0 - d, t0 + M + d) are staged once (zero
//     outside [0, T)); dy is three accumulating products over row-shifted
//     views of that tile (offsets 2d, d, 0 for taps 0, 1, 2) against Wd's
//     rows tap*C + c, again its natural [3C, 2C] layout read n-major. The
//     epilogue writes dx = dy * mask + dx' / sqrt(2). dh has to reach device
//     memory anyway (dWd and dWc read it), so the second pass replaces the
//     Pallas kernel's halo-row recompute by a re-read.
//
// The bf16 form (diffnet_block_bwd_bf16) computes what _bwd_kernel computes
// for bf16 inputs: h is read as bf16 and used in f32; do = [dx' / sqrt(2) |
// dskip] is formed in f32 and rounded to bf16 for the Wo^T product, which
// accumulates in f32 (bf16mma.cuh); dh is computed in f32 and stored as bf16,
// which the second pass's dh @ Wd^T (f32 accumulation) reads back; dx = dy *
// mask + dx' / sqrt(2) in f32, stored as bf16; g = s * th stored as bf16.
// Both weights are read n-major (one 32-bit load a fragment register). Bound
// at the run step's batch (B=16, T=446): 16*B*T*C^2 = 7.48 GFLOP (7.6 us at
// 989 TFLOP/s) against about 29 MB moved (h, dx', dskip, dx, dh, g; 8.7 us at
// 3.35 TB/s): bytes.

#include <cuda_runtime.h>

#include <type_traits>

#include "bf16mma.cuh"
#include "tf32x3.cuh"

using namespace tf32x3;
using bf16mma::bf16;

namespace {

// The residual channels C are a template parameter, so that every stride
// and chunk index is a constant; with_channels below lists those compiled
// (the shipped configurations' 256, and 128).
constexpr int NTHREADS = 256;  // 8 warps
constexpr int BK = 32;         // weight columns (the K of both products) per stage
constexpr int NC = 128;        // output columns per N-chunk
constexpr int WLD = BK + 4;    // ring row stride in floats (4 mod 32), n-major
constexpr int S = 4;           // ring stages
constexpr float RSQRT2 = 0.70710678118654752440f;

// This thread's 16-byte copies of chunk c, the NC x BK weight block at w
// (row stride ldw floats; null past the last chunk), into its ring stage.
__device__ __forceinline__ void fill(Ring<S, NTHREADS / 32>& bars, float* ring, int c,
                                     const float* w, int ldw, int tid) {
  if (w == nullptr) return;
  bars.acquire(c);
  float* dst = ring + c % S * NC * WLD;
  for (int e = tid; e < NC * BK / 4; e += NTHREADS) {
    const int r = e / (BK / 4), col = e % (BK / 4) * 4;
    cp_async16(dst + r * WLD + col, w + (size_t)r * ldw + col);
  }
  bars.commit(c);
}

template <int C, int M>
__global__ void __launch_bounds__(NTHREADS, 1) gate_bwd_kernel(
    const float* __restrict__ h, const float* __restrict__ dxout,
    const float* __restrict__ dskip, const float* __restrict__ wo,
    float* __restrict__ dh, float* __restrict__ g, int T) {
  static_assert(C % NC == 0, "channels off the N-chunks");
  using Tl = Tiling<M, NC>;
  constexpr int MW = Tl::MW, WN = Tl::WN, NW = Tl::NW;
  extern __shared__ float4 smem4[];
  __shared__ Ring<S, NTHREADS / 32> bars;
  constexpr int C2 = 2 * C, ldd = C2 + 4;           // 4 mod 32
  float* ring = reinterpret_cast<float*>(smem4);    // [S][NC][WLD]
  float* ds = ring + S * NC * WLD;                  // [M][2C + 4]
  const int b = blockIdx.y, t0 = blockIdx.x * M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp / WN * MW * 16, col0 = warp % WN * NW * 8;
  constexpr int q = C2 / BK, n_all = C / NC * q, cv = C / 4;
  // chunk i: Wo rows [nc * NC, +NC), columns [k0, k0 + BK) (null past the last)
  auto source = [&](int i) -> const float* {
    return i < n_all ? wo + (size_t)(i / q * NC) * C2 + i % q * BK : nullptr;
  };
  if (tid == 0) bars.init();
  __syncthreads();

  // first group: do = [dx' | dskip] over the tile, rows outside [0, T)
  // zeroed; dx' is scaled by 1/sqrt(2) in place once it lands
  for (int e = tid; e < 2 * M * cv; e += NTHREADS) {
    const int r = e / (2 * cv), c = e % (2 * cv) * 4, t = t0 + r;
    float* dst = ds + r * ldd + c;
    if (t >= T)
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    else if (c < C)
      cp_async16(dst, dxout + ((size_t)b * T + t) * C + c);
    else
      cp_async16(dst, dskip + ((size_t)b * T + t) * C + c - C);
  }
  cp_async_commit();
  for (int c = 0; c < S - 1; ++c) fill(bars, ring, c, source(c), C2, tid);
  cp_async_wait_all();      // the activations (the ring's copies are not in a group)
  __syncthreads();
  for (int e = tid; e < M * cv; e += NTHREADS) {
    float4* v = reinterpret_cast<float4*>(ds + e / cv * ldd + e % cv * 4);
    *v = make_float4(v->x * RSQRT2, v->y * RSQRT2, v->z * RSQRT2, v->w * RSQRT2);
  }
  __syncthreads();

  float acc[MW][NW][4];
  zero(acc);
  const auto bofs = [](int n) { return n * 8 * WLD; };
  for (int i = 0; i < n_all; ++i) {
    const int nc = i / q, k0 = i % q * BK;
    bars.wait(i);
    // in its last k8 step the warp's threads start chunk i + S - 1 into the
    // stage chunk i - 1 leaves
    chunk_mma<BK, Tl::SEP, false>(
        acc, ds + row0 * ldd + k0, ldd, ring + i % S * NC * WLD + col0 * WLD, WLD, bofs, lane,
        [&](int j) {
          if (j == BK / 8 - 1) fill(bars, ring, i + S - 1, source(i + S - 1), C2, tid);
        });
    bars.release(i, lane);
    if (k0 + BK != C2) continue;

#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int ni = 0; ni < NW; ++ni)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = t0 + row0 + mi * 16 + (lane >> 2) + hr * 8;
          if (t >= T) continue;
          const int j = nc * NC + col0 + ni * 8 + 2 * (lane & 3);
          const size_t row = (size_t)b * T + t;
          const float2 ha = ld2(h + row * C2 + j), hb = ld2(h + row * C2 + C + j);
          const float s0 = 1.f / (1.f + expf(-ha.x)), s1 = 1.f / (1.f + expf(-ha.y));
          const float th0 = tanhf(hb.x), th1 = tanhf(hb.y);
          const float dg0 = acc[mi][ni][2 * hr], dg1 = acc[mi][ni][2 * hr + 1];
          st2(g + row * C + j, s0 * th0, s1 * th1);
          st2(dh + row * C2 + j, dg0 * th0 * s0 * (1.f - s0), dg1 * th1 * s1 * (1.f - s1));
          st2(dh + row * C2 + C + j, dg0 * s0 * (1.f - th0 * th0), dg1 * s1 * (1.f - th1 * th1));
        }
    zero(acc);
  }
}

template <int C, int M>
__global__ void __launch_bounds__(NTHREADS, 1) shift_scatter_kernel(
    const float* __restrict__ dh, const float* __restrict__ dxout,
    const float* __restrict__ mask, const float* __restrict__ wd,
    float* __restrict__ dx, int T, int dil) {
  static_assert(C % NC == 0, "channels off the N-chunks");
  using Tl = Tiling<M, NC>;
  constexpr int MW = Tl::MW, WN = Tl::WN, NW = Tl::NW;
  extern __shared__ float4 smem4[];
  __shared__ Ring<S, NTHREADS / 32> bars;
  constexpr int C2 = 2 * C, ldd = C2 + 4;           // 4 mod 32
  const int span = min(dil, M);
  float* ring = reinterpret_cast<float*>(smem4);    // [S][NC][WLD]
  float* win = ring + S * NC * WLD;                 // [M + 2 span][2C + 4]
  const int b = blockIdx.y, t0 = blockIdx.x * M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp / WN * MW * 16, col0 = warp % WN * NW * 8;
  constexpr int q = C2 / BK, n_all = C / NC * 3 * q, cv = C2 / 4;
  // chunk i: N-chunk nc, tap, columns [k0, k0 + BK) of Wd rows tap*C + nc*NC + r
  auto source = [&](int i) -> const float* {
    if (i >= n_all) return nullptr;
    const int nc = i / (3 * q), tap = i % (3 * q) / q, k0 = i % q * BK;
    return wd + (size_t)(tap * C + nc * NC) * C2 + k0;
  };
  if (tid == 0) bars.init();
  __syncthreads();

  // first group: the dh window, rows outside [0, T) zeroed
  for (int e = tid; e < (M + 2 * span) * cv; e += NTHREADS) {
    const int w = e / cv, c = e % cv * 4, t = window_time(w, t0, M, dil);
    if (t >= 0 && t < T)
      cp_async16(win + w * ldd + c, dh + ((size_t)b * T + t) * C2 + c);
    else
      *reinterpret_cast<float4*>(win + w * ldd + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();
  for (int c = 0; c < S - 1; ++c) fill(bars, ring, c, source(c), C2, tid);
  cp_async_wait_all();      // the dh window (the ring's copies are not in a group)
  __syncthreads();

  float acc[MW][NW][4];
  zero(acc);
  const auto bofs = [](int n) { return n * 8 * WLD; };
  for (int i = 0; i < n_all; ++i) {
    const int nc = i / (3 * q), tap = i % (3 * q) / q, k0 = i % q * BK;
    bars.wait(i);
    // tap 0 reads dh at t + d, tap 1 at t, tap 2 at t - d
    chunk_mma<BK, Tl::SEP, false>(
        acc, win + ((2 - tap) * span + row0) * ldd + k0, ldd,
        ring + i % S * NC * WLD + col0 * WLD, WLD, bofs, lane, [&](int j) {
          if (j == BK / 8 - 1) fill(bars, ring, i + S - 1, source(i + S - 1), C2, tid);
        });
    bars.release(i, lane);
    if (i % (3 * q) != 3 * q - 1) continue;

#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int ni = 0; ni < NW; ++ni)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = t0 + row0 + mi * 16 + (lane >> 2) + hr * 8;
          if (t >= T) continue;
          const int j = nc * NC + col0 + ni * 8 + 2 * (lane & 3);
          const size_t row = (size_t)b * T + t;
          const float keep = mask != nullptr ? mask[row] : 1.f;
          const float2 r = ld2(dxout + row * C + j);
          st2(dx + row * C + j, acc[mi][ni][2 * hr] * keep + r.x * RSQRT2,
              acc[mi][ni][2 * hr + 1] * keep + r.y * RSQRT2);
        }
    zero(acc);
  }
}

// Each pass's shared memory: the weight ring and the do tile, or the dh
// window of M + 2 min(d, M) rows.
template <int C, int M>
size_t smem_gate() {
  return sizeof(float) * ((size_t)S * NC * WLD + (size_t)M * (2 * C + 4));
}

template <int C, int M>
size_t smem_scatter(int dil) {
  const int span = dil < M ? dil : M;
  return sizeof(float) * ((size_t)S * NC * WLD + (size_t)(M + 2 * span) * (2 * C + 4));
}

template <int C, int M>
bool fits(int dil) {
  return smem_gate<C, M>() <= max_dynamic_smem(gate_bwd_kernel<C, M>) &&
         smem_scatter<C, M>(dil) <= max_dynamic_smem(shift_scatter_kernel<C, M>);
}

template <int C, int M>
int launch(const float* h, const float* dxout, const float* dskip, const float* mask,
           const float* wo, const float* wd, float* dx, float* dh, float* g, int B, int T,
           int dil, cudaStream_t stream) {
  const size_t smem1 = smem_gate<C, M>(), smem2 = smem_scatter<C, M>(dil);
  const dim3 grid((T + M - 1) / M, B);
  cudaError_t err = cudaFuncSetAttribute(
      gate_bwd_kernel<C, M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  gate_bwd_kernel<C, M><<<grid, NTHREADS, smem1, stream>>>(h, dxout, dskip, wo, dh, g, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(shift_scatter_kernel<C, M>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  shift_scatter_kernel<C, M><<<grid, NTHREADS, smem2, stream>>>(dh, dxout, mask, wd, dx, T, dil);
  return (int)cudaGetLastError();
}

// -- bf16 ----------------------------------------------------------------------

// The bf16 ring: NC weight rows of BK16 k-columns a stage, rows of BK16 + 8
// bf16 (4 mod 32 words: the n-major fragment loads hit 32 banks); activation
// rows of 2C + 8 bf16.
constexpr int BK16 = 32, WLD16 = BK16 + 8;

__device__ __forceinline__ void fill_bf16(Ring<S, NTHREADS / 32>& bars, bf16* ring, int c,
                                          const bf16* w, int ldw, int tid) {
  if (w == nullptr) return;
  bars.acquire(c);
  bf16* dst = ring + c % S * NC * WLD16;
  for (int e = tid; e < NC * BK16 / 8; e += NTHREADS) {
    const int r = e / (BK16 / 8), col = e % (BK16 / 8) * 8;
    cp_async16(dst + r * WLD16 + col, w + (size_t)r * ldw + col);
  }
  bars.commit(c);
}

template <int C, int M>
__global__ void __launch_bounds__(NTHREADS, 1) gate_bwd_bf16_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ dxout,
    const bf16* __restrict__ dskip, const bf16* __restrict__ wo,
    bf16* __restrict__ dh, bf16* __restrict__ g, int T) {
  static_assert(C % NC == 0, "channels off the N-chunks");
  using Tl = Tiling<M, NC>;
  constexpr int MW = Tl::MW, WN = Tl::WN, NW = Tl::NW;
  extern __shared__ float4 smem4[];
  __shared__ Ring<S, NTHREADS / 32> bars;
  constexpr int C2 = 2 * C, ldd = C2 + 8;
  bf16* ring = reinterpret_cast<bf16*>(smem4);      // [S][NC][WLD16]
  bf16* ds = ring + S * NC * WLD16;                 // [M][2C + 8]
  const int b = blockIdx.y, t0 = blockIdx.x * M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp / WN * MW * 16, col0 = warp % WN * NW * 8;
  constexpr int q = C2 / BK16, n_all = C / NC * q, cv = C / 8;
  auto source = [&](int i) -> const bf16* {
    return i < n_all ? wo + (size_t)(i / q * NC) * C2 + i % q * BK16 : nullptr;
  };
  if (tid == 0) bars.init();
  __syncthreads();

  for (int e = tid; e < 2 * M * cv; e += NTHREADS) {
    const int r = e / (2 * cv), c = e % (2 * cv) * 8, t = t0 + r;
    bf16* dst = ds + r * ldd + c;
    if (t >= T)
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    else if (c < C)
      cp_async16(dst, dxout + ((size_t)b * T + t) * C + c);
    else
      cp_async16(dst, dskip + ((size_t)b * T + t) * C + c - C);
  }
  cp_async_commit();
  for (int c = 0; c < S - 1; ++c) fill_bf16(bars, ring, c, source(c), C2, tid);
  cp_async_wait_all();
  __syncthreads();
  // do[:, :C] = bf16(dx' * (1/sqrt(2))), the f32 product rounded once
  for (int e = tid; e < M * (C / 2); e += NTHREADS) {
    bf16* v = ds + e / (C / 2) * ldd + e % (C / 2) * 2;
    const float2 f = bf16mma::ld2(v);
    bf16mma::st2(v, f.x * RSQRT2, f.y * RSQRT2);
  }
  __syncthreads();

  float acc[MW][NW][4];
  zero(acc);
  const auto bofs = [](int n) { return n * 8 * WLD16; };
  for (int i = 0; i < n_all; ++i) {
    const int nc = i / q, k0 = i % q * BK16;
    bars.wait(i);
    bf16mma::chunk_mma<BK16, false>(
        acc, ds + row0 * ldd + k0, ldd, ring + i % S * NC * WLD16 + col0 * WLD16, WLD16, bofs,
        lane, [&](int j) {
          if (j == BK16 / 16 - 1) fill_bf16(bars, ring, i + S - 1, source(i + S - 1), C2, tid);
        });
    bars.release(i, lane);
    if (k0 + BK16 != C2) continue;

#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int ni = 0; ni < NW; ++ni)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = t0 + row0 + mi * 16 + (lane >> 2) + hr * 8;
          if (t >= T) continue;
          const int j = nc * NC + col0 + ni * 8 + 2 * (lane & 3);
          const size_t row = (size_t)b * T + t;
          const float2 ha = bf16mma::ld2(h + row * C2 + j), hb = bf16mma::ld2(h + row * C2 + C + j);
          const float s0 = 1.f / (1.f + expf(-ha.x)), s1 = 1.f / (1.f + expf(-ha.y));
          const float th0 = tanhf(hb.x), th1 = tanhf(hb.y);
          const float dg0 = acc[mi][ni][2 * hr], dg1 = acc[mi][ni][2 * hr + 1];
          bf16mma::st2(g + row * C + j, s0 * th0, s1 * th1);
          bf16mma::st2(dh + row * C2 + j, dg0 * th0 * s0 * (1.f - s0),
                       dg1 * th1 * s1 * (1.f - s1));
          bf16mma::st2(dh + row * C2 + C + j, dg0 * s0 * (1.f - th0 * th0),
                       dg1 * s1 * (1.f - th1 * th1));
        }
    zero(acc);
  }
}

template <int C, int M>
__global__ void __launch_bounds__(NTHREADS, 1) shift_scatter_bf16_kernel(
    const bf16* __restrict__ dh, const bf16* __restrict__ dxout,
    const bf16* __restrict__ mask, const bf16* __restrict__ wd,
    bf16* __restrict__ dx, int T, int dil) {
  static_assert(C % NC == 0, "channels off the N-chunks");
  using Tl = Tiling<M, NC>;
  constexpr int MW = Tl::MW, WN = Tl::WN, NW = Tl::NW;
  extern __shared__ float4 smem4[];
  __shared__ Ring<S, NTHREADS / 32> bars;
  constexpr int C2 = 2 * C, ldd = C2 + 8;
  const int span = min(dil, M);
  bf16* ring = reinterpret_cast<bf16*>(smem4);      // [S][NC][WLD16]
  bf16* win = ring + S * NC * WLD16;                // [M + 2 span][2C + 8]
  const int b = blockIdx.y, t0 = blockIdx.x * M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp / WN * MW * 16, col0 = warp % WN * NW * 8;
  constexpr int q = C2 / BK16, n_all = C / NC * 3 * q, cv = C2 / 8;
  auto source = [&](int i) -> const bf16* {
    if (i >= n_all) return nullptr;
    const int nc = i / (3 * q), tap = i % (3 * q) / q, k0 = i % q * BK16;
    return wd + (size_t)(tap * C + nc * NC) * C2 + k0;
  };
  if (tid == 0) bars.init();
  __syncthreads();

  for (int e = tid; e < (M + 2 * span) * cv; e += NTHREADS) {
    const int w = e / cv, c = e % cv * 8, t = window_time(w, t0, M, dil);
    if (t >= 0 && t < T)
      cp_async16(win + w * ldd + c, dh + ((size_t)b * T + t) * C2 + c);
    else
      *reinterpret_cast<float4*>(win + w * ldd + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();
  for (int c = 0; c < S - 1; ++c) fill_bf16(bars, ring, c, source(c), C2, tid);
  cp_async_wait_all();
  __syncthreads();

  float acc[MW][NW][4];
  zero(acc);
  const auto bofs = [](int n) { return n * 8 * WLD16; };
  for (int i = 0; i < n_all; ++i) {
    const int nc = i / (3 * q), tap = i % (3 * q) / q, k0 = i % q * BK16;
    bars.wait(i);
    bf16mma::chunk_mma<BK16, false>(
        acc, win + ((2 - tap) * span + row0) * ldd + k0, ldd,
        ring + i % S * NC * WLD16 + col0 * WLD16, WLD16, bofs, lane, [&](int j) {
          if (j == BK16 / 16 - 1) fill_bf16(bars, ring, i + S - 1, source(i + S - 1), C2, tid);
        });
    bars.release(i, lane);
    if (i % (3 * q) != 3 * q - 1) continue;

#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int ni = 0; ni < NW; ++ni)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = t0 + row0 + mi * 16 + (lane >> 2) + hr * 8;
          if (t >= T) continue;
          const int j = nc * NC + col0 + ni * 8 + 2 * (lane & 3);
          const size_t row = (size_t)b * T + t;
          const float keep = mask != nullptr ? __bfloat162float(mask[row]) : 1.f;
          const float2 r = bf16mma::ld2(dxout + row * C + j);
          bf16mma::st2(dx + row * C + j, acc[mi][ni][2 * hr] * keep + r.x * RSQRT2,
                       acc[mi][ni][2 * hr + 1] * keep + r.y * RSQRT2);
        }
    zero(acc);
  }
}

template <int C, int M>
size_t smem_gate_bf16() {
  return sizeof(bf16) * ((size_t)S * NC * WLD16 + (size_t)M * (2 * C + 8));
}

template <int C, int M>
size_t smem_scatter_bf16(int dil) {
  const int span = dil < M ? dil : M;
  return sizeof(bf16) * ((size_t)S * NC * WLD16 + (size_t)(M + 2 * span) * (2 * C + 8));
}

template <int C, int M>
bool fits_bf16(int dil) {
  return smem_gate_bf16<C, M>() <= max_dynamic_smem(gate_bwd_bf16_kernel<C, M>) &&
         smem_scatter_bf16<C, M>(dil) <= max_dynamic_smem(shift_scatter_bf16_kernel<C, M>);
}

template <int C, int M>
int launch_bf16(const bf16* h, const bf16* dxout, const bf16* dskip, const bf16* mask,
                const bf16* wo, const bf16* wd, bf16* dx, bf16* dh, bf16* g, int B, int T,
                int dil, cudaStream_t stream) {
  const size_t smem1 = smem_gate_bf16<C, M>(), smem2 = smem_scatter_bf16<C, M>(dil);
  const dim3 grid((T + M - 1) / M, B);
  cudaError_t err = cudaFuncSetAttribute(
      gate_bwd_bf16_kernel<C, M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  gate_bwd_bf16_kernel<C, M><<<grid, NTHREADS, smem1, stream>>>(h, dxout, dskip, wo, dh, g, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(shift_scatter_bf16_kernel<C, M>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  shift_scatter_bf16_kernel<C, M><<<grid, NTHREADS, smem2, stream>>>(dh, dxout, mask, wd, dx, T,
                                                                  dil);
  return (int)cudaGetLastError();
}

// The residual channels compiled, as ops/cuda/diffnet_block.py's WIDTHS
// lists them: f(std::integral_constant<int, C>{}) for c, `other` for any
// other.
template <typename F>
int with_channels(int c, int other, F&& f) {
  if (c == 256) return f(std::integral_constant<int, 256>{});
  if (c == 128) return f(std::integral_constant<int, 128>{});
  return other;
}

}  // namespace

// 1 if both passes' tiles of m rows (64 or 16) fit in a block's shared
// memory on the current device at dilation dil and c channels, else 0. The
// wrapper's tile plan asks this before it takes 64-row tiles.
extern "C" int diffnet_block_bwd_fits(int m, int dil, int c) {
  return with_channels(c, 0, [&](auto w) -> int {
    if (m == 64) return fits<decltype(w)::value, 64>(dil);
    if (m == 16) return fits<decltype(w)::value, 16>(dil);
    return 0;
  });
}

// The same for the bf16 form.
extern "C" int diffnet_block_bwd_bf16_fits(int m, int dil, int c) {
  return with_channels(c, 0, [&](auto w) -> int {
    if (m == 64) return fits_bf16<decltype(w)::value, 64>(dil);
    if (m == 16) return fits_bf16<decltype(w)::value, 16>(dil);
    return 0;
  });
}

// h, dh [B, T, 2C]; dxout, dskip, dx, g [B, T, C]; mask [B, T] or null;
// wo [C, 2C] and wd [3C, 2C] as the forward takes them; every pointer
// 16-byte aligned. m is the tile's rows (64 or 16). Returns
// cudaErrorInvalidValue for channels not compiled (with_channels) or
// another m, and the launch's error where a pass's shared memory does not
// fit (diffnet_block_bwd_fits).
extern "C" int diffnet_block_bwd_f32(const float* h, const float* dxout,
                                     const float* dskip, const float* mask,
                                     const float* wo, const float* wd,
                                     float* dx, float* dh, float* g, int B,
                                     int T, int c, int dil, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_channels(c, (int)cudaErrorInvalidValue, [&](auto w) -> int {
    constexpr int C = decltype(w)::value;
    if (m == 64) return launch<C, 64>(h, dxout, dskip, mask, wo, wd, dx, dh, g, B, T, dil, s);
    if (m == 16) return launch<C, 16>(h, dxout, dskip, mask, wo, wd, dx, dh, g, B, T, dil, s);
    return (int)cudaErrorInvalidValue;
  });
}

// The bf16 form: every tensor bf16 (mask too), the same shapes and rules as
// diffnet_block_bwd_f32 (its fit: diffnet_block_bwd_bf16_fits).
extern "C" int diffnet_block_bwd_bf16(const bf16* h, const bf16* dxout,
                                      const bf16* dskip, const bf16* mask,
                                      const bf16* wo, const bf16* wd,
                                      bf16* dx, bf16* dh, bf16* g, int B,
                                      int T, int c, int dil, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_channels(c, (int)cudaErrorInvalidValue, [&](auto w) -> int {
    constexpr int C = decltype(w)::value;
    if (m == 64)
      return launch_bf16<C, 64>(h, dxout, dskip, mask, wo, wd, dx, dh, g, B, T, dil, s);
    if (m == 16)
      return launch_bf16<C, 16>(h, dxout, dskip, mask, wo, wd, dx, dh, g, B, T, dil, s);
    return (int)cudaErrorInvalidValue;
  });
}
