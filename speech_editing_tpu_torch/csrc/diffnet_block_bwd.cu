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
// The bf16 form (diffnet_block_bwd_bf16, namespace bf16_form) computes
// what _bwd_kernel computes for bf16 inputs: h is read as bf16 and used in
// f32; do = [dx' / sqrt(2) | dskip] is formed in f32 and rounded to bf16
// for the Wo^T product, which accumulates in f32; dh is computed in f32
// and stored as bf16, which the second pass's dh @ Wd^T (f32 accumulation)
// reads back; dx = dy * mask + dx' / sqrt(2) in f32, stored as bf16; g = s
// * th stored as bf16. Bound at the run step's batch (B=16, T=446):
// 16*B*T*C^2 = 7.48 GFLOP (7.6 us at 989 TFLOP/s) against about 30 MB moved
// (h, dx', dskip, dx, dh, g; 9.0 us at 3.35 TB/s): bytes. Its design is
// K1's bf16 form's (diffnet_bf16.cuh): two consumer warpgroups on 64 time
// rows and a producer warp a CTA, every product a wgmma with A from
// registers (ldmatrix from padded rows) and B from a ring of TMA-filled
// tiles multicast over a cluster of up to 4 CTAs on neighbouring time
// tiles. Wo^T and Wd^T are K-major operands read straight from Wo [C, 2C]
// and Wd [3C, 2C], whose k = 2C is contiguous; each pass is one pair of
// N = C/2 products, so A is loaded once. It keeps two passes: the one-pass
// alternative recomputes the d halo rows of dh a side, which with 64-row
// products is a second do @ Wo^T over a whole tile and a second stream of
// Wo (a quarter more products and weight reads), while the second pass's
// re-read of dh (1 KB a row) comes from L2, where the first pass left it;
// the one-pass form was not built or measured. The second pass stages the
// dh window [t0 - d, t0 + 64 + d) once where it leaves room for two ring
// stages (d up to 47 at C=256), else the 64 rows each tap reads before
// the tap.

#include <cuda_runtime.h>

#include <type_traits>

#include "diffnet_bf16.cuh"
#include "tf32x3.cuh"

using namespace tf32x3;
using bf16_form::bf16;

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

// -- bf16 ----------------------------------------------------------------------

namespace bf16_form {

// K5's first pass on 64 time rows a CTA: do = [dx' / sqrt(2) | dskip]
// staged in padded rows (2C + 8 bf16), dg = do @ Wo^T as one pair (output
// columns n and n + C/2) over K-major tiles of Wo's rows, each warpgroup
// half of each, the gate backward in registers, dh and g written. tiles,
// share: as K1's shared cluster.
template <int C>
__global__ void __launch_bounds__(NTHREADS, 1) gate_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ dxout, const bf16* __restrict__ dskip,
    bf16* __restrict__ dh, bf16* __restrict__ g, const __grid_constant__ CUtensorMap wo_map,
    int T, int tiles, int share, int stages) {
  constexpr int C2 = 2 * C, N = C / 2, HALF = N / 2, ldd = C2 + 8, NACC = HALF / 2;
  constexpr int n_all = C2 / BK;
  constexpr uint32_t TILE = tile_bytes(N), STAGE = 2 * TILE, KBLOCK = N * 64;
  extern __shared__ uint8_t smem_raw[];
  __shared__ Ring ring;
  uint8_t* const ring_s = wgmma::align1024(smem_raw);
  bf16* const ds = reinterpret_cast<bf16*>(ring_s + (size_t)stages * STAGE);   // [64][2C + 8]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp / 4, row0 = 16 * (warp % 4);
  const int tile = blockIdx.x, per_b = (T + ROWS - 1) / ROWS;
  const bool live = tile < tiles;
  const int b = live ? tile / per_b : 0, t0 = live ? tile % per_b * ROWS : 0;
  const int tv = live ? T : 0;

  if (tid == 0) ring.init(stages, share, 0);
  cluster_sync();
  if (warp == CONSUMERS / 32) {
    // stage i: Wo's k columns [64 i, 64 i + 64) of rows [0, N) and [N, C)
    if (lane == 0)
      produce(ring, ring_s, n_all, stages, STAGE, 4, share,
              [&](int i, int j, const CUtensorMap*& map, int& c0, int& c1, int& offset) {
                map = &wo_map;
                c0 = i * BK + j % 2 * 32;
                c1 = j / 2 * N;
                offset = j / 2 * TILE + j % 2 * KBLOCK;
              });
    __syncwarp();
    cluster_sync();
    return;
  }

  for (int e = tid; e < ROWS * (C2 / 8); e += CONSUMERS) {
    const int r = e / (C2 / 8), c = e % (C2 / 8) * 8, t = t0 + r;
    bf16* dst = ds + r * ldd + c;
    if (t >= tv)
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    else if (c < C)
      tf32x3::cp_async16(dst, dxout + ((size_t)b * T + t) * C + c);
    else
      tf32x3::cp_async16(dst, dskip + ((size_t)b * T + t) * C + c - C);
  }
  tf32x3::cp_async_commit();
  tf32x3::cp_async_wait_all();
  consumer_sync();
  // do[:, :C] = bf16(dx' * (1/sqrt(2))), the f32 product rounded once
  for (int e = tid; e < ROWS * (C / 2); e += CONSUMERS) {
    bf16* v = ds + e / (C / 2) * ldd + e % (C / 2) * 2;
    const float2 f = ld2(v);
    st2(v, f.x * RSQRT2, f.y * RSQRT2);
  }
  consumer_sync();

  float lo[NACC], hi[NACC];
  // this warpgroup's rows of each K-major tile: HALF rows in
  const uint32_t ring_addr = smem_u32(ring_s) + wg * HALF * 64;
  const auto run = [&](int i, uint32_t (&a)[4][4], bool start) {
    const int s = i % stages;
    tf32x3::mbar_wait(&ring.full[s], (i / stages) & 1);
    const uint32_t addr = ring_addr + s * STAGE;
    stage_mma<0>(lo, hi, a, ds + row0 * ldd + i * BK, ldd, addr, addr + TILE, KBLOCK, start,
                 lane);
  };
  issue_stages(ring, 0, n_all, stages, share, lane, run, [](int) {});
  // do is loaded: h over the tile takes its place, landing while the last
  // products run
  consumer_sync();
  for (int e = tid; e < ROWS * (C2 / 8); e += CONSUMERS) {
    const int r = e / (C2 / 8), c = e % (C2 / 8) * 8, t = t0 + r;
    if (t < tv) tf32x3::cp_async16(ds + r * ldd + c, h + ((size_t)b * T + t) * C2 + c);
  }
  tf32x3::cp_async_commit();
  drain(ring, 0, n_all, stages, share, lane);
  wgmma::fence_operands(lo);
  wgmma::fence_operands(hi);
  tf32x3::cp_async_wait_all();
  consumer_sync();

  // accumulator element 4 j + e: row row0 + lane / 4 + 8 (e / 2), column
  // 8 j + 2 (lane % 4) + e % 2 of this warpgroup's half of lo (or hi, N
  // columns on); the outputs of four n8 tiles gathered for 16-byte stores
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int m = 0; m < HALF / 32; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = row0 + (lane >> 2) + 8 * hr, t = t0 + r;
        const int col0 = half * N + wg * HALF;
        uint32_t vg[4], va[4], vb[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * m + k, jc = col0 + 8 * j + 2 * (lane & 3);
          const float dg0 = half ? hi[4 * j + 2 * hr] : lo[4 * j + 2 * hr];
          const float dg1 = half ? hi[4 * j + 2 * hr + 1] : lo[4 * j + 2 * hr + 1];
          const float2 ha = ld2(ds + r * ldd + jc), hb = ld2(ds + r * ldd + C + jc);
          const float s0 = sigmoid_fast(ha.x), s1 = sigmoid_fast(ha.y);
          const float th0 = tanh_fast(hb.x), th1 = tanh_fast(hb.y);
          vg[k] = wgmma::pack2(s0 * th0, s1 * th1);
          va[k] = wgmma::pack2(dg0 * th0 * s0 * (1.f - s0), dg1 * th1 * s1 * (1.f - s1));
          vb[k] = wgmma::pack2(dg0 * s0 * (1.f - th0 * th0), dg1 * s1 * (1.f - th1 * th1));
        }
        const uint4 gg = quad_gather(vg, lane), ga = quad_gather(va, lane);
        const uint4 gb = quad_gather(vb, lane);
        if (t < tv) {
          const size_t row = (size_t)b * T + t;
          const int c = col0 + 32 * m + 8 * (lane & 3);
          *reinterpret_cast<uint4*>(g + row * C + c) = gg;
          *reinterpret_cast<uint4*>(dh + row * C2 + c) = ga;
          *reinterpret_cast<uint4*>(dh + row * C2 + C + c) = gb;
        }
      }
  cluster_sync();
}

// Rows of K5's second pass's dh window: the 64 + 2 min(d, 64) rows from t0 -
// d (whole), or the 64 rows one tap reads.
__host__ __device__ inline int window_rows(int dil, bool whole) {
  return whole ? ROWS + 2 * (dil < ROWS ? dil : ROWS) : ROWS;
}

// K5's second pass on 64 time rows a CTA: dy = sum over the taps of dh at t
// + d, t, t - d (tap 0, 1, 2) @ Wd[tap C .. tap C + C)^T, one pair (output
// columns n and n + C/2) over K-major tiles of Wd's rows, each warpgroup
// half of each, A from the dh window at the tap's row offset; dx = dy *
// mask + dx' / sqrt(2). whole: the window holds every tap's rows, staged
// once; else (a dilation whose window leaves no room for two ring stages)
// the 64 rows a tap reads are staged before its first stage.
template <int C>
__global__ void __launch_bounds__(NTHREADS, 1) scatter_kernel(
    const bf16* __restrict__ dh, const bf16* __restrict__ dxout, const bf16* __restrict__ mask,
    bf16* __restrict__ dx, const __grid_constant__ CUtensorMap wd_map, int T, int dil,
    int tiles, int share, int stages, int whole) {
  constexpr int C2 = 2 * C, N = C / 2, HALF = N / 2, ldd = C2 + 8, NACC = HALF / 2;
  constexpr int q = C2 / BK, n_all = 3 * q;
  constexpr uint32_t TILE = tile_bytes(N), STAGE = 2 * TILE, KBLOCK = N * 64;
  extern __shared__ uint8_t smem_raw[];
  __shared__ Ring ring;
  uint8_t* const ring_s = wgmma::align1024(smem_raw);
  bf16* const win = reinterpret_cast<bf16*>(ring_s + (size_t)stages * STAGE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp / 4, row0 = 16 * (warp % 4);
  const int tile = blockIdx.x, per_b = (T + ROWS - 1) / ROWS;
  const bool live = tile < tiles;
  const int b = live ? tile / per_b : 0, t0 = live ? tile % per_b * ROWS : 0;
  const int tv = live ? T : 0, span = min(dil, ROWS);

  if (tid == 0) ring.init(stages, share, 0);
  cluster_sync();
  if (warp == CONSUMERS / 32) {
    // stage i: tap i / q, Wd's k columns [64 (i % q), +64) of rows tap C +
    // [0, N) and tap C + [N, C)
    if (lane == 0)
      produce(ring, ring_s, n_all, stages, STAGE, 4, share,
              [&](int i, int j, const CUtensorMap*& map, int& c0, int& c1, int& offset) {
                map = &wd_map;
                c0 = i % q * BK + j % 2 * 32;
                c1 = i / q * C + j / 2 * N;
                offset = j / 2 * TILE + j % 2 * KBLOCK;
              });
    __syncwarp();
    cluster_sync();
    return;
  }

  // the window's rows (every tap's, or tap `tap`'s), zero outside [0, tv)
  const auto stage = [&](int tap) {
    const int rows = window_rows(dil, whole);
    for (int e = tid; e < rows * (C2 / 8); e += CONSUMERS) {
      const int w = e / (C2 / 8), c = e % (C2 / 8) * 8;
      const int t = whole ? tf32x3::window_time(w, t0, ROWS, dil) : t0 + w + (1 - tap) * dil;
      if (t >= 0 && t < tv)
        tf32x3::cp_async16(win + w * ldd + c, dh + ((size_t)b * T + t) * C2 + c);
      else
        *reinterpret_cast<uint4*>(win + w * ldd + c) = make_uint4(0, 0, 0, 0);
    }
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait_all();
    consumer_sync();
  };
  stage(0);

  float keep[2];    // the mask of this thread's two epilogue rows
  for (int hr = 0; hr < 2; ++hr) {
    const int t = t0 + row0 + (lane >> 2) + 8 * hr;
    keep[hr] = t >= tv || mask == nullptr ? 1.f : __bfloat162float(mask[(size_t)b * T + t]);
  }
  float lo[NACC], hi[NACC];
  const uint32_t ring_addr = smem_u32(ring_s) + wg * HALF * 64;
  const auto run = [&](int i, uint32_t (&a)[4][4], bool start) {
    const int tap = i / q, row = (whole ? (2 - tap) * span : 0) + row0;
    const int s = i % stages;
    tf32x3::mbar_wait(&ring.full[s], (i / stages) & 1);
    const uint32_t addr = ring_addr + s * STAGE;
    stage_mma<0>(lo, hi, a, win + row * ldd + i % q * BK, ldd, addr, addr + TILE, KBLOCK,
                 start, lane);
  };
  issue_stages(ring, 0, n_all, stages, share, lane, run, [&](int i) {
    if (!whole && i > 0 && i % q == 0) {
      consumer_sync();    // the last tap's rows are loaded into registers
      stage(i / q);
    }
  });
  // the window is loaded: dx' over the tile takes its place, landing while
  // the last products run
  consumer_sync();
  for (int e = tid; e < ROWS * (C / 8); e += CONSUMERS) {
    const int r = e / (C / 8), c = e % (C / 8) * 8, t = t0 + r;
    if (t < tv) tf32x3::cp_async16(win + r * ldd + c, dxout + ((size_t)b * T + t) * C + c);
  }
  tf32x3::cp_async_commit();
  drain(ring, 0, n_all, stages, share, lane);
  wgmma::fence_operands(lo);
  wgmma::fence_operands(hi);
  tf32x3::cp_async_wait_all();
  consumer_sync();

#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int m = 0; m < HALF / 32; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = row0 + (lane >> 2) + 8 * hr, t = t0 + r;
        const int col0 = half * N + wg * HALF;
        uint32_t v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * m + k, jc = col0 + 8 * j + 2 * (lane & 3);
          const float dy0 = half ? hi[4 * j + 2 * hr] : lo[4 * j + 2 * hr];
          const float dy1 = half ? hi[4 * j + 2 * hr + 1] : lo[4 * j + 2 * hr + 1];
          const float2 res = ld2(win + r * ldd + jc);
          v[k] = wgmma::pack2(dy0 * keep[hr] + res.x * RSQRT2, dy1 * keep[hr] + res.y * RSQRT2);
        }
        const uint4 gv = quad_gather(v, lane);
        if (t < tv)
          *reinterpret_cast<uint4*>(dx + ((size_t)b * T + t) * C + col0 + 32 * m +
                                    8 * (lane & 3)) = gv;
      }
  cluster_sync();
}

// Each pass's shared memory beside its ring, and the ring's stages (0 if
// fewer than two fit). Kept per span: 16 whole + stages for the second
// pass (whole where its window leaves room for two stages).
template <int C>
size_t gate_fixed() {
  return sizeof(bf16) * (size_t)ROWS * (2 * C + 8);
}

template <int C>
int gate_stages() {
  static const int s = ring_stages(gate_kernel<C>, gate_fixed<C>(), 2 * tile_bytes(C / 2));
  return s;
}

template <int C>
size_t scatter_fixed(int dil, bool whole) {
  return sizeof(bf16) * (size_t)window_rows(dil, whole) * (2 * C + 8);
}

template <int C>
int scatter_plan(int dil) {
  static int cache[256];
  const int span = dil < ROWS ? dil : ROWS;
  return cached(cache, span, [&] {
    const size_t stage = 2 * tile_bytes(C / 2);
    const int s = ring_stages(scatter_kernel<C>, scatter_fixed<C>(dil, true), stage);
    if (s >= 2) return 16 + s;
    return ring_stages(scatter_kernel<C>, scatter_fixed<C>(dil, false), stage);
  });
}

template <int C>
int launch_bwd(const bf16* h, const bf16* dxout, const bf16* dskip, const bf16* mask,
               bf16* dx, bf16* dh, bf16* g, const CUtensorMap* maps, int B, int T, int dil,
               int share, cudaStream_t stream) {
  int tiles = B * ((T + ROWS - 1) / ROWS), gs = gate_stages<C>();
  const int plan = scatter_plan<C>(dil);
  int ss = plan % 16, whole = plan / 16;
  if (gs < 2 || ss < 2) return (int)cudaErrorInvalidValue;
  const int grid = (tiles + share - 1) / share * share;
  const size_t stage = 2 * tile_bytes(C / 2);
  CUtensorMap wo_map = maps[0], wd_map = maps[1];
  void* gate_args[] = {&h, &dxout, &dskip, &dh, &g, &wo_map, &T, &tiles, &share, &gs};
  int err = launch_clustered<gate_kernel<C>>(grid, share, 1024 + gs * stage + gate_fixed<C>(),
                                            stream, gate_args);
  if (err != 0) return err;
  const bf16* dh_in = dh;
  void* scatter_args[] = {&dh_in, &dxout, &mask, &dx, &wd_map, &T, &dil, &tiles, &share, &ss,
                          &whole};
  return launch_clustered<scatter_kernel<C>>(
      grid, share, 1024 + ss * stage + scatter_fixed<C>(dil, whole), stream, scatter_args);
}

}  // namespace bf16_form

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

// 1 if the bf16 form's passes fit in a block's shared memory at c channels
// with their tiles of m = 64 rows (the only ones it has), else 0.
extern "C" int diffnet_block_bwd_bf16_fits(int m, int dil, int c) {
  if (m != 64 || dil < 1) return 0;
  return with_channels(c, 0, [&](auto w) -> int {
    constexpr int C = decltype(w)::value;
    return bf16_form::gate_stages<C>() >= 2 && bf16_form::scatter_plan<C>(dil) % 16 >= 2;
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

// The bf16 form: every tensor bf16 (mask too), the same shapes; 64-row
// tiles in clusters of `share` CTAs (1, 2 or 4) on neighbouring tiles that
// share the weights. Returns cudaErrorInvalidValue for channels not
// compiled or another share, cudaErrorSharedObjectSymbolNotFound where the
// driver has no cuTensorMapEncodeTiled, and a launch's error otherwise.
extern "C" int diffnet_block_bwd_bf16(const bf16* h, const bf16* dxout,
                                      const bf16* dskip, const bf16* mask,
                                      const bf16* wo, const bf16* wd,
                                      bf16* dx, bf16* dh, bf16* g, int B,
                                      int T, int c, int dil, int share, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((share != 1 && share != 2 && share != 4) || dil < 1) return (int)cudaErrorInvalidValue;
  return with_channels(c, (int)cudaErrorInvalidValue, [&](auto w) -> int {
    constexpr int C = decltype(w)::value;
    using namespace bf16_form;
    CUtensorMap maps[2];
    int err = weight_map(&maps[0], wo, C, 2 * C, C / 2);
    if (err == 0) err = weight_map(&maps[1], wd, 3 * C, 2 * C, C / 2);
    if (err != 0) return err;
    return launch_bwd<C>(h, dxout, dskip, mask, dx, dh, g, maps, B, T, dil, share, s);
  });
}
