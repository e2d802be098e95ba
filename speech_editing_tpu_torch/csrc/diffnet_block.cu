// DiffNet gated residual block, forward, float32 and bf16, for sm_90a.
//
// Replaces the forward Pallas TPU kernel of
// speech_editing_tpu/ops/pallas/diffnet_block.py (fused_diffnet_block ->
// _fwd_call, body _fwd_kernel):
//   y     = (x + step) * mask                  mask: [B, T] nonpadding
//   h     = conv_k3_dil(y) + cond @ Wc + bd + bc
//   g     = sigmoid(h[:, :C]) * tanh(h[:, C:])
//   o     = g @ Wo + bo
//   x'    = (x + o[:, :C]) / sqrt(2),  skip = o[:, C:]
// and, when the caller passes an output for it, h [B, T, 2C] (the saved
// pre-activation the backward kernel K5, diffnet_block_bwd.cu, reads).
// Wd is [3C, 2C] (row tap*C + c_in), the layout _fwd_call receives.
//
// Bound on the H100: operations. 2*T*2C*(3C + H + C) FLOP per batch row
// (49.7 GFLOP at B=78, T=512, C=256, H=192), float32-accurate on the tensor
// cores as 3xTF32 (tf32x3.cuh) at 495 / 3 = 165 TFLOP/s: 0.301 ms.
//
// Design: one CTA of 8 warps per tile of M time rows (64 at the train
// shape, 16 at the edit's), the tile plan picked by the wrapper.
//  * Both products run on the tensor cores (tf32x3.cuh): mma.sync m16n8k8
//    TF32, each operand split into hi + lo, three products a step.
//  * The weights stream through a ring of S stages of BK rows in shared
//    memory, filled by cp.async and guarded by a "full" and an "empty"
//    mbarrier a stage, so that warps drift apart and one warp's copies
//    overlap another's products. Each weight byte is read from L2 once per
//    M rows: 1.55 GB a call at B=78.
//  * y is staged once for the rows [t0 - d, t0 + M + d) (zero outside
//    [0, T)); the k=3 conv is three accumulating products over row-shifted
//    views of that one tile (offsets 0, d, 2d) against the Wd rows of taps
//    0, 1, 2, then cond @ Wc accumulates into the same h. No im2col copy.
//  * h is computed NC gate columns at a time: gate columns n and n + C sit
//    in the same thread's accumulator fragments, so the gate is
//    register-local. h is written only when hout is non-null; g goes to
//    shared memory and the second product, g @ Wo, ends in the same
//    thread-local residual/skip epilogue.
//  * At the edit's B=1 a thread-block cluster of 2 or 4 CTAs splits the
//    gate columns: each CTA streams its share of Wd, Wc and Wo, computes its
//    share of g, then after a cluster barrier copies its peers' shares of g
//    through distributed shared memory and computes its share of x' and
//    skip. That puts 128 CTAs on the card at T=512 instead of 32.
// Nothing but x', skip and (for training) h is written to device memory.
//
// The bf16 form (diffnet_block_fwd_bf16, namespace bf16_form) computes what
// _fwd_kernel computes for bf16 inputs, and rounds where it rounds: y =
// (x + step) * mask is formed in bf16; the products take bf16 operands and
// accumulate in f32; h = conv + cond @ Wc + bf16(bd + bc) stays f32 for the
// gate and is stored as bf16; g is rounded to bf16 before the Wo product;
// x' = (x + o[:C]) / sqrt(2) is computed in f32 and stored as bf16, skip =
// o[C:] too. Bound on the H100 at the run step's batch (B=16, T=446):
// 2*B*T*2C*(3C + H + C) = 8.98 GFLOP at 989 TFLOP/s bf16, 9.1 us, against
// about 22 MB moved (x, cond, x', skip, h; 6.6 us at 3.35 TB/s):
// operations. Its design (diffnet_bf16.cuh holds the shared parts):
//  * Hopper's warpgroup products: a CTA is two consumer warpgroups on 64
//    time rows and a producer warp; every product is wgmma.m64nNk16 with A
//    from registers and B from the weight ring, each warpgroup on half of
//    an NC-column chunk (NC = 128, or 64 where the split or shared memory
//    asks for it). The pair of accumulators over gate columns n and C + n
//    keeps the gate thread-local; the epilogues gather four n8 tiles
//    through shuffles for 16-byte stores.
//  * A at a row offset: the window [t0 - d, t0 + 64 + d) of y is staged
//    once in padded rows, and each k16 step's A is one ldmatrix.x4 a warp
//    at the tap's row offset (0, d, 2d); cond's and g's rows the same way.
//  * The weights are read from L2 once a cluster: Wd, Wc and Wo stream
//    through a ring of TMA-filled, 64-byte-swizzled MN-major tiles (64 k
//    rows of NC columns, two a stage), each box multicast to a cluster of
//    up to 4 CTAs on neighbouring time tiles. At the run step's 112 tiles
//    and clusters of 4 that is 35 MB of weight reads a call, against 558 MB
//    when PR 11's 16-row tiles each streamed all of them.
//  * At small B*T (fewer than 64 tiles) the cluster instead splits the gate
//    columns, 2 or 4 ways: each CTA streams its share of the weights,
//    computes its share of g, takes its peers' shares through distributed
//    shared memory (an mbarrier each CTA arrives on remotely) and computes
//    its share of x' and skip. B=1 x T=512 runs 32 CTAs instead of 8.
// The tile plan (split or shared cluster) is the wrapper's
// (ops/cuda/diffnet_block.py::_tile_plan_bf16); NC and the ring's depth
// are this file's (fwd_plan), from the shared memory the window leaves.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "diffnet_bf16.cuh"
#include "tf32x3.cuh"

namespace cg = cooperative_groups;
using namespace tf32x3;
using bf16_form::bf16;

namespace {

// The residual channels C and conditioner hidden size H are template
// parameters, so that every stride and chunk index is a constant. with_widths
// below lists the pairs compiled: those of every shipped configuration
// (config/flagship.py, egs/*.yaml: C = 256, H = 192) and C = 128 or H = 256
// beside them.
constexpr int NTHREADS = 256;    // 8 warps
constexpr float RSQRT2 = 0.70710678118654752440f;

// A CTA computes NC gate columns at a time (h columns n and n + C): the
// warps of Tiling<M, NC> (tf32x3.cuh) tile M x NC, and each warp's
// accumulator tiles n < NW are its columns, n >= NW their + C partners. A
// ring row holds a weight row's NC columns n, NC columns C + n and 8 floats
// of padding (a row stride of 8 mod 32).
template <int NC>
__host__ __device__ constexpr int ring_ld() {
  return 2 * NC + 8;
}

// The plan of a tile of M rows: gate columns a chunk, weight rows a ring
// stage, stages, CTAs an SM.
template <int M>
struct Plan;
template <>
struct Plan<64> {
  static constexpr int NC = 128, BK = 16, S = 2, MINB = 1;
};
template <>
struct Plan<16> {
  static constexpr int NC = 64, BK = 32, S = 3, MINB = 2;
};

// The weight ring and the y window, cond and g tiles, rows padded by 8 or 4
// floats.
template <int C, int H, int M>
size_t smem_bytes(int dil) {
  using P = Plan<M>;
  const int span = dil < M ? dil : M;
  return sizeof(float) * ((size_t)P::S * P::BK * ring_ld<P::NC>() +
                          (size_t)(M + 2 * span) * (C + 4) + (size_t)M * (H + 4) +
                          (size_t)M * (C + 4));
}

template <int C, int H, int M, int NC, int BK, int S, int MINB>
__global__ void __launch_bounds__(NTHREADS, MINB) diffnet_block_kernel(
    const float* __restrict__ x, const float* __restrict__ cond,
    const float* __restrict__ step, const float* __restrict__ mask,
    const float* __restrict__ wd, const float* __restrict__ bd,
    const float* __restrict__ wc, const float* __restrict__ bc,
    const float* __restrict__ wo, const float* __restrict__ bo,
    float* __restrict__ xout, float* __restrict__ skip,
    float* __restrict__ hout, int T, int dil) {
  static_assert(C % NC == 0 && C % BK == 0 && H % BK == 0, "widths off the plan's chunks");
  using Tl = Tiling<M, NC>;
  constexpr int MW = Tl::MW, WN = Tl::WN, NW = Tl::NW, WLD = ring_ld<NC>();
  extern __shared__ float4 smem4[];
  __shared__ Ring<S, NTHREADS / 32> bars;
  const int span = min(dil, M);
  constexpr int ldy = C + 4, ldc = H + 4;            // 4 mod 32
  float* ring = reinterpret_cast<float*>(smem4);     // [S][BK][WLD]
  float* ys = ring + S * BK * WLD;                   // [M + 2 span][C + 4]
  float* cs = ys + (M + 2 * span) * ldy;             // [M][H + 4]
  float* gs = cs + M * ldc;                          // [M][C + 4]

  const int csize = gridDim.x, rank = blockIdx.x;    // cluster (csize, 1, 1)
  const int b = blockIdx.z, t0 = blockIdx.y * M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp / WN * MW * 16;              // the warp's first row
  const int col0 = warp % WN * NW * 8;               // its first gate column in a chunk
  constexpr int C2 = 2 * C, K1 = 3 * C + H;         // K of the first product
  constexpr int q1 = K1 / BK, q2 = C / BK;           // ring chunks per N-chunk
  const int cq = C / csize;                          // this CTA's gate columns
  const int n1 = cq / NC * q1, n_all = n1 + cq / NC * q2;
  const int yrows = M + 2 * span;
  constexpr int cv = C / 4, hv = H / 4;

  // chunk i -> (N-chunk, first weight row); true for the second product
  auto chunk = [&](int i, int& nc, int& k0) {
    if (i < n1) {
      nc = i / q1;
      k0 = i % q1 * BK;
      return false;
    }
    nc = (i - n1) / q2;
    k0 = (i - n1) % q2 * BK;
    return true;
  };
  // chunk i's BK weight rows from column n (null past the last chunk); its
  // stage holds columns [n, n + NC) and [C + n, C + n + NC) of each row
  auto source = [&](int i) -> const float* {
    if (i >= n_all) return nullptr;
    int nc, k0;
    const bool p2 = chunk(i, nc, k0);
    const float* w = p2 ? wo + (size_t)k0 * C2
                        : k0 < 3 * C ? wd + (size_t)k0 * C2 : wc + (size_t)(k0 - 3 * C) * C2;
    return w + rank * cq + nc * NC;
  };
  // this thread's BK / 8 16-byte copies of chunk c into its stage
  auto fill = [&](int c) {
    const float* w = source(c);
    if (w == nullptr) return;
    bars.acquire(c);
    float* dst = ring + c % S * BK * WLD;
    for (int e = tid; e < BK * NC / 2; e += NTHREADS) {
      const int r = e / (NC / 2), half = e / (NC / 4) % 2, col = e % (NC / 4) * 4;
      cp_async16(dst + r * WLD + half * NC + col, w + (size_t)r * C2 + half * C + col);
    }
    bars.commit(c);
  };

  if (tid == 0) bars.init();
  __syncthreads();

  // first group: x over the window and cond over the tile, rows outside
  // [0, T) zeroed; y = (x + step) * mask is formed in place once it lands
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = tid; e < yrows * cv; e += NTHREADS) {
    const int w = e / cv, c = e % cv * 4, t = window_time(w, t0, M, dil);
    if (t >= 0 && t < T)
      cp_async16(ys + w * ldy + c, x + ((size_t)b * T + t) * C + c);
    else
      *reinterpret_cast<float4*>(ys + w * ldy + c) = zero4;
  }
  for (int e = tid; e < M * hv; e += NTHREADS) {
    const int r = e / hv, c = e % hv * 4, t = t0 + r;
    if (t < T)
      cp_async16(cs + r * ldc + c, cond + ((size_t)b * T + t) * H + c);
    else
      *reinterpret_cast<float4*>(cs + r * ldc + c) = zero4;
  }
  cp_async_commit();
  for (int c = 0; c < S - 1; ++c) fill(c);
  cp_async_wait_all();       // the activations (the ring's copies are not in a group)
  __syncthreads();
  for (int e = tid; e < yrows * cv; e += NTHREADS) {
    const int w = e / cv, c = e % cv * 4, t = window_time(w, t0, M, dil);
    if (t < 0 || t >= T) continue;
    float4* v = reinterpret_cast<float4*>(ys + w * ldy + c);
    const float4 sv = *reinterpret_cast<const float4*>(step + (size_t)b * C + c);
    const float m = mask != nullptr ? mask[(size_t)b * T + t] : 1.f;
    *v = make_float4((v->x + sv.x) * m, (v->y + sv.y) * m, (v->z + sv.z) * m, (v->w + sv.w) * m);
  }
  __syncthreads();

  float acc[MW][2 * NW][4];
  zero(acc);
  const auto bofs = [](int n) { return n / NW * NC + n % NW * 8; };

  for (int i = 0; i < n_all; ++i) {
    if (i == n1) __syncthreads();  // g is complete
    if (i == n1 && csize > 1) {
      // every CTA of the cluster has its share of g: copy the peers' shares
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      const int qv = cq / 4;
      for (int p = 0; p < csize; ++p) {
        if (p == rank) continue;
        const float* peer = cluster.map_shared_rank(gs, p);
        for (int e = tid; e < M * qv; e += NTHREADS) {
          const int off = e / qv * ldy + p * cq + e % qv * 4;
          *reinterpret_cast<float4*>(gs + off) = *reinterpret_cast<const float4*>(peer + off);
        }
      }
      cluster.sync();        // no CTA leaves while a peer still reads its g
    }

    int nc, k0;
    const bool p2 = chunk(i, nc, k0);
    const float* a;
    int lda = ldy;
    if (p2) {
      a = gs + k0;
    } else if (k0 < 3 * C) {
      const int tap = k0 / C;
      a = ys + tap * span * ldy + (k0 - tap * C);
    } else {
      a = cs + (k0 - 3 * C);
      lda = ldc;
    }
    bars.wait(i);
    // in its last k8 step the warp's threads start chunk i + S - 1 into the
    // stage chunk i - 1 leaves
    chunk_mma<BK, Tl::SEP, true>(acc, a + row0 * lda, lda, ring + i % S * BK * WLD + col0, WLD,
                                 bofs, lane, [&](int j) {
                                   if (j == BK / 8 - 1) fill(i + S - 1);
                                 });
    bars.release(i, lane);
    if (k0 + BK != (p2 ? C : K1)) continue;

    // end of an N-chunk: thread-local epilogue over its fragment
    const int gc = rank * cq + nc * NC + col0;
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int ni = 0; ni < NW; ++ni)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = row0 + mi * 16 + (lane >> 2) + hr * 8, t = t0 + r;
          const int j = gc + ni * 8 + 2 * (lane & 3);
          // columns j, j + 1 (lo) and C + j, C + j + 1 (hi)
          const float lo0 = acc[mi][ni][2 * hr], lo1 = acc[mi][ni][2 * hr + 1];
          const float hi0 = acc[mi][NW + ni][2 * hr], hi1 = acc[mi][NW + ni][2 * hr + 1];
          if (!p2) {
            const float2 b0 = ld2(bd + j), b1 = ld2(bc + j);
            const float2 b2 = ld2(bd + C + j), b3 = ld2(bc + C + j);
            const float ha0 = lo0 + (b0.x + b1.x), ha1 = lo1 + (b0.y + b1.y);
            const float hb0 = hi0 + (b2.x + b3.x), hb1 = hi1 + (b2.y + b3.y);
            st2(gs + r * ldy + j, 1.f / (1.f + expf(-ha0)) * tanhf(hb0),
                1.f / (1.f + expf(-ha1)) * tanhf(hb1));
            if (hout != nullptr && t < T) {
              float* hrow = hout + ((size_t)b * T + t) * C2;
              st2(hrow + j, ha0, ha1);
              st2(hrow + C + j, hb0, hb1);
            }
          } else if (t < T) {
            const size_t idx = ((size_t)b * T + t) * C + j;
            const float2 xv = ld2(x + idx), o0 = ld2(bo + j), o1 = ld2(bo + C + j);
            st2(xout + idx, (xv.x + (lo0 + o0.x)) * RSQRT2, (xv.y + (lo1 + o0.y)) * RSQRT2);
            st2(skip + idx, hi0 + o1.x, hi1 + o1.y);
          }
        }
    zero(acc);
  }
}

template <int C, int H, int M>
auto kernel_of() {
  using P = Plan<M>;
  return diffnet_block_kernel<C, H, M, P::NC, P::BK, P::S, P::MINB>;
}

template <int C, int H, int M>
int launch(const float* x, const float* cond, const float* step, const float* mask,
           const float* wd, const float* bd, const float* wc, const float* bc,
           const float* wo, const float* bo, float* xout, float* skip, float* hout,
           int B, int T, int dil, int cluster, cudaStream_t stream) {
  const size_t smem = smem_bytes<C, H, M>(dil);
  auto kernel = kernel_of<C, H, M>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (T + M - 1) / M, B);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, cond, step, mask, wd, bd, wc, bc, wo, bo, xout,
                           skip, hout, T, dil);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The pairs (C, H) compiled, as ops/cuda/diffnet_block.py's WIDTHS lists
// them: f(Widths<C, H>{}) for the pair (c, h), `other` for any other.
template <int C_, int H_>
struct Widths {
  static constexpr int C = C_, H = H_;
};

template <typename F>
int with_widths(int c, int h, int other, F&& f) {
  if (c == 256 && h == 192) return f(Widths<256, 192>{});
  if (c == 128 && h == 192) return f(Widths<128, 192>{});
  if (c == 256 && h == 256) return f(Widths<256, 256>{});
  if (c == 128 && h == 256) return f(Widths<128, 256>{});
  return other;
}

// Whether the plan of m rows a tile takes this cluster at C: 64-row tiles no
// cluster; 16-row tiles 1, 2 or 4 CTAs, each with whole NC-column chunks.
template <int C>
bool plan_ok(int m, int cluster, int nc16) {
  if (m == 64) return cluster == 1;
  return m == 16 && (cluster == 1 || cluster == 2 || cluster == 4) && C / cluster % nc16 == 0;
}

}  // namespace

// -- bf16 ----------------------------------------------------------------------

namespace bf16_form {

// Shared memory beside the ring: the y window, cond and g, in rows padded
// to C + 8 and H + 8 bf16 (16 mod 128 bytes: ldmatrix's eight row reads a
// matrix fall on distinct banks at any row offset); then, in f32, the
// biases (bf16(bd + bc) and bo, 2C each) and the window's mask.
template <int C, int H>
size_t fwd_fixed(int dil) {
  const int span = dil < ROWS ? dil : ROWS;
  return sizeof(bf16) * ((size_t)(ROWS + 2 * span) * (C + 8) + (size_t)ROWS * (H + 8) +
                         (size_t)ROWS * (C + 8)) +
         sizeof(float) * (4 * C + 3 * ROWS);
}

// K1 on 64 time rows a CTA: the first product (the conv's three taps and
// cond @ Wc) NC gate columns at a time, n and C + n as a pair, into the
// gate; then g @ Wo, NC output columns at a time, x' and skip as a pair.
// Each consumer warpgroup takes half of the NC columns of both products.
// tiles: B * ceil(T / 64); a CTA past them (the padding of the last
// cluster) loads and releases its stages and writes nothing. split > 1:
// the cluster's CTAs hold one tile and C / split gate columns each, and
// exchange g; share > 1: they hold `share` neighbouring tiles and all the
// columns, and multicast the weights.
template <int C, int H, int NC>
__global__ void __launch_bounds__(NTHREADS, 1) fwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ cond, const bf16* __restrict__ step,
    const bf16* __restrict__ mask, const bf16* __restrict__ bd, const bf16* __restrict__ bc,
    const bf16* __restrict__ bo, bf16* __restrict__ xout, bf16* __restrict__ skip,
    bf16* __restrict__ hout, const __grid_constant__ CUtensorMap wd_map,
    const __grid_constant__ CUtensorMap wc_map, const __grid_constant__ CUtensorMap wo_map,
    int T, int dil, int tiles, int split, int share, int stages) {
  constexpr int K1 = 3 * C + H, ldy = C + 8, ldc = H + 8, HALF = NC / 2, NACC = HALF / 2;
  constexpr uint32_t TILE = tile_bytes(NC), STAGE = 2 * TILE;
  constexpr int ATOMS = NC / 32, q1 = K1 / BK, q2 = C / BK;
  static_assert(C % NC == 0 && C % BK == 0 && H % BK == 0, "widths off the plan");
  extern __shared__ uint8_t smem_raw[];
  __shared__ Ring ring;
  uint8_t* const ring_s = wgmma::align1024(smem_raw);
  const int span = min(dil, ROWS), yrows = ROWS + 2 * span;
  bf16* const ys = reinterpret_cast<bf16*>(ring_s + (size_t)stages * STAGE);   // [yrows][C + 8]
  bf16* const cs = ys + yrows * ldy;                                          // [64][H + 8]
  bf16* const gs = cs + ROWS * ldc;                                           // [64][C + 8]
  float* const bias_s = reinterpret_cast<float*>(gs + ROWS * ldy);            // [2C] | [2C]
  float* const mask_s = bias_s + 4 * C;                                       // [yrows]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp / 4, row0 = 16 * (warp % 4);   // this warp's half and its 16 rows
  const int crank = split > 1 ? (int)cluster_rank() : 0;
  const int tile = blockIdx.x / split, per_b = (T + ROWS - 1) / ROWS;
  const bool live = tile < tiles;
  const int b = live ? tile / per_b : 0, t0 = live ? tile % per_b * ROWS : 0;
  const int tv = live ? T : 0;      // rows at or past tv are zero and not written
  const int cq = C / split, nch = cq / NC, n1 = nch * q1, n_all = n1 + nch * q2;

  if (tid == 0) ring.init(stages, share, split - 1);
  cluster_sync();    // the barriers initialised cluster-wide before any copy or arrival

  if (warp == CONSUMERS / 32) {
    if (lane == 0)
      produce(ring, ring_s, n_all, stages, STAGE, 2 * ATOMS, share,
              [&](int i, int j, const CUtensorMap*& map, int& c0, int& c1, int& offset) {
                const bool p2 = i >= n1;
                const int nc = p2 ? (i - n1) / q2 : i / q1;
                const int k0 = (p2 ? (i - n1) % q2 : i % q1) * BK;
                map = p2 ? &wo_map : k0 < 3 * C ? &wd_map : &wc_map;
                c1 = p2 || k0 < 3 * C ? k0 : k0 - 3 * C;
                c0 = j / ATOMS * C + crank * cq + nc * NC + j % ATOMS * 32;
                offset = j / ATOMS * TILE + j % ATOMS * 4096;
              });
    __syncwarp();
    cluster_sync();
    return;
  }

  // x over the window and cond over the tile, zero outside [0, tv); the
  // biases and the window's mask in f32 (0 outside [0, tv)); then y =
  // bf16(x + step) * mask in place, rounded as the Pallas kernel's bf16
  // arithmetic rounds it, each thread on one 8-column vector (its step in
  // registers), so that no global load waits inside a loop
  for (int e = tid; e < yrows * (C / 8); e += CONSUMERS) {
    const int w = e / (C / 8), c = e % (C / 8) * 8, t = tf32x3::window_time(w, t0, ROWS, dil);
    if (t >= 0 && t < tv)
      tf32x3::cp_async16(ys + w * ldy + c, x + ((size_t)b * T + t) * C + c);
    else
      *reinterpret_cast<uint4*>(ys + w * ldy + c) = make_uint4(0, 0, 0, 0);
  }
  for (int e = tid; e < ROWS * (H / 8); e += CONSUMERS) {
    const int r = e / (H / 8), c = e % (H / 8) * 8, t = t0 + r;
    if (t < tv)
      tf32x3::cp_async16(cs + r * ldc + c, cond + ((size_t)b * T + t) * H + c);
    else
      *reinterpret_cast<uint4*>(cs + r * ldc + c) = make_uint4(0, 0, 0, 0);
  }
  tf32x3::cp_async_commit();
  for (int e = tid; e < 2 * C; e += CONSUMERS) {
    bias_s[e] = round_bf16(__bfloat162float(bd[e]) + __bfloat162float(bc[e]));
    bias_s[2 * C + e] = __bfloat162float(bo[e]);
  }
  for (int w = tid; w < yrows; w += CONSUMERS) {
    const int t = tf32x3::window_time(w, t0, ROWS, dil);
    mask_s[w] = t < 0 || t >= tv ? 0.f : mask != nullptr ? __bfloat162float(mask[(size_t)b * T + t])
                                                         : 1.f;
  }
  static_assert(CONSUMERS % (C / 8) == 0, "a thread's column vector");
  const int cv = tid % (C / 8) * 8;
  const uint4 sraw = *reinterpret_cast<const uint4*>(step + (size_t)b * C + cv);
  const bf16* sv = reinterpret_cast<const bf16*>(&sraw);
  tf32x3::cp_async_wait_all();
  consumer_sync();
  for (int w = tid / (C / 8); w < yrows; w += CONSUMERS / (C / 8)) {
    uint4 v = *reinterpret_cast<const uint4*>(ys + w * ldy + cv);
    bf16* xv = reinterpret_cast<bf16*>(&v);
    const float m = mask_s[w];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      xv[k] = __float2bfloat16_rn(
          round_bf16(__bfloat162float(xv[k]) + __bfloat162float(sv[k])) * m);
    *reinterpret_cast<uint4*>(ys + w * ldy + cv) = v;
  }
  consumer_sync();

  float lo[NACC], hi[NACC];
  // this warpgroup's columns of each tile: HALF / 32 atoms in
  const uint32_t ring_addr = smem_u32(ring_s) + wg * (HALF / 32) * 4096;
  // stage i into a: its A rows (this warp's 16) and tiles
  const auto run = [&](int i, uint32_t (&a)[4][4], bool first) {
    const bool p2 = i >= n1;
    const int k0 = (p2 ? (i - n1) % q2 : i % q1) * BK;
    const bf16* arow = gs + row0 * ldy + k0;
    int lda = ldy;
    if (!p2 && k0 < 3 * C) {
      const int tap = k0 / C;
      arow = ys + (tap * span + row0) * ldy + (k0 - tap * C);
    } else if (!p2) {
      arow = cs + row0 * ldc + (k0 - 3 * C);
      lda = ldc;
    }
    const int s = i % stages;
    tf32x3::mbar_wait(&ring.full[s], (i / stages) & 1);
    const uint32_t addr = ring_addr + s * STAGE;
    stage_mma<1>(lo, hi, a, arow, lda, addr, addr + TILE, 0, first, lane);
  };

  int i = 0;
  for (int chunk = 0; chunk < 2 * nch; ++chunk) {
    const bool p2 = chunk >= nch;
    const int nc = p2 ? chunk - nch : chunk, nk = p2 ? q2 : q1;
    if (chunk == nch) {
      consumer_sync();    // g is complete here, and the y window read
      if (split > 1) {
        // every CTA of the cluster holds its share of g: take the peers'
        // shares through distributed shared memory
        if (tid == 0) {
          asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
          for (int p = 0; p < split; ++p)
            if (p != crank) mbar_arrive_cluster<true>(&ring.peers, p);
        }
        mbar_wait_cluster(&ring.peers, 0);
        cg::cluster_group cluster = cg::this_cluster();
        for (int p = 0; p < split; ++p) {
          if (p == crank) continue;
          const bf16* peer = cluster.map_shared_rank(gs, p);
          for (int e = tid; e < ROWS * (cq / 8); e += CONSUMERS) {
            const int off = e / (cq / 8) * ldy + p * cq + e % (cq / 8) * 8;
            *reinterpret_cast<uint4*>(gs + off) = *reinterpret_cast<const uint4*>(peer + off);
          }
        }
      }
      // x (raw) over the tile into the y window's rows, for the residual of
      // x', landing while the second product runs
      for (int e = tid; e < ROWS * (C / 8); e += CONSUMERS) {
        const int r = e / (C / 8), c = e % (C / 8) * 8, t = t0 + r;
        if (t < tv) tf32x3::cp_async16(ys + r * ldy + c, x + ((size_t)b * T + t) * C + c);
      }
      tf32x3::cp_async_commit();
      consumer_sync();    // the peers' shares of g
    }
    issue_stages(ring, i, nk, stages, share, lane, run, [](int) {});
    drain(ring, i, nk, stages, share, lane);
    i += nk;
    wgmma::fence_operands(lo);
    wgmma::fence_operands(hi);
    if (chunk == nch) {
      tf32x3::cp_async_wait_all();
      consumer_sync();
    }

    // thread-local epilogue over this warpgroup's half of the chunk:
    // accumulator element 4 j + e is row row0 + lane / 4 + 8 (e / 2),
    // column 8 j + 2 (lane % 4) + e % 2; the outputs of four n8 tiles are
    // gathered for 16-byte stores
    const int col0 = crank * cq + nc * NC + wg * HALF, c8 = 8 * (lane & 3);
    if (!p2) {
#pragma unroll
      for (int m = 0; m < HALF / 32; ++m)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = row0 + (lane >> 2) + 8 * hr, t = t0 + r;
          uint32_t va[4], vb[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = 4 * m + k, jc = col0 + 8 * j + 2 * (lane & 3);
            // the biases added in bf16 (bd + bc), then into the f32 sum
            const float2 ba = *reinterpret_cast<const float2*>(bias_s + jc);
            const float2 bb = *reinterpret_cast<const float2*>(bias_s + C + jc);
            const float ha0 = lo[4 * j + 2 * hr] + ba.x, ha1 = lo[4 * j + 2 * hr + 1] + ba.y;
            const float hb0 = hi[4 * j + 2 * hr] + bb.x, hb1 = hi[4 * j + 2 * hr + 1] + bb.y;
            st2(gs + r * ldy + jc, sigmoid_fast(ha0) * tanh_fast(hb0),
                sigmoid_fast(ha1) * tanh_fast(hb1));
            va[k] = wgmma::pack2(ha0, ha1);
            vb[k] = wgmma::pack2(hb0, hb1);
          }
          const uint4 ga = quad_gather(va, lane), gb = quad_gather(vb, lane);
          if (hout != nullptr && t < tv) {
            bf16* hrow = hout + ((size_t)b * T + t) * (2 * C) + col0 + 32 * m + c8;
            *reinterpret_cast<uint4*>(hrow) = ga;
            *reinterpret_cast<uint4*>(hrow + C) = gb;
          }
        }
    } else {
#pragma unroll
      for (int m = 0; m < HALF / 32; ++m)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = row0 + (lane >> 2) + 8 * hr, t = t0 + r;
          uint32_t va[4], vb[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = 4 * m + k, jc = col0 + 8 * j + 2 * (lane & 3);
            const float2 xv = ld2(ys + r * ldy + jc);
            const float2 o0 = *reinterpret_cast<const float2*>(bias_s + 2 * C + jc);
            const float2 o1 = *reinterpret_cast<const float2*>(bias_s + 3 * C + jc);
            va[k] = wgmma::pack2((xv.x + (lo[4 * j + 2 * hr] + o0.x)) * RSQRT2,
                                 (xv.y + (lo[4 * j + 2 * hr + 1] + o0.y)) * RSQRT2);
            vb[k] = wgmma::pack2(hi[4 * j + 2 * hr] + o1.x, hi[4 * j + 2 * hr + 1] + o1.y);
          }
          const uint4 ga = quad_gather(va, lane), gb = quad_gather(vb, lane);
          if (t < tv) {
            const size_t idx = ((size_t)b * T + t) * C + col0 + 32 * m + c8;
            *reinterpret_cast<uint4*>(xout + idx) = ga;
            *reinterpret_cast<uint4*>(skip + idx) = gb;
          }
        }
    }
  }
  cluster_sync();    // no CTA leaves while a peer may still arrive on or read it
}

// The plan of a launch: NC 128 where C / split allows it and three ring
// stages fit beside the window, else NC 64; stages as many as fit (at
// least two, else 0). Kept per span and split: 16 NC + stages.
template <int C, int H>
int fwd_plan(int dil, int split) {
  static int cache[256];
  const int span = dil < ROWS ? dil : ROWS;
  return cached(cache, span * 3 + (split == 4 ? 2 : split - 1), [&] {
    const size_t fixed = fwd_fixed<C, H>(dil);
    if (C / split % 128 == 0) {
      const int s = ring_stages(fwd_kernel<C, H, 128>, fixed, 2 * tile_bytes(128));
      if (s >= 3) return 16 * 128 + s;
    }
    const int s = ring_stages(fwd_kernel<C, H, 64>, fixed, 2 * tile_bytes(64));
    return s >= 2 ? 16 * 64 + s : 0;
  });
}

template <int C, int H, int NC>
int launch_fwd(const bf16* x, const bf16* cond, const bf16* step, const bf16* mask,
               const bf16* bd, const bf16* bc, const bf16* bo, bf16* xout, bf16* skip,
               bf16* hout, const CUtensorMap* maps, int B, int T, int dil, int split, int share,
               int stages, cudaStream_t stream) {
  int tiles = B * ((T + ROWS - 1) / ROWS);
  const int grid = split > 1 ? tiles * split : (tiles + share - 1) / share * share;
  const size_t smem = 1024 + (size_t)stages * 2 * tile_bytes(NC) + fwd_fixed<C, H>(dil);
  CUtensorMap wd_map = maps[0], wc_map = maps[1], wo_map = maps[2];
  void* args[] = {&x,    &cond,   &step,   &mask,   &bd,    &bc, &bo,    &xout,
                  &skip, &hout,   &wd_map, &wc_map, &wo_map, &T, &dil,  &tiles,
                  &split, &share, &stages};
  return launch_clustered<fwd_kernel<C, H, NC>>(grid, split > share ? split : share, smem,
                                                stream, args);
}

}  // namespace bf16_form

// 1 if the plan of m rows a tile (64 or 16) fits in a block's shared memory
// on the current device at dilation dil and widths (c, h), else 0. The
// wrapper's tile plan asks this before it takes 64-row tiles.
extern "C" int diffnet_block_fwd_fits(int m, int dil, int c, int h) {
  return with_widths(c, h, 0, [&](auto w) -> int {
    constexpr int C = decltype(w)::C, H = decltype(w)::H;
    if (m == 64) return smem_bytes<C, H, 64>(dil) <= max_dynamic_smem(kernel_of<C, H, 64>());
    if (m == 16) return smem_bytes<C, H, 16>(dil) <= max_dynamic_smem(kernel_of<C, H, 16>());
    return 0;
  });
}

// 1 if the bf16 form fits in a block's shared memory at dilation dil and
// widths (c, h) with its tiles of m = 64 rows (it has no other), else 0.
extern "C" int diffnet_block_fwd_bf16_fits(int m, int dil, int c, int h) {
  if (m != 64 || dil < 1) return 0;
  return with_widths(c, h, 0, [&](auto w) -> int {
    return bf16_form::fwd_plan<decltype(w)::C, decltype(w)::H>(dil, 1) > 0;
  });
}

// x, xout, skip [B, T, C]; cond [B, T, H]; step [B, C]; mask [B, T] or null;
// hout [B, T, 2C] or null; wd [3C, 2C]; wc [H, 2C]; wo [C, 2C]; biases [2C];
// every pointer 16-byte aligned. The tile plan: m rows per CTA (64 or 16) and
// cluster CTAs splitting the gate columns (1 at 64 rows; 1, 2 or 4 at 16,
// each CTA with a multiple of 64 of them). Returns cudaErrorInvalidValue for
// widths not compiled (with_widths) or a plan it does not take, and the
// launch's error where the plan's shared memory does not fit
// (diffnet_block_fwd_fits).
extern "C" int diffnet_block_fwd_f32(const float* x, const float* cond,
                                     const float* step, const float* mask,
                                     const float* wd, const float* bd,
                                     const float* wc, const float* bc,
                                     const float* wo, const float* bo,
                                     float* xout, float* skip, float* hout,
                                     int B, int T, int c, int h, int dil,
                                     int m, int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_widths(c, h, (int)cudaErrorInvalidValue, [&](auto w) -> int {
    constexpr int C = decltype(w)::C, H = decltype(w)::H;
    if (!plan_ok<C>(m, cluster, Plan<16>::NC)) return (int)cudaErrorInvalidValue;
    return m == 64 ? launch<C, H, 64>(x, cond, step, mask, wd, bd, wc, bc, wo, bo, xout, skip,
                                      hout, B, T, dil, 1, s)
                   : launch<C, H, 16>(x, cond, step, mask, wd, bd, wc, bc, wo, bo, xout, skip,
                                      hout, B, T, dil, cluster, s);
  });
}

// The bf16 form: every tensor bf16 (mask too), the same shapes; 64-row
// tiles in clusters of `split` CTAs that divide the gate columns (1, 2 or
// 4, each CTA with a multiple of 64 of them) or of `share` CTAs on
// neighbouring tiles that share the weights (1, 2 or 4; not both above 1).
// Returns cudaErrorInvalidValue for widths not compiled or a plan it does
// not take, cudaErrorSharedObjectSymbolNotFound where the driver has no
// cuTensorMapEncodeTiled, and the launch's error otherwise.
extern "C" int diffnet_block_fwd_bf16(const bf16* x, const bf16* cond,
                                      const bf16* step, const bf16* mask,
                                      const bf16* wd, const bf16* bd,
                                      const bf16* wc, const bf16* bc,
                                      const bf16* wo, const bf16* bo,
                                      bf16* xout, bf16* skip, bf16* hout,
                                      int B, int T, int c, int h, int dil,
                                      int split, int share, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto one_of = [](int v) { return v == 1 || v == 2 || v == 4; };
  if (!one_of(split) || !one_of(share) || (split > 1 && share > 1) || dil < 1)
    return (int)cudaErrorInvalidValue;
  return with_widths(c, h, (int)cudaErrorInvalidValue, [&](auto w) -> int {
    constexpr int C = decltype(w)::C, H = decltype(w)::H;
    using namespace bf16_form;
    const int plan = fwd_plan<C, H>(dil, split);
    if (C / split % 64 != 0 || plan == 0) return (int)cudaErrorInvalidValue;
    CUtensorMap maps[3];
    int err = weight_map(&maps[0], wd, 3 * C, 2 * C, BK);
    if (err == 0) err = weight_map(&maps[1], wc, H, 2 * C, BK);
    if (err == 0) err = weight_map(&maps[2], wo, C, 2 * C, BK);
    if (err != 0) return err;
    const int stages = plan % 16;
    return plan / 16 == 128
               ? launch_fwd<C, H, 128>(x, cond, step, mask, bd, bc, bo, xout, skip, hout, maps,
                                       B, T, dil, split, share, stages, s)
               : launch_fwd<C, H, 64>(x, cond, step, mask, bd, bc, bo, xout, skip, hout, maps,
                                      B, T, dil, split, share, stages, s);
  });
}
