// Non-causal softmax attention forward with key padding, float32, sm_90a.
//
// Replaces the Pallas TPU flash-attention forward that
// speech_editing_tpu/ops/flash_attention.py (flash_mha -> _flash_bhtd)
// drives: out = softmax(q k^T) v over [B, T, h, d], q pre-scaled
// (sm_scale = 1), pad keys excluded exactly (zero weight). A query row
// whose keys are all padding gets zeros; callers mask such rows. When the
// caller passes an output for it, each row's logsumexp over its valid keys
// ([B, h, Tq], -inf for a row with none) is written too: the softmax
// statistic the backward kernel K4 (flash_attention_bwd.cu) reads, as the
// Pallas forward saves its l and m residuals in training.
//
// Bound on the H100: bytes. At the train shape (B = 78, T = 48 tokens,
// h = 2, d = 96) the work is 4*T*h*d*sum(valid keys) = 101 MFLOP, 0.6 us at
// the 3xTF32 rate (495 / 3 = 165 TFLOP/s), against 11.5 MB of q, k, v, out
// and lse, 3.4 us at 3.35 TB/s; at the edit's B = 1 both are under 0.1 us,
// so there a launch's latency is the floor. The design reads each input
// once from device memory (K and V once from L2 for each further query
// tile), writes each output once, and spreads even B = 1 over 6 CTAs.
//
// Design: one CTA of 4 warps per (16 query rows, head, batch row).
//  * K and V are staged in shared memory with cp.async, 64 keys at a time
//    (all of them when Tk <= 64, the flagship's case), zero-filled to the
//    next 8 keys and d to the k8 step (any d <= 128), rows 4 mod 32 floats
//    apart so every fragment load hits 32 distinct banks.
//  * Both products run on the tensor cores at float32 accuracy: 3xTF32
//    mma.sync m16n8k8 (tf32x3.cuh), every operand split into TF32 hi + lo.
//  * Each warp takes two n8 key tiles of every 64-key tile (warp w: tiles
//    w and w + 4) and runs its own online softmax over them: Q K^T into
//    accumulator fragments, row max and sum with quad shuffles, p = exp(s -
//    m) in registers, and P V with P taken from those registers as the A
//    operand (the k-permuted fragment order, tf32x3.cuh), so P never
//    touches shared memory.
//  * The four warps' (m, l, O) are merged once at the end through shared
//    memory laid over the K and V tiles: m = max m_w, l = sum l_w e^(m_w -
//    m), out = sum O_w e^(m_w - m) / l.
// The attribute that lets a CTA take more than 48 KB of shared memory is
// set once per process.
//
// The bf16 form (attention_fwd_bf16) replaces the same Pallas kernel run
// on bf16 q, k, v (the JAX package's use_bf16 training: the fft text
// encoder, CampNet's decoder). It rounds where that kernel rounds
// (jax/experimental/pallas/ops/tpu/flash_attention.py, _flash_attention_kernel
// _single_batch): s = q k^T accumulated in f32 from the bf16 operands, the
// online softmax in f32, p = exp(s - m) cast to bf16 for P V with f32
// accumulation, the sum l of the f32 p; out is rounded once to bf16, lse
// stays f32. Bound on the H100: bytes at the flagship's B = 78 x S = 48
// (5.8 MB, 1.7 us at 3.35 TB/s, against 0.10 GFLOP, 0.1 us at 989 TFLOP/s);
// operations on CampNet's decoder rows (B = 16, h = 2, d = 96, T = 1536:
// 20.3 GFLOP over the valid keys, 20.5 us, against 19 MB, 5.7 us).
// Design, for Hopper's warpgroup products (wgmma.cuh):
//  * A CTA is one or two warpgroups, each owning 64 query rows across all
//    keys, so no merge between warps is needed; two (128 rows, K and V
//    staged half as often; at most 128 registers a thread, so two CTAs
//    share an SM) where Tq > 64 and that still gives a CTA for each SM.
//    Q is staged once.
//  * K and V tiles of 64 keys move through a two-stage ring by cp.async:
//    tile j + 1 copies while tile j computes, one barrier a tile. Tiles lie
//    in wgmma's 64-byte-swizzled layout; d is zero-filled to DP = 32, 64,
//    96 or 128 (32-element swizzle atoms, so d = 96 is not filled to 128).
//  * S = Q K^T: d / 16 wgmma.m64n64k16 steps, both operands K-major in
//    shared memory. The online softmax runs in f32 on the accumulator
//    (each thread holds rows g and g + 8 of its warp's 16: row max and sum
//    by quad shuffles), pad keys -inf from the tile's 64-bit valid mask,
//    p = 2^(s log2 e - m log2 e) by ex2.approx.
//  * O += P V: register-A wgmma, P's accumulator tiles rounded in pairs to
//    bf16 as they stand; V MN-major (transposed) from shared memory.
//  * A key tile with no valid key is neither staged nor computed (it adds
//    p = 0 to every row): the masks of up to 256 tiles are read at a time,
//    a warp a tile by ballots over the bool key mask, and the ring walks
//    the tiles that have a valid key. The bound counts only valid keys.
//  * Epilogue: O / l rounded once to bf16, lse = m + log l in f32 (-inf and
//    out = 0 for a row with no valid key).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bf16.cuh"
#include "tf32x3.cuh"
#include "wgmma.cuh"

using namespace tf32x3;

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int QROWS = 16;   // query rows of a CTA: one m16 tile
constexpr int KTILE = 64;   // keys staged at a time: 8 n8 tiles, two a warp

// Keys staged a tile: min(Tk, KTILE) rounded up to the n8 tile.
__host__ __device__ inline int tile_keys(int Tk) {
  const int n = Tk < KTILE ? Tk : KTILE;
  return (n + 7) / 8 * 8;
}

// Q, then K and V; the merge of the warps' partial outputs reuses the K and
// V rows, so there are at least NWARPS * QROWS of them.
template <int NDT>
size_t smem_bytes(int Tk) {
  const int kv = 2 * tile_keys(Tk) > NWARPS * QROWS ? 2 * tile_keys(Tk) : NWARPS * QROWS;
  return sizeof(float) * (size_t)(QROWS + kv) * row_ld<NDT>();
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int NDT>
__global__ void __launch_bounds__(NTHREADS) attention_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const unsigned char* __restrict__ key_pad, float* __restrict__ out,
    float* __restrict__ lse, int Tq, int Tk, int H, int D, int vec) {
  constexpr int DP = NDT * 8, LD = row_ld<NDT>();
  extern __shared__ float4 smem4[];
  __shared__ float valid_s[KTILE];
  __shared__ float m_s[NWARPS][QROWS], l_s[NWARPS][QROWS], scale_s[NWARPS][QROWS];
  float* q_s = reinterpret_cast<float*>(smem4);   // [QROWS][LD]
  float* k_s = q_s + QROWS * LD;                   // [tile_keys][LD]
  float* v_s = k_s + tile_keys(Tk) * LD;           // [tile_keys][LD]
  float* o_s = k_s;                                // merge: [NWARPS][QROWS][LD]

  const int b = blockIdx.z, hh = blockIdx.y, q0 = blockIdx.x * QROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t4 = lane & 3;

  // this lane's rows g and g + 8: running max, partial sum, output tiles
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NDT][4] = {};

  stage_rows<DP, LD>(q_s, q, b, q0, QROWS, Tq, H, D, hh, vec, tid, NTHREADS);
  for (int k0 = 0; k0 < Tk; k0 += KTILE) {
    const int nk = min(KTILE, Tk - k0), nk8 = (nk + 7) / 8 * 8;
    if (k0 > 0) __syncthreads();   // every warp is done with the last tile
    stage_rows<DP, LD>(k_s, k, b, k0, nk8, Tk, H, D, hh, vec, tid, NTHREADS);
    stage_rows<DP, LD>(v_s, v, b, k0, nk8, Tk, H, D, hh, vec, tid, NTHREADS);
    cp_async_commit();
    for (int j = tid; j < nk8; j += NTHREADS) {
      const int key = k0 + j;
      valid_s[j] = key < Tk && (key_pad == nullptr || !key_pad[(size_t)b * Tk + key]);
    }
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T over this warp's key tiles n0 = 8 (warp + 4u)
    float s[2][4], sp[2][3][4] = {};
    const bool has[2] = {8 * warp < nk8, 8 * (warp + NWARPS) < nk8};
#pragma unroll
    for (int kk = 0; kk < DP; kk += 8) {
      uint32_t ahi[4], alo[4];
      load_a(q_s + kk, LD, lane, ahi, alo);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (!has[u]) continue;
        uint32_t bhi[2], blo[2];
        load_b<false>(k_s + 8 * (warp + u * NWARPS) * LD + kk, LD, lane, bhi, blo);
        mma3_sep(sp[u], ahi, alo, bhi, blo);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) sum3(sp[u], s[u]);
    // online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * (warp + u * NWARPS) + 2 * t4 + (e & 1);
        s[u][e] = has[u] && valid_s[col] > 0.f ? s[u][e] : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[u][e]);
      }
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      mu[r] = m_new == -INFINITY ? 0.f : m_new;   // no valid key yet: p = 0
      alpha[r] = expf(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < NDT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[u][e] = expf(s[u][e] - mu[e >> 1]);
        l[e >> 1] += s[u][e];
      }
    // O += P V, P from registers
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (!has[u]) continue;
      uint32_t ahi[4], alo[4];
      a_from_acc(s[u], ahi, alo);
      const float* vt = v_s + 8 * (warp + u * NWARPS) * LD;
#pragma unroll
      for (int nt = 0; nt < NDT; ++nt) {
        uint32_t bhi[2], blo[2];
        load_b_kp(vt + nt * 8, LD, lane, bhi, blo);
        mma3(o[nt], ahi, alo, bhi, blo);
      }
    }
  }
  cp_async_wait_all();   // Tk = 0: the Q copies
  __syncthreads();       // K and V are no longer read: the merge takes their rows

  // merge the warps: each writes its (m, l, O) of the 16 rows
  const int g = lane >> 2;
  float* ow = o_s + warp * QROWS * LD;
#pragma unroll
  for (int nt = 0; nt < NDT; ++nt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      st2(ow + (g + 8 * hr) * LD + nt * 8 + 2 * t4, o[nt][2 * hr], o[nt][2 * hr + 1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    if (t4 == 0) {
      m_s[warp][g + 8 * r] = m[r];
      l_s[warp][g + 8 * r] = lr;
    }
  }
  __syncthreads();
  if (tid < QROWS) {
    float mm = -INFINITY;
    for (int w = 0; w < NWARPS; ++w) mm = fmaxf(mm, m_s[w][tid]);
    float sc[NWARPS], sum = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      sc[w] = mm == -INFINITY ? 0.f : expf(m_s[w][tid] - mm);
      sum += l_s[w][tid] * sc[w];
    }
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    for (int w = 0; w < NWARPS; ++w) scale_s[w][tid] = sc[w] * inv;
    if (lse != nullptr && q0 + tid < Tq)
      lse[((size_t)b * H + hh) * Tq + q0 + tid] = sum > 0.f ? mm + logf(sum) : -INFINITY;
  }
  __syncthreads();
  // out: NTHREADS / QROWS threads a row, four columns at a time
  constexpr int TPR = NTHREADS / QROWS;
  const int r = tid / TPR;
  if (q0 + r >= Tq) return;
  float sc[NWARPS];
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) sc[w] = scale_s[w][r];
  float* dst = out + ((size_t)b * Tq + q0 + r) * H * D + (size_t)hh * D;
  for (int c = tid % TPR * 4; c < D; c += TPR * 4) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(o_s + (w * QROWS + r) * LD + c);
      acc.x += sc[w] * x.x;
      acc.y += sc[w] * x.y;
      acc.z += sc[w] * x.z;
      acc.w += sc[w] * x.w;
    }
    if (vec) {
      *reinterpret_cast<float4*>(dst + c) = acc;
    } else {
      const float a[4] = {acc.x, acc.y, acc.z, acc.w};
      for (int j = 0; j < 4 && c + j < D; ++j) dst[c + j] = a[j];
    }
  }
}

template <int NDT>
int launch(const float* q, const float* k, const float* v, const unsigned char* key_pad,
           float* out, float* lse, int B, int Tq, int Tk, int H, int D, bool vec,
           cudaStream_t stream) {
  auto kernel = attention_fwd_kernel<NDT>;
  // once per process: room for the largest tile (64 keys)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<NDT>(KTILE));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Tq + QROWS - 1) / QROWS, H, B);
  const size_t smem = smem_bytes<NDT>(Tk);
  kernel<<<grid, NTHREADS, smem, stream>>>(q, k, v, key_pad, out, lse, Tq, Tk, H, D, vec);
  return (int)cudaGetLastError();
}


// -- the bf16 form -------------------------------------------------------------

namespace bf16_form {

using namespace attention_bf16;
using bf16 = __nv_bfloat16;
using wgmma::Tile;
using wgmma::align1024;
using wgmma::stage_tile;

constexpr int ROWS = wgmma::ROWS;   // query rows of a warpgroup; keys of a tile
constexpr int WG_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

// NWG = 2: at most 128 registers a thread, so two CTAs share an SM.
template <int DP, int NWG>
__global__ void __launch_bounds__(NWG * WG_THREADS, NWG == 2 ? 2 : 1) attention_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const unsigned char* __restrict__ key_pad, bf16* __restrict__ out,
    float* __restrict__ lse, int Tq, int Tk, int H, int D, int vec) {
  constexpr int NT = NWG * WG_THREADS, NACC = DP / 2, TB = Tile<DP>::BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t masks[MASK_TILES];
  // NWG Q tiles, then two ring stages of (K, V)
  uint8_t* const q_s = align1024(smem_raw);
  uint8_t* const kv_s = q_s + NWG * TB;

  const int b = blockIdx.z, hh = blockIdx.y, tid = threadIdx.x;
  const int wg = tid / WG_THREADS, warp = tid / 32 % 4, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * NWG * ROWS;

  for (int w = 0; w < NWG; ++w)
    stage_tile<DP>(q_s + w * TB, q, b, q0 + w * ROWS, Tq, H, D, hh, vec, tid, NT);
  cp_async_commit();
  const uint32_t q_addr = smem_u32(q_s + wg * TB);

  // this thread's rows g and g + 8 of its warp: running max, partial sum, output
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) o[i] = 0.f;

  const auto stage = [&](int j, int st) {   // K, then V, of key tile j
    uint8_t* t = kv_s + st * 2 * TB;
    stage_tile<DP>(t, k, b, j * ROWS, Tk, H, D, hh, vec, tid, NT);
    stage_tile<DP>(t + TB, v, b, j * ROWS, Tk, H, D, hh, vec, tid, NT);
    cp_async_commit();
  };
  const auto compute = [&](int st, uint64_t valid) {
    const uint32_t k_addr = smem_u32(kv_s + st * 2 * TB), v_addr = k_addr + TB;

    // S = Q K^T: DP / 16 steps, both operands K-major in shared memory
    float s[32];
    wgmma::fence_operands(s);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma::mma_ss<0, 0>(s, wgmma::desc_k(q_addr, kk), wgmma::desc_k(k_addr, kk), kk > 0);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(s);

    // online softmax of rows g (e < 2) and g + 8, in f32; pad keys -inf
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + 2 * t4 + (i & 1);
      s[i] = (valid >> col) & 1 ? s[i] : -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      mu[r] = m_new == -INFINITY ? 0.f : m_new * LOG2E;   // no valid key yet: p = 0
      alpha[r] = exp2_approx(fmaf(m[r], LOG2E, -mu[r]));
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2_approx(fmaf(s[i], LOG2E, -mu[(i >> 1) & 1]));
      l[(i >> 1) & 1] += s[i];
    }
    // O += P V: P's A operand is S's accumulator, rounded to bf16; V MN-major
    uint32_t pa[ROWS / 16][4];
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk) wgmma::acc_to_a(s, kk, pa[kk]);
    wgmma::fence_operands(pa);
    wgmma::fence_operands(o);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
      wgmma::mma_rs<1>(o, pa[kk], wgmma::desc_mn(v_addr, kk), 1);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(o);
  };
  for_live_tiles(masks, key_pad, b, Tk, stage, compute);
  cp_async_wait_all();   // no live tile: the Q copies

  // out = O / l, rounded once; lse = m + log l (-inf for a row with no valid key)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    const float inv = lr > 0.f ? 1.f / lr : 0.f;
    const int row = q0 + wg * ROWS + 16 * warp + g + 8 * r;
    if (row >= Tq) continue;
    if (lse != nullptr && t4 == 0)
      lse[((size_t)b * H + hh) * Tq + row] = lr > 0.f ? m[r] + logf(lr) : -INFINITY;
    bf16* dst = out + ((size_t)b * Tq + row) * H * D + (size_t)hh * D;
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      const int c = 8 * jj + 2 * t4;
      store2(dst, c, D, o[4 * jj + 2 * r] * inv, o[4 * jj + 2 * r + 1] * inv);
    }
  }
}

template <int DP, int NWG>
int launch_wg(const bf16* q, const bf16* k, const bf16* v, const unsigned char* key_pad,
              bf16* out, float* lse, int B, int Tq, int Tk, int H, int D, bool vec,
              cudaStream_t stream) {
  auto kernel = attention_fwd_kernel<DP, NWG>;
  constexpr int smem = 1024 + (NWG + 4) * Tile<DP>::BYTES;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Tq + NWG * ROWS - 1) / (NWG * ROWS), H, B);
  kernel<<<grid, NWG * WG_THREADS, smem, stream>>>(q, k, v, key_pad, out, lse, Tq, Tk, H, D, vec);
  return (int)cudaGetLastError();
}

// Two warpgroups a CTA (128 query rows, K and V staged half as often) where
// the second has rows and that still gives a CTA for each SM, else one.
template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, const unsigned char* key_pad,
           bf16* out, float* lse, int B, int Tq, int Tk, int H, int D, bool vec,
           cudaStream_t stream) {
  const long ctas = (long)((Tq + 2 * ROWS - 1) / (2 * ROWS)) * B * H;
  if (Tq > ROWS && ctas >= sm_count())
    return launch_wg<DP, 2>(q, k, v, key_pad, out, lse, B, Tq, Tk, H, D, vec, stream);
  return launch_wg<DP, 1>(q, k, v, key_pad, out, lse, B, Tq, Tk, H, D, vec, stream);
}

}  // namespace bf16_form

}  // namespace

// q, out [B, Tq, H, D]; k, v [B, Tk, H, D]; key_pad [B, Tk] bytes (nonzero =
// pad) or null; lse [B, H, Tq] or null. Requires 1 <= D <= 128 (the wrapper
// checks); returns cudaErrorInvalidValue otherwise.
extern "C" int attention_fwd_f32(const float* q, const float* k, const float* v,
                                 const unsigned char* key_pad, float* out,
                                 float* lse, int B, int Tq, int Tk, int H, int D,
                                 void* stream) {
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  if ((size_t)B * Tq * H == 0) return 0;
  const bool vec =
      D % 4 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch<4>(q, k, v, key_pad, out, lse, B, Tq, Tk, H, D, vec, s);
  if (D <= 64) return launch<8>(q, k, v, key_pad, out, lse, B, Tq, Tk, H, D, vec, s);
  if (D <= 96) return launch<12>(q, k, v, key_pad, out, lse, B, Tq, Tk, H, D, vec, s);
  return launch<16>(q, k, v, key_pad, out, lse, B, Tq, Tk, H, D, vec, s);
}

// The bf16 form: q, k, v, out bf16 as above; lse float32 [B, H, Tq] or null.
extern "C" int attention_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                  const __nv_bfloat16* v, const unsigned char* key_pad,
                                  __nv_bfloat16* out, float* lse, int B, int Tq, int Tk,
                                  int H, int D, void* stream) {
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  if ((size_t)B * Tq * H == 0) return 0;
  const bool vec = D % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return bf16_form::launch<32>(q, k, v, key_pad, out, lse, B, Tq, Tk, H, D, vec, s);
  if (D <= 64) return bf16_form::launch<64>(q, k, v, key_pad, out, lse, B, Tq, Tk, H, D, vec, s);
  if (D <= 96) return bf16_form::launch<96>(q, k, v, key_pad, out, lse, B, Tq, Tk, H, D, vec, s);
  return bf16_form::launch<128>(q, k, v, key_pad, out, lse, B, Tq, Tk, H, D, vec, s);
}
