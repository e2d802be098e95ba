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
// stays f32. Bound on the H100: bytes, as above, and half of them at bf16
// (5.8 MB at the train shape, 1.7 us at 3.35 TB/s; 0.25 GFLOP at 989
// TFLOP/s is 0.26 us). Design: the float32 form's CTA (4 warps, 16 query
// rows, 64 keys staged a tile with cp.async, a per-warp online softmax and
// one merge), its products one bf16 mma.sync.m16n8k16 each (bf16mma.cuh)
// where 3xTF32 takes three m16n8k8. Each warp takes 16 adjacent keys of a
// tile, so the two n8 accumulator tiles of its S are the A fragment of
// P V as they stand (rounded in pairs to bf16), and V's B fragments come
// by ldmatrix .trans. d is zero-filled to the k16 step (any d <= 128) and
// the keys to 16 a warp.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16mma.cuh"
#include "tf32x3.cuh"

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

namespace bm = bf16mma;
using bm::bf16;

constexpr int KTILE = 64;   // keys staged at a time: 16 a warp

// Q, then K and V, bf16 rows of DP + 8 (4 mod 8 words); the merge of the
// warps' partial outputs takes their place as floats (rows of DP + 4).
template <int DP>
constexpr size_t smem_bytes() {
  static_assert(NWARPS * QROWS * (DP + 4) * sizeof(float) <=
                    2 * KTILE * (DP + 8) * sizeof(bf16),
                "the merge does not fit over K and V");
  return sizeof(bf16) * (size_t)(QROWS + 2 * KTILE) * (DP + 8);
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS) attention_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const unsigned char* __restrict__ key_pad, bf16* __restrict__ out,
    float* __restrict__ lse, int Tq, int Tk, int H, int D, int vec) {
  constexpr int LD = DP + 8, NDT = DP / 8, LDM = DP + 4;
  extern __shared__ float4 smem4[];
  __shared__ float valid_s[KTILE];
  __shared__ float m_s[NWARPS][QROWS], l_s[NWARPS][QROWS], scale_s[NWARPS][QROWS];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);   // [QROWS][LD]
  bf16* k_s = q_s + QROWS * LD;                  // [KTILE][LD]
  bf16* v_s = k_s + KTILE * LD;                  // [KTILE][LD]
  float* o_s = reinterpret_cast<float*>(k_s);    // merge: [NWARPS][QROWS][LDM]

  const int b = blockIdx.z, hh = blockIdx.y, q0 = blockIdx.x * QROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  // this lane's rows g and g + 8: running max, partial sum, output tiles
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NDT][4] = {};

  bm::stage_rows<DP, LD>(q_s, q, b, q0, QROWS, Tq, H, D, hh, vec, tid, NTHREADS);
  for (int k0 = 0; k0 < Tk; k0 += KTILE) {
    const int nk16 = (min(KTILE, Tk - k0) + 15) / 16 * 16;
    if (k0 > 0) __syncthreads();   // every warp is done with the last tile
    bm::stage_rows<DP, LD>(k_s, k, b, k0, nk16, Tk, H, D, hh, vec, tid, NTHREADS);
    bm::stage_rows<DP, LD>(v_s, v, b, k0, nk16, Tk, H, D, hh, vec, tid, NTHREADS);
    cp_async_commit();
    for (int j = tid; j < nk16; j += NTHREADS) {
      const int key = k0 + j;
      valid_s[j] = key < Tk && (key_pad == nullptr || !key_pad[(size_t)b * Tk + key]);
    }
    cp_async_wait_all();
    __syncthreads();
    if (16 * warp >= nk16) continue;   // no key of this tile for this warp

    // S = Q K^T over this warp's keys 16 warp .. + 15 (two n8 tiles)
    const bf16* kw = k_s + 16 * warp * LD;
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[4], b0[2], b1[2];
      bm::load_a(q_s + kk, LD, lane, a);
      bm::load_b_nmajor(kw + kk, LD, lane, b0);
      bm::load_b_nmajor(kw + 8 * LD + kk, LD, lane, b1);
      bm::mma_bf16(s[0], a, b0);
      bm::mma_bf16(s[1], a, b1);
    }
    // online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3), in f32
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 16 * warp + 8 * u + 2 * t4 + (e & 1);
        s[u][e] = valid_s[col] > 0.f ? s[u][e] : -INFINITY;
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
    // O += P V: P's A fragment is S's two accumulator tiles, rounded to bf16
    const uint32_t pa[4] = {bm::pack2(s[0][0], s[0][1]), bm::pack2(s[0][2], s[0][3]),
                            bm::pack2(s[1][0], s[1][1]), bm::pack2(s[1][2], s[1][3])};
    const bf16* vw = v_s + 16 * warp * LD;
#pragma unroll
    for (int nt = 0; nt < NDT; nt += 2) {
      uint32_t b0[2], b1[2];
      bm::load_b_kmajor_x2(vw + nt * 8, vw + (nt + 1) * 8, LD, lane, b0, b1);
      bm::mma_bf16(o[nt], pa, b0);
      bm::mma_bf16(o[nt + 1], pa, b1);
    }
  }
  cp_async_wait_all();   // Tk = 0: the Q copies
  __syncthreads();       // K and V are no longer read: the merge takes their rows

  // merge the warps: each writes its (m, l, O) of the 16 rows
  float* ow = o_s + warp * QROWS * LDM;
#pragma unroll
  for (int nt = 0; nt < NDT; ++nt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      st2(ow + (g + 8 * hr) * LDM + nt * 8 + 2 * t4, o[nt][2 * hr], o[nt][2 * hr + 1]);
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
  // out: NTHREADS / QROWS threads a row, two columns at a time, rounded once
  constexpr int TPR = NTHREADS / QROWS;
  const int r = tid / TPR;
  if (q0 + r >= Tq) return;
  float sc[NWARPS];
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) sc[w] = scale_s[w][r];
  bf16* dst = out + ((size_t)b * Tq + q0 + r) * H * D + (size_t)hh * D;
  for (int c = tid % TPR * 2; c < D; c += TPR * 2) {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float2 x = ld2(o_s + (w * QROWS + r) * LDM + c);
      a0 += sc[w] * x.x;
      a1 += sc[w] * x.y;
    }
    if (D % 2 == 0) {
      bm::st2(dst + c, a0, a1);
    } else {
      dst[c] = __float2bfloat16_rn(a0);
      if (c + 1 < D) dst[c + 1] = __float2bfloat16_rn(a1);
    }
  }
}

template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, const unsigned char* key_pad,
           bf16* out, float* lse, int B, int Tq, int Tk, int H, int D, bool vec,
           cudaStream_t stream) {
  const dim3 grid((Tq + QROWS - 1) / QROWS, H, B);
  attention_fwd_kernel<DP><<<grid, NTHREADS, smem_bytes<DP>(), stream>>>(
      q, k, v, key_pad, out, lse, Tq, Tk, H, D, vec);
  return (int)cudaGetLastError();
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
