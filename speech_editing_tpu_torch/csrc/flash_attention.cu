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
// Bound on the H100: at the encoder's sizes (T = 48 tokens, h = 2, d = 96)
// the work is 4*T^2*h*d = 0.9 MFLOP against 4*T*h*d*4 = 147 KB, far below
// a microsecond either way: launch latency bounds it. The design keeps it
// to one launch with no host-side padding or transposes.
//
// Design: one warp per query row, ROWS rows per block, grid over
// (query tiles, heads, batch). Key/value tiles of KT rows are staged in
// shared memory (K with a row stride of d + 1, so the lanes' dot products
// hit distinct banks); each lane scores two keys of the tile, the warp
// keeps the running max and sum of the online softmax, and each lane
// accumulates up to four of the d output columns. Inputs are read in their
// [B, T, h, d] layout as they are; T needs no padding.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 8;    // query rows (warps) per block
constexpr int KT = 64;     // keys per shared-memory tile (two per lane)
constexpr int DMAX = 128;  // head width limit (four columns per lane)

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void attention_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const unsigned char* __restrict__ key_pad,
                                 float* __restrict__ out,
                                 float* __restrict__ lse, int Tq, int Tk,
                                 int H, int D) {
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [KT][D + 1]
  float* v_s = k_s + KT * (D + 1);               // [KT][D]
  float* q_s = v_s + KT * D;                     // [ROWS][D]
  float* valid_s = q_s + ROWS * D;               // [KT]
  const int b = blockIdx.z, hh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + warp;
  const bool active = row < Tq;
  const size_t row_stride = (size_t)H * D;  // between time steps

  for (int c = lane; c < D; c += 32) {
    q_s[warp * D + c] = active ? q[((size_t)b * Tq + row) * row_stride + hh * D + c] : 0.f;
  }
  float m = -INFINITY, l = 0.f;
  float o[DMAX / 32] = {0.f, 0.f, 0.f, 0.f};

  for (int kt0 = 0; kt0 < Tk; kt0 += KT) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < KT * D; i += blockDim.x) {
      const int jj = i / D, c = i % D, key = kt0 + jj;
      float kv = 0.f, vv = 0.f;
      if (key < Tk) {
        const size_t src = ((size_t)b * Tk + key) * row_stride + hh * D + c;
        kv = k[src];
        vv = v[src];
      }
      k_s[jj * (D + 1) + c] = kv;
      v_s[jj * D + c] = vv;
    }
    for (int jj = threadIdx.x; jj < KT; jj += blockDim.x) {
      const int key = kt0 + jj;
      valid_s[jj] = (key < Tk && (key_pad == nullptr || !key_pad[(size_t)b * Tk + key])) ? 1.f : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    float s[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int jj = lane + 32 * half;
      const float* kr = k_s + jj * (D + 1);
      const float* qr = q_s + warp * D;
      float acc = 0.f;
      for (int c = 0; c < D; ++c) acc = fmaf(qr[c], kr[c], acc);
      s[half] = valid_s[jj] > 0.f ? acc : -INFINITY;
    }
    const float m_new = fmaxf(m, warp_max(fmaxf(s[0], s[1])));
    if (m_new == -INFINITY) continue;  // no valid key yet (warp-uniform)
    const float alpha = expf(m - m_new);
    const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
    l = l * alpha + warp_sum(p0 + p1);
#pragma unroll
    for (int i = 0; i < DMAX / 32; ++i) o[i] *= alpha;
    const int n_keys = min(KT, Tk - kt0);
    for (int jj = 0; jj < n_keys; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, jj < 32 ? p0 : p1, jj % 32);
      const float* vr = v_s + jj * D;
#pragma unroll
      for (int i = 0; i < DMAX / 32; ++i) {
        const int c = lane + 32 * i;
        if (c < D) o[i] = fmaf(pj, vr[c], o[i]);
      }
    }
    m = m_new;
  }
  if (!active) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  float* dst = out + ((size_t)b * Tq + row) * row_stride + hh * D;
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < D) dst[c] = o[i] * inv;
  }
  if (lse != nullptr && lane == 0) {
    lse[((size_t)b * H + hh) * Tq + row] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

}  // namespace

// q, out [B, Tq, H, D]; k, v [B, Tk, H, D]; key_pad [B, Tk] bytes (nonzero =
// pad) or null; lse [B, H, Tq] or null. Requires D <= 128 (the wrapper
// checks).
extern "C" int attention_fwd_f32(const float* q, const float* k, const float* v,
                                 const unsigned char* key_pad, float* out,
                                 float* lse, int B, int Tq, int Tk, int H, int D,
                                 void* stream) {
  const size_t smem =
      (size_t)(KT * (D + 1) + KT * D + ROWS * D + KT) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(attention_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  const dim3 grid((Tq + ROWS - 1) / ROWS, H, B);
  attention_kernel<<<grid, ROWS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, key_pad, out, lse, Tq, Tk, H, D);
  return (int)cudaGetLastError();
}
