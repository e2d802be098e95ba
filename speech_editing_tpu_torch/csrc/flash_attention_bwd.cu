// Non-causal softmax attention backward with key padding, float32, sm_90a.
//
// Replaces the backward of the Pallas TPU flash attention that
// speech_editing_tpu/ops/flash_attention.py (flash_mha -> _flash_bhtd)
// drives: the custom VJP of JAX's bundled
// jax/experimental/pallas/ops/tpu/flash_attention.py (_flash_attention_bwd_dkv
// and _flash_attention_bwd_dq, with di = rowsum(o * do) computed outside
// them, as the caller does here). Over [B, T, h, d], q pre-scaled
// (sm_scale = 1), with lse [B, h, Tq] the forward's per-row logsumexp:
//   p_ij  = exp(q_i . k_j - lse_i)   (0 for a pad key j, or a row with no
//                                      valid key: lse_i = -inf)
//   dv_j  = sum_i p_ij do_i
//   ds_ij = p_ij (do_i . v_j - di_i)
//   dq_i  = sum_j ds_ij k_j,   dk_j = sum_i ds_ij q_i
// Pad keys get exactly zero dk and dv; a row with no valid key gets dq = 0.
//
// Bound on the H100: at the encoder's sizes (T = 48 tokens, h = 2,
// d = 96) the work is 10*T^2*h*d = 4.4 MFLOP per batch row against
// 8*T*h*d*4 bytes: far below a microsecond either way, so launch latency
// bounds it. The design keeps to two launches, reads the [B, T, h, d]
// tensors as they are (d = 96 needs no padding), and recomputes p from lse
// instead of storing the [T, T] probabilities.
//
// Design: two kernels, one warp per "own" row, ROWS rows per block, grid
// over (row tiles, heads, batch), the structure of the forward kernel K3.
//  * dq: a warp owns query row i; K and V tiles of KT = 32 keys are staged
//    in shared memory with a row stride of d + 1 (so the lanes' dot
//    products hit distinct banks); lane l scores key l of the tile (q.k and
//    do.v), forms ds, and the warp accumulates ds_ij k_j with each lane
//    holding up to four of the d columns.
//  * dk/dv: a warp owns key row j; Q and dO tiles of 32 query rows are
//    staged likewise with their lse and di; lane l forms p and ds for query
//    l of the tile, and the warp accumulates p do and ds q.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 8;    // own rows (warps) per block
constexpr int KT = 32;     // rows of the other side per shared tile (one per lane)
constexpr int DMAX = 128;  // head width limit (four columns per lane)

__device__ inline float dot_row(const float* a, const float* b, int D) {
  float acc = 0.f;
  for (int c = 0; c < D; ++c) acc = fmaf(a[c], b[c], acc);
  return acc;
}

__global__ void attention_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    const unsigned char* __restrict__ key_pad, float* __restrict__ dq, int Tq,
    int Tk, int H, int D) {
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [KT][D + 1]
  float* v_s = k_s + KT * (D + 1);               // [KT][D + 1]
  float* q_s = v_s + KT * (D + 1);               // [ROWS][D]
  float* do_s = q_s + ROWS * D;                  // [ROWS][D]
  float* valid_s = do_s + ROWS * D;              // [KT]
  const int b = blockIdx.z, hh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + warp;
  const bool active = row < Tq;
  const size_t row_stride = (size_t)H * D;

  const size_t own = ((size_t)b * Tq + row) * row_stride + hh * D;
  for (int c = lane; c < D; c += 32) {
    q_s[warp * D + c] = active ? q[own + c] : 0.f;
    do_s[warp * D + c] = active ? dout[own + c] : 0.f;
  }
  const size_t stat = ((size_t)b * H + hh) * Tq + row;
  const float lse_i = active ? lse[stat] : -INFINITY;
  const float di_i = active ? di[stat] : 0.f;
  const bool live = lse_i != -INFINITY;  // warp-uniform
  float acc[DMAX / 32] = {0.f, 0.f, 0.f, 0.f};

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
      v_s[jj * (D + 1) + c] = vv;
    }
    for (int jj = threadIdx.x; jj < KT; jj += blockDim.x) {
      const int key = kt0 + jj;
      valid_s[jj] = (key < Tk && (key_pad == nullptr || !key_pad[(size_t)b * Tk + key])) ? 1.f : 0.f;
    }
    __syncthreads();
    if (!live) continue;

    float ds = 0.f;
    if (valid_s[lane] > 0.f) {
      const float s = dot_row(q_s + warp * D, k_s + lane * (D + 1), D);
      const float dp = dot_row(do_s + warp * D, v_s + lane * (D + 1), D);
      ds = expf(s - lse_i) * (dp - di_i);
    }
    const int n_keys = min(KT, Tk - kt0);
    for (int jj = 0; jj < n_keys; ++jj) {
      const float dsj = __shfl_sync(0xffffffffu, ds, jj);
      const float* kr = k_s + jj * (D + 1);
#pragma unroll
      for (int i = 0; i < DMAX / 32; ++i) {
        const int c = lane + 32 * i;
        if (c < D) acc[i] = fmaf(dsj, kr[c], acc[i]);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < D) dq[own + c] = acc[i];
  }
}

__global__ void attention_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    const unsigned char* __restrict__ key_pad, float* __restrict__ dk,
    float* __restrict__ dv, int Tq, int Tk, int H, int D) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [KT][D + 1]
  float* do_s = q_s + KT * (D + 1);              // [KT][D + 1]
  float* k_s = do_s + KT * (D + 1);              // [ROWS][D]
  float* v_s = k_s + ROWS * D;                   // [ROWS][D]
  float* lse_s = v_s + ROWS * D;                 // [KT]
  float* di_s = lse_s + KT;                      // [KT]
  const int b = blockIdx.z, hh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key = blockIdx.x * ROWS + warp;
  const bool active = key < Tk;
  const bool valid = active && (key_pad == nullptr || !key_pad[(size_t)b * Tk + key]);
  const size_t row_stride = (size_t)H * D;

  const size_t own = ((size_t)b * Tk + key) * row_stride + hh * D;
  for (int c = lane; c < D; c += 32) {
    k_s[warp * D + c] = active ? k[own + c] : 0.f;
    v_s[warp * D + c] = active ? v[own + c] : 0.f;
  }
  float acc_k[DMAX / 32] = {0.f, 0.f, 0.f, 0.f};
  float acc_v[DMAX / 32] = {0.f, 0.f, 0.f, 0.f};

  for (int qt0 = 0; qt0 < Tq; qt0 += KT) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < KT * D; i += blockDim.x) {
      const int ii = i / D, c = i % D, qr = qt0 + ii;
      float qv = 0.f, dv_ = 0.f;
      if (qr < Tq) {
        const size_t src = ((size_t)b * Tq + qr) * row_stride + hh * D + c;
        qv = q[src];
        dv_ = dout[src];
      }
      q_s[ii * (D + 1) + c] = qv;
      do_s[ii * (D + 1) + c] = dv_;
    }
    for (int ii = threadIdx.x; ii < KT; ii += blockDim.x) {
      const int qr = qt0 + ii;
      const size_t stat = ((size_t)b * H + hh) * Tq + qr;
      lse_s[ii] = qr < Tq ? lse[stat] : -INFINITY;
      di_s[ii] = qr < Tq ? di[stat] : 0.f;
    }
    __syncthreads();
    if (!valid) continue;  // a pad key keeps dk = dv = 0 exactly

    float p = 0.f, ds = 0.f;
    const float l = lse_s[lane];
    if (l != -INFINITY) {
      const float s = dot_row(q_s + lane * (D + 1), k_s + warp * D, D);
      const float dp = dot_row(do_s + lane * (D + 1), v_s + warp * D, D);
      p = expf(s - l);
      ds = p * (dp - di_s[lane]);
    }
    const int n_q = min(KT, Tq - qt0);
    for (int ii = 0; ii < n_q; ++ii) {
      const float pi = __shfl_sync(0xffffffffu, p, ii);
      const float dsi = __shfl_sync(0xffffffffu, ds, ii);
      const float* qr = q_s + ii * (D + 1);
      const float* dr = do_s + ii * (D + 1);
#pragma unroll
      for (int i = 0; i < DMAX / 32; ++i) {
        const int c = lane + 32 * i;
        if (c < D) {
          acc_v[i] = fmaf(pi, dr[c], acc_v[i]);
          acc_k[i] = fmaf(dsi, qr[c], acc_k[i]);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < D) {
      dk[own + c] = acc_k[i];
      dv[own + c] = acc_v[i];
    }
  }
}

}  // namespace

// q, dout, dq [B, Tq, H, D]; k, v, dk, dv [B, Tk, H, D]; lse, di [B, H, Tq];
// key_pad [B, Tk] bytes (nonzero = pad) or null. Requires D <= 128 (the
// wrapper checks).
extern "C" int attention_bwd_f32(const float* q, const float* k, const float* v,
                                 const float* dout, const float* lse,
                                 const float* di, const unsigned char* key_pad,
                                 float* dq, float* dk, float* dv, int B, int Tq,
                                 int Tk, int H, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(2 * KT * (D + 1) + 2 * ROWS * D + 2 * KT) * sizeof(float);
  attention_bwd_dq_kernel<<<dim3((Tq + ROWS - 1) / ROWS, H, B), ROWS * 32, smem, s>>>(
      q, k, v, dout, lse, di, key_pad, dq, Tq, Tk, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkv_kernel<<<dim3((Tk + ROWS - 1) / ROWS, H, B), ROWS * 32, smem, s>>>(
      q, k, v, dout, lse, di, key_pad, dk, dv, Tq, Tk, H, D);
  return (int)cudaGetLastError();
}
