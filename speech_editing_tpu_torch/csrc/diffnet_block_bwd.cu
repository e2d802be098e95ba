// DiffNet gated residual block, backward, float32, for sm_90a.
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
//   dy3 = dh @ Wd^T                                        [T, 3C]
//   dy[t] = dy3[t + d, 0:C] + dy3[t, C:2C] + dy3[t - d, 2C:3C]   (zero rows
//           outside [0, T))
//   dx  = dy * mask + dx' / sqrt(2)
// The weight, bias, cond and step gradients are plain products of dh, g and
// do with the inputs, left to cuBLAS by the caller, as _vjp_bwd leaves them
// to XLA. Unlike the Pallas kernel (dilation 1, no mask) this one takes the
// [B, T] nonpadding mask of the forward (y = (x + step) * mask) and any
// dilation d, so the denoiser's default masked path trains through it.
//
// Bound on the H100: operations. 2*T*2C*C (dg) + 2*T*2C*3C (dy3) =
// 16*T*C^2 FLOP per batch row (41.9 GFLOP at B=78, T=512, C=256) against
// 4*T*7C bytes of activations, on the float32 CUDA cores (67 TFLOP/s).
//
// Design: two kernels, one block of C threads per (tile of TT time rows,
// batch row) each, as K1 is built.
//  1. Row-local: the block stages do [TT, 2C] in shared memory; thread j
//     owns column j of dg for the TT rows, reading Wo^T [2C, C] (transposed
//     by the wrapper, so a warp's loads are coalesced), then does the gate
//     backward in registers and writes dh and g.
//  2. Shift-scatter: the block stages the dh rows [t0 - d, t0 + TT + d)
//     ([TT + 2d, 2C], zero outside [0, T)) in shared memory; thread j owns
//     column j of dx and sums the three taps against Wd^T [2C, 3C]. dh has
//     to reach device memory anyway (dWd and dWc read it), so the second
//     pass replaces the Pallas kernel's halo-row recompute by a re-read.

#include <cuda_runtime.h>

namespace {

constexpr int TT = 16;  // time rows per block
constexpr float RSQRT2 = 0.70710678118654752440f;

__global__ void gate_bwd_kernel(const float* __restrict__ h,
                                const float* __restrict__ dxout,
                                const float* __restrict__ dskip,
                                const float* __restrict__ woT,
                                float* __restrict__ dh, float* __restrict__ g,
                                int T, int C) {
  extern __shared__ float4 smem4[];
  float* do_s = reinterpret_cast<float*>(smem4);  // [TT][2C]
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int j = threadIdx.x;
  const int C2 = 2 * C;

  for (int r = 0; r < TT; ++r) {
    const int t = t0 + r;
    const size_t idx = ((size_t)b * T + t) * C + j;
    do_s[r * C2 + j] = t < T ? dxout[idx] * RSQRT2 : 0.f;
    do_s[r * C2 + C + j] = t < T ? dskip[idx] : 0.f;
  }
  __syncthreads();

  float dg[TT];
#pragma unroll
  for (int r = 0; r < TT; ++r) dg[r] = 0.f;
  for (int k = 0; k < C2; k += 4) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = woT[(size_t)(k + i) * C + j];
#pragma unroll
    for (int r = 0; r < TT; ++r) {
      const float4 d4 = *reinterpret_cast<const float4*>(do_s + r * C2 + k);
      dg[r] = fmaf(d4.x, w[0], dg[r]);
      dg[r] = fmaf(d4.y, w[1], dg[r]);
      dg[r] = fmaf(d4.z, w[2], dg[r]);
      dg[r] = fmaf(d4.w, w[3], dg[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < TT; ++r) {
    const int t = t0 + r;
    if (t < T) {
      const size_t row = (size_t)b * T + t;
      const float ha = h[row * C2 + j], hb = h[row * C2 + C + j];
      const float s = 1.f / (1.f + expf(-ha));
      const float th = tanhf(hb);
      g[row * C + j] = s * th;
      dh[row * C2 + j] = dg[r] * th * s * (1.f - s);
      dh[row * C2 + C + j] = dg[r] * s * (1.f - th * th);
    }
  }
}

__global__ void shift_scatter_kernel(const float* __restrict__ dh,
                                     const float* __restrict__ dxout,
                                     const float* __restrict__ mask,
                                     const float* __restrict__ wdT,
                                     float* __restrict__ dx, int T, int C,
                                     int dil) {
  extern __shared__ float4 smem4[];
  float* win = reinterpret_cast<float*>(smem4);  // [TT + 2d][2C]
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int j = threadIdx.x;
  const int C2 = 2 * C, C3 = 3 * C;
  const int rows = TT + 2 * dil;

  // window row w holds dh at time t0 - d + w
  for (int w = 0; w < rows; ++w) {
    const int t = t0 - dil + w;
    const bool in = t >= 0 && t < T;
    const size_t src = ((size_t)b * T + t) * C2;
    win[w * C2 + j] = in ? dh[src + j] : 0.f;
    win[w * C2 + C + j] = in ? dh[src + C + j] : 0.f;
  }
  __syncthreads();

  // output row r (time t0 + r): tap 0 reads window row r + 2d (time t + d),
  // tap 1 row r + d (time t), tap 2 row r (time t - d)
  float acc[TT];
#pragma unroll
  for (int r = 0; r < TT; ++r) acc[r] = 0.f;
  for (int n = 0; n < C2; n += 4) {
    float w0[4], w1[4], w2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* wr = wdT + (size_t)(n + i) * C3;
      w0[i] = wr[j];
      w1[i] = wr[C + j];
      w2[i] = wr[2 * C + j];
    }
#pragma unroll
    for (int r = 0; r < TT; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(win + (r + 2 * dil) * C2 + n);
      const float4 m = *reinterpret_cast<const float4*>(win + (r + dil) * C2 + n);
      const float4 z = *reinterpret_cast<const float4*>(win + r * C2 + n);
      float s = acc[r];
      s = fmaf(a.x, w0[0], s); s = fmaf(a.y, w0[1], s);
      s = fmaf(a.z, w0[2], s); s = fmaf(a.w, w0[3], s);
      s = fmaf(m.x, w1[0], s); s = fmaf(m.y, w1[1], s);
      s = fmaf(m.z, w1[2], s); s = fmaf(m.w, w1[3], s);
      s = fmaf(z.x, w2[0], s); s = fmaf(z.y, w2[1], s);
      s = fmaf(z.z, w2[2], s); s = fmaf(z.w, w2[3], s);
      acc[r] = s;
    }
  }
#pragma unroll
  for (int r = 0; r < TT; ++r) {
    const int t = t0 + r;
    if (t < T) {
      const size_t row = (size_t)b * T + t;
      const float keep = mask != nullptr ? mask[row] : 1.f;
      dx[row * C + j] = acc[r] * keep + dxout[row * C + j] * RSQRT2;
    }
  }
}

}  // namespace

// h, dh [B, T, 2C]; dxout, dskip, dx, g [B, T, C]; mask [B, T] or null;
// woT [2C, C] (Wo transposed); wdT [2C, 3C] (Wd transposed). Requires C a
// multiple of 32 and at most 1024, and (TT + 2 dil) * 2C floats of shared
// memory within the card's 227 KB (the wrapper checks).
extern "C" int diffnet_block_bwd_f32(const float* h, const float* dxout,
                                     const float* dskip, const float* mask,
                                     const float* woT, const float* wdT,
                                     float* dx, float* dh, float* g, int B,
                                     int T, int C, int dil, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + TT - 1) / TT, B);
  const size_t smem1 = (size_t)TT * 2 * C * sizeof(float);
  if (smem1 > 48 * 1024) {
    cudaFuncSetAttribute(gate_bwd_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  }
  gate_bwd_kernel<<<grid, C, smem1, s>>>(h, dxout, dskip, woT, dh, g, T, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = (size_t)(TT + 2 * dil) * 2 * C * sizeof(float);
  if (smem2 > 48 * 1024) {
    cudaFuncSetAttribute(shift_scatter_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  }
  shift_scatter_kernel<<<grid, C, smem2, s>>>(dh, dxout, mask, wdT, dx, T, C, dil);
  return (int)cudaGetLastError();
}
