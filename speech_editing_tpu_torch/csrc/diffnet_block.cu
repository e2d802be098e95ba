// DiffNet gated residual block, forward, float32, for sm_90a.
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
// The k=3 conv is the product of the [TT, 3C] row-shifted tile with
// Wd [3C, 2C] (row tap*C + c_in), the layout _fwd_call receives.
//
// Bound on the H100: operations. A block does 2*T*2C*(3C + H + C) FLOP
// (0.64 GFLOP at B=1, T=512, C=256, H=192) against about 4.4 MB of
// activations and weights, on the float32 CUDA cores (67 TFLOP/s).
//
// Design: one block of C threads per (tile of TT time rows, batch row).
//  * The block stages its im2col tile A = [y(t-d) | y(t) | y(t+d) | cond(t)]
//    ([TT, 3C + H]) in shared memory: the halo is read straight from x, so
//    any dilation d works, and the nonpadding mask multiplies y before the
//    conv as the plain branch of modules/wavenet.py does.
//  * Thread j owns output columns j and j + C of h for all TT rows, so the
//    gate is thread-local; h stays in registers and is written only when
//    a gradient is needed (hout non-null). Each weight value read from
//    L2 feeds TT rows; each float4 of A read from shared memory (a
//    broadcast) feeds eight FMAs.
//  * g [TT, C] goes to shared memory; the second product keeps the same
//    column ownership, so the residual/skip epilogue is thread-local too.
// Nothing but x', skip and (for training) h is written to device memory.

#include <cuda_runtime.h>

namespace {

constexpr int TT = 8;  // time rows per block
constexpr float RSQRT2 = 0.70710678118654752440f;

__global__ void diffnet_block_kernel(
    const float* __restrict__ x, const float* __restrict__ cond,
    const float* __restrict__ step, const float* __restrict__ mask,
    const float* __restrict__ wd, const float* __restrict__ bd,
    const float* __restrict__ wc, const float* __restrict__ bc,
    const float* __restrict__ wo, const float* __restrict__ bo,
    float* __restrict__ xout, float* __restrict__ skip,
    float* __restrict__ hout, int T, int C, int H, int dil) {
  extern __shared__ float4 smem4[];
  const int ka = 3 * C + H;
  float* a_s = reinterpret_cast<float*>(smem4);  // [TT][3C + H]
  float* g_s = a_s + TT * ka;                    // [TT][C]
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int j = threadIdx.x;
  const int C2 = 2 * C;

  const float step_j = step[(size_t)b * C + j];
  for (int r = 0; r < TT; ++r) {
    const int t = t0 + r;
#pragma unroll
    for (int tap = 0; tap < 3; ++tap) {
      const int s = t + (tap - 1) * dil;
      float v = 0.f;
      if (t < T && s >= 0 && s < T) {
        v = x[((size_t)b * T + s) * C + j] + step_j;
        if (mask != nullptr) v *= mask[(size_t)b * T + s];
      }
      a_s[r * ka + tap * C + j] = v;
    }
    for (int c = j; c < H; c += C) {
      a_s[r * ka + 3 * C + c] = t < T ? cond[((size_t)b * T + t) * H + c] : 0.f;
    }
  }
  __syncthreads();

  float h0[TT], h1[TT];
#pragma unroll
  for (int r = 0; r < TT; ++r) h0[r] = h1[r] = 0.f;
  // h += A[:, 0:3C] @ Wd, then A[:, 3C:] @ Wc
  for (int part = 0; part < 2; ++part) {
    const float* wmat = part == 0 ? wd : wc;
    const int k_len = part == 0 ? 3 * C : H;
    const int a_off = part == 0 ? 0 : 3 * C;
    for (int k = 0; k < k_len; k += 4) {
      float w0[4], w1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w0[i] = wmat[(size_t)(k + i) * C2 + j];
        w1[i] = wmat[(size_t)(k + i) * C2 + C + j];
      }
#pragma unroll
      for (int r = 0; r < TT; ++r) {
        const float4 a4 = *reinterpret_cast<const float4*>(a_s + r * ka + a_off + k);
        const float as[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          h0[r] = fmaf(as[i], w0[i], h0[r]);
          h1[r] = fmaf(as[i], w1[i], h1[r]);
        }
      }
    }
  }
  const float bias0 = bd[j] + bc[j], bias1 = bd[C + j] + bc[C + j];
#pragma unroll
  for (int r = 0; r < TT; ++r) {
    const float ha = h0[r] + bias0, hb = h1[r] + bias1;
    g_s[r * C + j] = 1.f / (1.f + expf(-ha)) * tanhf(hb);
    if (hout != nullptr && t0 + r < T) {
      const size_t idx = ((size_t)b * T + t0 + r) * C2;
      hout[idx + j] = ha;
      hout[idx + C + j] = hb;
    }
  }
  __syncthreads();

  float o0[TT], o1[TT];
#pragma unroll
  for (int r = 0; r < TT; ++r) o0[r] = o1[r] = 0.f;
  for (int k = 0; k < C; k += 4) {
    float w0[4], w1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w0[i] = wo[(size_t)(k + i) * C2 + j];
      w1[i] = wo[(size_t)(k + i) * C2 + C + j];
    }
#pragma unroll
    for (int r = 0; r < TT; ++r) {
      const float4 g4 = *reinterpret_cast<const float4*>(g_s + r * C + k);
      const float gs[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o0[r] = fmaf(gs[i], w0[i], o0[r]);
        o1[r] = fmaf(gs[i], w1[i], o1[r]);
      }
    }
  }
  const float bo0 = bo[j], bo1 = bo[C + j];
#pragma unroll
  for (int r = 0; r < TT; ++r) {
    const int t = t0 + r;
    if (t < T) {
      const size_t idx = ((size_t)b * T + t) * C + j;
      xout[idx] = (x[idx] + (o0[r] + bo0)) * RSQRT2;
      skip[idx] = o1[r] + bo1;
    }
  }
}

}  // namespace

// x, xout, skip [B, T, C]; cond [B, T, H]; step [B, C]; mask [B, T] or null;
// hout [B, T, 2C] or null; wd [3C, 2C]; wc [H, 2C]; wo [C, 2C]; biases [2C].
// Requires C a multiple
// of 32 and at most 1024, H a multiple of 4 (the wrapper checks).
extern "C" int diffnet_block_fwd_f32(const float* x, const float* cond,
                                     const float* step, const float* mask,
                                     const float* wd, const float* bd,
                                     const float* wc, const float* bc,
                                     const float* wo, const float* bo,
                                     float* xout, float* skip, float* hout,
                                     int B, int T, int C, int H, int dil,
                                     void* stream) {
  const size_t smem = (size_t)TT * (3 * C + H + C) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(diffnet_block_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  const dim3 grid((T + TT - 1) / TT, B);
  diffnet_block_kernel<<<grid, C, smem, static_cast<cudaStream_t>(stream)>>>(
      x, cond, step, mask, wd, bd, wc, bc, wo, bo, xout, skip, hout, T, C, H, dil);
  return (int)cudaGetLastError();
}
