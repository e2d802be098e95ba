// Fused log-mel spectrogram, float32, for sm_90a.
//
// Replaces the Pallas TPU kernel speech_editing_tpu/ops/pallas/mel_kernel.py
// (mel_spectrogram_pallas, body _kernel): constant centre padding, Hann
// window folded into cos/sin DFT bases, two DFT products,
// sqrt(re^2 + im^2 + 1e-30), the slaney mel product, log10(max(eps, .)).
//
// Bound on the H100: operations. Per frame it does 2*2*n_fft*n_bins FLOP
// (2.1 MFLOP at n_fft=1024) on the float32 CUDA cores against hop*4 bytes
// of new wav, so the bases (4.2 MB, L2-resident) and the FMA rate set the
// time, not device memory.
//
// Design: one block per (tile of FT frames, batch row).
//  * The block copies the centre-padded wav segment its frames cover,
//    (FT-1)*hop + n_fft samples, into shared memory once; frame f sample n
//    is seg[f*hop + n]. Frames are read strided from that segment, so there
//    is no [T, n_fft] frame copy and no pre-shifted chunk views (the TPU
//    kernel's hop*4 == n_fft restriction is gone; any hop that is a
//    multiple of 4 and at most n_fft works).
//  * Each thread owns two DFT bins and accumulates re/im of all FT frames,
//    so every basis value read from L2 feeds FT frames, and every float4
//    of wav read from shared memory (a broadcast) feeds four bins' FMAs.
//  * The magnitude spectrum [FT, n_bins] stays in shared memory; the mel
//    product and the log run from there and only [FT, n_mels] is written.

#include <cuda_runtime.h>

namespace {

constexpr int FT = 8;  // frames per block

__host__ __device__ inline int seg_len(int hop, int n_fft) {
  return ((FT - 1) * hop + n_fft + 3) & ~3;
}

__global__ void mel_kernel(const float* __restrict__ wav,
                           const float* __restrict__ cos_w,
                           const float* __restrict__ sin_w,
                           const float* __restrict__ fb_t,
                           float* __restrict__ out, int n_wav, int n_frames,
                           int n_fft, int hop, int n_bins, int n_mels,
                           float eps) {
  extern __shared__ float4 smem4[];
  float* seg = reinterpret_cast<float*>(smem4);
  const int len = seg_len(hop, n_fft);
  float* amp = seg + len;  // [FT][n_bins]
  const int b = blockIdx.y;
  const int frame0 = blockIdx.x * FT;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  const float* w = wav + (size_t)b * n_wav;
  const int start = frame0 * hop - n_fft / 2;
  for (int i = tid; i < len; i += nthreads) {
    const int s = start + i;
    seg[i] = (s >= 0 && s < n_wav) ? w[s] : 0.f;
  }
  __syncthreads();

  const int k0 = tid, k1 = tid + nthreads;
  const bool has0 = k0 < n_bins, has1 = k1 < n_bins;
  const int kc0 = has0 ? k0 : 0, kc1 = has1 ? k1 : 0;  // clamped reads
  float re0[FT], im0[FT], re1[FT], im1[FT];
#pragma unroll
  for (int f = 0; f < FT; ++f) re0[f] = im0[f] = re1[f] = im1[f] = 0.f;

  for (int n = 0; n < n_fft; n += 4) {
    float c0[4], s0[4], c1[4], s1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t row = (size_t)(n + i) * n_bins;
      c0[i] = cos_w[row + kc0];
      s0[i] = sin_w[row + kc0];
      c1[i] = cos_w[row + kc1];
      s1[i] = sin_w[row + kc1];
    }
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      const float4 x4 = *reinterpret_cast<const float4*>(seg + f * hop + n);
      const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        re0[f] = fmaf(xs[i], c0[i], re0[f]);
        im0[f] = fmaf(xs[i], s0[i], im0[f]);
        re1[f] = fmaf(xs[i], c1[i], re1[f]);
        im1[f] = fmaf(xs[i], s1[i], im1[f]);
      }
    }
  }
#pragma unroll
  for (int f = 0; f < FT; ++f) {
    if (has0) amp[f * n_bins + k0] = sqrtf(re0[f] * re0[f] + im0[f] * im0[f] + 1e-30f);
    if (has1) amp[f * n_bins + k1] = sqrtf(re1[f] * re1[f] + im1[f] * im1[f] + 1e-30f);
  }
  __syncthreads();

  for (int o = tid; o < FT * n_mels; o += nthreads) {
    const int f = o / n_mels, m = o % n_mels;
    if (frame0 + f >= n_frames) continue;
    const float* a = amp + f * n_bins;
    float acc = 0.f;
    for (int k = 0; k < n_bins; ++k) acc = fmaf(a[k], fb_t[(size_t)k * n_mels + m], acc);
    out[((size_t)b * n_frames + frame0 + f) * n_mels + m] = log10f(fmaxf(eps, acc));
  }
}

}  // namespace

// wav [batch, n_wav] -> out [batch, n_wav / hop + 1, n_mels]; cos_w/sin_w
// [n_fft, n_bins] (window folded in), fb_t [n_bins, n_mels]. Requires hop
// and n_fft multiples of 4, hop <= n_fft, n_bins <= 2048 (the wrapper checks).
extern "C" int mel_spectrogram_f32(const float* wav, const float* cos_w,
                                   const float* sin_w, const float* fb_t,
                                   float* out, int batch, int n_wav, int n_fft,
                                   int hop, int n_bins, int n_mels, float eps,
                                   void* stream) {
  const int n_frames = n_wav / hop + 1;
  const int threads = ((n_bins + 1) / 2 + 31) / 32 * 32;  // two bins a thread
  const size_t smem = (size_t)(seg_len(hop, n_fft) + FT * n_bins) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const dim3 grid((n_frames + FT - 1) / FT, batch);
  mel_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      wav, cos_w, sin_w, fb_t, out, n_wav, n_frames, n_fft, hop, n_bins, n_mels,
      eps);
  return (int)cudaGetLastError();
}
