// Fused log-mel spectrogram, float32, for sm_90a.
//
// Replaces the Pallas TPU kernel speech_editing_tpu/ops/pallas/mel_kernel.py
// (mel_spectrogram_pallas, body _kernel): constant centre padding, the
// periodic Hann window, sqrt(re^2 + im^2 + 1e-30) of the rDFT's bins, the
// slaney mel product, log10(max(eps, .)). n_fft = 1024 is compiled in.
//
// The TPU kernel runs the rDFT as two dense products against cos/sin bases,
// because its matrix unit beats an FFT there. On the H100 that costs 2.1
// MFLOP a frame on the float32 CUDA cores and streams the 4.2 MB of bases
// from L2 into every block. A real FFT needs about 25.6 kFLOP a frame and no
// basis: at the edit's 513 frames the whole function is about 15 MFLOP and
// 0.7 MB of wav and mel, 0.2 us at the card's float32 and memory rates. So
// what bounds it on this card is latency: the launch, one read of the wav
// from device memory, and the chain of dependent shared-memory passes and
// barriers inside a CTA. The design keeps that chain short and fills the
// card at B = 1:
//
//  * One CTA of 256 threads per (tile of F = 4 frames, batch row): 129 CTAs
//    at 513 frames on 132 SMs. The 64 threads of a frame each run one
//    radix-8 butterfly a stage.
//  * A frame's 1024 real samples are packed as 512 complex values
//    z[n] = x[2n] + i x[2n+1], windowed as they are read from device memory
//    by the first stage: no staged copy of the segment, and the reads of
//    overlapping frames hit L1.
//  * The 512-point complex FFT is three radix-8 Stockham stages (Ns = 1, 8,
//    64), ping-ponging between two shared-memory buffers, in natural order
//    with no bit reversal. Thread j of a frame reads z[j + 64 r] (r < 8),
//    multiplies it by W_512^(r (j mod Ns) 64 / Ns), runs an 8-point DFT in
//    registers and writes element k to (j / Ns) 8 Ns + (j mod Ns) + Ns k.
//    The buffers keep re and im apart, element i at i + i / 8, so the first
//    two stages' strided stores fall on 32 distinct banks.
//  * The split step gives the 513 bins from Z: with E = (Z[k] +
//    conj Z[512-k]) / 2 and O = (Z[k] - conj Z[512-k]) / 2i, X[k] = E +
//    W_1024^k O and X[512-k] = conj(E - W_1024^k O). Only magnitudes are kept.
//  * The window and the twiddles come from host tables computed in float64
//    and rounded to float32 (no __sincosf), the twiddles laid out in the
//    order a stage's threads read them, so that a warp's reads fall on
//    distinct banks. The twiddles and the mel tables are copied into shared
//    memory by cp.async, issued before the first stage's wav loads so that
//    both are in flight together.
//  * Each mel band sums only over its non-zero bins [lo, hi): the host packs
//    the slaney filterbank's weights (at most two a bin). Two lanes take a
//    band, each every other bin of all F frames, joined by one shuffle. Each
//    output is written once, with no atomics: bit-reproducible.
//
// Shared memory: two buffers of 2 x 4 x 576 floats, the twiddles and the
// mel tables, under 48 KB, so several CTAs share an SM at larger B.

#include <cuda_runtime.h>

#include "tf32x3.cuh"  // cp_async16, cp_async4, cp_async_commit, cp_async_wait_all

namespace {

using tf32x3::cp_async16;
using tf32x3::cp_async4;

constexpr int N_FFT = 1024;
constexpr int N2 = N_FFT / 2;          // the complex FFT's length
constexpr int F = 4;                   // frames per CTA
constexpr int TPF = N2 / 8;            // threads per frame, one butterfly each a stage
constexpr int THREADS = F * TPF;       // 256
constexpr int LD = N2 + N2 / 8;        // one frame's re (or im) row, padded: 576
constexpr int BUF = 2 * F * LD;        // one ping-pong buffer [re, im][F][LD], floats
// twiddles, float2, in the order the threads read them: stage Ns's
// W_512^(r s 64 / Ns) at TW_<Ns> + (r - 1) Ns + s (r = 1..7, s < Ns), then
// the split step's W_1024^k (k <= 256) at TW_SPLIT
constexpr int TW8 = 0, TW64 = TW8 + 7 * 8, TW_SPLIT = TW64 + 7 * 64;
constexpr int N_TW = TW_SPLIT + N2 / 2 + 1;  // 761
constexpr int AMP_LD = N2 + 1;         // 513 magnitudes a frame

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ constexpr size_t smem_bytes(int n_weights, int n_mels) {
  return sizeof(float) *
         (size_t)(2 * BUF + round4(2 * N_TW) + round4(n_weights) + round4(3 * n_mels));
}

struct cf {
  float x, y;
};
__device__ __forceinline__ cf operator+(cf a, cf b) { return {a.x + b.x, a.y + b.y}; }
__device__ __forceinline__ cf operator-(cf a, cf b) { return {a.x - b.x, a.y - b.y}; }
__device__ __forceinline__ cf cmul(cf a, float2 w) {
  return {a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x};
}
__device__ __forceinline__ cf mul_mi(cf a) { return {a.y, -a.x}; }  // a * (-i)

__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

// Y = DFT4(u), natural order: Y[k] = sum_r u[r] (-i)^(rk).
__device__ __forceinline__ void dft4(cf u0, cf u1, cf u2, cf u3, cf& y0, cf& y1, cf& y2,
                                     cf& y3) {
  const cf s0 = u0 + u2, s1 = u0 - u2, s2 = u1 + u3, s3 = mul_mi(u1 - u3);
  y0 = s0 + s2;
  y2 = s0 - s2;
  y1 = s1 + s3;
  y3 = s1 - s3;
}

// In place, natural order in and out: v[k] = sum_r v[r] W_8^(rk). One
// radix-2 split (even outputs from v[r] + v[r+4], odd ones from (v[r] -
// v[r+4]) W_8^r), then two 4-point DFTs. sqrt(1/2) is W_8's float32 value.
__device__ __forceinline__ void dft8(cf (&v)[8]) {
  constexpr float H = 0.70710678118654752440f;
  const cf a0 = v[0] + v[4], a1 = v[1] + v[5], a2 = v[2] + v[6], a3 = v[3] + v[7];
  const cf d0 = v[0] - v[4], d1 = v[1] - v[5], d2 = v[2] - v[6], d3 = v[3] - v[7];
  const cf c1 = {(d1.x + d1.y) * H, (d1.y - d1.x) * H};     // * W_8
  const cf c3 = {(d3.y - d3.x) * H, -(d3.x + d3.y) * H};    // * W_8^3
  dft4(a0, a1, a2, a3, v[0], v[2], v[4], v[6]);
  dft4(d0, c1, mul_mi(d2), c3, v[1], v[3], v[5], v[7]);
}

// Element k of the butterfly of thread j in stage NS goes to this index.
template <int NS>
__device__ __forceinline__ void store(float* dst, int f, int j, const cf (&v)[8]) {
  float* re = dst + f * LD;
  float* im = dst + (F + f) * LD;
  const int base = (j / NS) * NS * 8 + j % NS;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = pad(base + NS * k);
    re[i] = v[k].x;
    im[i] = v[k].y;
  }
}

// A Stockham stage after the first: src -> dst, with the stage's twiddles
// (tw: [7][NS] in shared memory, so a warp reads them on distinct banks).
template <int NS>
__device__ __forceinline__ void stage(const float* src, float* dst, const float2* tw, int f,
                                      int j) {
  const float* re = src + f * LD;
  const float* im = src + (F + f) * LD;
  cf v[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = pad(j + TPF * r);
    v[r] = {re[i], im[i]};
  }
  const int s = j % NS;
#pragma unroll
  for (int r = 1; r < 8; ++r) v[r] = cmul(v[r], tw[(r - 1) * NS + s]);
  dft8(v);
  store<NS>(dst, f, j, v);
}

// Copies n floats (src and dst 16-byte aligned) with cp.async.
__device__ __forceinline__ void stage_table(float* dst, const float* src, int n, int tid) {
  const int n4 = n / 4;
  for (int i = tid; i < n4; i += THREADS) cp_async16(dst + 4 * i, src + 4 * i);
  for (int i = 4 * n4 + tid; i < n; i += THREADS) cp_async4(dst + i, src + i);
}

__global__ void __launch_bounds__(THREADS)
    mel_kernel(const float* __restrict__ wav, const float* __restrict__ window,
               const float* __restrict__ twiddles, const float* __restrict__ weights,
               const int* __restrict__ bands, float* __restrict__ out, int n_wav,
               int n_frames, int hop, int n_mels, int n_weights, float eps) {
  extern __shared__ float4 smem4[];
  float* a_buf = reinterpret_cast<float*>(smem4);
  float* b_buf = a_buf + BUF;
  float* tw_s = b_buf + BUF;
  float* w_s = tw_s + round4(2 * N_TW);
  int* band_s = reinterpret_cast<int*>(w_s + round4(n_weights));
  const float2* tw = reinterpret_cast<const float2*>(tw_s);

  const int tid = threadIdx.x;
  const int f = tid / TPF, j = tid % TPF;
  const int b = blockIdx.y;
  const int frame0 = blockIdx.x * F;

  stage_table(tw_s, twiddles, 2 * N_TW, tid);
  stage_table(w_s, weights, n_weights, tid);
  stage_table(reinterpret_cast<float*>(band_s), reinterpret_cast<const float*>(bands),
              3 * n_mels, tid);
  tf32x3::cp_async_commit();

  // stage 1 (Ns = 1, no twiddles): frame sample m is padded-wav sample
  // frame * hop + m, wav sample frame * hop + m - n_fft / 2
  cf v[8];
  {
    const float* x = wav + (size_t)b * n_wav;
    const int start = (frame0 + f) * hop - N2;
    const float2* win2 = reinterpret_cast<const float2*>(window);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int n = j + TPF * r;
      const int s = start + 2 * n;
      const float x0 = (s >= 0 && s < n_wav) ? __ldg(x + s) : 0.f;
      const float x1 = (s + 1 >= 0 && s + 1 < n_wav) ? __ldg(x + s + 1) : 0.f;
      const float2 w = __ldg(win2 + n);
      v[r] = {x0 * w.x, x1 * w.y};
    }
  }
  dft8(v);
  store<1>(a_buf, f, j, v);
  tf32x3::cp_async_wait_all();
  __syncthreads();
  stage<8>(a_buf, b_buf, tw + TW8, f, j);
  __syncthreads();
  stage<64>(b_buf, a_buf, tw + TW64, f, j);
  __syncthreads();

  // split step: Z (in a_buf) -> |X| for the 513 bins, into b_buf. Thread j
  // of frame f takes k = j + 64 i (i < 4), and thread 0 also k = 256; all
  // its loads go out before its first store.
  {
    constexpr int NK = N2 / 2 / TPF + 1;  // 5, the last for j == 0 only
    const float* re = a_buf + f * LD;
    const float* im = a_buf + (F + f) * LD;
    float* amp = b_buf + f * AMP_LD;
    const int nk = j == 0 ? NK : NK - 1;
    cf zk[NK], zm[NK];
    float2 w[NK];
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      if (i < nk) {
        const int k = i < NK - 1 ? j + TPF * i : N2 / 2;
        const int m = (N2 - k) & (N2 - 1);
        zk[i] = {re[pad(k)], im[pad(k)]};
        zm[i] = {re[pad(m)], im[pad(m)]};
        w[i] = tw[TW_SPLIT + k];
      }
    }
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      if (i < nk) {
        const int k = i < NK - 1 ? j + TPF * i : N2 / 2;
        const cf e = {0.5f * (zk[i].x + zm[i].x), 0.5f * (zk[i].y - zm[i].y)};
        const cf o = {0.5f * (zk[i].y + zm[i].y), -0.5f * (zk[i].x - zm[i].x)};
        const cf p = cmul(o, w[i]);
        const cf lo = e + p, hi = e - p;
        amp[k] = sqrtf(lo.x * lo.x + lo.y * lo.y + 1e-30f);
        amp[N2 - k] = sqrtf(hi.x * hi.x + hi.y * hi.y + 1e-30f);
      }
    }
  }
  __syncthreads();

  // mel step: lanes 2m and 2m + 1 take band m, bins lo + h, lo + h + 2, ...
  const float* amp = b_buf;
  const int lanes = (2 * n_mels + 31) / 32 * 32;  // whole warps, for the shuffle
  if (tid < lanes) {
    const int m = tid >> 1, h = tid & 1;
    float acc[F];
#pragma unroll
    for (int fi = 0; fi < F; ++fi) acc[fi] = 0.f;
    if (m < n_mels) {
      const int lo = band_s[m], hi = band_s[n_mels + m];
      const float* wm = w_s + band_s[2 * n_mels + m] - lo;
#pragma unroll 4
      for (int k = lo + h; k < hi; k += 2) {
        const float wk = wm[k];
#pragma unroll
        for (int fi = 0; fi < F; ++fi) acc[fi] = fmaf(amp[fi * AMP_LD + k], wk, acc[fi]);
      }
    }
#pragma unroll
    for (int fi = 0; fi < F; ++fi) acc[fi] += __shfl_xor_sync(0xffffffffu, acc[fi], 1);
    if (m < n_mels) {
#pragma unroll
      for (int fi = 0; fi < F; ++fi) {
        if ((fi & 1) == h && frame0 + fi < n_frames)
          out[((size_t)b * n_frames + frame0 + fi) * n_mels + m] = log10f(fmaxf(eps, acc[fi]));
      }
    }
  }
}

}  // namespace

// wav [batch, n_wav] -> out [batch, n_wav / hop + 1, n_mels], n_fft = 1024.
// window [1024]; twiddles [N_TW][2] (see TW8 above); weights [n_weights]: each band's weights over its bins [lo, hi),
// band after band; bands [3][n_mels] int32: lo, hi (exclusive) and the
// band's offset into weights. All 16-byte aligned. Requires 1 <= hop <=
// 1024 and n_mels <= 128 (the wrapper checks); returns
// cudaErrorInvalidValue if the tables need more than 48 KB of shared memory.
extern "C" int mel_spectrogram_f32(const float* wav, const float* window,
                                   const float* twiddles, const float* weights,
                                   const int* bands, float* out, int batch, int n_wav,
                                   int hop, int n_mels, int n_weights, float eps,
                                   void* stream) {
  const size_t smem = smem_bytes(n_weights, n_mels);
  if (smem > 48 * 1024 || hop < 1 || hop > N_FFT || 2 * n_mels > THREADS)
    return (int)cudaErrorInvalidValue;
  const int n_frames = n_wav / hop + 1;
  const dim3 grid((n_frames + F - 1) / F, batch);
  mel_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      wav, window, twiddles, weights, bands, out, n_wav, n_frames, hop, n_mels, n_weights,
      eps);
  return (int)cudaGetLastError();
}
