// fastdsp: native (C++, multithreaded) offline DSP for the binarizer.
//
// The reference toolkit's offline pipeline leans on native third-party DSP
// (librosa's C/numba STFT+mel, parselmouth == Praat C++ pitch; SURVEY §2.9).
// Our numpy replacements are correct but single-threaded; this library is
// the native equivalent: the same STFT -> mel -> log10 and Boersma-style
// normalized-autocorrelation f0 tracker, threaded over frames.
//
// Parity contract (tested in tests/test_torch_native_dsp.py):
//  * stft_mel: matches utils/audio/dsp.py::wav2spec mel/linear outputs
//    (center=True constant padding, caller-supplied window and mel basis,
//    double-precision FFT) to ~1e-5.
//  * autocorr_f0: matches utils/audio/pitch.py::autocorr_pitch frame for
//    frame (caller supplies the window and normalized window-AC terms).
//
// Build: at first use, by speech_editing_tpu_torch/utils/audio/native.py
// (g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread) into
// speech_editing_tpu_torch/_build/. Bindings: ctypes, no pybind11.

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

using cplx = std::complex<double>;

// per-size FFT plan: bit-reversal permutation + twiddle tables (cached
// per thread; sizes used are tiny — 1024/2048)
struct FftPlan {
  int n = 0;
  std::vector<int> rev;
  std::vector<cplx> tw_fwd, tw_inv;  // concatenated per-stage twiddles
};

FftPlan* get_plan(int n) {
  thread_local std::vector<FftPlan> plans;
  for (auto& p : plans)
    if (p.n == n) return &p;
  plans.emplace_back();
  FftPlan& p = plans.back();
  p.n = n;
  p.rev.assign(n, 0);
  for (int i = 1, j = 0; i < n; i++) {
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    p.rev[i] = j;
  }
  for (int len = 2; len <= n; len <<= 1)
    for (int k = 0; k < len / 2; k++) {
      double ang = 2.0 * M_PI * k / len;
      p.tw_fwd.emplace_back(std::cos(ang), -std::sin(ang));
      p.tw_inv.emplace_back(std::cos(ang), std::sin(ang));
    }
  return &plans.back();
}

// iterative radix-2 Cooley-Tukey; n must be a power of two
void fft_inplace(cplx* a, int n, bool inverse) {
  const FftPlan* plan = get_plan(n);
  for (int i = 1; i < n; i++) {
    int j = plan->rev[i];
    if (i < j) std::swap(a[i], a[j]);
  }
  const cplx* tw = inverse ? plan->tw_inv.data() : plan->tw_fwd.data();
  for (int len = 2; len <= n; len <<= 1) {
    for (int i = 0; i < n; i += len) {
      for (int k = 0; k < len / 2; k++) {
        cplx u = a[i + k], v = a[i + k + len / 2] * tw[k];
        a[i + k] = u + v;
        a[i + k + len / 2] = u - v;
      }
    }
    tw += len / 2;
  }
  if (inverse)
    for (int i = 0; i < n; i++) a[i] /= n;
}

void parallel_for(long n_items, int n_threads,
                  const std::function<void(long, long)>& body) {
  if (n_threads <= 1 || n_items <= 1) {
    body(0, n_items);
    return;
  }
  int nt = std::min<long>(n_threads, n_items);
  std::vector<std::thread> pool;
  long chunk = (n_items + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    long lo = t * chunk, hi = std::min(n_items, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(body, lo, hi);
  }
  for (auto& th : pool) th.join();
}

inline double wav_at(const float* wav, long n, long i) {
  return (i < 0 || i >= n) ? 0.0 : static_cast<double>(wav[i]);
}

double median_of(std::vector<double> v) {
  if (v.empty()) return 0.0;
  size_t mid = v.size() / 2;
  std::nth_element(v.begin(), v.begin() + mid, v.end());
  double m = v[mid];
  if (v.size() % 2 == 0) {
    std::nth_element(v.begin(), v.begin() + mid - 1, v.begin() + mid);
    m = 0.5 * (m + v[mid - 1]);
  }
  return m;
}

}  // namespace

extern "C" {

// frames for center=True STFT: 1 + n // hop  (n_fft even)
long fastdsp_num_frames(long n, int hop) { return 1 + n / hop; }

// wav [n] -> out_mel [T, n_mels] (log10, eps-clamped), optional out_linear
// [T, n_bins] (raw magnitude). window[n_fft] = win_length window centered
// in n_fft (dsp.py::stft_window); mel_fb [n_mels, n_bins] row-major.
int fastdsp_stft_mel(const float* wav, long n, int n_fft, int hop,
                     const double* window, const double* mel_fb, int n_mels,
                     double eps, float* out_mel, float* out_linear,
                     int n_threads) {
  if ((n_fft & (n_fft - 1)) != 0 || n_fft <= 0) return -1;  // pow2 only
  long t_frames = fastdsp_num_frames(n, hop);
  int n_bins = n_fft / 2 + 1;
  long pad = n_fft / 2;  // center=True, constant (zero) padding

  // mel rows are triangles with narrow support — precompute each row's
  // nonzero band so the per-frame projection is O(support), not O(n_bins)
  std::vector<int> row_lo(n_mels), row_hi(n_mels);
  for (int m = 0; m < n_mels; m++) {
    const double* row = mel_fb + static_cast<long>(m) * n_bins;
    int lo = 0, hi = n_bins;
    while (lo < n_bins && row[lo] == 0.0) lo++;
    while (hi > lo && row[hi - 1] == 0.0) hi--;
    row_lo[m] = lo;
    row_hi[m] = hi;
  }

  // frames are processed in PAIRS: two real frames packed into one complex
  // FFT (x + i*y), separated by conjugate symmetry — halves the FFT count
  long n_pairs = (t_frames + 1) / 2;
  parallel_for(n_pairs, n_threads, [&](long lo, long hi) {
    std::vector<cplx> buf(n_fft);
    std::vector<double> mag0(n_bins), mag1(n_bins);
    auto emit = [&](long f, const std::vector<double>& mag) {
      if (out_linear != nullptr)
        for (int b = 0; b < n_bins; b++)
          out_linear[f * n_bins + b] = static_cast<float>(mag[b]);
      for (int m = 0; m < n_mels; m++) {
        const double* row = mel_fb + static_cast<long>(m) * n_bins;
        double acc = 0.0;
        for (int b = row_lo[m]; b < row_hi[m]; b++) acc += row[b] * mag[b];
        out_mel[f * n_mels + m] =
            static_cast<float>(std::log10(std::max(eps, acc)));
      }
    };
    for (long p = lo; p < hi; p++) {
      long f0 = 2 * p, f1 = 2 * p + 1;
      bool has_f1 = f1 < t_frames;
      long s0 = f0 * hop - pad, s1 = f1 * hop - pad;
      for (int k = 0; k < n_fft; k++)
        buf[k] = cplx(wav_at(wav, n, s0 + k) * window[k],
                      has_f1 ? wav_at(wav, n, s1 + k) * window[k] : 0.0);
      fft_inplace(buf.data(), n_fft, false);
      for (int b = 0; b < n_bins; b++) {
        cplx z = buf[b];
        cplx zc = std::conj(buf[(n_fft - b) & (n_fft - 1)]);
        mag0[b] = 0.5 * std::abs(z + zc);
        if (has_f1) mag1[b] = 0.5 * std::abs(z - zc);
      }
      emit(f0, mag0);
      if (has_f1) emit(f1, mag1);
    }
  });
  return static_cast<int>(t_frames);
}

// Boersma-style normalized-autocorrelation f0 tracker; mirrors
// utils/audio/pitch.py::autocorr_pitch. window[win] and wac_norm[lag_max+2]
// (window AC / wac[0], clamped) are caller-supplied for exact parity.
// out [n // hop] f0 in Hz, 0 = unvoiced.
int fastdsp_autocorr_f0(const float* wav, long n, int hop, int sr,
                        double f0_min, double f0_max, double vth,
                        const double* window, int win,
                        const double* wac_norm, float* out, int n_threads) {
  long n_frames = n / hop;
  if (n_frames == 0) return 0;
  int half = win / 2;
  int lag_min = std::max(2, static_cast<int>(sr / f0_max));
  int lag_max = std::min(win - 2, static_cast<int>(sr / f0_min));
  if (lag_max <= lag_min) {
    std::memset(out, 0, sizeof(float) * n_frames);
    return static_cast<int>(n_frames);
  }
  int nfft = 1;
  while (nfft < 2 * win) nfft <<= 1;

  std::vector<double> rms(n_frames), r0v(n_frames), f0raw(n_frames);

  parallel_for(n_frames, n_threads, [&](long lo, long hi) {
    std::vector<double> frame(win);
    std::vector<cplx> buf(nfft);
    for (long f = lo; f < hi; f++) {
      long center = f * hop + hop / 2;
      double mean = 0.0;
      for (int k = 0; k < win; k++) {
        frame[k] = wav_at(wav, n, center - half + k);
        mean += frame[k];
      }
      mean /= win;
      double energy = 0.0;
      for (int k = 0; k < win; k++) {
        frame[k] -= mean;
        energy += frame[k] * frame[k];
      }
      rms[f] = std::sqrt(energy / win);

      for (int k = 0; k < nfft; k++)
        buf[k] = (k < win) ? cplx(frame[k] * window[k], 0.0) : cplx(0.0, 0.0);
      fft_inplace(buf.data(), nfft, false);
      for (int k = 0; k < nfft; k++) buf[k] = cplx(std::norm(buf[k]), 0.0);
      fft_inplace(buf.data(), nfft, true);  // -> circular AC (real)

      double ac0 = std::max(buf[0].real(), 1e-12);
      auto rr = [&](int lag) {
        return (buf[lag].real() / ac0) / wac_norm[lag];
      };
      int best = lag_min;
      double best_v = rr(lag_min);
      for (int lag = lag_min + 1; lag <= lag_max; lag++) {
        double v = rr(lag);
        if (v > best_v) { best_v = v; best = lag; }
      }
      double rm1 = rr(best - 1), r0 = rr(best), rp1 = rr(best + 1);
      double den = rm1 - 2.0 * r0 + rp1;
      double delta =
          (std::fabs(den) > 1e-9) ? 0.5 * (rm1 - rp1) / den : 0.0;
      delta = std::max(-1.0, std::min(1.0, delta));
      r0v[f] = r0;
      f0raw[f] = sr / std::max(best + delta, 1e-6);
    }
  });

  double rms_med = median_of(rms);
  std::vector<double> f0(n_frames);
  for (long f = 0; f < n_frames; f++) {
    bool voiced = r0v[f] > vth && rms[f] > 1e-4 + 0.02 * rms_med;
    f0[f] = (voiced && f0raw[f] >= f0_min && f0raw[f] <= f0_max) ? f0raw[f]
                                                                 : 0.0;
  }
  // 3-tap circular median smoothing (np.roll semantics), keep voicing
  if (n_frames >= 3) {
    for (long f = 0; f < n_frames; f++) {
      double a = f0[(f + 1) % n_frames], b = f0[f],
             c = f0[(f - 1 + n_frames) % n_frames];
      double lo = std::min({a, b, c}), hi = std::max({a, b, c});
      double med = a + b + c - lo - hi;
      out[f] = static_cast<float>(b > 0 ? (med > 0 ? med : b) : 0.0);
    }
  } else {
    for (long f = 0; f < n_frames; f++) out[f] = static_cast<float>(f0[f]);
  }
  return static_cast<int>(n_frames);
}

}  // extern "C"
