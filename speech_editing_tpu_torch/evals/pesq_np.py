"""Pure-numpy PESQ (ITU-T P.862, narrowband) — dependency-free fallback.

Parity surface: ``eval/pesq_metric.py:36`` (``pesq(16000, ref, deg, 'nb')``).
The reference calls the ITU C implementation via the ``pesq`` PyPI package,
which is absent in this environment; this module implements the P.862
perceptual model in numpy so ``evals.get_metrics`` emits a real PESQ number
everywhere.

Implementation notes (honesty matters here):

* The processing chain follows the published P.862 algorithm: level
  alignment to a fixed listening level, IRS-receive input filtering,
  envelope-based time alignment, Hann-windowed power spectra, Bark-band
  grouping, partial frequency/gain compensation, Zwicker loudness
  transform, asymmetric + symmetric disturbance with masking deadzone, and
  the L6-over-320ms / L2-over-utterance aggregation into
  ``4.5 - 0.1*D - 0.0309*DA``.
* The Bark band edges and a few internal constants are *derived from the
  published formulas* (Zwicker scale, Terhardt absolute threshold) rather
  than copied from the ITU reference tables, so scores deviate from the
  canonical C implementation by a few tenths of a MOS point. When the C
  ``pesq`` package is installed, ``evals.pesq_metric`` prefers it and this
  module is never used.
* Calibrated invariants (tested): identical signals score > 4.0; score
  decreases monotonically with additive-noise level; output is clipped to
  P.862's [-0.5, 4.5] range.

The port's copy of the JAX package's ``evals/pesq_np.py``.
"""

from __future__ import annotations

import numpy as np

TARGET_POWER = 1e7  # P.862 fixed listening-level power after alignment


def _hz_to_bark(f):
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(7.6e-4 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _abs_threshold_db(f_hz):
    """Terhardt absolute hearing threshold (dB SPL), floored for f->0."""
    f = np.maximum(np.asarray(f_hz, np.float64), 20.0) / 1000.0
    return (3.64 * f ** -0.8 - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
            + 1e-3 * f ** 4)


def _irs_receive_gain_db(f_hz):
    """Piecewise-linear approximation of the IRS receive characteristic
    (P.862 applies it to both signals in nb mode): bandpass ~300-3100 Hz
    with steep rolloffs."""
    pts_f = np.array([0, 50, 100, 200, 300, 500, 1000, 2000, 3000,
                      3400, 4000, 8000], np.float64)
    pts_g = np.array([-200.0, -40, -20, -8, -3, 0, 0, 1, 0,
                      -3, -25, -80], np.float64)
    return np.interp(np.asarray(f_hz, np.float64), pts_f, pts_g)


class _NBModel:
    """Frame/band constants for narrowband PESQ at a given sample rate."""

    def __init__(self, sr: int):
        if sr not in (8000, 16000):
            raise ValueError("PESQ nb supports 8 kHz or 16 kHz input")
        self.sr = sr
        self.nfft = 256 if sr == 8000 else 512
        self.hop = self.nfft // 2
        self.window = 0.5 * (1 - np.cos(
            2 * np.pi * np.arange(self.nfft) / self.nfft))
        freqs = np.fft.rfftfreq(self.nfft, 1.0 / sr)
        self.freqs = freqs
        # 49 bands uniform on the bark scale over the nb analysis range
        self.n_bands = 49
        z_edges = np.linspace(_hz_to_bark(50.0), _hz_to_bark(4000.0),
                              self.n_bands + 1)
        bin_z = _hz_to_bark(freqs)
        self.band_of_bin = np.clip(
            np.searchsorted(z_edges, bin_z, side="right") - 1,
            -1, self.n_bands - 1)
        self.band_of_bin[(bin_z < z_edges[0]) | (bin_z > z_edges[-1])] = -1
        self.band_width = np.diff(z_edges)  # bark widths (uniform)
        centers_z = 0.5 * (z_edges[:-1] + z_edges[1:])
        # invert bark -> Hz numerically for threshold lookup
        f_grid = np.linspace(10, 8000, 4000)
        self.band_center_hz = np.interp(centers_z, _hz_to_bark(f_grid), f_grid)
        thr_db = _abs_threshold_db(self.band_center_hz)
        # internal-noise / threshold power per band, on the model's intensity
        # scale (calibrated so conversational speech sits well above it)
        self.band_thresh = 10.0 ** (thr_db / 10.0) * 1e4
        # loudness normalisation; the 4.0 calibrates the white-noise
        # SNR->MOS curve to the canonical C implementation's (snr 40/20/10/0
        # -> ~3.8/2.6/1.9/1.6)
        self.sl = 4.0 / np.sum(self.band_width)

    def frames(self, x: np.ndarray) -> np.ndarray:
        n = (len(x) - self.nfft) // self.hop + 1
        if n < 1:
            return np.zeros((0, self.nfft // 2 + 1))
        idx = (np.arange(self.nfft)[None, :]
               + self.hop * np.arange(n)[:, None])
        spec = np.fft.rfft(x[idx] * self.window[None, :], axis=1)
        return (spec.real ** 2 + spec.imag ** 2)

    def bark_spectrum(self, power_frames: np.ndarray) -> np.ndarray:
        """[N, nfft/2+1] bin powers -> [N, n_bands] bark band intensities."""
        nb = self.n_bands
        out = np.zeros((power_frames.shape[0], nb))
        valid = self.band_of_bin >= 0
        np.add.at(out.T, self.band_of_bin[valid],
                  power_frames[:, valid].T)
        # normalise by band width in bins so narrow low bands aren't starved
        counts = np.bincount(self.band_of_bin[valid], minlength=nb)
        return out / np.maximum(counts, 1)[None, :]


def _level_align(x: np.ndarray, sr: int) -> np.ndarray:
    """Scale to the fixed P.862 listening level using 300-3000 Hz power."""
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / sr)
    band = (freqs >= 300) & (freqs <= 3000)
    p_band = np.sum(np.abs(spec[band]) ** 2) / len(x) ** 2 * 2
    if p_band <= 0:
        return x
    return x * np.sqrt(TARGET_POWER / (p_band * len(x)) * len(x))


def _irs_filter(x: np.ndarray, sr: int) -> np.ndarray:
    spec = np.fft.rfft(x)
    gain = 10.0 ** (_irs_receive_gain_db(np.fft.rfftfreq(len(x), 1.0 / sr))
                    / 20.0)
    return np.fft.irfft(spec * gain, n=len(x))


def _time_align(ref: np.ndarray, deg: np.ndarray, model: _NBModel):
    """Global delay estimate via cross-correlation of frame log-energy
    envelopes (P.862's crude align; fine per-utterance align omitted)."""
    def env(x):
        n = (len(x) - model.nfft) // model.hop + 1
        if n < 2:
            return np.zeros(2)
        idx = (np.arange(model.nfft)[None, :]
               + model.hop * np.arange(n)[:, None])
        e = np.sum(x[idx] ** 2, axis=1)
        return np.log10(np.maximum(e, 1e-10))

    er, ed = env(ref), env(deg)
    n = min(len(er), len(ed))
    er, ed = er[:n] - er[:n].mean(), ed[:n] - ed[:n].mean()
    corr = np.correlate(ed, er, mode="full")
    delay_frames = int(np.argmax(corr)) - (n - 1)
    delay = delay_frames * model.hop
    if delay > 0:
        deg = deg[delay:]
    elif delay < 0:
        ref = ref[-delay:]
    n = min(len(ref), len(deg))
    return ref[:n], deg[:n]


def pesq_np(sr: int, ref: np.ndarray, deg: np.ndarray) -> float:
    """Narrowband PESQ MOS for float waveforms in [-1, 1]."""
    model = _NBModel(sr)
    ref = np.asarray(ref, np.float64)
    deg = np.asarray(deg, np.float64)
    if min(len(ref), len(deg)) < 4 * model.nfft:
        raise ValueError("signals too short for PESQ")
    ref = _irs_filter(_level_align(ref, sr), sr)
    deg = _irs_filter(_level_align(deg, sr), sr)
    ref, deg = _time_align(ref, deg, model)

    p_ref = model.frames(ref)
    p_deg = model.frames(deg)
    b_ref = model.bark_spectrum(p_ref)
    b_deg = model.bark_spectrum(p_deg)
    n = b_ref.shape[0]
    if n == 0:
        raise ValueError("signals too short for PESQ")

    thr = model.band_thresh[None, :]
    audible_ref = np.sum(np.where(b_ref > thr, b_ref, 0.0), axis=1)
    active = audible_ref > 1e2 * np.median(
        np.maximum(audible_ref, 1e-10)) * 1e-2  # speech-active frames

    # partial frequency compensation: time-averaged per-band ratio over
    # active frames, clipped, applied to the reference
    num = np.sum(b_deg[active], axis=0) + 1e3
    den = np.sum(b_ref[active], axis=0) + 1e3
    freq_comp = np.clip(num / den, 0.01, 100.0)
    b_ref_c = b_ref * freq_comp[None, :]

    # short-term gain compensation on the degraded signal
    g_num = np.sum(np.where(b_ref_c > thr, b_ref_c, 0.0), axis=1) + 5e3
    g_den = np.sum(np.where(b_deg > thr, b_deg, 0.0), axis=1) + 5e3
    gain = g_num / g_den
    # first-order smoothing along time (P.862 uses 0.8/0.2)
    for i in range(1, n):
        gain[i] = 0.8 * gain[i - 1] + 0.2 * gain[i]
    gain = np.clip(gain, 3e-4, 5.0)
    b_deg_c = b_deg * gain[:, None]

    def loudness(b):
        # Zwicker law around the per-band internal noise/threshold power
        rel = b / thr
        s = (thr / 0.5) ** 0.23 * ((0.5 + 0.5 * rel) ** 0.23 - 1.0)
        return model.sl * np.where(b > thr, s, 0.0)

    l_ref = loudness(b_ref_c)
    l_deg = loudness(b_deg_c)

    d = l_deg - l_ref
    deadzone = 0.25 * np.minimum(l_deg, l_ref)
    d = np.sign(d) * np.maximum(np.abs(d) - deadzone, 0.0)

    # asymmetry factor: additive distortions (deg > ref) hurt more
    h = ((b_deg_c + 50.0) / (b_ref_c + 50.0)) ** 1.2
    h = np.where(h < 3.0, 0.0, np.minimum(h, 12.0))
    d_asym = d * h

    w = model.band_width[None, :]
    frame_d = np.minimum(
        (np.sum(w * np.abs(d) ** 3, 1) / np.sum(w)) ** (1 / 3), 45.0)
    frame_da = np.minimum(np.sum(w * np.abs(d_asym), 1) / np.sum(w), 45.0)

    # weight each frame by its audible reference power (quiet frames count
    # less), then L6 over 320 ms intervals and L2 over the utterance
    weight = ((audible_ref + 1e5) / 1e7) ** 0.04
    frame_d = np.minimum(frame_d / weight, 45.0)
    frame_da = np.minimum(frame_da / weight, 45.0)

    def aggregate(fd, p_frame, p_interval, n_per=None):
        if n_per is None:
            n_per = max(1, int(0.32 * model.sr / model.hop))
        pads = (-len(fd)) % n_per
        fd = np.pad(fd, (0, pads))
        intervals = fd.reshape(-1, n_per)
        per_int = (np.mean(intervals ** p_frame, 1)) ** (1 / p_frame)
        return (np.mean(per_int ** p_interval)) ** (1 / p_interval)

    d_total = aggregate(frame_d, 6.0, 2.0)
    da_total = aggregate(frame_da, 1.0, 2.0)

    mos = 4.5 - 0.1 * d_total - 0.0309 * da_total
    return float(np.clip(mos, -0.5, 4.5))
