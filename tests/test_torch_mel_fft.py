"""K2's algorithm (``csrc/mel_kernel.cu``), emulated step by step on the CPU.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against its plain version. Here numpy repeats what each CTA does, in
float32, with the kernel's tables (``ops/cuda/mel_kernel.py::mel_tables``)
and index maps: tiles of F frames over the centre-padded wav (the last one
ragged), even/odd packing of each windowed frame into 512 complex values,
three radix-8 Stockham stages through padded re/im buffers, the split step
to 513 bins, and the mel step over each band's non-zero bins, two lanes a
band. The emulation is held against ``torch.fft.rfft``, the port's plain
version and the JAX package's rfft path and Pallas kernel (interpret mode).
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F_

from speech_editing_tpu.ops.mel import MelConfig as JMelConfig
from speech_editing_tpu.ops.mel import mel_spectrogram as jmel_xla
from speech_editing_tpu.ops.pallas.mel_kernel import mel_spectrogram_pallas
from speech_editing_tpu_torch.ops.cuda.mel_kernel import N_FFT, mel_bands, mel_tables
from speech_editing_tpu_torch.ops.mel import MelConfig, mel_bases
from speech_editing_tpu_torch.ops.mel import mel_spectrogram as mel_plain
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

# csrc/mel_kernel.cu's geometry
F = 4                  # frames per CTA
N2 = N_FFT // 2        # complex FFT length
TPF = N2 // 8          # threads per frame, one radix-8 butterfly each a stage
LD = N2 + N2 // 8      # a frame's padded re (or im) row
TW = {8: 0, 64: 7 * 8}  # each stage's block of twiddles, then the split step's
TW_SPLIT = 7 * 8 + 7 * 64
H = np.float32(np.sqrt(0.5))
R = np.arange(8)
J = np.arange(TPF)


def pad(i):
    return i + (i >> 3)


def cmul(a, b):
    """(re, im) pairs of float32 arrays."""
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def dft4(u0, u1, u2, u3):
    s0 = (u0[0] + u2[0], u0[1] + u2[1])
    s1 = (u0[0] - u2[0], u0[1] - u2[1])
    s2 = (u1[0] + u3[0], u1[1] + u3[1])
    s3 = (u1[1] - u3[1], -(u1[0] - u3[0]))               # (u1 - u3) * (-i)
    return ((s0[0] + s2[0], s0[1] + s2[1]), (s1[0] + s3[0], s1[1] + s3[1]),
            (s0[0] - s2[0], s0[1] - s2[1]), (s1[0] - s3[0], s1[1] - s3[1]))


def dft8(re, im):
    """The kernel's 8-point DFT over the last axis: one radix-2 split, the
    odd half times W_8^r, two 4-point DFTs."""
    v = [(re[..., r], im[..., r]) for r in range(8)]
    a = [(v[r][0] + v[r + 4][0], v[r][1] + v[r + 4][1]) for r in range(4)]
    d = [(v[r][0] - v[r + 4][0], v[r][1] - v[r + 4][1]) for r in range(4)]
    c = [d[0], ((d[1][0] + d[1][1]) * H, (d[1][1] - d[1][0]) * H),
         (d[2][1], -d[2][0]), ((d[3][1] - d[3][0]) * H, -(d[3][0] + d[3][1]) * H)]
    out = [None] * 8
    out[0::2] = dft4(*a)
    out[1::2] = dft4(*c)
    return np.stack([o[0] for o in out], -1), np.stack([o[1] for o in out], -1)


def store(ns, re, im, lead):
    """Thread j's element k to (j / ns) 8 ns + j % ns + ns k, padded."""
    idx = pad((J[:, None] // ns) * ns * 8 + J[:, None] % ns + ns * R[None, :])
    bre, bim = np.zeros(lead + (LD,), np.float32), np.zeros(lead + (LD,), np.float32)
    bre[..., idx], bim[..., idx] = re, im
    return bre, bim


def stage(ns, bre, bim, tw):
    idx = pad(J[:, None] + TPF * R[None, :])
    re, im = bre[..., idx], bim[..., idx]
    row = TW[ns] + (R[None, 1:] - 1) * ns + J[:, None] % ns   # r = 0 takes no twiddle
    re[..., 1:], im[..., 1:] = cmul((re[..., 1:], im[..., 1:]), (tw[row, 0], tw[row, 1]))
    return store(ns, *dft8(re, im), bre.shape[:-1])


def emulate_bins(wav: np.ndarray, cfg: MelConfig) -> np.ndarray:
    """[B, N] -> the split step's bins [B, N // hop + 1, 513], complex."""
    t = mel_tables(cfg)
    b, n = wav.shape
    n_frames = n // cfg.hop_size + 1
    tiles = -(-n_frames // F)
    frames = (np.arange(tiles)[:, None] * F + np.arange(F)[None, :])   # ragged last tile
    # stage 1: z[n] = x[2n] w[2n] + i x[2n+1] w[2n+1], read straight from the wav
    m = 2 * (J[:, None] + TPF * R[None, :])                           # [TPF, 8]
    s = frames[:, :, None, None] * cfg.hop_size - N2 + m               # wav sample
    read = lambda s: np.where((s >= 0) & (s < n), wav[:, np.clip(s, 0, n - 1)], 0.0
                              ).astype(np.float32)
    re, im = read(s) * t.window[m], read(s + 1) * t.window[m + 1]
    lead = (b, tiles, F)
    bre, bim = store(1, *dft8(re, im), lead)
    bre, bim = stage(8, bre, bim, t.twiddles)
    bre, bim = stage(64, bre, bim, t.twiddles)
    # split step: k = 0 .. 256 gives X[k] and X[512 - k]
    k = np.arange(N2 // 2 + 1)
    zk = (bre[..., pad(k)], bim[..., pad(k)])
    zm = (bre[..., pad((N2 - k) % N2)], bim[..., pad((N2 - k) % N2)])
    e = (np.float32(0.5) * (zk[0] + zm[0]), np.float32(0.5) * (zk[1] - zm[1]))
    o = (np.float32(0.5) * (zk[1] + zm[1]), np.float32(-0.5) * (zk[0] - zm[0]))
    w = t.twiddles[TW_SPLIT:]
    p = cmul(o, (w[:, 0], w[:, 1]))
    x = np.zeros(lead + (N2 + 1,), np.complex64)
    x[..., N2 - k] = (e[0] - p[0]) - 1j * (e[1] - p[1])
    x[..., k] = (e[0] + p[0]) + 1j * (e[1] + p[1])
    return x.reshape(b, tiles * F, N2 + 1)[:, :n_frames]


def emulate_mel(amp: np.ndarray, cfg: MelConfig) -> np.ndarray:
    """The mel step: lane h of band m sums bins lo + h, lo + h + 2, ... < hi,
    in order; the two lanes' sums are added; then log10(max(eps, .))."""
    t = mel_tables(cfg)
    out = np.zeros(amp.shape[:-1] + (cfg.num_mels,), np.float32)
    for m, (lo, hi, off) in enumerate(t.bands.T):
        acc = []
        for h in (0, 1):
            a = np.zeros(amp.shape[:-1], np.float32)
            for k in range(lo + h, hi, 2):
                a = a + amp[..., k] * t.weights[off + k - lo]
            acc.append(a)
        out[..., m] = acc[0] + acc[1]
    return np.log10(np.maximum(np.float32(cfg.eps), out))


def emulate(wav: np.ndarray, cfg: MelConfig) -> np.ndarray:
    x = emulate_bins(wav, cfg)
    amp = np.sqrt(x.real ** 2 + x.imag ** 2 + np.float32(1e-30)).astype(np.float32)
    return emulate_mel(amp, cfg)


def utterance(rng, b: int, n: int) -> np.ndarray:
    """A 180 Hz tone with a tremolo over a 0.02 rms noise floor (as a
    recording has; without one, mel bins at the eps floor compare rounding)."""
    t_ax = np.arange(n) / 22050
    tone = 0.3 * np.sin(2 * np.pi * 180 * t_ax) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t_ax))
    return (tone[None] + 0.02 * rng.randn(b, n)).astype(np.float32)


HOPS = [256, 128]


@pytest.mark.parametrize("hop", HOPS)
def test_fft_emulation_matches_rfft(rng, hop):
    """Packing, the three stages and the split step give the rfft of each
    windowed frame, the last tile ragged (N = 256 * 41 + 17 at hop 256)."""
    cfg = MelConfig(hop_size=hop)
    wav = (rng.randn(2, 256 * 41 + 17) * 0.2).astype(np.float32)
    got = emulate_bins(wav, cfg)
    n_frames = wav.shape[1] // hop + 1
    assert got.shape == (2, n_frames, N2 + 1) and n_frames % F != 0
    frames = F_.pad(torch.tensor(wav, dtype=torch.float64), (N2, N2)).unfold(1, N_FFT, hop)
    ref = torch.fft.rfft(frames * torch.tensor(mel_tables(cfg).window, dtype=torch.float64))
    ref = ref.numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("hop", HOPS)
def test_emulation_matches_plain_and_jax(rng, hop):
    """The whole function against the plain version, the JAX package's
    rfft path and its Pallas kernel (at hop 128 the latter takes the XLA
    path), at the Pallas kernel's bars in log10 units."""
    cfg, jcfg = MelConfig(hop_size=hop), JMelConfig(hop_size=hop)
    wav = utterance(rng, 2, 256 * 60 + 17)
    got = emulate(wav, cfg)
    assert got.shape == (2, wav.shape[1] // hop + 1, 80)
    refs = {"plain": mel_plain(torch.tensor(wav), cfg).numpy(),
            "jax rfft": np.asarray(jmel_xla(jnp.asarray(wav), jcfg)),
            "pallas": np.asarray(mel_spectrogram_pallas(jnp.asarray(wav), jcfg))}
    for name, ref in refs.items():
        d = np.abs(got - ref)
        assert d.max() < 2e-2 and d.mean() < 2e-3, (name, d.max(), d.mean())


def test_band_tables_reproduce_the_dense_filterbank(rng):
    """Scattering the packed weights back gives the filterbank bit for bit,
    every non-zero weight lies inside its band's range, a bin has at most
    two, and the band sums equal amp @ fb_t."""
    cfg = MelConfig()
    t = mel_tables(cfg)
    fb_t = mel_bases(cfg)[2]
    dense = np.zeros_like(fb_t)
    for m, (lo, hi, off) in enumerate(t.bands.T):
        dense[lo:hi, m] = t.weights[off:off + hi - lo]
    np.testing.assert_array_equal(dense, fb_t)
    assert t.weights.size == np.count_nonzero(fb_t) <= 2 * fb_t.shape[0]
    assert (np.count_nonzero(fb_t, axis=1) <= 2).all()
    amp = rng.rand(5, fb_t.shape[0])
    sums = np.stack([amp[:, lo:hi] @ t.weights[off:off + hi - lo].astype(np.float64)
                     for lo, hi, off in t.bands.T], 1)
    np.testing.assert_allclose(sums, amp @ fb_t.astype(np.float64), rtol=1e-12, atol=0)


def test_mel_bands_of_an_empty_band():
    fb = np.array([[0, 1, 2, 0], [0, 0, 0, 0], [0, 0, 3, 4]], np.float32)
    bands, weights = mel_bands(fb)
    np.testing.assert_array_equal(bands, [[1, 0, 2], [3, 0, 4], [0, 2, 2]])
    np.testing.assert_array_equal(weights, [1, 2, 3, 4])


def test_tables_are_float64_rounded():
    """Window and twiddles are the float64 values rounded to float32; each
    stage's block holds W_512^(r s 64 / Ns) at (r - 1) Ns + s."""
    t = mel_tables(MelConfig())
    tw = t.twiddles[:, 0] + 1j * t.twiddles[:, 1]
    stage = lambda ns: np.exp(-2j * np.pi * (np.arange(1, 8)[:, None] * np.arange(ns)
                                             * (TPF // ns)).ravel() / N2)
    exact = np.concatenate([stage(8), stage(64),
                            np.exp(-2j * np.pi * np.arange(N2 // 2 + 1) / N_FFT)])
    assert tw.shape == exact.shape == (TW_SPLIT + N2 // 2 + 1,)
    np.testing.assert_array_equal(t.twiddles[:, 0], exact.real.astype(np.float32))
    np.testing.assert_array_equal(t.twiddles[:, 1], exact.imag.astype(np.float32))
    assert np.abs(tw - exact).max() < 1e-7
    n = np.arange(N_FFT)
    np.testing.assert_array_equal(t.window,
                                  (0.5 - 0.5 * np.cos(2 * np.pi * n / N_FFT)).astype(np.float32))


@pytest.mark.parametrize("ns", [1, 8, 64])
def test_stage_maps_are_permutations_on_distinct_banks(ns):
    """Each stage writes every element once; the padded buffer puts the
    stores of a warp (32 consecutive j) on 32 distinct banks in stages 1
    and 2 and at most 2 to a bank in stage 3, whose reads are the next
    stage's pattern."""
    idx = (J[:, None] // ns) * ns * 8 + J[:, None] % ns + ns * R[None, :]
    assert sorted(idx.ravel()) == list(range(N2))
    worst = max(np.bincount(pad(idx[w:w + 32, k]) % 32).max()
                for w in (0, 32) for k in range(8))
    assert worst == (1 if ns < 64 else 2)
    reads = pad(J[:, None] + TPF * R[None, :])
    assert max(np.bincount(reads[w:w + 32, k] % 32).max() for w in (0, 32) for k in range(8)) <= 2


def test_port_has_no_library_fft():
    """The port computes no spectrum through torch.fft, torch.stft or cuFFT:
    K2 is its own FFT."""
    root = pathlib.Path(__file__).resolve().parents[1] / "speech_editing_tpu_torch"
    hits = [f"{p.relative_to(root)}" for p in root.rglob("*")
            if p.suffix in (".py", ".cu", ".cuh")
            and any(s in p.read_text() for s in ("torch.fft", "torch.stft", "cufft", "cuFFT"))]
    assert not hits, hits
