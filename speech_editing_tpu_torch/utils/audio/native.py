"""ctypes bindings for the native DSP library (``native/fastdsp.cpp``).

The threaded C++ STFT -> mel -> log10 and the normalized-autocorrelation
f0 tracker: host code, the native counterparts of the binarizer's numpy
loops (``utils/audio/dsp.py``, ``utils/audio/pitch.py``). ``build()``
compiles the source with ``g++`` at first use into
``speech_editing_tpu_torch/_build/``; every entry point reports
unavailability (no compiler, a library that does not load or that dies on
its first call) through :func:`available`, which the callers read.
``calls`` counts the library's calls by entry point.

No pybind11: plain C ABI + ctypes, zero-copy via numpy pointers.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC_PATH = os.path.join(_PKG, "native", "fastdsp.cpp")
SO_PATH = os.path.join(_PKG, "_build", "libfastdsp.so")
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_LIB: Optional[ctypes.CDLL] = None
_LOAD_FAILED = False
#: library calls made in this process, by entry point
calls = {"stft_mel": 0, "autocorr_f0": 0}

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def build(force: bool = False) -> bool:
    """Compile the library if ``g++`` and the source are there. Safe under
    concurrent callers (the binarizer's worker pool): compiles to a
    per-pid temp file, then renames it atomically, so no worker loads a
    half-written library."""
    if os.path.exists(SO_PATH) and not force:
        return True
    if not os.path.exists(SRC_PATH):
        return False
    os.makedirs(os.path.dirname(SO_PATH), exist_ok=True)
    tmp = f"{SO_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, SRC_PATH, "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, SO_PATH)
        return True
    except (OSError, subprocess.CalledProcessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _bind(lib: ctypes.CDLL) -> None:
    lib.fastdsp_num_frames.restype = ctypes.c_long
    lib.fastdsp_num_frames.argtypes = [ctypes.c_long, ctypes.c_int]
    lib.fastdsp_stft_mel.restype = ctypes.c_int
    lib.fastdsp_stft_mel.argtypes = [
        _f32p, ctypes.c_long, ctypes.c_int, ctypes.c_int, _f64p, _f64p,
        ctypes.c_int, ctypes.c_double, _f32p, ctypes.c_void_p, ctypes.c_int]
    lib.fastdsp_autocorr_f0.restype = ctypes.c_int
    lib.fastdsp_autocorr_f0.argtypes = [
        _f32p, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, _f64p, ctypes.c_int, _f64p,
        _f32p, ctypes.c_int]


def _open() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(SO_PATH)
    except OSError:
        return None
    _bind(lib)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and probed at the first call; None when it
    cannot be. The probe runs in a throwaway process before this one loads
    the library: a library built with -march=native on another host dies
    of SIGILL, which no process survives, and is then rebuilt here."""
    global _LIB, _LOAD_FAILED
    if _LIB is not None or _LOAD_FAILED:
        return _LIB
    ok = build() and bool(os.environ.get("FASTDSP_NO_PROBE") or _probe_subprocess()
                          or (build(force=True) and _probe_subprocess()))
    _LIB = _open() if ok else None
    _LOAD_FAILED = _LIB is None
    return _LIB


def _selftest() -> bool:
    """The SIMD-heavy entry point on a tiny input (inside the probe
    process: a SIGILL kills that process, not the caller)."""
    m = stft_mel_native(np.random.RandomState(0).randn(4096).astype(np.float32), n_threads=1)
    return bool(np.isfinite(m).all())


def _probe_subprocess() -> bool:
    code = ("import os, sys; sys.path.insert(0, %r); os.environ['FASTDSP_NO_PROBE'] = '1'; "
            "from speech_editing_tpu_torch.utils.audio import native; "
            "sys.exit(0 if native._selftest() else 1)") % os.path.dirname(_PKG)
    try:
        return subprocess.run([sys.executable, "-c", code], timeout=120,
                              capture_output=True).returncode == 0
    except (subprocess.SubprocessError, OSError):
        return False


def available() -> bool:
    return _load() is not None


def _n_threads(n_threads: Optional[int]) -> int:
    return n_threads if n_threads else max(os.cpu_count() or 1, 1)


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native DSP library unavailable: g++ could not build {SRC_PATH}, "
                           "or the library did not load")
    return lib


def stft_mel_native(wav: np.ndarray, fft_size: int = 1024, hop_size: int = 256,
                    win_length: int = 1024, num_mels: int = 80, fmin: float = 80,
                    fmax: float = -1, eps: float = 1e-6, sample_rate: int = 22050,
                    want_linear: bool = False, n_threads: Optional[int] = None,
                    window: Optional[np.ndarray] = None,
                    mel_basis: Optional[np.ndarray] = None):
    """log10-mel [T, n_mels] (+ the linear magnitude [T, n_bins] with
    ``want_linear``): the STFT -> mel core of ``dsp.py::wav2spec``. Callers
    in a loop pass the ``window`` and ``mel_basis``."""
    lib = _lib()
    from speech_editing_tpu_torch.utils.audio.dsp import mel_filterbank, stft_window

    wav = np.ascontiguousarray(wav, np.float32)
    if window is None:
        window = stft_window("hann", win_length, fft_size)
    window = np.ascontiguousarray(window, np.float64)
    if mel_basis is None:
        fmin = 0 if fmin == -1 else fmin
        fmax = sample_rate / 2 if fmax == -1 else fmax
        mel_basis = mel_filterbank(sample_rate, fft_size, num_mels, fmin, fmax)
    fb = np.ascontiguousarray(mel_basis, np.float64)
    t = int(lib.fastdsp_num_frames(len(wav), hop_size))
    mel = np.empty((t, num_mels), np.float32)
    lin = np.empty((t, fft_size // 2 + 1), np.float32) if want_linear else None
    lin_ptr = lin.ctypes.data_as(ctypes.c_void_p) if want_linear else None
    calls["stft_mel"] += 1
    rc = lib.fastdsp_stft_mel(wav, len(wav), fft_size, hop_size, window, fb, num_mels, eps,
                              mel, lin_ptr, _n_threads(n_threads))
    if rc != t:
        raise RuntimeError(f"fastdsp_stft_mel failed: rc={rc}, expected {t} frames")
    return (mel, lin) if want_linear else mel


def autocorr_pitch_native(wav: np.ndarray, hop_size: int, sample_rate: int,
                          f0_min: float = 75, f0_max: float = 800,
                          voicing_threshold: float = 0.45,
                          n_threads: Optional[int] = None) -> np.ndarray:
    """f0 per frame (``len(wav) // hop_size`` values, 0 where unvoiced):
    ``pitch.py::autocorr_pitch`` in C++."""
    lib = _lib()
    wav = np.ascontiguousarray(wav, np.float32)
    n_frames = len(wav) // hop_size
    out = np.zeros(n_frames, np.float32)
    if n_frames == 0:
        return out
    win = min(int(round(3.0 / f0_min * sample_rate)), len(wav))
    lag_min = max(2, int(sample_rate / f0_max))
    lag_max = min(win - 2, int(sample_rate / f0_min))
    if lag_max <= lag_min:
        return out
    window = np.hanning(win).astype(np.float64)
    nfft = int(2 ** np.ceil(np.log2(2 * win)))
    wac = np.fft.irfft(np.abs(np.fft.rfft(window, nfft)) ** 2, nfft)[: lag_max + 2]
    wac_norm = np.ascontiguousarray(np.maximum(wac / wac[0], 1e-6), np.float64)
    calls["autocorr_f0"] += 1
    rc = lib.fastdsp_autocorr_f0(wav, len(wav), hop_size, sample_rate, float(f0_min),
                                 float(f0_max), float(voicing_threshold), window, win,
                                 wac_norm, out, _n_threads(n_threads))
    if rc != n_frames:
        raise RuntimeError(f"fastdsp_autocorr_f0 failed: rc={rc}, expected {n_frames} frames")
    return out
