"""PyTorch port, the native DSP library (``speech_editing_tpu_torch/native/
fastdsp.cpp`` through ``utils/audio/native.py``): bit for bit the JAX
package's library built from the same source with the same flags, and
against the port's numpy path at the JAX package's own bars
(``tests/test_native_dsp.py``): mel bit-equal, linear 1e-4, f0 1e-3 with
identical voicing, 1 and 4 threads identical, short and empty inputs.
Skips without ``g++``."""

import shutil

import numpy as np
import pytest

from speech_editing_tpu.utils.audio import dsp as jdsp
from speech_editing_tpu.utils.audio import native as jnative
from speech_editing_tpu_torch.data.binarizer import BaseBinarizer
from speech_editing_tpu_torch.utils.audio import dsp as tdsp
from speech_editing_tpu_torch.utils.audio import native
from speech_editing_tpu_torch.utils.audio.pitch import autocorr_pitch, extract_pitch
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

SR = 22050


@pytest.fixture(scope="module")
def built():
    if shutil.which("g++") is None or not native.build():
        pytest.skip("g++ unavailable: the native DSP library is not built")
    assert native.available()


def _wav(dur=2.5, seed=0):
    t = np.arange(int(SR * dur)) / SR
    rs = np.random.RandomState(seed)
    wav = (0.4 * np.sin(2 * np.pi * 180 * t * (1 + 0.1 * np.sin(2 * np.pi * 0.7 * t)))
           + 0.01 * rs.randn(len(t)))
    return wav.astype(np.float32)


def test_library_is_built_in_the_port_and_not_in_native(built):
    assert native.SO_PATH.endswith("speech_editing_tpu_torch/_build/libfastdsp.so")
    assert native.SRC_PATH.endswith("speech_editing_tpu_torch/native/fastdsp.cpp")
    assert native.CXX_FLAGS == ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
                                "-pthread"]


def test_bit_equal_to_the_jax_package_library(built):
    if not jnative.build():
        pytest.skip("the JAX package's native library did not build")
    wav = _wav(1.5, seed=7)
    mel, lin = native.stft_mel_native(wav, 1024, 256, 1024, 80, 55, 7600, want_linear=True)
    jmel, jlin = jnative.stft_mel_native(wav, 1024, 256, 1024, 80, 55, 7600, want_linear=True)
    np.testing.assert_array_equal(mel, jmel)
    np.testing.assert_array_equal(lin, jlin)
    f0 = native.autocorr_pitch_native(wav, 256, SR, 80, 600)
    np.testing.assert_array_equal(f0, jnative.autocorr_pitch_native(wav, 256, SR, 80, 600))
    got = tdsp.wav2spec(wav, fmin=55, fmax=7600, backend="native")
    ref = jdsp.wav2spec(wav, fmin=55, fmax=7600, backend="native")
    for k in ("wav", "mel", "linear", "mel_basis"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_stft_mel_against_the_numpy_path(built):
    wav = _wav()
    ref = tdsp.wav2spec(wav, fft_size=1024, hop_size=256, win_length=1024, num_mels=80,
                        fmin=55, fmax=7600)
    mel, lin = native.stft_mel_native(wav, 1024, 256, 1024, 80, 55, 7600, want_linear=True)
    assert mel.shape == ref["mel"].shape
    np.testing.assert_array_equal(mel, ref["mel"])
    np.testing.assert_allclose(lin, 10.0 ** ref["linear"], atol=1e-4)
    # the port's numpy path against JAX's: read 0.0 on this input (bit-equal)
    jref = jdsp.wav2spec(wav, fmin=55, fmax=7600, backend="numpy")
    assert float(np.abs(ref["mel"] - jref["mel"]).max()) <= 4.8e-7


def test_wav2spec_native_backend(built):
    wav = _wav(1.5, seed=3)
    a = tdsp.wav2spec(wav, fmin=55, fmax=7600, backend="numpy")
    b = tdsp.wav2spec(wav, fmin=55, fmax=7600, backend="native")
    np.testing.assert_array_equal(a["mel"], b["mel"])
    np.testing.assert_array_equal(a["wav"], b["wav"])
    np.testing.assert_allclose(a["linear"], b["linear"], atol=1e-5)
    c = tdsp.wav2spec(wav, fmin=55, fmax=7600, backend="auto")
    np.testing.assert_array_equal(a["mel"], c["mel"])


def test_autocorr_f0_against_the_numpy_tracker(built):
    wav = _wav(2.0, seed=1)
    ref = autocorr_pitch(wav, 256, SR, f0_min=80, f0_max=600)
    nat = native.autocorr_pitch_native(wav, 256, SR, 80, 600)
    assert nat.shape == ref.shape
    np.testing.assert_array_equal(nat > 0, ref > 0)
    np.testing.assert_allclose(nat, ref, atol=1e-3)
    before = native.calls["autocorr_f0"]
    key = extract_pitch("autocorr_native", wav, 256, SR, f0_min=80, f0_max=600)
    assert native.calls["autocorr_f0"] == before + 1
    np.testing.assert_array_equal(key, nat)


def test_threading_consistency(built):
    wav = _wav(3.0, seed=4)
    a = native.stft_mel_native(wav, 1024, 256, 1024, 80, 55, 7600, n_threads=1)
    b = native.stft_mel_native(wav, 1024, 256, 1024, 80, 55, 7600, n_threads=4)
    np.testing.assert_array_equal(a, b)
    pa = native.autocorr_pitch_native(wav, 256, SR, 80, 600, n_threads=1)
    pb = native.autocorr_pitch_native(wav, 256, SR, 80, 600, n_threads=4)
    np.testing.assert_array_equal(pa, pb)


def test_short_and_empty_inputs(built):
    assert native.autocorr_pitch_native(np.zeros(100, np.float32), 256, SR).shape == (0,)
    assert native.autocorr_pitch_native(np.zeros(0, np.float32), 256, SR).shape == (0,)
    mel = native.stft_mel_native(np.zeros(1000, np.float32), 1024, 256, 1024, 80, 55, 7600)
    assert mel.shape[0] == 1 + 1000 // 256
    assert np.all(np.isfinite(mel))


def test_binarizer_auto_backend_takes_the_library(built, tmp_path):
    """The binarizer's audio step with its default ``dsp_backend`` (auto)
    runs the library's mel (counted, not assumed), bit-equal to the numpy
    backend's."""
    from speech_editing_tpu_torch.utils.audio.io import save_wav

    fn = str(tmp_path / "item.wav")
    save_wav(_wav(1.0, seed=5), fn, SR)
    p = dict(fft_size=1024, hop_size=256, win_size=1024, audio_num_mel_bins=80, fmin=55,
             fmax=7600, audio_sample_rate=SR, loud_norm=False)
    before = native.calls["stft_mel"]
    res: dict = {}
    BaseBinarizer.process_audio(fn, res, p)
    assert native.calls["stft_mel"] == before + 1
    numpy_res: dict = {}
    BaseBinarizer.process_audio(fn, numpy_res, dict(p, dsp_backend="numpy"))
    assert native.calls["stft_mel"] == before + 1
    np.testing.assert_array_equal(res["mel"], numpy_res["mel"])


def test_unavailable_library_raises_for_native_and_falls_back_for_auto(monkeypatch):
    wav = _wav(0.5, seed=6)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LOAD_FAILED", True)
    assert not native.available()
    with pytest.raises(RuntimeError, match="library not built"):
        tdsp.wav2spec(wav, backend="native")
    with pytest.raises(RuntimeError, match="native DSP library unavailable"):
        native.stft_mel_native(wav)
    np.testing.assert_array_equal(tdsp.wav2spec(wav, backend="auto")["mel"],
                                  tdsp.wav2spec(wav, backend="numpy")["mel"])
    np.testing.assert_array_equal(extract_pitch("autocorr_native", wav, 256, SR),
                                  extract_pitch("autocorr", wav, 256, SR))
