"""PyTorch port, the host audio tools of the offline pipeline against the
JAX package on CPU: the silence trimmer and ``wav2spec(trim_long_sil=True)``,
``wav2spec``'s ``backend`` (``native`` raises where JAX's does: a window or
FFT size the C++ library does not take, or no library), the
``autocorr_native`` pitch-tracker key (the C++ tracker), the CWT
forward half, and the wav processors with ``sox`` absent."""

import shutil

import numpy as np
import pytest

from speech_editing_tpu.data import wav_processors as jwp
from speech_editing_tpu.utils.audio import cwt as jcwt
from speech_editing_tpu.utils.audio import dsp as jdsp
from speech_editing_tpu.utils.audio import pitch as jpitch
from speech_editing_tpu.utils.audio import vad as jvad
from speech_editing_tpu_torch.data import wav_processors as twp
from speech_editing_tpu_torch.utils.audio import cwt as tcwt
from speech_editing_tpu_torch.utils.audio import dsp as tdsp
from speech_editing_tpu_torch.utils.audio import native
from speech_editing_tpu_torch.utils.audio import pitch as tpitch
from speech_editing_tpu_torch.utils.audio import vad as tvad
from speech_editing_tpu_torch.utils.audio.io import save_wav
from tests.test_torch_bf16_families import one_thread  # noqa: F401  (autouse fixture)

SR = 22050


def speech_with_pauses(seed):
    """Voiced bursts of 0.3-0.8 s between silences of 0.1-1.5 s."""
    rs = np.random.RandomState(seed)
    parts = []
    for _ in range(5):
        n = int(rs.uniform(0.3, 0.8) * SR)
        t = np.arange(n) / SR
        parts.append(0.3 * np.sin(2 * np.pi * rs.uniform(100, 250) * t))
        parts.append(1e-4 * rs.randn(int(rs.uniform(0.1, 1.5) * SR)))
    return np.concatenate(parts).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trim_long_silences_matches_jax(seed):
    wav = speech_with_pauses(seed)
    out = tvad.trim_long_silences(wav, SR)
    np.testing.assert_array_equal(out, jvad.trim_long_silences(wav, SR))
    assert len(out) < len(wav)
    short = wav[:100]
    np.testing.assert_array_equal(tvad.trim_long_silences(short, SR), short)


def test_wav2spec_trims_long_silences_of_a_file_as_jax_does(tmp_path):
    fn = str(tmp_path / "pauses.wav")
    save_wav(speech_with_pauses(3), fn, SR)
    got = tdsp.wav2spec(fn, fmin=55, fmax=7600, trim_long_sil=True)
    ref = jdsp.wav2spec(fn, fmin=55, fmax=7600, trim_long_sil=True, backend="numpy")
    untrimmed = tdsp.wav2spec(fn, fmin=55, fmax=7600)
    assert got["mel"].shape == ref["mel"].shape and len(got["mel"]) < len(untrimmed["mel"])
    for k in ("wav", "mel", "linear"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=0, err_msg=k)


def test_wav2spec_backends():
    wav = speech_with_pauses(4)[:SR]
    ref = jdsp.wav2spec(wav, backend="numpy")
    for backend in ("numpy", "auto"):
        got = tdsp.wav2spec(wav, backend=backend)
        np.testing.assert_allclose(got["mel"], ref["mel"], atol=1e-5, rtol=0)
    for kw in ({"window": "hamming"}, {"fft_size": 1000, "win_length": 1000}):
        with pytest.raises(RuntimeError, match="backend='native' unavailable: unsupported"):
            tdsp.wav2spec(wav, backend="native", **kw)
        with pytest.raises(RuntimeError, match="backend='native' unavailable: unsupported"):
            jdsp.wav2spec(wav, backend="native", **kw)
    if native.available():
        got = tdsp.wav2spec(wav, backend="native")
        np.testing.assert_array_equal(got["mel"], tdsp.wav2spec(wav, backend="auto")["mel"])
        np.testing.assert_allclose(got["mel"], ref["mel"], atol=1e-5, rtol=0)
    else:
        with pytest.raises(RuntimeError, match="library not built"):
            tdsp.wav2spec(wav, backend="native")


def test_autocorr_native_key_is_the_numpy_tracker():
    wav = speech_with_pauses(5)
    got = tpitch.extract_pitch("autocorr_native", wav, 256, SR, f0_min=80, f0_max=600)
    numpy_f0 = tpitch.extract_pitch("autocorr", wav, 256, SR, f0_min=80, f0_max=600)
    if native.available():      # the C++ tracker: the numpy one's voicing, its f0 within 1e-3
        np.testing.assert_array_equal(got, native.autocorr_pitch_native(wav, 256, SR, 80, 600))
        np.testing.assert_array_equal(got > 0, numpy_f0 > 0)
        np.testing.assert_allclose(got, numpy_f0, atol=1e-3, rtol=0)
    else:
        np.testing.assert_array_equal(got, numpy_f0)
    np.testing.assert_allclose(
        got, jpitch.extract_pitch("autocorr_native", wav, 256, SR, f0_min=80, f0_max=600),
        atol=1e-3, rtol=1e-5)
    assert (got > 0).any()
    np.testing.assert_array_equal(tpitch.f0_to_coarse_host(got), jpitch.f0_to_coarse(got))


def test_cwt_forward_matches_jax():
    rs = np.random.RandomState(0)
    f0 = np.where(rs.rand(300) < 0.7, 120 + 40 * np.sin(np.arange(300) / 20), 0.0)
    for fn in ("cwt_mexh", "get_lf0_cwt"):
        w, scales = getattr(tcwt, fn)(np.log(f0 + 100))
        jw, jscales = getattr(jcwt, fn)(np.log(f0 + 100))
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(scales, jscales)
    for a, b in zip(tcwt.get_cont_lf0(f0), jcwt.get_cont_lf0(f0)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tcwt.get_cont_lf0(np.zeros(10)), jcwt.get_cont_lf0(np.zeros(10))):
        np.testing.assert_array_equal(a, b)
    w = rs.randn(50, 10)
    for a, b in zip(tcwt.norm_scale(w), jcwt.norm_scale(w)):
        np.testing.assert_array_equal(a, b)
    got, ref = tcwt.f0_to_cwt(f0), jcwt.f0_to_cwt(f0)
    assert sorted(got) == sorted(ref) and got["cwt_spec"].shape == (300, 10)
    np.testing.assert_array_equal(got["cwt_spec"], ref["cwt_spec"])
    assert (got["cwt_mean"], got["cwt_std"]) == (ref["cwt_mean"], ref["cwt_std"])


def test_wav_processors_pass_through_without_sox(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    names = ["sox_to_wav", "sox_resample", "trim_sil", "no_such_stage"]
    outs = []
    for mod in (jwp, twp):
        fn = mod.run_wav_processors("in.wav", str(tmp_path), names)
        outs.append((fn, capsys.readouterr().out))
    assert outs[0] == outs[1] and outs[1][0] == "in.wav"
    assert outs[1][1].count("sox not installed") == 3 and "unknown" in outs[1][1]
    assert sorted(twp.WAV_PROCESSORS) == sorted(jwp.WAV_PROCESSORS)
    proc = twp.get_wav_processor_cls("sox_resample")()
    assert proc.output_fn("/a/b/x.flac", "/t") == jwp.ResampleProcessor().output_fn(
        "/a/b/x.flac", "/t")
    assert twp.get_wav_processor_cls("sox_to_wav")().process("x.wav", "/t") == "x.wav"
