"""PyTorch port, host and sequence ops: parity with the JAX package on CPU.

Inputs are made with numpy and fed to both; float32 tolerances are
atol=rtol=1e-4 (summation order differs between XLA and ATen) unless a
test states otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.ops import diffusion as jdiff
from speech_editing_tpu.ops import pitch as jpitch
from speech_editing_tpu.ops import seq_ops as jseq
from speech_editing_tpu.utils.audio import dsp as jdsp
from speech_editing_tpu.utils.audio import pitch as japitch
from speech_editing_tpu_torch.ops import diffusion as tdiff
from speech_editing_tpu_torch.ops import pitch as tpitch
from speech_editing_tpu_torch.ops import seq_ops as tseq
from speech_editing_tpu_torch.utils.audio import dsp as tdsp
from speech_editing_tpu_torch.utils.audio import pitch as tapitch
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=1e-4, rtol=1e-4)


def test_dsp_constants_match():
    np.testing.assert_allclose(tdsp.stft_window("hann", 1024, 1024),
                               jdsp.stft_window("hann", 1024, 1024), atol=1e-12)
    np.testing.assert_allclose(tdsp.stft_window("hann", 800, 1024),
                               jdsp.stft_window("hann", 800, 1024), atol=1e-12)
    np.testing.assert_array_equal(
        tdsp.mel_filterbank(22050, 1024, 80, 55.0, 7600.0),
        jdsp.mel_filterbank(22050, 1024, 80, 55.0, 7600.0))


def test_seq_ops_match(rng):
    b, s, t = 3, 9, 40
    tokens = rng.randint(1, 20, (b, s))
    tokens[1, 6:] = 0
    np.testing.assert_array_equal(
        tseq.make_positions(torch.tensor(tokens)).numpy(),
        np.asarray(jseq.make_positions(jnp.asarray(tokens))))
    dur = rng.rand(b, s).astype(np.float32) * 6
    dur[0, 0] = 2.5  # half-to-even rounding
    pad = tokens == 0
    np.testing.assert_array_equal(
        tseq.length_regulator(torch.tensor(dur), t, torch.tensor(pad)).numpy(),
        np.asarray(jseq.length_regulator(jnp.asarray(dur), t, jnp.asarray(pad))))
    mel2ph = np.clip(np.sort(rng.randint(0, s + 3, (b, t)), axis=1), 0, s + 2)
    h = rng.randn(b, s, 5).astype(np.float32)
    np.testing.assert_allclose(
        tseq.expand_states(torch.tensor(h), torch.tensor(mel2ph)).numpy(),
        np.asarray(jseq.expand_states(jnp.asarray(h), jnp.asarray(mel2ph))),
        atol=0, rtol=0)
    np.testing.assert_array_equal(
        tseq.mel2token_to_dur(torch.tensor(mel2ph), s).numpy(),
        np.asarray(jseq.mel2token_to_dur(jnp.asarray(mel2ph), s)))
    assert tseq.clip_mel2token_to_multiple(torch.tensor(mel2ph), 8).shape == (b, 40)


@pytest.mark.parametrize("schedule", ["vpsde", "linear", "cosine"])
def test_diffusion_schedule_and_posterior_match(rng, schedule):
    js = jdiff.DiffusionSchedule.create(schedule, timesteps=8)
    ts = tdiff.DiffusionSchedule.create(schedule, timesteps=8)
    for name in ("betas", "alphas_cumprod", "posterior_mean_coef1",
                 "posterior_mean_coef2", "posterior_log_variance_clipped"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), err_msg=name)
    x0, xt, noise = (rng.randn(2, 7, 80).astype(np.float32) for _ in range(3))
    t = np.array([0, 5])
    out_t = tdiff.q_posterior_sample(ts, torch.tensor(x0), torch.tensor(xt),
                                     torch.tensor(t), torch.tensor(noise))
    out_j = jdiff.q_posterior_sample(js, jnp.asarray(x0), jnp.asarray(xt),
                                     jnp.asarray(t), noise=jnp.asarray(noise))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    t = np.array([-1, 3])
    out_t = tdiff.diffuse(ts, torch.tensor(x0), torch.tensor(t), torch.tensor(noise))
    out_j = jdiff.diffuse(js, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


def test_f0_to_coarse_and_denorm_match(rng):
    f0 = np.concatenate([[0.0, 50.0, 900.0, 1200.0, 30.0],
                         rng.rand(200) * 700 + 40]).astype(np.float32)
    np.testing.assert_array_equal(
        tapitch.f0_to_coarse(torch.tensor(f0)).numpy(),
        np.asarray(japitch.f0_to_coarse(jnp.asarray(f0))))
    lf0 = (rng.rand(2, 30) * 4 + 5).astype(np.float32)
    uv = (rng.rand(2, 30) > 0.7).astype(np.float32)
    pad = rng.rand(2, 30) > 0.8
    np.testing.assert_allclose(
        tapitch.denorm_f0(torch.tensor(lf0), torch.tensor(uv),
                          pitch_padding=torch.tensor(pad)).numpy(),
        np.asarray(japitch.denorm_f0(jnp.asarray(lf0), jnp.asarray(uv),
                                     pitch_padding=jnp.asarray(pad))), **TOL)


def _harmonic_wav(rs, n_frames, hop=256, sr=22050):
    """A harmonic tone with a gliding f0, interrupted by two noise bursts.
    (Digital silence is left out: with a zero frame energy the tracker's
    normalised autocorrelation is ill-conditioned in both frameworks.)"""
    n = n_frames * hop
    t_ax = np.arange(n) / sr
    f0 = 140 + 60 * np.sin(2 * np.pi * 0.7 * t_ax)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(0.3 / k * np.sin(k * phase) for k in (1, 2, 3))
    for start in (n // 3, 2 * n // 3):
        wav[start: start + 8 * hop] = 0.05 * rs.randn(8 * hop)
    return wav.astype(np.float32)


def test_extract_pitch_matches(rng):
    wav = _harmonic_wav(rng, 96)
    f0_t = tpitch.extract_pitch(torch.tensor(wav)).numpy()
    f0_j = np.asarray(jpitch.extract_pitch_jax(jnp.asarray(wav)))
    assert f0_t.shape == f0_j.shape == (96,)
    voiced = f0_j > 0
    assert voiced.sum() > 40 and (~voiced).sum() > 5
    np.testing.assert_array_equal(f0_t > 0, voiced)
    np.testing.assert_allclose(f0_t[voiced], f0_j[voiced], rtol=1e-4)
    # what the conditioner sees: interpolated log-f0 and its coarse bins
    lf_t, uv_t = tpitch.norm_interp_f0(torch.tensor(f0_t))
    lf_j, uv_j = jpitch.norm_interp_f0_jax(jnp.asarray(f0_j))
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))
    np.testing.assert_allclose(lf_t.numpy(), np.asarray(lf_j), **TOL)
    coarse_t = tapitch.f0_to_coarse(tapitch.denorm_f0(lf_t, uv_t))
    coarse_j = japitch.f0_to_coarse(japitch.denorm_f0(lf_j, uv_j))
    np.testing.assert_array_equal(coarse_t.numpy(), np.asarray(coarse_j))


def test_extract_pitch_even_frame_median():
    # an even frame count: the voicing floor uses the mean of the middle pair
    x = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert float(tpitch._median(x)) == float(jnp.median(jnp.asarray(x.numpy())))


@pytest.mark.parametrize("pattern", ["gaps", "edges", "none_voiced", "all_voiced"])
def test_interp_unvoiced_matches(rng, pattern):
    f0 = (rng.rand(40) * 3 + 6).astype(np.float32)
    if pattern == "gaps":
        f0[5:9] = 0
        f0[20:31] = 0
    elif pattern == "edges":
        f0[:4] = 0
        f0[35:] = 0
    elif pattern == "none_voiced":
        f0[:] = 0
    np.testing.assert_allclose(
        tpitch.interp_unvoiced(torch.tensor(f0)).numpy(),
        np.asarray(jpitch.interp_unvoiced_jax(jnp.asarray(f0))), **TOL)
