"""PyTorch port, vocoder and the whole region edit against the JAX package.

The whole edit is ``bench.py``'s ``edit_body`` at a tiny size: log-mel
(the Pallas kernel, interpret mode) and f0 of a harmonic wav, the masked
conditioner, the reverse diffusion under per-row keys (whose draws are
injected into the port), the composite and HiFi-GAN. Weights go across
with ``params_from_jax`` / ``vocoder_params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.models.spec_denoiser.spec_denoiser import \
    GaussianDiffusion as JGD
from speech_editing_tpu.models.vocoder import HifiGanGenerator as JHifiGan
from speech_editing_tpu.ops.diffusion import per_row_noise
from speech_editing_tpu.ops.mel import MelConfig as JMelConfig
from speech_editing_tpu.ops.pallas.mel_kernel import mel_spectrogram_pallas
from speech_editing_tpu.ops.pitch import extract_pitch_jax, norm_interp_f0_jax
from speech_editing_tpu.utils.convert_torch_ckpt import convert_hifigan_generator
from speech_editing_tpu_torch.infer.edit import EditPipeline
from speech_editing_tpu_torch.models.vocoder.hifigan import HifiGanGenerator
from speech_editing_tpu_torch.ops.mel import mel_spectrogram
from speech_editing_tpu_torch.utils.convert_jax_params import (
    params_from_jax, vocoder_params_from_jax)
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

VHP = {"upsample_rates": [4, 4], "upsample_kernel_sizes": [8, 8],
       "upsample_initial_channel": 16, "resblock": "2",
       "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]]}
VHP1 = {"upsample_rates": [4, 2], "upsample_kernel_sizes": [8, 4],
        "upsample_initial_channel": 16, "resblock": "1",
        "resblock_kernel_sizes": [3, 5], "resblock_dilation_sizes": [[1, 3], [1, 3]]}
HP = {
    "hidden_size": 32, "enc_layers": 1, "enc_ffn_kernel_size": 5, "num_heads": 2,
    "encoder_type": "fft", "decoder_type": "fft", "dec_layers": 1,
    "dec_ffn_kernel_size": 5, "audio_num_mel_bins": 80, "dur_predictor_layers": 1,
    "predictor_dropout": 0.2, "dur_predictor_kernel": 5, "predictor_kernel": 5,
    "use_pitch_embed": True, "use_spk_embed": False, "use_spk_id": False,
    "predictor_grad": 0.1, "residual_layers": 2, "residual_channels": 16,
    "dilation_cycle_length": 1, "timesteps": 2, "timescale": 1,
    "schedule_type": "vpsde", "frames_multiple": 1, "use_uv": True,
    "pitch_type": "frame",
}


def _randomize(params, seed, scale=0.1):
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rs.randn(*a.shape).astype(np.float32), params)


@pytest.mark.parametrize("vhp", [VHP, VHP1], ids=["resblock2", "resblock1"])
def test_hifigan_matches(vhp):
    mel = (np.random.RandomState(0).randn(2, 21, 80) * 0.5).astype(np.float32)
    jg = JHifiGan(hp=vhp)
    params = _randomize(jax.jit(jg.init)(jax.random.PRNGKey(0), jnp.asarray(mel))["params"],
                        1, 0.05)
    ref = np.asarray(jax.jit(jg.apply)({"params": params}, jnp.asarray(mel)))
    tg = HifiGanGenerator(vhp)
    tg.load_state_dict(vocoder_params_from_jax(params, vhp))
    with torch.no_grad():
        out = tg(torch.tensor(mel)).numpy()
    assert out.shape == ref.shape == (2, 21 * int(np.prod(vhp["upsample_rates"])))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("vhp", [VHP, VHP1], ids=["resblock2", "resblock1"])
def test_vocoder_state_dict_round_trip(vhp):
    torch.manual_seed(0)
    sd = {k: v.numpy() for k, v in HifiGanGenerator(vhp).state_dict().items()}
    back = vocoder_params_from_jax(convert_hifigan_generator(sd, vhp), vhp)
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


def test_whole_tiny_edit_matches_with_injected_noise():
    rs = np.random.RandomState(0)
    t, s, vocab, hop, sr = 32, 8, 40, 256, 22050
    t_ax = np.arange(t * hop) / sr
    # eight harmonics over a noise floor: every mel bin has energy, so both
    # float32 DFTs agree to ~1e-5 in log10 (a pure tone leaves bins near the
    # eps floor, where they differ by up to the mel tests' 2e-2)
    wav = (sum(0.3 / k * np.sin(2 * np.pi * 180 * k * t_ax) for k in range(1, 9))
           * (1 + 0.3 * np.sin(2 * np.pi * 3 * t_ax))
           + 0.02 * rs.randn(t * hop)).astype(np.float32)[None]
    txt = rs.randint(1, vocab, (1, s))
    mel2ph = np.clip(np.sort(rs.randint(1, s + 1, (1, t))), 1, s)
    mask = np.zeros((1, t, 1), np.float32)
    mask[:, t // 3: 2 * t // 3] = 1.0

    # JAX: bench.py's edit_body with per-row keys
    cfg = JMelConfig()
    model, voc = JGD(vocab_size=vocab, hp=HP, out_dims=80), JHifiGan(hp=VHP)
    mel0 = mel_spectrogram_pallas(jnp.asarray(wav), cfg)[:, :t]
    f0_hz = extract_pitch_jax(jnp.asarray(wav[0]), hop, sr, 80.0, 600.0)[:t]
    f0n, uvn = norm_interp_f0_jax(f0_hz)
    jargs = (jnp.asarray(txt), jnp.asarray(mask), jnp.asarray(mel2ph), None, mel0,
             f0n[None], uvn[None])
    params = _randomize(jax.jit(model.init)(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        *jargs)["params"], 2)
    vparams = _randomize(jax.jit(voc.init)(jax.random.PRNGKey(2), mel0)["params"], 3, 0.05)
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(7), 0)])
    out = jax.jit(lambda p, *a: model.apply(p, *a, infer=True, rng=keys))(
        {"params": params}, *jargs)
    comp_ref = out["mel_out"] * mask + mel0 * (1 - mask)
    wav_ref = voc.apply({"params": vparams}, comp_ref)

    pipe = EditPipeline(HP, VHP, device="cpu", vocab_size=vocab)
    pipe.model.load_state_dict(params_from_jax(params, HP))
    pipe.vocoder.load_state_dict(vocoder_params_from_jax(vparams, VHP))
    noise = [torch.tensor(np.asarray(per_row_noise(keys, step, (t, 80))))
             for step in range(HP["timesteps"], -1, -1)]
    wav_out, mel_out = pipe(torch.tensor(wav), torch.tensor(txt), torch.tensor(mel2ph),
                            torch.tensor(mask), noise=noise)
    np.testing.assert_allclose(mel_out.numpy(), np.asarray(comp_ref), atol=1e-3)
    np.testing.assert_allclose(wav_out.numpy(), np.asarray(wav_ref), atol=1e-3)
    keep = mask[0, :, 0] == 0   # frames outside the edit are the source mel
    source = mel_spectrogram(torch.tensor(wav), pipe.mel_cfg)[:, :t]
    torch.testing.assert_close(mel_out[0, keep], source[0, keep], rtol=0, atol=0)


def test_edit_pipeline_seeded_weights_are_reproducible():
    a = EditPipeline(HP, VHP, device="cpu", seed=3)
    b = EditPipeline(HP, VHP, device="cpu", seed=3)
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    c = EditPipeline(HP, VHP, device="cpu", seed=4)
    assert not torch.equal(a.vocoder.conv_pre.weight, c.vocoder.conv_pre.weight)
