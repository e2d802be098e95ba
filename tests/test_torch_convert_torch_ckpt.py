"""PyTorch port, released reference checkpoints (``utils/convert_torch_ckpt.py``)
against the JAX package's converter, on CPU.

Reference-layout state dicts are built from seeded tensors: weight-normed
(``weight_g``/``weight_v``) where the reference is, with the weights the
converters drop (diffusion schedule buffers, a conditioner's decoder). The
JAX package's ``convert_*`` followed by its forward equals the port's
converter followed by the port's forward within 1e-4 (HiFi-GAN, FastSpeech),
the whole FluentSpeech edit within 1e-3; the converted state dicts equal the
JAX trees carried across by ``convert_jax_params`` (1e-6: the weight-norm
fold's sums run in another order). ``load_torch_checkpoint`` reads both of
the reference trainer's nestings; a missing, unknown or misshapen key
raises; the command line writes a work dir the port's HiFi-GAN loads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.models.spec_denoiser.spec_denoiser import GaussianDiffusion as JGD
from speech_editing_tpu.models.vocoder import HifiGanGenerator as JHifiGan
from speech_editing_tpu.ops.diffusion import per_row_noise
from speech_editing_tpu.ops.mel import MelConfig as JMelConfig
from speech_editing_tpu.ops.pallas.mel_kernel import mel_spectrogram_pallas
from speech_editing_tpu.ops.pitch import extract_pitch_jax, norm_interp_f0_jax
from speech_editing_tpu.training.tasks.tts import FastSpeechTask as JFastSpeechTask
from speech_editing_tpu.utils import convert_torch_ckpt as jconv
from speech_editing_tpu_torch.config.hparams import dump_yaml
from speech_editing_tpu_torch.infer.edit import EditPipeline
from speech_editing_tpu_torch.infer.vocoder import HifiGAN
from speech_editing_tpu_torch.models.fs import FastSpeech
from speech_editing_tpu_torch.models.spec_denoiser.spec_denoiser import GaussianDiffusion
from speech_editing_tpu_torch.models.vocoder.hifigan import HifiGanGenerator
from speech_editing_tpu_torch.utils import convert_jax_params as cjp
from speech_editing_tpu_torch.utils import convert_torch_ckpt as conv
from speech_editing_tpu_torch.utils.init import init_like_flax
from tests.test_torch_edit import HP as EDIT_HP
from tests.test_torch_edit import VHP1
from tests.test_torch_tts_fs import HP as TTS_HP
from tests.test_torch_tts_fs import VOCAB as TTS_VOCAB
from tests.test_torch_tts_fs import jax_batch, torch_batch, tts_batch
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=1e-4, rtol=1e-4)
EDIT_VOCAB = 40


def seeded(model: torch.nn.Module, seed: int, scale: float = 0.1) -> dict:
    """``model``'s state dict at flax's initial distributions plus seeded
    noise on every float tensor (flax zero-inits biases and DiffNet's output
    projection, which would hide parts of the graph), as numpy."""
    torch.manual_seed(seed)
    rs = np.random.RandomState(seed)
    sd = init_like_flax(model).state_dict()
    return {k: (v.numpy() + scale * rs.randn(*v.shape).astype(np.float32)
                if v.is_floating_point() else v.numpy()) for k, v in sd.items()}


def weight_normed(sd: dict, keys, seed: int) -> dict:
    """Each ``X.weight`` of ``keys`` as the reference's weight norm holds
    it: a seeded direction ``weight_v`` and a seeded gain ``weight_g``."""
    rs = np.random.RandomState(seed)
    out = {k: v for k, v in sd.items() if k not in keys}
    for k in keys:
        v = sd[k]
        prefix = k[: -len(".weight")]
        out[f"{prefix}.weight_v"] = rs.randn(*v.shape).astype(np.float32)
        out[f"{prefix}.weight_g"] = (0.2 + 0.3 * rs.rand(v.shape[0], *[1] * (v.ndim - 1))
                                     ).astype(np.float32)
    return out


def reference_hifigan(vhp: dict, seed: int) -> dict:
    sd = seeded(HifiGanGenerator(vhp), seed, 0.05)
    return weight_normed(sd, [k for k in sd if k.endswith(".weight")], seed + 1)


def reference_fluentspeech(hp: dict, seed: int) -> dict:
    """A FluentSpeech checkpoint's layout: the port's names plus the schedule
    buffers and the conditioner's unused decoder and ``mel_out``."""
    sd = seeded(GaussianDiffusion(EDIT_VOCAB, hp, 80), seed)
    rs = np.random.RandomState(seed + 1)
    for name in ("betas", "alphas_cumprod", "posterior_mean_coef1", "spec_min", "spec_max"):
        sd[name] = rs.rand(hp["timesteps"]).astype(np.float32)
    sd["fs.decoder.layers.0.op.layer_norm1.weight"] = np.ones(hp["hidden_size"], np.float32)
    sd["fs.mel_out.weight"] = rs.randn(80, hp["hidden_size"]).astype(np.float32)
    return sd


def assert_state_dicts_close(got: dict, want: dict, atol: float = 1e-6) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol, rtol=0, err_msg=k)


def test_weight_norm_fold_is_torchs():
    conv1 = torch.nn.utils.weight_norm(torch.nn.Conv1d(4, 6, 3))
    up = torch.nn.utils.weight_norm(torch.nn.ConvTranspose1d(6, 4, 4, 2))
    for m in (conv1, up):
        with torch.no_grad():
            m.weight_g.uniform_(0.5, 1.5)
        m(torch.randn(1, m.in_channels, 8))     # weight_norm recomputes .weight in forward
        sd = {k: v.detach() for k, v in m.state_dict().items()}
        folded = conv.fold_weight_norm(sd)
        assert "weight_g" not in folded and "weight_v" not in folded
        torch.testing.assert_close(folded["weight"], m.weight.detach(), atol=1e-6, rtol=1e-6)
    new = torch.nn.utils.parametrizations.weight_norm(torch.nn.Conv1d(4, 6, 3))
    folded = conv.fold_weight_norm(new.state_dict())
    assert sorted(folded) == ["bias", "weight"]
    torch.testing.assert_close(folded["weight"], new.weight.detach(), atol=1e-6, rtol=1e-6)


def test_batchnorm_fold_equals_eval_batchnorm():
    bn = torch.nn.BatchNorm1d(5).eval()
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.normal_()
        bn.running_var.uniform_(0.5, 2.0)
    sd = {k: v.clone() for k, v in bn.state_dict().items()}
    sd = {f"n.{k}": v for k, v in sd.items()}
    conv.fold_batchnorm(sd, "n")
    folded = torch.nn.BatchNorm1d(5).eval()
    folded.load_state_dict({k[2:]: v for k, v in sd.items()})
    x = torch.randn(3, 5)
    torch.testing.assert_close(folded(x), bn(x), atol=1e-6, rtol=1e-6)
    ref = jconv.fold_batchnorm({k: v.numpy() for k, v in
                                {f"n.{k}": v for k, v in bn.state_dict().items()}.items()}, "n")
    np.testing.assert_allclose(sd["n.weight"].numpy(), ref["scale"], atol=1e-7, rtol=0)
    np.testing.assert_allclose(sd["n.bias"].numpy(), ref["bias"], atol=1e-7, rtol=0)


@pytest.mark.parametrize("nesting", ["model_gen", "model", "bare"])
def test_load_torch_checkpoint_reads_the_reference_trainers_nestings(tmp_path, nesting):
    sd = {k: torch.tensor(v) for k, v in reference_hifigan(VHP1, 0).items()}
    payload = {"bare": sd, "model": {"state_dict": {"model": sd}, "global_step": 3},
               "model_gen": {"state_dict": {"model_gen": sd, "model_disc": {"x": torch.ones(1)}},
                             "optimizer_states": []}}[nesting]
    path = str(tmp_path / "model_ckpt_steps_3.ckpt")
    torch.save(payload, path)
    got = conv.load_torch_checkpoint(path)
    ref = jconv.load_torch_checkpoint(path)
    assert sorted(got) == sorted(ref) == sorted(sd)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


def test_missing_unknown_and_misshapen_keys_raise():
    sd = reference_hifigan(VHP1, 0)
    conv.convert_hifigan_generator(sd, VHP1)
    with pytest.raises(KeyError, match=r"missing \['conv_post.weight'\]"):
        conv.convert_hifigan_generator({k: v for k, v in sd.items()
                                        if not k.startswith("conv_post.weight")}, VHP1)
    with pytest.raises(KeyError, match=r"unknown \['m_source.l_linear.weight'\]"):
        conv.convert_hifigan_generator(dict(sd, **{"m_source.l_linear.weight": np.ones(2)}),
                                       VHP1)
    with pytest.raises(KeyError, match="conv_post.bias"):
        conv.convert_hifigan_generator(dict(sd, **{"conv_post.bias": np.ones(3, np.float32)}),
                                       VHP1)
    fluent = reference_fluentspeech(EDIT_HP, 0)
    with pytest.raises(KeyError, match="unknown"):
        conv.convert_gaussian_diffusion(dict(fluent, **{"fs.stray.weight": np.ones(1)}), EDIT_HP)
    # strict load of what a converter returns
    sd_port = conv.convert_gaussian_diffusion(fluent, EDIT_HP)
    GaussianDiffusion(EDIT_VOCAB, EDIT_HP, 80).load_state_dict(sd_port, strict=True)


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_hifigan_matches_jax_converter_and_forward(resblock):
    vhp = VHP1 if resblock == "1" else dict(VHP1, resblock="2")
    sd = reference_hifigan(vhp, 1)
    params = jconv.convert_hifigan_generator(sd, vhp)
    port_sd = conv.convert_hifigan_generator(sd, vhp)
    assert_state_dicts_close(port_sd, cjp.vocoder_params_from_jax(params, vhp))
    mel = (np.random.RandomState(0).randn(2, 21, 80) * 0.5).astype(np.float32)
    ref = np.asarray(jax.jit(JHifiGan(hp=vhp).apply)({"params": params}, jnp.asarray(mel)))
    gen = HifiGanGenerator(vhp)
    gen.load_state_dict(port_sd, strict=True)
    with torch.no_grad():
        out = gen(torch.tensor(mel)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_fastspeech_matches_jax_converter_and_forward():
    hp = dict(TTS_HP, encoder_type="fft", decoder_type="fft")
    sd = seeded(FastSpeech(TTS_VOCAB, hp, decoder=True, masked=False), 2, 0.05)
    sd["fs_leftover.weight"] = np.ones(1, np.float32)
    with pytest.raises(KeyError, match="fs_leftover"):
        conv.convert_fastspeech(sd, hp)
    del sd["fs_leftover.weight"]
    params = jconv.convert_fastspeech(sd, hp, include_decoder=True)
    port_sd = conv.convert_fastspeech(sd, hp)
    assert_state_dicts_close(port_sd, cjp.fastspeech_params_from_jax(params, hp), atol=0)
    # the duration head's bias raised by 2: a token lasts about two frames
    params["dur_predictor"]["linear"]["bias"] += 2.0
    port_sd["dur_predictor.linear.0.bias"] += 2.0
    task = type("Task", (JFastSpeechTask,), {"sil_token_ids": [1, 2]})(hp)
    jm = task.build_model()
    batch = tts_batch(1)
    jb, tb = jax_batch(batch), torch_batch(batch)
    ref = jax.jit(jm.apply)({"params": params}, jb["txt_tokens"], mel2ph=jb["mel2ph"],
                            spk_embed=jb["spk_embed"], f0=jb["f0"], uv=jb["uv"])
    model = FastSpeech(TTS_VOCAB, hp, decoder=True, masked=False).eval()
    model.load_state_dict(port_sd, strict=True)
    with torch.no_grad():
        out = model(tb["txt_tokens"], None, tb["mel2ph"], tb["spk_embed"], tb["f0"], tb["uv"])
    for k in ("mel_out", "dur"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL, err_msg=k)


def test_whole_fluentspeech_edit_matches_jax_from_one_reference_checkpoint():
    """bench.py's edit_body at a tiny size, from one reference-layout
    FluentSpeech checkpoint and one weight-normed HiFi-GAN: the JAX
    package's converters and edit against the port's converters and
    ``EditPipeline`` (the sampler's per-row noise injected), within 1e-3."""
    hp, vhp = EDIT_HP, VHP1
    sd, voc_sd = reference_fluentspeech(hp, 3), reference_hifigan(vhp, 4)
    params = jconv.convert_gaussian_diffusion(sd, hp)
    vparams = jconv.convert_hifigan_generator(voc_sd, vhp)
    port_sd = conv.convert_gaussian_diffusion(sd, hp)
    assert_state_dicts_close(port_sd, cjp.params_from_jax(params, hp), atol=0)

    rs = np.random.RandomState(0)
    t, s, hop, sr = 32, 8, 256, 22050
    t_ax = np.arange(t * hop) / sr
    wav = (sum(0.3 / k * np.sin(2 * np.pi * 180 * k * t_ax) for k in range(1, 9))
           * (1 + 0.3 * np.sin(2 * np.pi * 3 * t_ax))
           + 0.02 * rs.randn(t * hop)).astype(np.float32)[None]
    txt = rs.randint(1, EDIT_VOCAB, (1, s))
    mel2ph = np.clip(np.sort(rs.randint(1, s + 1, (1, t))), 1, s)
    mask = np.zeros((1, t, 1), np.float32)
    mask[:, t // 3: 2 * t // 3] = 1.0
    model, voc = JGD(vocab_size=EDIT_VOCAB, hp=hp, out_dims=80), JHifiGan(hp=vhp)
    mel0 = mel_spectrogram_pallas(jnp.asarray(wav), JMelConfig())[:, :t]
    f0n, uvn = norm_interp_f0_jax(extract_pitch_jax(jnp.asarray(wav[0]), hop, sr, 80.0,
                                                    600.0)[:t])
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(7), 0)])
    out = jax.jit(lambda p, *a: model.apply(p, *a, infer=True, rng=keys))(
        {"params": params}, jnp.asarray(txt), jnp.asarray(mask), jnp.asarray(mel2ph), None,
        mel0, f0n[None], uvn[None])
    comp_ref = out["mel_out"] * mask + mel0 * (1 - mask)
    wav_ref = jax.jit(voc.apply)({"params": vparams}, comp_ref)

    pipe = EditPipeline(hp, vhp, device="cpu", vocab_size=EDIT_VOCAB)
    pipe.model.load_state_dict(port_sd, strict=True)
    pipe.vocoder.load_state_dict(conv.convert_hifigan_generator(voc_sd, vhp), strict=True)
    noise = [torch.tensor(np.asarray(per_row_noise(keys, step, (t, 80))))
             for step in range(hp["timesteps"], -1, -1)]
    wav_out, mel_out = pipe(torch.tensor(wav), torch.tensor(txt), torch.tensor(mel2ph),
                            torch.tensor(mask), noise=noise)
    np.testing.assert_allclose(mel_out.numpy(), np.asarray(comp_ref), atol=1e-3)
    np.testing.assert_allclose(wav_out.numpy(), np.asarray(wav_ref), atol=1e-3)


def test_command_line_writes_a_work_dir_the_hifigan_vocoder_loads(tmp_path):
    sd = reference_hifigan(VHP1, 5)
    ckpt = str(tmp_path / "model_ckpt_steps_2168000.ckpt")
    torch.save({"state_dict": {"model_gen": {k: torch.tensor(v) for k, v in sd.items()}}}, ckpt)
    cfg = tmp_path / "hifigan.yaml"
    cfg.write_text(dump_yaml(dict(VHP1, audio_sample_rate=22050, hop_size=256)))
    out_dir = str(tmp_path / "voc")
    path = conv.main(["--family", "hifigan", "--config", str(cfg), ckpt, out_dir])
    assert path.endswith("model_ckpt_steps_2168000.ckpt")
    voc = HifiGAN({"vocoder_ckpt": out_dir}, device="cpu")
    assert voc.kind == "hifigan"
    mel = (np.random.RandomState(1).randn(12, 80) * 0.5).astype(np.float32)
    gen = HifiGanGenerator(VHP1)
    gen.load_state_dict(conv.convert_hifigan_generator(sd, VHP1))
    with torch.no_grad():
        want = gen(torch.tensor(mel)[None])[0].numpy()
    np.testing.assert_array_equal(voc.spec2wav(mel), want)
