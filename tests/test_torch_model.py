"""PyTorch port, FluentSpeech model: the conditioner, DiffNet and the
reverse diffusion against the JAX package on CPU, with the JAX weights
carried across by ``params_from_jax`` and the JAX sampler's own per-row
noise injected. Also the weight round trip through the reference torch
layout that ``speech_editing_tpu/utils/convert_torch_ckpt.py`` reads.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.models.spec_denoiser.spec_denoiser import \
    GaussianDiffusion as JGD
from speech_editing_tpu.modules.wavenet import DiffNet as JDiffNet
from speech_editing_tpu.ops.diffusion import per_row_noise
from speech_editing_tpu.utils.convert_torch_ckpt import convert_gaussian_diffusion
from speech_editing_tpu_torch.models.spec_denoiser.spec_denoiser import GaussianDiffusion
from speech_editing_tpu_torch.modules.wavenet import DiffNet
from speech_editing_tpu_torch.utils.convert_jax_params import (
    diffnet_params_from_jax, params_from_jax)
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=1e-4, rtol=1e-4)
VOCAB = 30
HP = {
    "hidden_size": 32, "enc_layers": 2, "enc_ffn_kernel_size": 5, "num_heads": 2,
    "encoder_type": "fft", "decoder_type": "fft", "dec_layers": 1,
    "dec_ffn_kernel_size": 5, "audio_num_mel_bins": 80, "dur_predictor_layers": 2,
    "predictor_dropout": 0.2, "dur_predictor_kernel": 3, "predictor_kernel": 5,
    "use_pitch_embed": True, "use_spk_embed": False, "use_spk_id": False,
    "predictor_grad": 0.1, "residual_layers": 3, "residual_channels": 32,
    "dilation_cycle_length": 2, "timesteps": 2, "timescale": 1,
    "schedule_type": "vpsde", "frames_multiple": 1, "use_uv": True,
    "pitch_type": "frame",
}


def _randomize(params, seed):
    """Perturb every leaf: flax zero-inits DiffNet's output projection and
    all biases, which would hide most of the graph from a comparison."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rs.randn(*a.shape).astype(np.float32), params)


def _batch(rs, b=2, s=10, t=36):
    tokens = rs.randint(1, VOCAB, (b, s))
    tokens[1, 7:] = 0
    mel2ph = np.zeros((b, t), np.int64)
    for i, (n_tok, n_frames) in enumerate([(s, t), (7, t - 5)]):
        bounds = np.sort(rs.choice(np.arange(1, n_frames), n_tok - 1, replace=False))
        mel2ph[i, :n_frames] = np.searchsorted(bounds, np.arange(n_frames),
                                               side="right") + 1
    mask = np.zeros((b, t, 1), np.float32)
    mask[:, t // 3: 2 * t // 3] = 1.0
    uv = (rs.rand(b, t) < 0.2).astype(np.float32)
    f0 = (rs.rand(b, t) * 2 + 6.5).astype(np.float32) * (1 - uv)
    mels = (rs.randn(b, t, 80) * 0.5 - 1.0).astype(np.float32)
    return dict(tokens=tokens, mask=mask, mel2ph=mel2ph, mels=mels, f0=f0, uv=uv)


@functools.lru_cache(maxsize=1)
def _models():
    """(jax model, numpy params, port model with those params, batch)."""
    batch = _batch(np.random.RandomState(0))
    jm = JGD(vocab_size=VOCAB, hp=HP, out_dims=80)
    args = [jnp.asarray(batch[k]) for k in ("tokens", "mask", "mel2ph")]
    params = jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        *args, None, *(jnp.asarray(batch[k]) for k in ("mels", "f0", "uv")))["params"]
    params = _randomize(params, 1)
    tm = GaussianDiffusion(VOCAB, HP, 80).eval()
    tm.load_state_dict(params_from_jax(params, HP))
    return jm, params, tm, batch


def _port_args(batch):
    return (torch.tensor(batch["tokens"]), torch.tensor(batch["mask"]),
            torch.tensor(batch["mel2ph"]), None, torch.tensor(batch["mels"]),
            torch.tensor(batch["f0"]), torch.tensor(batch["uv"]))


def _jax_args(batch):
    return (jnp.asarray(batch["tokens"]), jnp.asarray(batch["mask"]),
            jnp.asarray(batch["mel2ph"]), None, jnp.asarray(batch["mels"]),
            jnp.asarray(batch["f0"]), jnp.asarray(batch["uv"]))


@pytest.mark.parametrize("use_pred_pitch", [False, True])
def test_compute_cond_matches(use_pred_pitch):
    jm, params, tm, batch = _models()
    ref = jax.jit(functools.partial(jm.apply, method=jm.compute_cond,
                                    use_pred_pitch=use_pred_pitch))(
        {"params": params}, *_jax_args(batch))
    with torch.no_grad():
        out = tm.compute_cond(*_port_args(batch), use_pred_pitch=use_pred_pitch)
    for key in ("dur", "pitch_pred", "f0_denorm", "decoder_inp", "cond"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL,
                                   err_msg=key)


def test_predict_durations_matches():
    jm, params, tm, batch = _models()
    tokens, mask, mel2ph = (batch[k] for k in ("tokens", "mask", "mel2ph"))
    masked_mel2ph = mel2ph * (1 - mask[..., 0]).astype(np.int64)
    masked_dur = np.stack([np.bincount(r, minlength=tokens.shape[1] + 1)[1:]
                           for r in masked_mel2ph])
    ref = jax.jit(functools.partial(jm.apply, method=jm.predict_durations))(
        {"params": params}, jnp.asarray(tokens), jnp.asarray(mask),
        jnp.asarray(masked_mel2ph), jnp.asarray(masked_dur))
    with torch.no_grad():
        out = tm.predict_durations(torch.tensor(tokens), torch.tensor(mask),
                                   torch.tensor(masked_mel2ph), torch.tensor(masked_dur))
    np.testing.assert_allclose(out["dur"].numpy(), np.asarray(ref["dur"]), **TOL)
    np.testing.assert_array_equal(out["mel2ph"].numpy(), np.asarray(ref["mel2ph"]))


def test_diffnet_matches_with_nonpadding():
    rs = np.random.RandomState(3)
    b, t, hdim = 2, 27, 24
    spec = rs.randn(b, t, 80).astype(np.float32)
    cond = rs.randn(b, t, hdim).astype(np.float32)
    steps = np.array([0, 5])
    nonpad = np.ones((b, t), np.float32)
    nonpad[1, 19:] = 0
    jd = JDiffNet(80, hdim, 3, 32, dilation_cycle_length=2)
    jargs = (jnp.asarray(spec), jnp.asarray(steps), jnp.asarray(cond),
             jnp.asarray(nonpad)[..., None])
    params = _randomize(jax.jit(jd.init)(jax.random.PRNGKey(0), *jargs)["params"], 4)
    ref = jax.jit(jd.apply)({"params": params}, *jargs)
    td = DiffNet(80, hdim, 3, 32, dilation_cycle_length=2)
    td.load_state_dict(diffnet_params_from_jax(params, 3))
    with torch.no_grad():
        out = td(torch.tensor(spec), torch.tensor(steps), torch.tensor(cond),
                 torch.tensor(nonpad))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("use_pred_pitch", [False, True])
def test_reverse_diffusion_matches_with_injected_noise(use_pred_pitch):
    """The infer branch under per-row keys: the port gets JAX's own draws."""
    jm, params, tm, batch = _models()
    b, t = batch["mel2ph"].shape
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(7), i) for i in range(b)])
    big_t = HP["timesteps"]
    noise = [torch.tensor(np.asarray(per_row_noise(keys, step, (t, 80))))
             for step in range(big_t, -1, -1)]
    ref = jax.jit(functools.partial(jm.apply, infer=True,
                                    use_pred_pitch=use_pred_pitch))(
        {"params": params}, *_jax_args(batch), rng=keys)
    with torch.no_grad():
        out = tm(*_port_args(batch), use_pred_pitch=use_pred_pitch, noise=noise)
    np.testing.assert_allclose(out["mel_out"].numpy(), np.asarray(ref["mel_out"]),
                               **TOL)


def test_reverse_diffusion_draws_from_generator():
    _, _, tm, batch = _models()
    args = _port_args(batch)
    with torch.no_grad():
        a = tm(*args, generator=torch.Generator().manual_seed(5))["mel_out"]
        b = tm(*args, generator=torch.Generator().manual_seed(5))["mel_out"]
        c = tm(*args, generator=torch.Generator().manual_seed(6))["mel_out"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    with pytest.raises(ValueError):
        tm(*args, noise=[torch.zeros(2, 36, 80)])


def test_state_dict_round_trip_through_reference_layout():
    """port state_dict -> convert_gaussian_diffusion (reference torch layout
    to flax) -> params_from_jax -> the same state_dict, exactly."""
    torch.manual_seed(0)
    hp = dict(HP, use_spk_embed=True)
    tm = GaussianDiffusion(VOCAB, hp, 80)
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    back = params_from_jax(convert_gaussian_diffusion(sd, hp), hp)
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
