"""PyTorch port, the shipped FluentSpeech configuration's conditioner
against the JAX package on CPU: the conv text encoder on padded tokens
(LayerNorm and GroupNorm), the conditioner with a speaker embedding, the
training loss and every gradient (JAX's diffusion draws injected), and
the weight round trip through the reference torch layout that the
unchanged ``convert_text_conv_encoder`` reads."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.models.spec_denoiser.spec_denoiser import \
    GaussianDiffusion as JGD
from speech_editing_tpu.modules.conv import TextConvEncoder as JTextConvEncoder
from speech_editing_tpu.training.tasks.spec_denoiser import \
    make_loss_fn as j_make_loss_fn
from speech_editing_tpu.utils.convert_torch_ckpt import (convert_gaussian_diffusion,
                                                         convert_text_conv_encoder)
from speech_editing_tpu_torch.models.spec_denoiser.spec_denoiser import GaussianDiffusion
from speech_editing_tpu_torch.modules.conv import TextConvEncoder
from speech_editing_tpu_torch.training.tasks.spec_denoiser import make_loss_fn
from speech_editing_tpu_torch.utils.convert_jax_params import (
    params_from_jax, text_conv_encoder_params_from_jax)
from tests.test_torch_model import VOCAB, _randomize
from tests.test_torch_train import GRAD_TOL, SIL, _jax_batch, _jax_draws, _torch_batch
from tests.test_torch_train import HP as TRAIN_HP
from tests.test_torch_train import _batch as _train_batch
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=1e-4, rtol=1e-4)
HP = dict(TRAIN_HP, encoder_type="conv", enc_dilations=[1, 2], enc_kernel_size=5,
          layers_in_block=2, enc_post_net_kernel=3, enc_dec_norm="ln",
          use_spk_embed=True)


def _tokens(rs, b=3, s=11):
    tokens = rs.randint(1, VOCAB, (b, s))
    tokens[1, 7:] = 0
    tokens[2, 3:] = 0
    return tokens


@pytest.mark.parametrize("norm_type", ["ln", "gn"])
def test_text_conv_encoder_matches_with_padding(norm_type):
    tokens = _tokens(np.random.RandomState(0))
    jenc = JTextConvEncoder(VOCAB, 32, 32, (1, 2, 1), 5, norm_type=norm_type)
    params = _randomize(jax.jit(jenc.init)(jax.random.PRNGKey(0),
                                           jnp.asarray(tokens))["params"], 1)
    ref = jax.jit(jenc.apply)({"params": params}, jnp.asarray(tokens))
    enc = TextConvEncoder(VOCAB, 32, 32, (1, 2, 1), 5, norm_type=norm_type)
    enc.load_state_dict(text_conv_encoder_params_from_jax(params, 3))
    with torch.no_grad():
        out = enc(torch.tensor(tokens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not out[1, 7:].any() and not out[2, 3:].any()


def _batch(seed):
    batch = _train_batch(seed)
    batch["spk_embed"] = np.random.RandomState(seed + 100).randn(2, 256).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=1)
def _jax():
    """(jax model, randomized numpy params, jitted value_and_grad of the
    JAX loss with dropout off) for the conv encoder with a speaker
    embedding."""
    batch = _jax_batch(_batch(0))
    jm = JGD(vocab_size=VOCAB, hp=HP, out_dims=80)
    params = jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        batch["txt_tokens"], batch["time_mel_masks"][..., None], batch["mel2ph"],
        batch["spk_embed"], batch["mels"], batch["f0"], batch["uv"])["params"]
    params = _randomize(params, 3)
    loss_fn = j_make_loss_fn(jm, HP, sil_token_ids=SIL, train=False)
    return jm, params, jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _port_model(params):
    tm = GaussianDiffusion(VOCAB, HP, 80)
    tm.load_state_dict(params_from_jax(params, HP))
    return tm


def test_conditioner_with_speaker_embedding_matches():
    jm, params, _ = _jax()
    jb, tb = _jax_batch(_batch(1)), _torch_batch(_batch(1))
    ref = jax.jit(functools.partial(jm.apply, method=jm.compute_cond))(
        {"params": params}, jb["txt_tokens"], jb["time_mel_masks"][..., None],
        jb["mel2ph"], jb["spk_embed"], jb["mels"], jb["f0"], jb["uv"])
    with torch.no_grad():
        out = _port_model(params).compute_cond(
            tb["txt_tokens"], tb["time_mel_masks"][..., None], tb["mel2ph"],
            tb["spk_embed"], tb["mels"], tb["f0"], tb["uv"])
    for key in ("dur", "pitch_pred", "decoder_inp", "cond"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL,
                                   err_msg=key)
    with torch.no_grad():   # the speaker embedding reaches the conditioner
        other = _port_model(params).compute_cond(
            tb["txt_tokens"], tb["time_mel_masks"][..., None], tb["mel2ph"],
            tb["spk_embed"] + 1, tb["mels"], tb["f0"], tb["uv"])
    assert not torch.allclose(other["cond"], out["cond"])


def test_loss_and_every_gradient_match_jax():
    jm, params, grad_fn = _jax()
    batch = _batch(0)
    rng = jax.random.PRNGKey(5)
    (j_total, j_losses), j_grads = grad_fn(params, _jax_batch(batch), rng)
    tm = _port_model(params)
    t, noise = _jax_draws(rng, batch)
    total, losses = make_loss_fn(tm, HP, SIL, train=False)(_torch_batch(batch), t=t,
                                                           noise=noise)
    total.backward()
    assert sorted(losses) == sorted(j_losses)
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()), float(j_losses[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=1e-4)
    ref = params_from_jax(jax.tree.map(np.asarray, j_grads), HP)
    named = dict(tm.named_parameters())
    assert sorted(named) == sorted(ref)
    assert any(k.startswith("fs.encoder.res_blocks.") for k in named)
    assert "fs.spk_embed_proj.weight" in named
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), **GRAD_TOL,
                                   err_msg=name)


def test_state_dict_round_trip_through_reference_layout():
    """port state_dict -> the unchanged converters (reference torch layout
    to flax) -> params_from_jax -> the same state_dict, exactly; the
    encoder's flax tree is the one ``convert_text_conv_encoder`` builds."""
    torch.manual_seed(0)
    tm = GaussianDiffusion(VOCAB, HP, 80)
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    flax_params = convert_gaussian_diffusion(sd, HP)
    enc = convert_text_conv_encoder(sd, len(HP["enc_dilations"]), 2, prefix="fs.encoder.")
    assert jax.tree.structure(enc) == jax.tree.structure(flax_params["fs"]["encoder"])
    assert jax.tree.structure(flax_params) == jax.tree.structure(_jax()[1])
    back = params_from_jax(flax_params, HP)
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
