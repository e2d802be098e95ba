"""PyTorch port, ``enc_dec_norm`` other than ``ln`` against the JAX
package on CPU: ``bn`` and ``in`` are GroupNorm with 8 groups in both (as
``gn``), any other name no norm at all. The conv text encoder's forward on
padded tokens, and the loss and every gradient of a training step of the
conditioner with the conv encoder, within 1e-4 (the ``ln`` and ``gn``
cases are in ``test_torch_conv_encoder.py``)."""

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
from speech_editing_tpu_torch.models.spec_denoiser.spec_denoiser import GaussianDiffusion
from speech_editing_tpu_torch.modules.conv import TextConvEncoder, _GroupNorm
from speech_editing_tpu_torch.training.tasks.spec_denoiser import make_loss_fn
from speech_editing_tpu_torch.utils.convert_jax_params import (
    params_from_jax, text_conv_encoder_params_from_jax)
from speech_editing_tpu_torch.utils.init import init_like_flax
from tests.test_torch_bf16_families import one_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_conv_encoder import HP as CONV_HP
from tests.test_torch_conv_encoder import _batch, _tokens
from tests.test_torch_model import VOCAB, _randomize
from tests.test_torch_train import SIL, _jax_batch, _jax_draws, _torch_batch

TOL = dict(atol=1e-4, rtol=1e-4)
NORMS = ["bn", "in", "none"]


@pytest.mark.parametrize("norm_type", NORMS)
def test_text_conv_encoder_matches_with_padding(norm_type):
    tokens = _tokens(np.random.RandomState(1))
    jenc = JTextConvEncoder(VOCAB, 32, 32, (1, 2, 1), 5, norm_type=norm_type)
    params = _randomize(jax.jit(jenc.init)(jax.random.PRNGKey(0),
                                           jnp.asarray(tokens))["params"], 2)
    ref = jax.jit(jenc.apply)({"params": params}, jnp.asarray(tokens))
    enc = TextConvEncoder(VOCAB, 32, 32, (1, 2, 1), 5, norm_type=norm_type)
    sd = text_conv_encoder_params_from_jax(params, 3)
    enc.load_state_dict(sd)
    norms = [m for m in enc.modules() if isinstance(m, _GroupNorm)]
    assert len(norms) == (7 if norm_type != "none" else 0)
    assert any(k.startswith("last_norm.") for k in sd) == (norm_type != "none")
    with torch.no_grad():
        out = enc(torch.tensor(tokens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not out[1, 7:].any() and not out[2, 3:].any()


@functools.lru_cache(maxsize=None)
def _jax(norm_type):
    """(hp, jax model, randomized params, jitted value_and_grad of the JAX
    loss) for the conv encoder under ``enc_dec_norm=norm_type``."""
    hp = dict(CONV_HP, enc_dec_norm=norm_type)
    batch = _jax_batch(_batch(0))
    jm = JGD(vocab_size=VOCAB, hp=hp, out_dims=80)
    params = jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        batch["txt_tokens"], batch["time_mel_masks"][..., None], batch["mel2ph"],
        batch["spk_embed"], batch["mels"], batch["f0"], batch["uv"])["params"]
    params = _randomize(params, 3)
    loss_fn = j_make_loss_fn(jm, hp, sil_token_ids=SIL, train=False)
    return hp, params, jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.mark.parametrize("norm_type", NORMS)
def test_train_step_loss_and_every_gradient_match_jax(norm_type):
    hp, params, grad_fn = _jax(norm_type)
    batch = _batch(2)
    rng = jax.random.PRNGKey(7)
    (j_total, j_losses), j_grads = grad_fn(params, _jax_batch(batch), rng)
    tm = GaussianDiffusion(VOCAB, hp, 80)
    tm.load_state_dict(params_from_jax(params, hp))
    t, noise = _jax_draws(rng, batch)
    total, losses = make_loss_fn(tm, hp, SIL, train=False)(_torch_batch(batch), t=t,
                                                           noise=noise)
    total.backward()
    assert sorted(losses) == sorted(j_losses)
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()), float(j_losses[k]), **TOL,
                                   err_msg=k)
    ref = params_from_jax(jax.tree.map(np.asarray, j_grads), hp)
    named = dict(tm.named_parameters())
    assert sorted(named) == sorted(ref)
    has_norm = any(".norm" in k or "last_norm" in k or ".blocks.0.0." in k
                   for k in named if k.startswith("fs.encoder."))
    assert has_norm == (norm_type != "none")
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), **TOL, err_msg=name)


@pytest.mark.parametrize("norm_type", NORMS)
def test_init_like_flax_builds_every_norm(norm_type):
    """The port's flax-style initialisation and a forward run for each norm
    (a norm without parameters included)."""
    torch.manual_seed(0)
    hp = dict(CONV_HP, enc_dec_norm=norm_type)
    tm = init_like_flax(GaussianDiffusion(VOCAB, hp, 80))
    for m in tm.modules():
        if isinstance(m, _GroupNorm):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert not m.bias.any()
    with torch.no_grad():
        out = tm.fs.encoder(torch.tensor(_tokens(np.random.RandomState(0))))
    assert torch.isfinite(out).all()

