"""PyTorch port, the editing configs' model switches against the JAX package
on CPU: ``use_masked_cond: false``, ``ref_pad_compat`` and ``no_diffusion``
of FluentSpeech's ``GaussianDiffusion`` and ``timesteps: 4``
(``egs/spec_denoiser_libritts.yaml``), each in training (every loss term
of the task's loss, dropout off, JAX's own diffusion draws) and at
inference (the reverse run with JAX's per-row noise); and StutterSpeech
under ``ref_pad_compat``, the one switch its JAX model reads. The batch's
second row is shorter than the first, so its padded frames reach DiffNet's
and the pitch predictor's convolutions: ``ref_pad_compat`` changes the
result there, and each switch is also checked to change it.

Weights: one random draw in the shapes of the JAX model's ``init`` (traced,
not compiled), crossed by ``params_from_jax``. Losses agree within rtol
1e-4 (atol 1e-6), the reverse run within 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.models.spec_denoiser.spec_denoiser import \
    GaussianDiffusion as JGD
from speech_editing_tpu.ops.diffusion import per_row_noise
from speech_editing_tpu.training.tasks.spec_denoiser import \
    make_loss_fn as j_make_loss_fn
from speech_editing_tpu.training.tasks.stutter_speech import \
    collapse_stutter_labels as j_collapse
from speech_editing_tpu_torch.models.spec_denoiser.spec_denoiser import GaussianDiffusion
from speech_editing_tpu_torch.models.stutter_speech import StutterGaussianDiffusion
from speech_editing_tpu_torch.training.tasks.spec_denoiser import make_loss_fn
from speech_editing_tpu_torch.training.tasks.stutter_speech import (StutterSpeechTask,
                                                                    collapse_stutter_labels)
from speech_editing_tpu_torch.utils import convert_jax_params as cjp
from tests.test_torch_model import VOCAB
from tests.test_torch_stutter import HP as STUTTER_HP
from tests.test_torch_stutter import _JStutterTask, random_params
from tests.test_torch_stutter import _batch as stutter_batch
from tests.test_torch_train import HP, SIL, _batch, _jax_batch, _torch_batch
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

SWITCHES = {"use_masked_cond": dict(use_masked_cond=False),
            "ref_pad_compat": dict(ref_pad_compat=True),
            "no_diffusion": dict(no_diffusion=True),
            "timesteps_4": dict(timesteps=4)}
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
EDIT_TOL = dict(atol=1e-3, rtol=1e-3)


class _Shapes:
    """``init_model``'s signature over the FluentSpeech model, for
    :func:`random_params`."""

    def __init__(self, hp):
        self.hp = hp

    def build_model(self):
        return JGD(vocab_size=VOCAB, hp=self.hp, out_dims=80)

    def init_model(self, model, batch, rng):
        b = _jax_batch(batch)
        return model.init({"params": rng, "diffusion": rng}, b["txt_tokens"],
                          b["time_mel_masks"][..., None], b["mel2ph"], None, b["mels"],
                          b["f0"], b["uv"])


@functools.lru_cache(maxsize=1)
def _params():
    return random_params(_Shapes(HP), _batch(0), 3)


def _port(hp):
    model = GaussianDiffusion(VOCAB, hp, 80)
    model.load_state_dict(cjp.params_from_jax(_params(), HP))
    return model


def _jax_draws(rng, batch, timesteps):
    """The (t, noise) the JAX loss draws from ``rng`` at ``timesteps``."""
    k_t, k_noise = jax.random.split(jax.random.split(rng)[0])
    t = jax.random.randint(k_t, (batch["mels"].shape[0],), 0, timesteps + 1)
    noise = jax.random.normal(k_noise, batch["mels"].shape, jnp.float32)
    return torch.tensor(np.asarray(t)).long(), torch.tensor(np.asarray(noise))


def _train_losses(hp, batch, rng):
    """(JAX's loss terms, the port's) of one batch with dropout off."""
    jm = JGD(vocab_size=VOCAB, hp=hp, out_dims=80)
    j_total, j_losses = jax.jit(j_make_loss_fn(jm, hp, sil_token_ids=SIL, train=False))(
        _params(), _jax_batch(batch), rng)
    t, noise = _jax_draws(rng, batch, hp["timesteps"])
    with torch.no_grad():
        total, losses = make_loss_fn(_port(hp), hp, SIL, train=False)(
            _torch_batch(batch), t=t, noise=noise)
    return (dict(j_losses, total=j_total), dict(losses, total=total))


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_switch_in_training_matches_jax(switch):
    hp = dict(HP, **SWITCHES[switch])
    batch, rng = _batch(0), jax.random.PRNGKey(5)
    ref, got = _train_losses(hp, batch, rng)
    assert sorted(got) == sorted(ref)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), **LOSS_TOL, err_msg=k)
    with torch.no_grad():
        t, noise = _jax_draws(rng, batch, HP["timesteps"])
        base, _ = make_loss_fn(_port(HP), HP, SIL, train=False)(_torch_batch(batch), t=t,
                                                               noise=noise)
    assert abs(float(base) - float(got["total"])) > 1e-4, "the switch changed nothing"


def _noise(keys, steps, t_mel):
    return [torch.tensor(np.asarray(per_row_noise(keys, s, (t_mel, 80))))
            for s in range(steps, -1, -1)]


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_switch_at_inference_matches_jax(switch):
    """The model's own inference forward (``--infer``'s) with JAX's
    per-row noise (none under ``no_diffusion``, which draws none)."""
    hp = dict(HP, **SWITCHES[switch])
    batch = _batch(1)
    jb = _jax_batch(batch)
    b, t_mel = batch["mel2ph"].shape
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(7), i) for i in range(b)])
    jm = JGD(vocab_size=VOCAB, hp=hp, out_dims=80)
    ref = jax.jit(functools.partial(jm.apply, infer=True))(
        {"params": _params()}, jb["txt_tokens"], jb["time_mel_masks"][..., None],
        jb["mel2ph"], None, jb["mels"], jb["f0"], jb["uv"], rng=keys)
    tb = _torch_batch(batch)
    args = (tb["txt_tokens"], tb["time_mel_masks"][..., None], tb["mel2ph"], None,
            tb["mels"], tb["f0"], tb["uv"])
    noise = None if hp.get("no_diffusion") else _noise(keys, hp["timesteps"], t_mel)
    with torch.no_grad():
        out = _port(hp).eval()(*args, noise=noise)
        base = _port(HP).eval()(*args, noise=_noise(keys, HP["timesteps"], t_mel))
    for key in ("mel_out", "dur", "pitch_pred"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **EDIT_TOL,
                                   err_msg=key)
    # use_masked_cond moves the predictions alone: mel2ph and f0 are given
    assert any(not torch.allclose(out[k], base[k], atol=1e-4)
               for k in ("mel_out", "dur", "pitch_pred"))


def test_no_diffusion_draws_nothing_and_compute_cond_ignores_the_switches():
    """``no_diffusion`` takes no draw from the generator; the edit
    drivers' ``compute_cond`` reads none of the switches, as JAX's."""
    hp = dict(HP, no_diffusion=True, use_masked_cond=False, ref_pad_compat=False)
    tb = _torch_batch(_batch(2))
    args = (tb["txt_tokens"], tb["time_mel_masks"][..., None], tb["mel2ph"], None,
            tb["mels"], tb["f0"], tb["uv"])
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    with torch.no_grad():
        _port(hp).forward_train(*args, generator=gen, train=False)
        assert torch.equal(gen.get_state(), state)
        a = _port(hp).compute_cond(*args)
        b = _port(HP).compute_cond(*args)
    for key in ("cond", "dur", "pitch_pred"):
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


# -- StutterSpeech -----------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _stutter_params():
    return random_params(_JStutterTask(STUTTER_HP), stutter_batch(0), 7)


def _stutter_port(hp):
    model = StutterGaussianDiffusion(VOCAB, hp, 80).eval()
    model.load_state_dict(cjp.stutter_speech_params_from_jax(_stutter_params(), STUTTER_HP))
    return model


@pytest.mark.parametrize("infer", [False, True])
def test_stutter_speech_ref_pad_compat_matches_jax(infer):
    """StutterSpeech's DiffNet without a mask, in training (JAX's t and
    noise) and at inference (its per-row noise); the switches its JAX model
    does not read (``no_diffusion``, ``use_masked_cond``) change nothing."""
    hp = dict(STUTTER_HP, ref_pad_compat=True)
    batch = stutter_batch(1)
    jb = _jax_batch(batch)
    b, t_mel = batch["mel2ph"].shape
    jm = _JStutterTask(hp).build_model()
    keys = jax.random.split(jax.random.PRNGKey(11), b) if infer else jax.random.PRNGKey(9)
    ref = jax.jit(functools.partial(jm.apply, infer=infer))(
        {"params": _stutter_params()}, jb["txt_tokens"], jb["time_mel_masks"][..., None],
        j_collapse(jb["stutter_mel_masks"]), jb["mel2ph"], jb["spk_embed"], jb["mels"],
        jb["f0"], jb["uv"], rng=keys)
    tb = _torch_batch(batch)
    args = (tb["txt_tokens"], tb["time_mel_masks"][..., None], tb["mel2ph"], tb["spk_embed"],
            tb["mels"], tb["f0"], tb["uv"])
    ignored = dict(hp, no_diffusion=True, use_masked_cond=False)
    outs = []
    for model_hp in (hp, ignored, STUTTER_HP):
        model = _stutter_port(model_hp)
        with torch.no_grad():
            if infer:
                outs.append(model(*args, noise=_noise(keys, hp["timesteps"], t_mel)))
            else:
                k_t, k_noise = jax.random.split(keys)
                t = torch.tensor(np.asarray(jax.random.randint(
                    k_t, (b,), 0, hp["timesteps"] + 1))).long()
                noise = torch.tensor(np.asarray(jax.random.normal(k_noise, (b, t_mel, 80))))
                outs.append(model.forward_train(
                    *args, t=t, noise=noise, train=False,
                    stutter_labels=collapse_stutter_labels(tb["stutter_mel_masks"])))
    out, same, unmasked = outs
    tol = EDIT_TOL if infer else dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out["mel_out"].numpy(), np.asarray(ref["mel_out"]), **tol)
    torch.testing.assert_close(same["mel_out"], out["mel_out"], rtol=0, atol=0)
    assert not torch.allclose(unmasked["mel_out"], out["mel_out"], atol=1e-4)
    assert StutterSpeechTask(dict(hp, vocab_size=VOCAB)).build_model().ref_pad_compat
