"""PyTorch port, initial weights against flax's: ``init_like_flax`` gives
every parameter that flax sets to a constant (zero biases, DiffNet's zero
output projection, norm scales of one) exactly that constant, and every
other parameter a spread within a stated tolerance of a flax
``model.init`` of the same hp, for both text encoders and for the HiFi-GAN
generator. Two independent draws of n values have standard deviations
that differ by about 1/sqrt(n) relatively; the tolerance is 4/sqrt(n),
and at least 5 %. The StutterSpeech editor and its stutter predictor
(``init_model`` of the JAX tasks) are held the same way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.models.spec_denoiser.spec_denoiser import \
    GaussianDiffusion as JGD
from speech_editing_tpu.models.vocoder.hifigan import HifiGanGenerator as JHifiGan
from speech_editing_tpu.training.tasks.stutter_speech import \
    StutterPredictorTask as JPredictorTask
from speech_editing_tpu.training.tasks.stutter_speech import \
    StutterSpeechTask as JStutterTask
from speech_editing_tpu_torch.models.stutter_speech import (StutterGaussianDiffusion,
                                                            StutterPredictor)
from speech_editing_tpu_torch.models.vocoder.hifigan import HifiGanGenerator
from speech_editing_tpu_torch.training.tasks.spec_denoiser import build_model
from speech_editing_tpu_torch.utils.convert_jax_params import (
    params_from_jax, stutter_predictor_params_from_jax, stutter_speech_params_from_jax,
    vocoder_params_from_jax)
from speech_editing_tpu_torch.utils.init import init_like_flax
from tests.helpers import TINY_VOC_HP
from tests.test_torch_conv_encoder import HP as CONV_HP
from tests.test_torch_model import HP as FFT_HP
from tests.test_torch_model import VOCAB
from tests.test_torch_stutter import HP as STUTTER_HP
from tests.test_torch_stutter import _batch
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

WIDE = dict(hidden_size=64, residual_channels=64)   # enough values a tensor to compare spreads


def _flax_model(hp):
    b, s, t = 2, 9, 32
    tokens = jnp.ones((b, s), jnp.int32)
    mel2ph = jnp.minimum(jnp.arange(t) // 4 + 1, s)[None].repeat(b, 0)
    jm = JGD(vocab_size=VOCAB, hp=hp, out_dims=80)
    params = jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        tokens, jnp.zeros((b, t, 1)), mel2ph, jnp.zeros((b, 256)),
        jnp.zeros((b, t, 80)), jnp.zeros((b, t)), jnp.zeros((b, t)))["params"]
    torch.manual_seed(0)
    return params_from_jax(params, hp), build_model(VOCAB, hp)


def _flax_vocoder():
    jv = JHifiGan(TINY_VOC_HP)
    params = jax.jit(jv.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)))["params"]
    torch.manual_seed(0)
    return (vocoder_params_from_jax(params, TINY_VOC_HP),
            init_like_flax(HifiGanGenerator(TINY_VOC_HP)))


def _flax_stutter(which):
    """A JAX StutterSpeech task's ``init_model`` (the editor or the stutter
    predictor) at the conv encoder's widths and the port's model."""
    hp = dict(STUTTER_HP, **WIDE)
    if which == "stutter_speech":
        jtask, model = JStutterTask(hp), StutterGaussianDiffusion(VOCAB, hp, 80)
        convert = stutter_speech_params_from_jax
    else:
        jtask, model = JPredictorTask(hp), StutterPredictor(VOCAB, hp, 16, 80)
        convert = stutter_predictor_params_from_jax
    params = jtask.init_model(jtask.build_model(), _batch(0, t=48), jax.random.PRNGKey(0))
    torch.manual_seed(0)
    return convert(jax.tree.map(np.asarray, params["params"]), hp), init_like_flax(model)


@pytest.mark.parametrize("which", ["fft_encoder", "conv_encoder", "hifigan", "stutter_speech",
                                   "stutter_predictor"])
def test_initial_weights_follow_flax(which):
    if which == "hifigan":
        ref, model = _flax_vocoder()
    elif which.startswith("stutter"):
        ref, model = _flax_stutter(which)
    else:
        hp = dict(FFT_HP if which == "fft_encoder" else CONV_HP, use_spk_embed=True, **WIDE)
        ref, model = _flax_model(hp)
    got = {k: v.detach() for k, v in model.state_dict().items()}
    assert sorted(got) == sorted(ref)
    n_random = 0
    for name, want in ref.items():
        want, mine = want.double(), got[name].double()
        assert mine.shape == want.shape, name
        if bool((want == want.flatten()[0]).all()):
            assert bool((mine == want).all()), f"{name}: flax sets {float(want.flatten()[0])}"
            continue
        n_random += 1
        tol = max(0.05, 4 / want.numel() ** 0.5)
        ratio = float(mine.std() / want.std())
        assert abs(ratio - 1) <= tol, f"{name}: std {float(mine.std()):.4g} vs flax " \
                                      f"{float(want.std()):.4g} (tol {tol:.3f})"
        assert float(mine.abs().max()) <= 2.0 * float(want.abs().max()) + 1e-6, name
    assert n_random >= 10
    if which in ("fft_encoder", "conv_encoder", "stutter_speech"):
        out = model.denoise_fn.output_projection
        assert not out.weight.any() and not out.bias.any()
