"""PyTorch port, FastSpeech as the TTS model against the JAX package on CPU:
the training forward (the dataset's durations and pitch) and the
free-running inference forward (durations and pitch predicted, regulated
to ``max_frames``) for each decoder type (fft, conv, wn, rnn) and each
encoder type (fft, conv, rel_fft, tacotron, tacotron2).

Weights are drawn at random in the shapes of the JAX task's ``init_model``
(``jax.eval_shape``: nothing compiled) and cross by
``fastspeech_params_from_jax``. The JAX models run jitted (an eager
forward compiles op by op, 15 s here), dropout off. Outputs agree within
atol = rtol = 1e-4. This file also holds the TTS tests' shared harness
(``HP``, ``tts_batch``, ``jax_task``, ``np_tree``, ``one_thread``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.training.tasks.tts import FastSpeechTask as JFastSpeechTask
from speech_editing_tpu_torch.models.fs import FastSpeech
from speech_editing_tpu_torch.utils import convert_jax_params as cjp
from tests.test_torch_bf16_families import one_thread  # noqa: F401
from tests.test_torch_stutter import random_params
from tests.test_torch_train import HP as TRAIN_HP
from tests.test_torch_train import SIL, _batch

TOL = dict(atol=1e-4, rtol=1e-4)
VOCAB = 30
# tiny widths of egs/base.yaml's keys: 2 + 1 FFT layers of 32 wide, speaker
# embeddings on; the frame budget of free-running inference is 48 frames
HP = dict(TRAIN_HP, vocab_size=VOCAB, binary_data_dir="", enc_dilations=[1, 2],
          enc_kernel_size=5, dec_dilations=[1, 2], dec_kernel_size=5, layers_in_block=2,
          enc_post_net_kernel=3, dec_post_net_kernel=3, enc_dec_norm="ln", dropout=0.0,
          use_spk_embed=True, max_frames=48, enc_prenet=True, predictor_layers=5)
DECODERS = ("fft", "conv", "wn", "rnn")
ENCODERS = ("fft", "conv", "rel_fft", "tacotron", "tacotron2")
CASES = [("fft", d) for d in DECODERS] + [(e, "fft") for e in ENCODERS[1:]]


def np_tree(tree):
    return jax.tree.map(np.array, tree)


def tts_batch(seed: int, t: int = 36) -> dict:
    """A collated batch (numpy): two rows, row 1 shorter with its tail
    padded, with a speaker embedding."""
    batch = _batch(seed, t=t)
    batch.pop("time_mel_masks")
    batch["spk_embed"] = np.random.RandomState(seed + 50).randn(2, 256).astype(np.float32)
    return batch


def jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in batch.items()}


def torch_batch(batch: dict) -> dict:
    return {k: torch.tensor(v) for k, v in batch.items()}


def jax_task(cls, hp: dict, seed: int):
    """(JAX task, its model, parameters drawn at random in its init's
    shapes, the duration head's bias raised by 2 so that a token lasts
    about two frames)."""
    task = type(cls.__name__, (cls,), {"sil_token_ids": SIL})(hp)
    params = random_params(task, tts_batch(0), seed)
    fs = params["fs"] if "fs" in params else params
    fs["dur_predictor"]["linear"]["bias"] += 2.0
    return task, task.build_model(), params


def _hp(encoder: str, decoder: str) -> dict:
    return dict(HP, encoder_type=encoder, decoder_type=decoder)


@pytest.mark.parametrize("encoder,decoder", CASES)
def test_fastspeech_train_and_infer_forwards_match_jax(encoder, decoder):
    hp = _hp(encoder, decoder)
    _, jm, params = jax_task(JFastSpeechTask, hp, seed=CASES.index((encoder, decoder)))
    model = FastSpeech(VOCAB, hp, decoder=True, masked=False)
    model.load_state_dict(cjp.fastspeech_params_from_jax(params, hp))
    batch = tts_batch(1)
    jb, tb = jax_batch(batch), torch_batch(batch)
    ref = jax.jit(jm.apply)({"params": params}, jb["txt_tokens"], mel2ph=jb["mel2ph"],
                            spk_embed=jb["spk_embed"], f0=jb["f0"], uv=jb["uv"])
    with torch.no_grad():
        out = model(tb["txt_tokens"], None, tb["mel2ph"], tb["spk_embed"], tb["f0"], tb["uv"])
    for key in ("mel_out", "dur", "pitch_pred", "decoder_inp"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL, err_msg=key)
    assert not out["mel_out"][1, 31:].any()
    # free-running: durations and pitch predicted, frames regulated to max_frames
    ref = jax.jit(functools.partial(jm.apply, infer=True, use_pred_mel2ph=True,
                                    use_pred_pitch=True))(
        {"params": params}, jb["txt_tokens"], spk_embed=jb["spk_embed"])
    with torch.no_grad():
        out = model(tb["txt_tokens"], None, None, tb["spk_embed"], use_pred_mel2ph=True,
                    use_pred_pitch=True)
    assert out["mel_out"].shape == (2, HP["max_frames"], 80)
    np.testing.assert_array_equal(out["mel2ph"].numpy(), np.asarray(ref["mel2ph"]))
    assert (out["mel2ph"] > 0).sum() > 10
    for key in ("mel_out", "f0_denorm", "dur"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL, err_msg=key)
