"""PyTorch port, FastSpeech2-orig (``egs/fs2_orig.yaml``'s switches: energy
embedding, CWT pitch, ``cwt_std_scale``) against the JAX package on CPU:
the training forward (ground-truth f0 and frame energy), the task's
inference forward (durations and energy predicted, the dataset's f0) and
free-running synthesis (f0 rebuilt by ``cwt2f0`` from the predicted
coefficients and stats, over ``max_frames``); and with ``pitch_type:
frame`` the frame pitch path. Weights as in ``test_torch_tts_fs.py``,
crossing by ``fs2_orig_params_from_jax``; within atol = rtol = 1e-4."""

import functools

import jax
import numpy as np
import pytest
import torch

from speech_editing_tpu.training.tasks.tts import FastSpeech2OrigTask as JFS2Task
from speech_editing_tpu.training.tasks.tts import mel_energy as j_mel_energy
from speech_editing_tpu_torch.models.fs2_orig import FastSpeech2Orig
from speech_editing_tpu_torch.training.tasks.tts import FastSpeech2OrigTask, mel_energy
from speech_editing_tpu_torch.utils import convert_jax_params as cjp
from tests.test_torch_tts_fs import (HP, VOCAB, jax_batch, jax_task, one_thread,  # noqa: F401
                                     torch_batch, tts_batch)

TOL = dict(atol=1e-4, rtol=1e-4)
FS2_HP = dict(HP, encoder_type="fft", decoder_type="fft", use_energy_embed=True,
              pitch_type="cwt", cwt_std_scale=0.8, lambda_energy=0.1)


def _models(hp, seed):
    _, jm, params = jax_task(JFS2Task, hp, seed)
    model = FastSpeech2Orig(VOCAB, hp)
    model.load_state_dict(cjp.fs2_orig_params_from_jax(params, hp))
    return jm, params, model.eval()


def _close(out, ref, keys):
    for key in keys:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL, err_msg=key)


@pytest.mark.parametrize("pitch_type", ["cwt", "frame"])
def test_fs2_orig_train_and_infer_forwards_match_jax(pitch_type):
    hp = dict(FS2_HP, pitch_type=pitch_type)
    jm, params, model = _models(hp, seed=11)
    batch = tts_batch(2)
    jb, tb = jax_batch(batch), torch_batch(batch)
    energy = mel_energy(tb["mels"])
    np.testing.assert_allclose(energy.numpy(), np.asarray(j_mel_energy(jb["mels"])), rtol=1e-6)
    pitch = ("cwt", "f0_mean", "f0_std") if pitch_type == "cwt" else ("pitch_pred",)
    for infer in (False, True):     # training; the task's --infer forward
        ref = jax.jit(functools.partial(jm.apply, infer=infer))(
            {"params": params}, jb["txt_tokens"], mel2ph=jb["mel2ph"],
            spk_embed=jb["spk_embed"], f0=jb["f0"], uv=jb["uv"],
            energy=None if infer else j_mel_energy(jb["mels"]))
        with torch.no_grad():
            out = model(tb["txt_tokens"], tb["mel2ph"], tb["spk_embed"], tb["f0"], tb["uv"],
                        None if infer else energy, infer=infer)
        np.testing.assert_array_equal(out["mel2ph"].numpy(), np.asarray(ref["mel2ph"]))
        _close(out, ref, ("mel_out", "dur", "energy_pred", "f0_denorm", "decoder_inp") + pitch)
    # free running: durations, energy and (CWT) pitch predicted, max_frames frames
    ref = jax.jit(functools.partial(jm.apply, infer=True))(
        {"params": params}, jb["txt_tokens"], spk_embed=jb["spk_embed"])
    with torch.no_grad():
        out = model(tb["txt_tokens"], None, tb["spk_embed"], infer=True)
    assert out["mel_out"].shape == (2, HP["max_frames"], 80)
    assert (out["mel2ph"] > 0).sum() > 10 and (out["f0_denorm"] > 0).any()
    np.testing.assert_array_equal(out["mel2ph"].numpy(), np.asarray(ref["mel2ph"]))
    _close(out, ref, ("mel_out", "f0_denorm", "energy_pred"))


def test_fs2_orig_task_serves_cwt_keys_and_drops_the_frame_pitch_predictor():
    task = FastSpeech2OrigTask(FS2_HP)
    assert task.effective_batch_keys()[-3:] == ("cwt_spec", "f0_mean", "f0_std")
    assert "spk_embed" in task.effective_batch_keys()
    model = task.build_model()
    assert not hasattr(model, "pitch_predictor") and hasattr(model, "cwt_pitch_predictor")
    frame = FastSpeech2OrigTask(dict(FS2_HP, pitch_type="frame"))
    assert "cwt_spec" not in frame.effective_batch_keys()
    assert not hasattr(frame.build_model(), "cwt_pitch_predictor")
