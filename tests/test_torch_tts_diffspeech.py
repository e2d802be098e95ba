"""PyTorch port, DiffSpeech (``egs/diffspeech.yaml``'s switches: cosine
schedule, ``dilation_cycle_length: 1``, the default ``spec_min`` /
``spec_max``) against the JAX package on CPU: the training forward given
JAX's own ``t`` and noise (regenerated here from the same key splits), the
model's reverse loop at ``timesteps: 4`` given JAX's per-step noise (masked
after every step; free-running, durations and pitch predicted over
``max_frames``), and the task's ``--infer`` forward against JAX's
``build_infer_fn`` (``p_sample_loop``, unmasked between steps). Weights as in
``test_torch_tts_fs.py``, crossing by ``diffspeech_params_from_jax``;
within atol = rtol = 1e-4, the reverse loops within 1e-3."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from speech_editing_tpu.training.tasks.tts import DiffSpeechTask as JDiffSpeechTask
from speech_editing_tpu_torch.models.diffspeech import DiffSpeech
from speech_editing_tpu_torch.training.tasks.tts import DiffSpeechTask
from speech_editing_tpu_torch.utils import convert_jax_params as cjp
from tests.test_torch_tts_fs import (HP, VOCAB, jax_batch, jax_task, one_thread,  # noqa: F401
                                     torch_batch, tts_batch)

TOL = dict(atol=1e-4, rtol=1e-4)
LOOP_TOL = dict(atol=1e-3, rtol=1e-3)
DS_HP = dict(HP, encoder_type="fft", timesteps=4, schedule_type="cosine", max_beta=0.06,
             spec_min=[], spec_max=[], residual_layers=3, residual_channels=32,
             dilation_cycle_length=1)


def _models():
    _, jm, params = jax_task(JDiffSpeechTask, DS_HP, seed=21)
    model = DiffSpeech(VOCAB, DS_HP, 80)
    model.load_state_dict(cjp.diffspeech_params_from_jax(params, DS_HP))
    return jm, params, model.eval()


def _noise(keys, shape):
    return [torch.tensor(np.asarray(jax.random.normal(k, shape, jnp.float32))) for k in keys]


def test_diffspeech_training_forward_matches_jax_given_its_draws():
    jm, params, model = _models()
    batch = tts_batch(3)
    jb, tb = jax_batch(batch), torch_batch(batch)
    rng = jax.random.PRNGKey(4)
    ref = jax.jit(functools.partial(jm.apply, infer=False))(
        {"params": params}, jb["txt_tokens"], mel2ph=jb["mel2ph"], spk_embed=jb["spk_embed"],
        ref_mels=jb["mels"], f0=jb["f0"], uv=jb["uv"], rng=rng)
    k_t, k_noise = jax.random.split(rng)
    t = torch.tensor(np.asarray(jax.random.randint(k_t, (2,), 0, DS_HP["timesteps"])))
    noise = _noise([k_noise], batch["mels"].shape)[0]
    with torch.no_grad():
        out = model.forward_train(tb["txt_tokens"], tb["mel2ph"], tb["spk_embed"], tb["mels"],
                                  tb["f0"], tb["uv"], t=t.long(), noise=noise, train=False)
    assert float(out["noise_pred"].abs().max()) > 0.1
    for key in ("noise_pred", "noise_gt", "mel_out", "dur", "pitch_pred", "decoder_inp"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL, err_msg=key)
    spec = torch.linspace(-7, 2, 80)
    torch.testing.assert_close(model.denorm_spec(model.norm_spec(spec)), spec)


def test_diffspeech_reverse_loop_matches_jax_given_its_per_step_noise():
    """Free-running: durations and pitch predicted, the state masked to the
    predicted frames after every step."""
    jm, params, model = _models()
    batch = tts_batch(4)
    jb, tb = jax_batch(batch), torch_batch(batch)
    rng = jax.random.PRNGKey(7)
    ref = jax.jit(functools.partial(jm.apply, infer=True))(
        {"params": params}, jb["txt_tokens"], spk_embed=jb["spk_embed"], rng=rng)
    keys, (key, sub) = [], jax.random.split(rng)
    keys.append(sub)
    for _ in range(DS_HP["timesteps"]):
        key, sub = jax.random.split(key)
        keys.append(sub)
    with torch.no_grad():
        out = model(tb["txt_tokens"], None, tb["spk_embed"],
                    noise=_noise(keys, (2, HP["max_frames"], 80)))
    np.testing.assert_array_equal(out["mel2ph"].numpy(), np.asarray(ref["mel2ph"]))
    lengths = (out["mel2ph"] > 0).sum(1)
    assert lengths.sum() > 10 and lengths.max() < HP["max_frames"]
    for row, n in enumerate(lengths.tolist()):
        assert not out["mel_out"][row, n:].any()
    np.testing.assert_allclose(out["mel_out"].numpy(), np.asarray(ref["mel_out"]), **LOOP_TOL)


def test_diffspeech_task_infer_matches_jax_p_sample_loop():
    jm, params, model = _models()
    task = DiffSpeechTask(DS_HP)
    j_task = jax_task(JDiffSpeechTask, DS_HP, 0)[0]
    batch = tts_batch(5)
    jb, tb = jax_batch(batch), torch_batch(batch)
    rng = jax.random.PRNGKey(8)
    ref = j_task.build_infer_fn(jm)({"params": params}, jb, rng)
    key, sub = jax.random.split(rng)
    keys = [sub] + list(jax.random.split(key, DS_HP["timesteps"]))
    out = task.build_infer_fn(model)(tb, noise=_noise(keys, batch["mels"].shape))
    np.testing.assert_allclose(out["mel_out"].numpy(), np.asarray(ref["mel_out"]), **LOOP_TOL)
    assert not out["mel_out"][1, 31:].any()
