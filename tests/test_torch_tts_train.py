"""PyTorch port, one training step of each TTS task (FastSpeech,
FastSpeech2-orig with CWT pitch and energy, DiffSpeech) through the port's
``Trainer`` against ``jax.value_and_grad`` of the JAX task's ``loss_fn`` on
CPU: every loss term, the total, the pre-clip gradient norm and every
parameter's gradient (dropout off; DiffSpeech given JAX's own diffusion
draws, regenerated from the same key splits). The bars are the family
tests': losses rtol 1e-4, gradients atol 1e-4 and rtol 1e-3
(``GRAD_TOL``). ``clip_grad_norm`` is 0 here, so the step leaves the
gradients as the loss gave them."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.training.tasks.tts import DiffSpeechTask as JDiffSpeechTask
from speech_editing_tpu.training.tasks.tts import FastSpeech2OrigTask as JFS2Task
from speech_editing_tpu.training.tasks.tts import FastSpeechTask as JFastSpeechTask
from speech_editing_tpu_torch.training.tasks.tts import (DiffSpeechTask, FastSpeech2OrigTask,
                                                         FastSpeechTask)
from speech_editing_tpu_torch.training.trainer import Trainer
from tests.test_torch_train import GRAD_TOL, SIL
from tests.test_torch_tts_diffspeech import DS_HP
from tests.test_torch_tts_fs import HP, jax_batch, jax_task, np_tree, one_thread  # noqa: F401
from tests.test_torch_tts_fs import tts_batch
from tests.test_torch_tts_fs2 import FS2_HP

TASKS = {
    "fs": (JFastSpeechTask, FastSpeechTask, dict(HP, encoder_type="fft", decoder_type="fft"),
           {"l1", "ssim", "pdur", "wdur", "sdur", "uv", "f0"}),
    "fs2_orig": (JFS2Task, FastSpeech2OrigTask, FS2_HP,
                 {"l1", "ssim", "pdur", "wdur", "sdur", "C", "uv", "f0_mean", "f0_std", "e"}),
    "diffspeech": (JDiffSpeechTask, DiffSpeechTask, DS_HP,
                   {"diff", "pdur", "wdur", "sdur", "uv", "f0"}),
}


def _batch(seed: int) -> dict:
    """The TTS batch with FastSpeech2-orig's CWT targets."""
    batch = tts_batch(seed)
    rs = np.random.RandomState(seed + 70)
    batch["cwt_spec"] = (rs.randn(2, batch["mels"].shape[1], 10) * (batch["mel2ph"] > 0)[..., None]
                         ).astype(np.float32)
    batch["f0_mean"] = (5 + rs.rand(2)).astype(np.float32)
    batch["f0_std"] = (0.2 + 0.1 * rs.rand(2)).astype(np.float32)
    return batch


@pytest.mark.parametrize("name", list(TASKS))
def test_tts_task_step_through_the_trainer_matches_jax(name):
    j_cls, cls, hp, terms = TASKS[name]
    hp = dict(hp, clip_grad_norm=0)
    j_task, jm, params = jax_task(j_cls, hp, seed=31)
    batch = _batch(6)
    rng = jax.random.PRNGKey(9)
    grad_fn = jax.jit(jax.value_and_grad(j_task.make_loss_fn(jm, train=False), has_aux=True))
    (j_total, j_losses), j_grads = grad_fn(params, jax_batch(batch), rng)
    task = cls(hp)
    task.sil_token_ids = SIL
    trainer = Trainer(task, task.hp, "cpu", dropout=False)
    trainer.model.load_state_dict(task.params_from_jax(params, hp))
    draws = {}
    if name == "diffspeech":
        k_t, k_noise = jax.random.split(jax.random.split(rng)[0])
        draws = dict(t=torch.tensor(np.asarray(jax.random.randint(
                         k_t, (2,), 0, hp["timesteps"]))).long(),
                     noise=torch.tensor(np.asarray(jax.random.normal(
                         k_noise, batch["mels"].shape, jnp.float32))))
    metrics = trainer.train_step(trainer._device_batch(batch), trainer.generator, **draws)
    assert set(j_losses) == terms and set(metrics) == terms | {"total_loss", "grad_norm",
                                                                "nan_grads"}
    for k in terms:
        np.testing.assert_allclose(float(metrics[k]), float(j_losses[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(metrics["total_loss"]), float(j_total), rtol=1e-4)
    j_norm = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree.leaves(j_grads))))
    np.testing.assert_allclose(float(metrics["grad_norm"]), j_norm, rtol=1e-3)
    ref = task.params_from_jax(np_tree(j_grads), hp)
    named = dict(trainer.model.named_parameters())
    assert sorted(named) == sorted(ref) and trainer.train_step.updates == 1
    for n, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[n].numpy(), **GRAD_TOL, err_msg=n)
