"""PyTorch port, ``enc_dec_norm`` in the other families' conv stacks
against the JAX package on CPU: CampNet's ``ConvBlocks`` under ``bn``
(GroupNorm with 8 groups) and StutterSpeech's conv encoder and stutter head
under an unknown name (no norm), the loss and every gradient of a training
step each (the FluentSpeech cases are in ``test_torch_enc_dec_norm.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_bf16_families import one_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_enc_dec_norm import TOL
from tests.test_torch_model import VOCAB
from tests.test_torch_train import SIL, _jax_batch, _jax_draws, _torch_batch


def test_campnet_conv_blocks_train_with_batch_norm_name():
    """CampNet's ``ConvBlocks`` under ``enc_dec_norm=bn``: its loss and
    every gradient against JAX's (the family harness)."""
    from tests.test_torch_family_train import _check_loss_and_grads

    losses = _check_loss_and_grads("campnet", jax.random.PRNGKey(1), enc_dec_norm="bn")
    assert set(losses) == {"l1_coarse", "ssim_coarse", "l1_fine", "ssim_fine"}


def test_stutter_speech_conv_stacks_train_without_a_norm():
    """StutterSpeech's conv encoder and stutter head under an unknown
    ``enc_dec_norm`` (no norm): its loss and every gradient against JAX's."""
    from speech_editing_tpu.training.tasks.stutter_speech import \
        StutterSpeechTask as JStutterSpeechTask
    from speech_editing_tpu_torch.models.stutter_speech import StutterGaussianDiffusion
    from speech_editing_tpu_torch.training.tasks.stutter_speech import StutterSpeechTask
    from speech_editing_tpu_torch.utils.convert_jax_params import \
        stutter_speech_params_from_jax
    from tests.test_torch_stutter import HP as STUTTER_HP
    from tests.test_torch_stutter import _batch as stutter_batch
    from tests.test_torch_stutter import random_params

    hp = dict(STUTTER_HP, enc_dec_norm="none")
    task = type("Task", (JStutterSpeechTask,), {"sil_token_ids": SIL})(hp)
    params = random_params(task, stutter_batch(0), 7)
    batch, rng = stutter_batch(0), jax.random.PRNGKey(5)
    grad_fn = jax.jit(jax.value_and_grad(task.make_loss_fn(task.build_model(), train=False),
                                         has_aux=True))
    jbatch = dict(_jax_batch(batch), global_step=jnp.asarray(0.0, jnp.float32))
    (_, j_losses), j_grads = grad_fn(params, jbatch, rng)
    model = StutterGaussianDiffusion(VOCAB, hp, 80)
    model.load_state_dict(stutter_speech_params_from_jax(params, hp))
    assert not any("norm" in k for k in model.state_dict() if ".res_blocks." in k)
    port = StutterSpeechTask(hp)
    port.sil_token_ids = SIL
    t, noise = _jax_draws(rng, batch)
    total, losses = port.make_loss_fn(model, train=False)(
        dict(_torch_batch(batch), global_step=torch.tensor(0.0)), t=t, noise=noise)
    total.backward()
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()), float(j_losses[k]), **TOL,
                                   err_msg=k)
    ref = stutter_speech_params_from_jax(jax.tree.map(np.asarray, j_grads), hp)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), **TOL, err_msg=name)
