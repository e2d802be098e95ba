"""PyTorch port, the training tasks of the editing families beside
FluentSpeech, against the JAX package on CPU: CampNet's, A3T's and
EditSpeech's losses and every gradient (dropout off; CampNet with the
reference's value-only masking and without it, EditSpeech with the
teacher-forcing coin at 0 and at 1 and both backward-LSTM modes), A3T's
``AffineNorm`` under ``model.train()``, a JAX checkpoint of each family
loaded through that family's converter, and the entry's task table (the
two-step runs are in ``test_torch_family_run.py``).

Losses agree within rtol 1e-4 and gradients within atol 1e-4, rtol 1e-3
(``GRAD_TOL``).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from speech_editing_tpu.training.checkpoint import save_checkpoint as j_save_checkpoint
from speech_editing_tpu.training.optim import build_optimizer as j_optimizer
from speech_editing_tpu.training.tasks.a3t import A3TTask as JA3TTask
from speech_editing_tpu.training.tasks.campnet import CampNetTask as JCampNetTask
from speech_editing_tpu.training.tasks.editspeech import EditSpeechTask as JEditSpeechTask
from speech_editing_tpu.training.train_state import TrainState
from speech_editing_tpu_torch.models.a3t import A3T
from speech_editing_tpu_torch.modules.conformer import AffineNorm
from speech_editing_tpu_torch.run import TASKS, task_class
from speech_editing_tpu_torch.training.tasks.a3t import A3TTask
from speech_editing_tpu_torch.training.tasks.campnet import CampNetTask
from speech_editing_tpu_torch.training.tasks.editspeech import EditSpeechTask
from speech_editing_tpu_torch.training.trainer import Trainer
from speech_editing_tpu_torch.utils.init import init_like_flax
from tests.helpers import TINY_HP
from tests.test_torch_model import VOCAB
from tests.test_torch_stutter import random_params
from tests.test_torch_train import GRAD_TOL, SIL, _jax_batch, _torch_batch
from tests.test_torch_train import _batch as _train_batch
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

HP = dict(TINY_HP, vocab_size=VOCAB, binary_data_dir="", lstm_hidden=32)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _batch(seed):
    batch = _train_batch(seed)
    batch["spk_embed"] = np.random.RandomState(seed + 100).randn(2, 256).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax(family: str, **extra):
    """(JAX task, perturbed numpy params, jitted value_and_grad of its loss
    with dropout off), the tasks' silence ids ``SIL``."""
    jcls = {"campnet": JCampNetTask, "a3t": JA3TTask, "editspeech": JEditSpeechTask}[family]
    task = type("Task", (jcls,), {"sil_token_ids": SIL})(dict(HP, **extra))
    model = task.build_model()
    params = random_params(task, _batch(0), 3)
    grad_fn = jax.jit(jax.value_and_grad(task.make_loss_fn(model, train=False), has_aux=True))
    return task, params, grad_fn


PORT = {"campnet": CampNetTask, "a3t": A3TTask, "editspeech": EditSpeechTask}


def _check_loss_and_grads(family, rng, draws=None, **extra):
    jtask, params, grad_fn = _jax(family, **extra)
    batch = _batch(1)
    (j_total, j_losses), j_grads = grad_fn(params, _jax_batch(batch), rng)
    task = PORT[family](dict(HP, **extra))
    task.sil_token_ids = SIL
    model = task.build_model()
    model.load_state_dict(task.params_from_jax(params, task.hp))
    model.train()
    total, losses = task.make_loss_fn(model, train=False)(_torch_batch(batch), **(draws or {}))
    total.backward()
    assert sorted(losses) == sorted(j_losses)
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()), float(j_losses[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=1e-4)
    ref = task.params_from_jax(_np(j_grads), task.hp)
    named = {n: p for n, p in model.named_parameters() if p.requires_grad}
    # the LSTMs' input biases are frozen at zero: flax's cells have none
    assert sorted(set(ref) - set(named)) == sorted(n for n, _ in model.named_parameters()
                                                   if not _.requires_grad)
    for name, p in named.items():
        # a parameter the loss does not reach (EditSpeech's dur_embed) has
        # no gradient, and a zero one in JAX's tree
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(grad.numpy(), ref[name].numpy(), **GRAD_TOL, err_msg=name)
    return losses


@pytest.mark.parametrize("ref_pad_compat", [False, True])
def test_campnet_loss_and_every_gradient_match_jax(ref_pad_compat):
    losses = _check_loss_and_grads("campnet", jax.random.PRNGKey(1),
                                   ref_pad_compat=ref_pad_compat)
    assert set(losses) == {"l1_coarse", "ssim_coarse", "l1_fine", "ssim_fine"}


def test_a3t_loss_and_every_gradient_match_jax():
    losses = _check_loss_and_grads("a3t", jax.random.PRNGKey(2))
    assert set(losses) == {"l1_coarse", "ssim_coarse", "l1_fine", "ssim_fine"}


def _coin_key(heads: bool) -> jax.Array:
    """A key whose teacher-forcing draw in the JAX loss comes out ``heads``."""
    for seed in range(100):
        rng = jax.random.PRNGKey(seed)
        if bool(jax.random.uniform(jax.random.split(rng)[0], ()) < 0.5) == heads:
            return rng
    raise AssertionError("no key found")


@pytest.mark.parametrize("ref_pad_compat", [False, True])
@pytest.mark.parametrize("coin", [0, 1])
def test_editspeech_loss_and_every_gradient_match_jax(coin, ref_pad_compat):
    """Teacher-forced (coin 1: ``proj_in`` of the ground truth) and
    free-running (coin 0) inputs, the backward LSTM right-aligned or over
    the padded axis: every gradient, ``proj_in``'s and both LSTMs' too."""
    losses = _check_loss_and_grads("editspeech", _coin_key(bool(coin)),
                                   {"teacher_forcing": float(coin)},
                                   ref_pad_compat=ref_pad_compat)
    assert set(losses) == {"l1_forward", "ssim_forward", "l1_backward", "ssim_backward",
                           "pdur", "wdur"}


def test_editspeech_draws_its_coin_from_the_generator():
    task = EditSpeechTask(HP)
    torch.manual_seed(0)
    model = task.build_model()
    loss_fn = task.make_loss_fn(model, train=False)
    batch = _torch_batch(_batch(2))
    totals = {c: float(loss_fn(batch, teacher_forcing=c)[0].detach()) for c in (0.0, 1.0)}
    drawn = [float(loss_fn(batch, torch.Generator().manual_seed(s))[0].detach()) for s in range(8)]
    assert set(drawn) == set(totals.values())


def test_affine_norm_is_unchanged_by_train_mode():
    """A3T under ``espnet_bn_affine``: ``model.train()`` leaves its norms on
    their stored statistics (no batch statistics, no update of them)."""
    torch.manual_seed(0)
    model = init_like_flax(A3T(VOCAB, dict(HP, espnet_bn_affine=True)))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, AffineNorm):
                m.running_mean.normal_()
                m.running_var.uniform_(0.5, 2.0)
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    assert stats
    b = _torch_batch(_batch(3))
    args = (b["txt_tokens"], b["mels"], b["mel2ph"], b["time_mel_masks"][..., None])
    with torch.no_grad():
        model.eval()
        ev = model(*args)["mel_out_postnet"]
        model.train()
        tr = model(*args)["mel_out_postnet"]
    torch.testing.assert_close(tr, ev, rtol=0, atol=0)
    for k, v in model.state_dict().items():
        if k in stats:
            assert torch.equal(v, stats[k]), k


@pytest.mark.parametrize("family", sorted(PORT))
def test_a_jax_checkpoint_loads_through_the_familys_converter(family, tmp_path):
    jtask, params, _ = _jax(family)
    j_save_checkpoint(str(tmp_path), TrainState.create(params, j_optimizer(dict(HP, lr=1e-3))),
                      12)
    hp = dict(HP, work_dir=str(tmp_path))
    trainer = Trainer(PORT[family](hp), hp, "cpu")
    trainer._build_state()
    assert trainer.global_step == 12
    want = trainer.task.params_from_jax(params, trainer.hp)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_the_entry_resolves_every_editing_task():
    for name in ("spec_denoiser.SpecDenoiserTask", "stutter_speech.StutterSpeechTask",
                 "stutter_speech.StutterPredictorTask", "campnet.CampNetTask",
                 "a3t.A3TTask", "editspeech.EditSpeechTask", "ps_adv.PortaSpeechAdvTask",
                 "portaspeech.PortaSpeechTask", "portaspeech.PortaSpeechFlowTask"):
        cls = task_class(f"speech_editing_tpu.training.tasks.{name}")
        assert cls is TASKS[name.split(".")[1]]
    with pytest.raises(ValueError, match="has no task"):
        task_class("speech_editing_tpu.training.tasks.tts.TacotronTask")
