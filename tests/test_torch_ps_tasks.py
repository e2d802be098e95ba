"""PyTorch port, the PortaSpeech family's tasks against the JAX package on
CPU, and their runs:

* one step of PortaSpeech (KL warm-up and the ``posterior_start_steps``
  noise active) and of PortaSpeech-flow through the port's ``Trainer``
  against ``jax.value_and_grad`` of the JAX task's ``loss_fn``: every loss
  term, the total, the gradient norm and every parameter's gradient (JAX's
  draws injected; ``clip_grad_norm`` 0);
* a JAX ``TrainState`` checkpoint resumed in the port's trainer;
* ``WordSpeechDataset``'s items and batches (with ``token_size_multiple``
  and ``frame_size_multiple``) equal to the JAX package's;
* ``run`` on ``egs/{ps,ps_flow,ps_adv}.yaml`` at tiny widths over
  ``tests/helpers.py``'s word corpus (with its word and phone sets): two
  steps with sanity validation, a validation and a checkpoint, a resume to
  a third step, and ``--infer`` of the test split; the port's
  ``tts_infer`` refusing the family (``run --infer`` is its inference
  entry).

The models are narrower than ``tests/test_torch_portaspeech.py``'s (one
layer or block where that file has two: ``TASK_HP``), which keeps JAX's
compiles of the gradients short. The adversarial step is
``tests/test_torch_ps_adv.py``.
"""


import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.data.datasets import WordSpeechDataset as JWordSpeechDataset
from speech_editing_tpu.training.checkpoint import save_checkpoint as j_save_checkpoint
from speech_editing_tpu.training.optim import build_optimizer as j_optimizer
from speech_editing_tpu.training.tasks.portaspeech import PortaSpeechFlowTask as JFlowTask
from speech_editing_tpu.training.tasks.portaspeech import PortaSpeechTask as JPSTask
from speech_editing_tpu.training.train_state import TrainState
from speech_editing_tpu_torch.training.tasks.portaspeech import (PortaSpeechFlowTask,
                                                                 PortaSpeechTask)
from speech_editing_tpu_torch.training.trainer import Trainer
from speech_editing_tpu_torch.data.datasets import WordSpeechDataset
from speech_editing_tpu_torch.infer.tts_infer import infer_cls_for
from speech_editing_tpu_torch.run import run
from speech_editing_tpu_torch.training.checkpoint import get_last_checkpoint
from tests.helpers import TINY_HP, VOCAB, write_synth_corpus
from tests.test_torch_portaspeech import (PS_HP, fast_jit, jax_batch, jax_draws,  # noqa: F401
                                          jax_model, one_thread, word_batch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)    # the family tests' gradient bar
TASK_HP = dict(enc_layers=1, fvae_enc_n_layers=1, fvae_dec_n_layers=1, prior_flow_n_blocks=1,
               post_glow_n_blocks=1)
HP = dict(PS_HP, **TASK_HP, clip_grad_norm=0, lr=1e-3, scheduler="none", disc_win_num=2,
          mel_disc_hidden_size=16, lambda_mel_adv=0.05, disc_start_steps=0, disc_lr=2e-3)


def np_tree(tree):
    return jax.tree.map(np.array, tree)


@pytest.mark.parametrize("flow", [False, True], ids=["ps_warm", "ps_flow"])
def test_task_step_through_the_trainer_matches_jax(flow):
    """At step 30 of a 100-step KL warm-up; PortaSpeech with
    ``posterior_start_steps`` 50 decodes from the warm-up noise."""
    warm = not flow
    hp = dict(HP, posterior_start_steps=50 if warm else 0)
    jm, params, _ = jax_model(flow, warm, TASK_HP)
    j_task = (JFlowTask if flow else JPSTask)(hp)
    batch = word_batch(2)
    rng = jax.random.PRNGKey(4)
    jb = dict(jax_batch(batch), global_step=jnp.float32(30))
    (j_total, j_losses), j_grads = fast_jit(jax.value_and_grad(
        j_task.make_loss_fn(jm, train=False), has_aux=True), params, jb, rng)
    task = (PortaSpeechFlowTask if flow else PortaSpeechTask)(hp)
    trainer = Trainer(task, task.hp, "cpu", dropout=False)
    trainer.model.load_state_dict(task.params_from_jax(params, hp))
    trainer.train_step.step = 30
    draws = jax_draws(flow, jax.random.split(rng)[0], 2, 64, infer=False)
    if not warm:
        draws.pop("warm_noise")
    metrics = trainer.train_step(trainer._device_batch(batch), trainer.generator, **draws)
    terms = {"l1", "ssim", "kl", "wdur"} | ({"postflow"} if flow else set())
    assert set(j_losses) == terms
    assert set(metrics) == terms | {"total_loss", "grad_norm", "nan_grads"}
    for k in terms | {"total_loss"}:
        ref = j_total if k == "total_loss" else j_losses[k]
        np.testing.assert_allclose(float(metrics[k]), float(ref), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    j_norm = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree.leaves(j_grads))))
    np.testing.assert_allclose(float(metrics["grad_norm"]), j_norm, rtol=1e-3)
    ref = task.params_from_jax(np_tree(j_grads), hp)
    named = dict(trainer.model.named_parameters())
    assert sorted(named) == sorted(ref)
    for n, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[n].numpy(), **GRAD_TOL, err_msg=n)


def test_jax_train_state_resumes_in_the_port(tmp_path):
    _, params, _ = jax_model(True, False, TASK_HP)
    j_save_checkpoint(str(tmp_path), TrainState.create(params, j_optimizer(HP)), 12)
    hp = dict(HP, work_dir=str(tmp_path))
    trainer = Trainer(PortaSpeechFlowTask(hp), hp, "cpu")
    trainer._build_state()
    assert trainer.global_step == 12 and trainer.train_step.updates == 0
    want = trainer.task.params_from_jax(params, hp)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, want[k]), k


# -- the runs ------------------------------------------------------------------------

TINY = ("hidden_size=32,enc_layers=2,word_enc_layers=1,enc_ffn_kernel_size=3,"
        "dur_predictor_layers=2,fvae_enc_dec_hidden=32,latent_size=8,fvae_enc_n_layers=2,"
        "fvae_dec_n_layers=2,prior_flow_hidden=16,prior_flow_n_blocks=2,post_glow_hidden=16,"
        "post_glow_n_blocks=2,mel_disc_hidden_size=16,disc_win_num=2,max_sentences=4,"
        "max_valid_sentences=4,num_sanity_val_steps=1,eval_max_batches=1,tb_log_interval=1,"
        "ds_workers=0,test_num=2,test_save_workers=1,vocoder=GriffinLim,save_gt=False,"
        "num_valid_plots=0,lr=0.001,scheduler=none")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The word corpus with its word and phone sets."""
    d = tmp_path_factory.mktemp("words")
    write_synth_corpus(str(d), np.random.RandomState(0), n_items=8)
    (d / "word_set.json").write_text(json.dumps([f"W{i}" for i in range(VOCAB - 3)]))
    (d / "phone_set.json").write_text(json.dumps([f"P{i}" for i in range(VOCAB - 3)]))
    return str(d)


def _argv(config, corpus, work, more=""):
    return ["--config", os.path.join(REPO, "egs", f"{config}.yaml"), "--device", "cpu",
            "--exp_name", work, "-hp", f"binary_data_dir={corpus},{TINY}{more}"]


@pytest.mark.parametrize("config", ["ps", "ps_flow", "ps_adv"])
def test_run_trains_validates_resumes_and_infers(config, corpus, tmp_path, capsys):
    work = str(tmp_path / config)
    trainer = run(_argv(config, corpus, work, ",max_updates=2,val_check_interval=2"))
    assert trainer.global_step == 2 and get_last_checkpoint(work)[1] == 2
    assert trainer.task.word_dict_size == VOCAB
    out = capsys.readouterr().out
    assert "| validation @ step 2: " in out and "kl=" in out
    if config == "ps_adv":
        assert "disc_real=" in out and "adv=" in out
    trainer = run(_argv(config, corpus, work, ",max_updates=3,val_check_interval=2"))
    assert trainer.global_step == 3 and get_last_checkpoint(work)[1] == 3
    assert "| loaded checkpoint" in capsys.readouterr().out
    run(_argv(config, corpus, work, ",max_updates=3") + ["--infer"])
    gen_dir = os.path.join(work, "generated_3_test")
    wavs = [os.path.basename(f) for f in glob.glob(os.path.join(gen_dir, "wavs", "[[]P[]]*.wav"))]
    assert len(wavs) == 2
    mel = np.load(glob.glob(os.path.join(gen_dir, "wavs", "*_mel.npy"))[0])
    assert mel.shape[1] == 80 and np.isfinite(mel).all() and np.abs(mel).sum() > 0
    with pytest.raises(ValueError, match="no PortaSpeech driver"):
        infer_cls_for({"task_cls": f"x.{type(trainer.task).__name__}"})


def test_word_dataset_batches_match_jax(corpus):
    hp = dict(TINY_HP, binary_data_dir=corpus, frames_multiple=4, token_size_multiple=8,
              frame_size_multiple=16, seed=3)
    ours, ref = WordSpeechDataset("train", hp), JWordSpeechDataset("train", hp)
    samples = [(ours[i], ref[i]) for i in (0, 3, 5)]
    for got, want in samples:
        for k in ("word_token", "ph2word", "mel2word", "txt_token"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got = ours.collater([a for a, _ in samples])
    want = ref.collater([b for _, b in samples])
    for k in ("word_tokens", "ph2word", "mel2word", "txt_tokens", "mels", "pitch"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["word_tokens"].shape[1] % 8 == 0 and got["mel2word"].shape[1] % 16 == 0
