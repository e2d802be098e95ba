"""PyTorch port, the training entry ``python -m speech_editing_tpu_torch.run``
on the CPU: a tiny config over ``egs/spec_denoiser.yaml`` and a tiny
synthetic corpus train N steps with sanity and interval validation and
rolling checkpoints, a second run resumes at N, ``--validate`` validates
the last checkpoint, the eval loss of one validation batch equals the JAX
package's eval step with the same injected draws, the shipped config
(``use_bf16: true``) trains in bf16, the editing configs' switches train
through the entry, and the settings the port does not run raise
(``--infer`` itself is tested in ``test_torch_infer_run.py``)."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.models.spec_denoiser.spec_denoiser import \
    GaussianDiffusion as JGD
from speech_editing_tpu.training.tasks.spec_denoiser import \
    SpecDenoiserTask as JSpecDenoiserTask
from speech_editing_tpu.training.tasks.spec_denoiser import \
    make_loss_fn as j_make_loss_fn
from speech_editing_tpu.training.train_state import make_eval_step as j_make_eval_step
from speech_editing_tpu.utils.convert_torch_ckpt import convert_gaussian_diffusion
from speech_editing_tpu_torch.config.hparams import dump_yaml
from speech_editing_tpu_torch.run import run
from speech_editing_tpu_torch.training.checkpoint import get_all_ckpts
from tests.helpers import TINY_HP, VOCAB, write_synth_corpus
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHONES = ["|", ",", "sil"] + [f"P{i}" for i in range(VOCAB - 6)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(tiny config path, exp name): the corpus, its phone set and a config
    whose base is the shipped ``egs/spec_denoiser.yaml``."""
    d = tmp_path_factory.mktemp("run")
    write_synth_corpus(str(d / "data"), np.random.RandomState(0), n_items=8)
    (d / "data" / "phone_set.json").write_text(json.dumps(PHONES))
    cfg = dict(TINY_HP, base_config=os.path.join(REPO, "egs", "spec_denoiser.yaml"),
               binary_data_dir=str(d / "data"), decoder_type="fft", residual_channels=16,
               max_updates=4, val_check_interval=2, num_sanity_val_steps=1,
               eval_max_batches=2, tb_log_interval=1, max_sentences=4, ds_workers=0,
               num_ckpt_keep=2)
    (d / "tiny.yaml").write_text(dump_yaml(cfg))
    return str(d / "tiny.yaml"), str(d / "exp")


def _run(setup, *extra):
    config, exp = setup
    return run(["--config", config, "--exp_name", exp, "--device", "cpu",
                "-hp", "use_bf16=False", *extra])


@functools.lru_cache(maxsize=1)
def _trained(setup):
    return _run(setup)


def test_trains_validates_checkpoints_and_resumes(setup, capsys):
    trainer = _trained(setup)
    out = capsys.readouterr().out
    assert trainer.global_step == 4 and trainer.train_step.updates == 4
    ref = JSpecDenoiserTask(trainer.hp)
    assert trainer.task.vocab_size == ref.vocab_size == len(PHONES) + 3
    assert trainer.task.sil_token_ids == ref.sil_token_ids == (0, 1, 2, 3, 4)
    for step in (1, 2, 3, 4):
        assert f"| step {step} |" in out
    assert "| validation @ step 2:" in out and "| validation @ step 4:" in out
    work = setup[1]
    assert [os.path.basename(p) for p in get_all_ckpts(work)] == [
        "model_ckpt_steps_4.ckpt", "model_ckpt_steps_2.ckpt"]
    assert os.path.exists(os.path.join(work, "config.yaml"))
    saved = {k: v.clone() for k, v in trainer.train_step.state_dict()["model"].items()}
    resumed = _run(setup, "-hp", "use_bf16=False,max_updates=6")
    out = capsys.readouterr().out
    assert f"| loaded checkpoint {work}/model_ckpt_steps_4.ckpt (step 4)" in out
    assert "| step 5 |" in out and resumed.global_step == 6
    assert [os.path.basename(p) for p in get_all_ckpts(work)] == [
        "model_ckpt_steps_6.ckpt", "model_ckpt_steps_4.ckpt"]
    assert any(not torch.equal(v, saved[k])
               for k, v in resumed.train_step.state_dict()["model"].items())
    validated = _run(setup, "--validate")
    assert validated.global_step == 6 and "| validation @ step 6:" in capsys.readouterr().out


def test_eval_loss_equals_jax(setup):
    trainer = _trained(setup)
    hp = trainer.hp
    with trainer._loader("valid", shuffle=False, max_sentences_key="max_valid_sentences") \
            as loader:
        raw = next(iter(loader))
    keys = trainer.task.effective_batch_keys()
    assert "spk_embed" in keys
    batch = {k: raw[k] for k in keys}
    sd = {k: v.detach().numpy() for k, v in trainer.model.state_dict().items()}
    jm = JGD(vocab_size=trainer.task.vocab_size, hp=hp, out_dims=80)
    j_eval = j_make_eval_step(j_make_loss_fn(jm, hp, trainer.task.sil_token_ids,
                                             train=False))
    rng = jax.random.PRNGKey(3)
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
          for k, v in batch.items()}
    ref = j_eval(convert_gaussian_diffusion(sd, hp), jb, rng)
    # the draws JAX's loss takes from ``rng``
    k_t, k_noise = jax.random.split(jax.random.split(rng)[0])
    t = jax.random.randint(k_t, (len(raw["id"]),), 0, hp["timesteps"] + 1)
    noise = jax.random.normal(k_noise, raw["mels"].shape, jnp.float32)
    got = trainer.eval_step(trainer._device_batch(raw), t=torch.tensor(np.asarray(t)).long(),
                            noise=torch.tensor(np.asarray(noise)))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_the_shipped_config_trains_in_bf16(setup, tmp_path):
    """``egs/spec_denoiser.yaml`` as shipped (``use_bf16: true``, no
    override) takes two steps in bf16 against float32 master weights, and
    checkpoints float32 parameters and moments."""
    trainer = run(["--config", setup[0], "--exp_name", str(tmp_path / "bf16"), "--device",
                   "cpu", "-hp", "max_updates=2"])
    assert trainer.hp["use_bf16"] is True and trainer.global_step == 2
    assert trainer.train_step.updates == 2
    state = torch.load(get_all_ckpts(str(tmp_path / "bf16"))[0], weights_only=True)["state"]
    assert all(v.dtype == torch.float32 for v in state["model"].values()
               if v.is_floating_point())
    moments = [m for s in state["optimizer"]["state"].values()
               for k, m in s.items() if k.startswith("exp_avg")]
    assert moments and all(m.dtype == torch.float32 and torch.isfinite(m).all()
                           for m in moments)
    assert any(float(m.abs().max()) > 0 for m in moments)


@pytest.mark.parametrize("extra", [
    ["-hp", "use_bf16=False,train_sets=a|b"],
    ["--infer", "-hp", "use_bf16=False,train_sets=a|b"],
    ["--infer", "-hp", "use_bf16=False,tp_size=2"],
    ["-hp", "use_bf16=False,tp_size=2"],
])
def test_settings_not_ported_raise(setup, tmp_path, extra):
    """``train_sets`` does nothing in the JAX package and raises; a
    ``tp_size`` of 2 in one process raises, since the model axis must
    divide the world size (``tests/test_torch_parallel_*.py`` train with it
    on two ranks)."""
    error = ValueError if "tp_size" in extra[-1] else NotImplementedError
    with pytest.raises(error):
        run(["--config", setup[0], "--exp_name", str(tmp_path / "x"), "--device", "cpu",
             *extra])


@pytest.mark.parametrize("extra", [
    "no_diffusion=True", "use_masked_cond=False", "ref_pad_compat=True",
    "accumulate_grad_batches=2", "use_bf16=True,accumulate_grad_batches=2"])
def test_switches_train_through_the_entry(setup, tmp_path, extra):
    """The editing configs' switches train through the entry: two updates
    (of two microbatches each under accumulation), finite losses."""
    trainer = run(["--config", setup[0], "--exp_name", str(tmp_path / "x"), "--device", "cpu",
                   "-hp", f"use_bf16=False,max_updates=2,val_check_interval=2,"
                   f"num_sanity_val_steps=0,{extra}"])
    assert trainer.global_step == trainer.train_step.updates == 2
    assert trainer.accum == (2 if "accumulate" in extra else 1)
    assert get_all_ckpts(str(tmp_path / "x"))
