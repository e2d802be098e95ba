"""PyTorch port, data-parallel training on the CPU over two gloo ranks: a
FluentSpeech step equals JAX's single-device ``make_train_step`` on the
global batch (two steps, parameters and Adam moments within 1e-4); the
training entry ``run`` under torchrun's environment (each rank joins
through ``init_distributed()`` and trains on its rows) writes checkpoints
equal to a single-process run within 1e-5 for the spec_denoiser task
(predictor dropout on: its masks are drawn for the global batch), with
rank 0 alone printing and writing (the HiFi-GAN task's run is
``test_torch_parallel_gan.py``); a ``tp_size`` that does not divide the
world raises; and ``Trainer.test`` refuses to run under more than one
rank."""

import os

import jax
import numpy as np
import pytest
import torch

from speech_editing_tpu.training.train_state import TrainState
from speech_editing_tpu_torch.parallel.dryrun import spawn_ranks
from speech_editing_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from speech_editing_tpu_torch.training.checkpoint import get_all_ckpts
from speech_editing_tpu_torch.training.tasks.spec_denoiser import SpecDenoiserTask
from speech_editing_tpu_torch.training.trainer import Trainer
from speech_editing_tpu_torch.utils.convert_jax_params import params_from_jax
from tests import torch_parallel_workers as workers
from tests.helpers import TINY_HP
from tests.test_torch_train import (HP, SIL, VOCAB, _adam, _batch, _jax, _jax_draws,
                                    _jax_train_step, _port_model)
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)


def test_dp_steps_match_jax():
    """Each of two ranks takes one row of ``_batch``'s two; after two steps
    (the second at lr / 2) both hold JAX's parameters and moments."""
    _, params, _, _ = _jax()
    tx, j_step = _jax_train_step()
    state = TrainState.create(params, tx)
    batches, draws, j_metrics = [], [], []
    for i, seed in enumerate((0, 1)):
        batch, rng = _batch(seed), jax.random.PRNGKey(10 + i)
        state, m = j_step(state, {k: jax.numpy.asarray(v.astype(np.int32) if v.dtype == np.int64
                                                       else v) for k, v in batch.items()}, rng)
        j_metrics.append(m)
        batches.append(batch)
        draws.append(_jax_draws(rng, batch))
    got = spawn_ranks(workers.train_steps, 2, dict(
        hp=HP, vocab=VOCAB, sil=SIL, weights=params_from_jax(params, HP), batches=batches,
        draws=draws))
    names = list(_port_model(params).state_dict())
    adam = _adam(state.opt_state)
    full = got[0]["state"]
    for key, tree in (("model", state.params), ("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        ref = params_from_jax(jax.tree.map(np.asarray, tree), HP)
        for i, name in enumerate(names):
            ours = full["model"][name] if key == "model" else full["optimizer"]["state"][i][key]
            np.testing.assert_allclose(ours.numpy(), ref[name].numpy(), atol=1e-4, rtol=1e-4,
                                       err_msg=f"{key} {name}")
    for out in got:
        assert out["finite"] and out["rows"] == [1, 1]
        for m, jm in zip(out["metrics"], j_metrics):
            for k in ("total_loss", "grad_norm", "nan_grads", "l1_coarse", "sdur"):
                np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def sd_config(tmp_path_factory):
    return workers.write_sd_config(tmp_path_factory.mktemp("dp_run"))


def test_two_rank_run_matches_one_process_spec_denoiser(sd_config, tmp_path):
    argv = ["--config", sd_config, "--device", "cpu"]
    work_s, work_m = str(tmp_path / "single"), str(tmp_path / "multi")
    single, got = workers.single_and_two_ranks(argv, work_s, work_m)
    assert single.global_step == got[0]["step"] == got[1]["step"] == 4
    assert got[0]["mesh"] == "data=2"
    workers.assert_same_checkpoint(work_s, work_m)
    workers.assert_rank0_alone_logs(got, work_m)
    assert [os.path.basename(p) for p in get_all_ckpts(work_m)] == [
        "model_ckpt_steps_4.ckpt", "model_ckpt_steps_2.ckpt"]
    for k, v in got[1]["model"].items():     # every rank ends with the same weights
        torch.testing.assert_close(v, got[0]["model"][k], rtol=0, atol=0)


def test_tp_size_must_divide_the_world():
    task = SpecDenoiserTask(dict(TINY_HP, vocab_size=10, binary_data_dir=""))
    with pytest.raises(ValueError, match="tp=2 must divide the world size 1"):
        Trainer(task, dict(task.hp, tp_size=2), device="cpu")


def test_test_refuses_more_than_one_rank(tmp_path):
    """``--infer`` runs single-process (JAX's ``test_multihost_infer_guard``)."""
    hp = dict(TINY_HP, binary_data_dir=str(tmp_path), infer=True,
              work_dir=str(tmp_path / "work"), vocab_size=10)
    trainer = Trainer(SpecDenoiserTask(hp), hp, device="cpu")
    trainer.mesh = Mesh({DATA_AXIS: 2}, 0, {})      # rank 0 of a 2-rank job
    with pytest.raises(RuntimeError, match="single-process"):
        trainer.test()
