"""PyTorch port, resuming a JAX work dir: a checkpoint of a JAX run that has
taken steps carries its adamw state (Adam's count and moments, the
schedule's count) into the port's ``Trainer``, and one more step from it
equals JAX's next step: the same parameters at 1e-5, at the learning rate
JAX's schedule gives at that count (under the warmup schedule, not the lr
0 of a restart), with the same batch and diffusion draws."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_editing_tpu.models.spec_denoiser.spec_denoiser import \
    GaussianDiffusion as JGD
from speech_editing_tpu.training.checkpoint import save_checkpoint as j_save_checkpoint
from speech_editing_tpu.training.optim import build_lr_schedule as j_schedule
from speech_editing_tpu.training.optim import build_optimizer as j_optimizer
from speech_editing_tpu.training.tasks.spec_denoiser import \
    SpecDenoiserTask as JSpecDenoiserTask
from speech_editing_tpu.training.tasks.spec_denoiser import \
    make_loss_fn as j_make_loss_fn
from speech_editing_tpu.training.train_state import TrainState, make_train_step
from speech_editing_tpu_torch.training.checkpoint import load_jax_checkpoint
from speech_editing_tpu_torch.training.trainer import Trainer
from speech_editing_tpu_torch.utils.convert_jax_params import params_from_jax
from tests.test_torch_model import VOCAB
from tests.test_torch_stutter import random_params
from tests.test_torch_train import HP, SIL, _batch, _jax_batch, _jax_draws
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

# warmup over 4 updates, so that the resumed update (the third) runs at
# lr / 2 where a restart would run at 0
RESUME_HP = dict(HP, warmup_updates=4)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX run of two steps saved to a work dir, and JAX's third step
    from it: (work dir, state after two, state after three, the third
    step's batch and rng)."""
    jm = JGD(vocab_size=VOCAB, hp=RESUME_HP, out_dims=80)
    task = JSpecDenoiserTask(dict(RESUME_HP, vocab_size=VOCAB, binary_data_dir=""))
    params = random_params(task, _batch(0), 3)
    tx = j_optimizer(RESUME_HP)
    j_step = make_train_step(j_make_loss_fn(jm, RESUME_HP, SIL, train=False), tx)
    state = TrainState.create(params, tx)
    for i in (0, 1):
        state, _ = j_step(state, _jax_batch(_batch(i)), jax.random.PRNGKey(20 + i))
    state = jax.tree.map(np.asarray, state)    # the step donates its input state
    work = tmp_path_factory.mktemp("jax_work")
    j_save_checkpoint(str(work), state, 2)
    rng = jax.random.PRNGKey(22)
    third, _ = j_step(jax.tree.map(jnp.array, state), _jax_batch(_batch(2)), rng)
    return str(work), state, third, rng


def _adam(opt_state):
    return next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def test_the_checkpoint_carries_the_adamw_state(jax_run):
    work, state, _, _ = jax_run
    payload = load_jax_checkpoint(f"{work}/model_ckpt_steps_2.ckpt")
    adam = payload["jax_adam"]
    assert adam["count"] == adam["schedule_count"] == 2
    want = _adam(state.opt_state)
    for got, ref in ((adam["mu"], want.mu), (adam["nu"], want.nu)):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_ref = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, dict(ref)))
        assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
        for (path, g), (_, r) in zip(flat_got, flat_ref):
            np.testing.assert_array_equal(g, r, err_msg=str(path))


def test_a_resumed_step_equals_jax_next_step(jax_run, capsys):
    work, state, third, rng = jax_run
    trainer = Trainer.from_hp(dict(RESUME_HP, work_dir=work), device="cpu",
                              vocab_size=VOCAB, sil_token_ids=SIL, dropout=False)
    trainer._build_state()
    assert "Adam's moments and 2 updates" in capsys.readouterr().out
    step = trainer.train_step
    assert step.step == 2 and step.updates == 2
    named = dict(trainer.model.named_parameters())
    mu = params_from_jax(jax.tree.map(np.asarray, _adam(state.opt_state).mu), HP)
    for name, p in named.items():
        assert torch.equal(step.optimizer.state[p]["exp_avg"], mu[name]), name
        assert float(step.optimizer.state[p]["step"]) == 2.0

    batch = _batch(2)
    t, noise = _jax_draws(rng, batch)
    step({k: torch.tensor(v) for k, v in batch.items()}, t=t, noise=noise)
    lr = float(j_schedule(RESUME_HP)(2))
    assert lr == pytest.approx(RESUME_HP["lr"] / 2, rel=1e-7)
    assert step.optimizer.param_groups[0]["lr"] == pytest.approx(lr, rel=1e-7)
    assert step.updates == 3 and step.step == 3
    ref = params_from_jax(jax.tree.map(np.asarray, third.params), HP)
    start = params_from_jax(jax.tree.map(np.asarray, state.params), HP)
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    assert any(not torch.equal(p.detach(), start[n]) for n, p in named.items())
