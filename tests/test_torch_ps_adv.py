"""PyTorch port, adversarial PortaSpeech's step against the JAX package on
CPU: one step (``AdvTrainStep`` against the JAX task's ``step_fn``) from a
JAX ``GanTrainState`` checkpoint that the port's trainer loads (both nets,
both Adam states, the step): every metric, then both nets' parameters and
Adam moments; JAX's draws (the posterior's noise, the windows' starts)
injected. The widths are ``tests/test_torch_ps_tasks.py``'s; the
two-rank step is ``tests/test_torch_parallel_ps_adv.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from speech_editing_tpu.training.checkpoint import save_checkpoint as j_save_checkpoint
from speech_editing_tpu.training.optim import build_optimizer as j_optimizer
from speech_editing_tpu.training.tasks.hifigan import GanTrainState
from speech_editing_tpu.training.tasks.ps_adv import PortaSpeechAdvTask as JAdvTask
from speech_editing_tpu_torch.training.tasks.ps_adv import PortaSpeechAdvTask
from speech_editing_tpu_torch.training.trainer import Trainer
from speech_editing_tpu_torch.utils.convert_jax_params import multi_window_disc_params_from_jax
from tests.test_torch_portaspeech import (fast_jit, init_shapes, jax_batch,  # noqa: F401
                                          jax_draws, jax_model, np_, one_thread, random_tree,
                                          word_batch)
from tests.test_torch_ps_tasks import HP, TASK_HP


def _adam(opt_state):
    return next(s for s in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu"))


def _assert_net_matches(net, opt, j_params, j_opt, convert, lr):
    """Parameters within 1e-4 and Adam moments within 1e-3 in relative L2
    a tensor. Adam's first step moves a parameter by lr times its
    gradient's sign: where JAX's gradient is within rounding of zero
    (under 1e-2 of its tensor's rms) the sign may differ, and the parameter
    may then lie up to 2 lr away."""
    adam = _adam(j_opt)
    want, mu, nu = (convert(t) for t in (j_params, adam.mu, adam.nu))
    for name, p in net.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        apart = np.abs(got - ref) > 1e-4 + 1e-4 * np.abs(ref)
        if apart.any():
            m = mu[name].numpy()
            assert (np.abs(m) <= 1e-2 * np.sqrt(np.mean(m ** 2)))[apart].all(), name
            assert np.abs(got - ref)[apart].max() <= 2.02 * lr + 1e-4, name
        for key, ref_m in (("exp_avg", mu), ("exp_avg_sq", nu)):
            got_m, ref_m = opt.state[p][key], ref_m[name]
            err = float((got_m - ref_m).norm() / ref_m.norm().clamp(min=1e-30))
            assert err <= 1e-3, (name, key, err)
        assert float(opt.state[p]["step"]) == int(adam.count)


def test_adv_step_from_a_jax_checkpoint_matches_jax(tmp_path):
    jm, params, _ = jax_model(False, True, TASK_HP)     # no step count: the warm-up is off
    j_task = JAdvTask(HP)
    jd = j_task.build_discriminators()
    batch = word_batch(3)
    jb = jax_batch(batch)
    x_len = (batch["mel2word"] > 0).sum(-1)
    d_params = random_tree(init_shapes(jd, jb["mels"], x_len, rng=jax.random.PRNGKey(0)), 12)
    j_task.gen_tx = j_optimizer(HP)
    j_task.disc_tx = j_optimizer(dict(HP, lr=HP["disc_lr"]))
    state = GanTrainState(step=jnp.zeros((), jnp.int32), gen_params=params,
                          gen_opt=j_task.gen_tx.init(params), disc_params=d_params,
                          disc_opt=j_task.disc_tx.init(d_params))
    j_save_checkpoint(str(tmp_path), state, 5)
    rng = jax.random.PRNGKey(6)
    new, j_metrics = fast_jit(j_task.make_gan_train_step(jm, jd),
                              jax.tree.map(jnp.array, state), jb, rng)
    # JAX's draws: k_gen -> (k_vae, k_drop, k_win); the windows from k_win
    k_vae, _, k_win = jax.random.split(jax.random.split(rng)[0], 3)
    eps = jax_draws(False, k_vae, 2, 64, infer=False)["eps"]
    starts = [torch.tensor(np_(jax.random.randint(k, (2,), 0, 2 ** 30)) % np.maximum(
        x_len - win, 1)) for k, win in zip(jax.random.split(k_win, 2), (32, 64))]

    hp = dict(HP, work_dir=str(tmp_path))
    trainer = Trainer(PortaSpeechAdvTask(hp), hp, "cpu")
    trainer._build_state()
    assert trainer.global_step == 5
    metrics = trainer.train_step(trainer._device_batch(batch), trainer.generator, eps=eps,
                                 start_frames=starts)
    assert set(metrics) == set(j_metrics) == {"l1", "ssim", "kl", "wdur", "adv", "disc_real",
                                              "disc_fake", "total_loss"}
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(j_metrics[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    step = trainer.train_step
    assert step.step == 6 and int(new.step) == 1
    new = jax.tree.map(np_, new)
    _assert_net_matches(trainer.model, step.gen_opt, new.gen_params, new.gen_opt,
                        lambda t: trainer.task.params_from_jax(t, hp), HP["lr"])
    _assert_net_matches(trainer.disc, step.disc_opt, new.disc_params, new.disc_opt,
                        multi_window_disc_params_from_jax, HP["disc_lr"])
