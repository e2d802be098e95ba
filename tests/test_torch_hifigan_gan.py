"""PyTorch port, HiFi-GAN's GAN training against the JAX package on CPU:
each discriminator (a period one, a scale one, the MPD and the MSD with
their pooling) on the same weights, every feature map included; the
LSGAN, feature-matching and spectral losses (the GAN-loss mel, the STFT
magnitude, the multi-resolution STFT loss); two steps of the whole GAN
step (``GanTrainStep`` against ``make_gan_train_step``): every loss and
both nets' parameters and Adam moments; and a JAX ``GanTrainState``
checkpoint resumed in the port's trainer with both Adam states, then
stepped once more in both.

A tiny config (``tests/helpers.py::TINY_VOC_HP``: hop 64, a 3-stage
ResBlock2 generator of 16 channels) with the MPD shrunk to periods 2 and 3
and the MSD to 2 scales, the STFT losses on. Weights: random draws in the
shapes of the JAX modules' ``init`` (traced, not compiled), crossed by
``vocoder_params_from_jax`` and ``discriminator_params_from_jax``.
Tolerance atol = rtol = 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.models.vocoder import hifigan as jh
from speech_editing_tpu.models.vocoder import losses as jlosses
from speech_editing_tpu.training.checkpoint import save_checkpoint as j_save_checkpoint
from speech_editing_tpu.training.optim import build_gan_optimizer as j_gan_optimizer
from speech_editing_tpu.training.tasks.hifigan import GanTrainState
from speech_editing_tpu.training.tasks.hifigan import HifiGanTask as JHifiGanTask
from speech_editing_tpu_torch.models.vocoder import hifigan as th
from speech_editing_tpu_torch.models.vocoder import losses as tlosses
from speech_editing_tpu_torch.training.optim import build_gan_lr_schedule
from speech_editing_tpu_torch.training.tasks.hifigan import HifiGanTask
from speech_editing_tpu_torch.training.trainer import Trainer
from speech_editing_tpu_torch.utils.convert_jax_params import (discriminator_params_from_jax,
                                                               vocoder_params_from_jax)
from tests.helpers import TINY_VOC_HP
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=1e-4, rtol=1e-4)
HP = dict(TINY_VOC_HP, disc_periods=(2, 3), msd_scales=2, use_ms_stft=True,
          binary_data_dir="")
B, FRAMES = 2, TINY_VOC_HP["max_samples"] // TINY_VOC_HP["hop_size"]
N = FRAMES * TINY_VOC_HP["hop_size"]


def _random_tree(shapes, seed):
    """Kernels normal with variance 1 / fan_in, biases 0.05 of noise."""
    rs = np.random.RandomState(seed)

    def leaf(s):
        if len(s.shape) <= 1:
            return (0.05 * rs.randn(*s.shape)).astype(np.float32)
        return (rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree.map(leaf, shapes)


def _batch(seed):
    rs = np.random.RandomState(seed)
    return {"mels": (rs.randn(B, FRAMES, 80) * 0.5 - 2).astype(np.float32),
            "wavs": (np.sin(np.arange(N) * rs.uniform(0.02, 0.2, (B, 1)))
                     * 0.5 + rs.randn(B, N) * 0.05).astype(np.float32)}


@functools.lru_cache(maxsize=1)
def _params():
    """(generator params, discriminator params) as numpy trees."""
    task = JHifiGanTask(HP)
    disc = task.build_discriminators()
    b = _batch(0)
    wav = jnp.asarray(b["wavs"])
    gen = jax.eval_shape(lambda: task.build_model().init(jax.random.PRNGKey(0),
                                                          jnp.asarray(b["mels"])))["params"]
    dis = jax.eval_shape(lambda: disc.init(jax.random.PRNGKey(1), wav, wav))
    return _random_tree(gen, 1), _random_tree(dis, 2)


def _port_discs(disc_params):
    disc = HifiGanTask(HP).build_discriminators()
    disc.load_state_dict(discriminator_params_from_jax(disc_params, HP))
    return disc


def _fmap_nhwc(x):
    """A port feature map in flax's layout: [B, C, H, W] -> [B, H, W, C],
    [B, C, T] -> [B, T, C]."""
    x = x.detach()
    return (x.permute(0, 2, 3, 1) if x.dim() == 4 else x.transpose(1, 2)).numpy()


@pytest.mark.parametrize("which", ["mpd", "msd"])
def test_discriminators_match_jax(which):
    """Scores and every feature map of both wavs; the MSD's later scales
    see the pooled wavs (``avg_pool_1d``, equal to JAX's)."""
    _, disc_params = _params()
    b = _batch(1)
    y, y_hat = b["wavs"], b["wavs"][::-1].copy() * 0.7
    jmod = (jh.MultiPeriodDiscriminator(periods=HP["disc_periods"]) if which == "mpd"
            else jh.MultiScaleDiscriminator(num_scales=HP["msd_scales"]))
    ref = jax.jit(jmod.apply)({"params": disc_params[which]}, jnp.asarray(y),
                              jnp.asarray(y_hat))
    with torch.no_grad():
        got = getattr(_port_discs(disc_params), which)(torch.tensor(y), torch.tensor(y_hat))
    for outs, refs in zip(got[:2], ref[:2]):
        for o, r in zip(outs, refs):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    for fmaps, refs in zip(got[2:], ref[2:]):
        assert len(fmaps) == len(refs)
        for per_disc, per_ref in zip(fmaps, refs):
            assert len(per_disc) == len(per_ref)
            for f, r in zip(per_disc, per_ref):
                np.testing.assert_allclose(_fmap_nhwc(f), np.asarray(r), **TOL)
    np.testing.assert_allclose(th.avg_pool_1d(torch.tensor(y)).numpy(),
                               np.asarray(jh._avg_pool_1d(jnp.asarray(y))), **TOL)


def test_gan_losses_match_jax():
    rs = np.random.RandomState(3)
    outs = [rs.randn(B, n).astype(np.float32) for n in (7, 11)]
    fakes = [rs.randn(B, n).astype(np.float32) for n in (7, 11)]
    fr = [[rs.randn(B, 3, 5).astype(np.float32) for _ in range(3)] for _ in range(2)]
    fg = [[(f + rs.randn(*f.shape) * 0.3).astype(np.float32) for f in d] for d in fr]
    t = lambda xs: [torch.tensor(x) for x in xs]
    j = lambda xs: [jnp.asarray(x) for x in xs]
    for got, ref in ((th.discriminator_loss(t(outs), t(fakes)),
                      jh.discriminator_loss(j(outs), j(fakes))),
                     ((th.generator_loss(t(fakes)),), (jh.generator_loss(j(fakes)),)),
                     ((th.feature_loss([t(d) for d in fr], [t(d) for d in fg]),),
                      (jh.feature_loss([j(d) for d in fr], [j(d) for d in fg]),))):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(float(g), float(r), rtol=1e-5)
    # the real maps are detached: their gradient is zero, the fake maps' is not
    real = [[torch.tensor(f, requires_grad=True) for f in d] for d in fr]
    fake = [[torch.tensor(f, requires_grad=True) for f in d] for d in fg]
    th.feature_loss(real, fake).backward()
    assert all(f.grad is None for d in real for f in d)
    assert all(float(f.grad.abs().sum()) > 0 for d in fake for f in d)


def test_spectral_losses_match_jax():
    b = _batch(4)
    y = b["wavs"]
    x = (y * 0.8 + np.random.RandomState(5).randn(*y.shape) * 0.02).astype(np.float32)
    x[0, :10] = 1.5                       # outside [-1, 1]: the mel clamps
    np.testing.assert_allclose(tlosses.gan_mel_spectrogram(torch.tensor(x), HP).numpy(),
                               np.asarray(jlosses.gan_mel_spectrogram(jnp.asarray(x), HP)),
                               **TOL)
    np.testing.assert_allclose(
        tlosses.stft_magnitude(torch.tensor(x), 512, 50, 240).numpy(),
        np.asarray(jlosses.stft_magnitude(jnp.asarray(x), 512, 50, 240)), **TOL)
    got = tlosses.multi_resolution_stft_loss(torch.tensor(x), torch.tensor(y))
    ref = jlosses.multi_resolution_stft_loss(jnp.asarray(x), jnp.asarray(y))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-4)


def test_gan_schedule_matches_optax():
    hp = dict(HP, lr=2e-4, lr_decay=0.9, scheduler_step_size=3)
    ref = j_gan_optimizer(hp)
    params = {"w": jnp.ones(3)}
    state = ref.init(params)
    ours = build_gan_lr_schedule(hp)
    for count in range(8):
        # optax's update at ``count`` scales a unit gradient's Adam step by the lr
        upd, state = ref.update({"w": jnp.ones(3)}, state, params)
        lr = -float(upd["w"][0]) / (1.0 + 1e-4)
        np.testing.assert_allclose(ours(count), lr, rtol=1e-4, err_msg=f"count {count}")


# -- the step ---------------------------------------------------------------------------

def _j_state(gen_params, disc_params, tx):
    return GanTrainState(step=jnp.zeros((), jnp.int32), gen_params=gen_params,
                         gen_opt=tx.init(gen_params), disc_params=disc_params,
                         disc_opt=tx.init(disc_params))


@functools.lru_cache(maxsize=1)
def _jax_run():
    """JAX's GAN step, jitted once: two steps from the random weights.
    Returns (the step, the task's optimizer, the states after each step,
    each step's metrics)."""
    task = JHifiGanTask(HP)
    task.gen_tx = task.disc_tx = tx = j_gan_optimizer(HP)
    step = task.make_gan_train_step(task.build_model(), task.build_discriminators())
    state = _j_state(*_params(), tx)
    states, metrics = [], []
    for i in range(2):
        state, m = step(state, {k: jnp.asarray(v) for k, v in _batch(10 + i).items()},
                        jax.random.PRNGKey(i))
        states.append(jax.tree.map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
    return step, tx, states, metrics


def _port_trainer(tmp_path, hp=HP):
    return Trainer(HifiGanTask(dict(hp, work_dir=str(tmp_path))), dict(hp, work_dir=str(tmp_path)),
                   device="cpu")


def _load(trainer, gen_params, disc_params):
    trainer.model.load_state_dict(vocoder_params_from_jax(gen_params, HP))
    trainer.disc.load_state_dict(discriminator_params_from_jax(disc_params, HP))


def _adam_state(opt_state):
    return next(s for s in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu"))


MOMENT_L2 = 1e-3


def _first_moments(state):
    """Both nets' Adam first moments of a JAX state, by port name."""
    return {**vocoder_params_from_jax(_adam_state(state.gen_opt).mu, HP),
            **{f"disc.{k}": v for k, v in discriminator_params_from_jax(
                _adam_state(state.disc_opt).mu, HP).items()}}


def _assert_nets_match(trainer, state, tol=TOL, moment_l2=MOMENT_L2, first=None):
    """Both nets' parameters (within ``tol``) and Adam moments (within
    ``moment_l2`` in relative L2 a tensor) against a JAX state. Adam's
    first step moves each parameter by lr times its gradient's sign: where
    ``first`` (the first step's moments, JAX's) is within rounding of zero
    (under 1e-2 of its tensor's rms), a sign may differ, and the parameter
    then lies up to 2 lr (and the rounding) away; so too where the last
    step's gradient is (``state``'s first moment within rounding of zero),
    which then decides the sign of the last step."""
    step = trainer.train_step
    for net, params, opt, jopt, convert, prefix in (
            (trainer.model, state.gen_params, step.gen_opt, state.gen_opt,
             vocoder_params_from_jax, ""),
            (trainer.disc, state.disc_params, step.disc_opt, state.disc_opt,
             discriminator_params_from_jax, "disc.")):
        adam = _adam_state(jopt)
        trees = [convert(t, HP) for t in (params, adam.mu, adam.nu)]
        for name, p in net.named_parameters():
            got, ref = p.detach().numpy(), trees[0][name].numpy()
            apart = np.abs(got - ref) > tol["atol"] + tol["rtol"] * np.abs(ref)
            if first is not None and apart.any():
                near_zero = np.zeros_like(apart)
                for m in (first[prefix + name].numpy(), trees[1][name].numpy()):
                    near_zero |= np.abs(m) <= 1e-2 * np.sqrt(np.mean(m ** 2))
                assert near_zero[apart].all(), name
                assert np.abs(got - ref)[apart].max() <= 2.02 * HP["lr"] + tol["atol"], name
            else:
                np.testing.assert_allclose(got, ref, **tol, err_msg=name)
            for key, ref in zip(("exp_avg", "exp_avg_sq"), trees[1:]):
                got, ref = opt.state[p][key], ref[name]
                err = float((got - ref).norm() / ref.norm().clamp(min=1e-30))
                assert err <= moment_l2, (name, key, err)
            assert float(opt.state[p]["step"]) == int(adam.count)


def test_two_gan_steps_match_jax(tmp_path):
    """Every loss of both steps, then both nets' parameters and Adam
    moments; the generator's update leaves the discriminators' gradients
    and weights alone until their own update."""
    _, _, states, j_metrics = _jax_run()
    trainer = _port_trainer(tmp_path)
    _load(trainer, *_params())
    step = trainer.train_step
    for i in range(2):
        metrics = trainer.step(_batch(10 + i))
        assert set(metrics) == set(j_metrics[i]) == {
            "mel", "a_p", "a_s", "fm_f", "fm_s", "sc", "mag", "r_p", "f_p", "r_s", "f_s",
            "total_loss"}
        for k, v in metrics.items():
            np.testing.assert_allclose(float(v), j_metrics[i][k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i} {k}")
    assert step.step == 2 and trainer.global_step == 2
    _assert_nets_match(trainer, states[1], first=_first_moments(states[0]))


def test_generator_gradient_does_not_reach_the_discriminators(tmp_path):
    trainer = _port_trainer(tmp_path)
    step = trainer.train_step
    batch = trainer._device_batch(_batch(12))
    y_ = step.model(batch["mels"])
    before = [p.detach().clone() for p in step.disc_params]
    total = sum(step.generator_losses(batch["wavs"], y_).values())
    step._update(step.gen_opt, step.gen_params, total)
    assert all(p.grad is None for p in step.disc_params)
    assert all(torch.equal(p, q) for p, q in zip(step.disc_params, before))


def test_jax_gan_checkpoint_resumes_with_both_adam_states(tmp_path):
    """A JAX ``GanTrainState`` after one step, saved by the JAX package,
    loads in the port's trainer (both nets, both Adam moments and counts,
    the step), and the next step agrees with JAX's second."""
    step_fn, _, states, j_metrics = _jax_run()
    first = jax.tree.map(jnp.asarray, states[0])
    j_save_checkpoint(str(tmp_path), first, 1)
    trainer = _port_trainer(tmp_path)
    trainer._build_state()
    assert trainer.global_step == 1
    _assert_nets_match(trainer, states[0], dict(atol=0, rtol=0), moment_l2=0)
    metrics = trainer.step(_batch(11))
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), j_metrics[1][k], rtol=1e-4, atol=1e-6, err_msg=k)
    _assert_nets_match(trainer, states[1], first=_first_moments(states[0]))
