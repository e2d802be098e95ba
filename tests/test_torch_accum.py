"""PyTorch port, gradient accumulation (``accumulate_grad_batches``) against
the JAX package on CPU: two updates of two microbatches each through
``TrainStep.accumulate`` against ``make_accum_train_step`` driven by the
JAX trainer's host loop (each microbatch its own rng, the sum of the
gradients applied over the count), in float32 and in bf16 (``use_bf16``,
each microbatch through ``bf16_loss`` against the float32 masters). The
shipped ``egs/spec_denoiser.yaml`` at tiny widths, lr constant, JAX's own
diffusion draws injected, dropout off.

Float32: the last microbatch's loss and the update's gradient norm
within rtol 1e-4, the parameters and Adam's moments within 1e-4. bf16:
PR 12's bars (``test_torch_bf16.py``) on the losses: loss terms within
1e-2, the gradient norm within 1e-2, the total within 2e-3 or one bf16
unit in the last place (a total of 14, the second update's, is bf16 to
within 0.0625; it reads 0.032 apart there, the parameters having moved
apart after one update); Adam's first
moment within PR 12's 0.4 in relative L2, and at the median within 0.1
(PR 12's 0.05 was read on one batch, at 0.012: these four microbatches'
own gradients, each alone in one bf16 step, read 0.016, 0.087, 0.018 and
0.064 at the median against JAX's, and the accumulated moment 0.055 and
0.054 after the two updates; the flax layers round a product before adding
the bias, the port's inside). The parameters within 4 lr (two Adam steps),
and apart by more than half an lr (an Adam step's sign flipped, or its size
moved) at no more than a tenth of the elements [0.022, 0.033].

The bars fail a wrong accumulation (readings of the two updates with
``TrainStep.accumulate`` broken on purpose,
``test_bf16_bars_fail_a_wrong_accumulation``): with the
first microbatch's gradient left out, the moment's median reads 0.69 and
0.51 (its largest 1.6 and 1.1), the gradient norm 0.44 and 0.22 apart (0.11
and 0.56 when the count drops to 1 too) and 0.19 and 0.29 of the elements
sit apart; with the sum not divided by the count, the gradient norm reads
0.99 and 1.0 apart, while the moments and parameters read as the right
accumulation's, because the shipped ``clip_grad_norm: 1`` clips both sums
to the same norm.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_editing_tpu.models.spec_denoiser.spec_denoiser import \
    GaussianDiffusion as JGD
from speech_editing_tpu.training.optim import build_optimizer as j_optimizer
from speech_editing_tpu.training.tasks.spec_denoiser import \
    SpecDenoiserTask as JSpecDenoiserTask
from speech_editing_tpu.training.tasks.spec_denoiser import \
    make_loss_fn as j_make_loss_fn
from speech_editing_tpu.training.train_state import TrainState, make_accum_train_step
from speech_editing_tpu_torch.training.train_state import TrainStep
from speech_editing_tpu_torch.training.trainer import Trainer
from speech_editing_tpu_torch.utils.convert_jax_params import params_from_jax
from tests.test_torch_bf16 import EXACT, SIL, VOCAB, _np, _port_step, _rel_l2, _shipped_hp
from tests.test_torch_stutter import random_params
from tests.test_torch_train import _batch
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

ACCUM, UPDATES = 2, 2


def _micro(i):
    batch = _batch(i)
    batch["spk_embed"] = (np.random.RandomState(10 + i).randn(2, 256) * 0.3).astype(np.float32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in batch.items()}


def _draws(rng, batch, hp, bf16):
    """JAX's diffusion draws for ``rng``: t, and noise in the mels' dtype."""
    k_t, k_noise = jax.random.split(jax.random.split(rng)[0])
    t = jax.random.randint(k_t, (batch["mels"].shape[0],), 0, hp["timesteps"] + 1)
    dtype = jnp.bfloat16 if bf16 else jnp.float32
    noise = jax.random.normal(k_noise, batch["mels"].shape, dtype)
    return {"t": torch.tensor(np.asarray(t)).long(), "noise": torch.tensor(_np(noise))}


@functools.lru_cache(maxsize=2)
def _run_jax(bf16):
    """The JAX trainer's accumulation loop: per update, ``grad_fn`` on each
    microbatch at the update's step, the gradients summed, ``apply_fn`` with
    the count. Returns (params, hp, states after each update, the last
    microbatch's metrics with the apply's of each update)."""
    hp = dict(_shipped_hp(scheduler="none", lr=1e-3, accumulate_grad_batches=ACCUM),
              use_bf16=bf16)
    params = random_params(JSpecDenoiserTask(dict(hp, vocab_size=VOCAB)), _micro(0), 2)
    jm = JGD(vocab_size=VOCAB, hp=hp, out_dims=80)
    tx = j_optimizer(hp)
    grad_fn, apply_fn = make_accum_train_step(j_make_loss_fn(jm, hp, SIL, train=False), tx,
                                              use_bf16=bf16)
    jb = _jax_batch(_micro(0))
    grad_fn = grad_fn.lower(params, jb, jax.random.PRNGKey(0), 0.0).compile(EXACT)
    state = TrainState.create(params, tx)
    states, metrics = [], []
    for u in range(UPDATES):
        grads_sum = None
        for j in range(ACCUM):
            grads, m = grad_fn(state.params, _jax_batch(_micro(u * ACCUM + j)),
                               jax.random.PRNGKey(100 + u * ACCUM + j), float(u))
            grads_sum = grads if grads_sum is None else jax.tree.map(jnp.add, grads_sum,
                                                                     grads)
        state, applied = apply_fn(state, grads_sum, float(ACCUM))
        states.append(jax.tree.map(np.asarray, (state.params, _adam(state.opt_state).mu,
                                                _adam(state.opt_state).nu)))
        metrics.append({k: float(v) for k, v in dict(m, **applied).items()})
    return params, hp, states, metrics


def _adam(opt_state):
    return next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _run_port(params, hp, bf16):
    step = _port_step(hp, params)
    out = []
    for u in range(UPDATES):
        micro = [_micro(u * ACCUM + j) for j in range(ACCUM)]
        draws = [_draws(jax.random.PRNGKey(100 + u * ACCUM + j), b, hp, bf16)
                 for j, b in enumerate(micro)]
        metrics = step.accumulate(({k: torch.tensor(v) for k, v in b.items()} for b in micro),
                                  draws=draws)
        named = dict(step.model.named_parameters())
        out.append(({k: float(v) for k, v in metrics.items()},
                    {n: p.detach().numpy().copy() for n, p in named.items()},
                    {n: step.optimizer.state[p]["exp_avg"].numpy().copy()
                     for n, p in named.items()},
                    {n: step.optimizer.state[p]["exp_avg_sq"].numpy().copy()
                     for n, p in named.items()}))
    assert step.step == step.updates == UPDATES      # the schedule counts updates
    return out


def test_two_accumulated_updates_match_jax_float32():
    params, hp, states, j_metrics = _run_jax(False)
    for (metrics, p, mu, nu), (jp, jmu, jnu), jm in zip(_run_port(params, hp, False), states,
                                                        j_metrics):
        assert set(metrics) == set(jm)
        for k in ("total_loss", "grad_norm", "l1_coarse", "pdur", "f0"):
            np.testing.assert_allclose(metrics[k], jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
        assert metrics["nan_grads"] == jm["nan_grads"] == 0.0
        for got, tree in ((p, jp), (mu, jmu), (nu, jnu)):
            ref = params_from_jax(tree, hp)
            for name, v in got.items():
                np.testing.assert_allclose(v, ref[name].numpy(), atol=1e-4, rtol=1e-4,
                                           err_msg=name)


def _bf16_readings(hp, port, states, j_metrics):
    """Per update, each bf16 bar's reading and the bar: {name: (reading, bar)}."""
    out = []
    for (metrics, p, mu, _), (jp, jmu, _), jm in zip(port, states, j_metrics):
        r = {k: (abs(metrics[k] - jm[k]) / abs(jm[k]), 1e-2)
             for k in ("l1_coarse", "ssim_coarse", "pdur", "wdur", "uv", "f0", "grad_norm")}
        ulp = 2.0 ** (np.floor(np.log2(abs(jm["total_loss"]))) - 7)
        r["total_loss"] = (abs(metrics["total_loss"] - jm["total_loss"]),
                           max(ulp, 2e-3 * abs(jm["total_loss"])))
        ref_mu, ref_p = params_from_jax(jmu, hp), params_from_jax(jp, hp)
        errs = [_rel_l2(mu[n], ref_mu[n].numpy()) for n in mu]
        r["mu_max"], r["mu_median"] = (max(errs), 0.4), (float(np.median(errs)), 0.1)
        diffs = [np.abs(v - ref_p[n].numpy()) for n, v in p.items()]
        r["param_max_over_lr"] = (max(float(d.max()) for d in diffs) / hp["lr"], 4 * 1.001)
        r["apart"] = (float(np.mean([np.mean(d > 0.5 * hp["lr"]) for d in diffs])), 0.1)
        out.append(r)
    return out


def test_two_accumulated_updates_match_jax_bf16():
    params, hp, states, j_metrics = _run_jax(True)
    start = params_from_jax(params, hp)
    port = _run_port(params, hp, True)
    for u, r in enumerate(_bf16_readings(hp, port, states, j_metrics)):
        for name, (reading, bar) in r.items():
            assert reading <= bar, (u, name, reading, bar)
    assert any(not np.array_equal(v, start[n].numpy()) for n, v in port[-1][1].items())


@pytest.mark.parametrize("wrong,caught_by", [("first_left_out", "mu_median"),
                                             ("undivided", "grad_norm")])
def test_bf16_bars_fail_a_wrong_accumulation(monkeypatch, wrong, caught_by):
    """The bf16 bars against a broken ``TrainStep.accumulate``: the first
    microbatch's gradient left out fails the moment's median bar, the sum
    not divided by the count the gradient norm's (clipping at the shipped
    ``clip_grad_norm: 1`` gives both sums the same moments)."""
    backward, apply = TrainStep._backward, TrainStep._apply
    calls = []

    def left_out(self, batch, generator, draws):
        calls.append(1)
        if len(calls) % ACCUM != 1:
            return backward(self, batch, generator, draws)
        saved = [None if p.grad is None else p.grad.clone() for p in self.params]
        metrics = backward(self, batch, generator, draws)
        for p, g in zip(self.params, saved):
            p.grad = g
        return metrics

    if wrong == "first_left_out":
        monkeypatch.setattr(TrainStep, "_backward", left_out)
    else:
        monkeypatch.setattr(TrainStep, "_apply", lambda self, n: apply(self, 1))
    params, hp, states, j_metrics = _run_jax(True)
    readings = _bf16_readings(hp, _run_port(params, hp, True), states, j_metrics)
    assert all(r[caught_by][0] > r[caught_by][1] for r in readings), readings


def test_trainer_steps_accumulate_microbatches():
    """``Trainer.step`` with several batches makes one update of their mean
    gradient: the same parameters as ``TrainStep.accumulate``, and the
    update count (``global_step``) moves once."""
    hp = dict(_shipped_hp(scheduler="none", lr=1e-3, accumulate_grad_batches=2),
              use_bf16=False)
    trainers = [Trainer.from_hp(hp, device="cpu", seed=4, vocab_size=VOCAB,
                                sil_token_ids=SIL, dropout=False) for _ in range(2)]
    assert trainers[0].accum == 2
    micro = [_micro(5), _micro(6)]
    trainers[0].step(*micro)
    trainers[1].train_step.accumulate((trainers[1].to_device(b) for b in micro),
                                      trainers[1].generator)
    assert trainers[0].global_step == trainers[1].global_step == 1
    for (n, a), b in zip(trainers[0].model.named_parameters(), trainers[1].model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
