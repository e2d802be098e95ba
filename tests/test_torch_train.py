"""PyTorch port, the FluentSpeech training step against the JAX package on
CPU: every loss term, the whole loss and every parameter gradient (JAX's
own diffusion draws injected), two optimizer steps with the warmup
schedule, the NaN tripwire, the lr schedules, and the predictors' dropout.
The JAX weights and gradients cross by ``params_from_jax``, a pure layout
map.
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
from speech_editing_tpu.training import losses as jl
from speech_editing_tpu.training.optim import build_lr_schedule as j_schedule
from speech_editing_tpu.training.optim import build_optimizer as j_optimizer
from speech_editing_tpu.training.tasks.spec_denoiser import \
    make_loss_fn as j_make_loss_fn
from speech_editing_tpu.training.train_state import TrainState, make_train_step
from speech_editing_tpu_torch.models.spec_denoiser.spec_denoiser import GaussianDiffusion
from speech_editing_tpu_torch.modules.predictors import DurationPredictor
from speech_editing_tpu_torch.training import losses as tl
from speech_editing_tpu_torch.training.optim import build_lr_schedule
from speech_editing_tpu_torch.training.tasks.spec_denoiser import make_loss_fn
from speech_editing_tpu_torch.training.train_state import TrainStep
from speech_editing_tpu_torch.training.trainer import Trainer
from speech_editing_tpu_torch.utils.convert_jax_params import params_from_jax
from tests.test_torch_model import HP as MODEL_HP
from tests.test_torch_model import VOCAB, _randomize
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

HP = dict(MODEL_HP, lambda_ph_dur=0.1, lambda_word_dur=1.0, lambda_sent_dur=0.5,
          lambda_uv=1.0, lambda_f0=1.0, mel_losses="l1:0.5|ssim:0.5",
          lr=1e-2, scheduler="warmup", warmup_updates=2, clip_grad_norm=1,
          clip_grad_value=0, optimizer_adam_beta1=0.9, optimizer_adam_beta2=0.98,
          weight_decay=0)
SIL = (1, 2)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


def _batch(seed, b=2, s=10, t=36):
    """A collated batch (numpy, the keys of make_loss_fn): row 1 has 7
    tokens and t - 5 frames; the middle third of each row is masked."""
    rs = np.random.RandomState(seed)
    tokens = rs.randint(1, VOCAB, (b, s))
    tokens[1, 7:] = 0
    mel2ph = np.zeros((b, t), np.int64)
    mels = np.zeros((b, t, 80), np.float32)
    mask = np.zeros((b, t), np.float32)
    for i, (n_tok, n_frames) in enumerate([(s, t), (7, t - 5)]):
        bounds = np.sort(rs.choice(np.arange(1, n_frames), n_tok - 1, replace=False))
        mel2ph[i, :n_frames] = np.searchsorted(bounds, np.arange(n_frames),
                                               side="right") + 1
        mels[i, :n_frames] = rs.randn(n_frames, 80) * 0.5 - 1.0
        mask[i, n_frames // 3: 2 * n_frames // 3] = 1.0
    uv = (rs.rand(b, t) < 0.2).astype(np.float32) * (mel2ph > 0)
    f0 = (rs.rand(b, t) * 2 + 6.5).astype(np.float32) * (1 - uv) * (mel2ph > 0)
    return dict(txt_tokens=tokens, mels=mels, mel2ph=mel2ph, f0=f0, uv=uv,
                time_mel_masks=mask)


def _jax_batch(batch):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _jax_draws(rng, batch):
    """The (t, noise) the JAX loss draws from ``rng`` (loss_fn splits it
    into the diffusion and dropout keys; the model splits the first)."""
    k_diff, _ = jax.random.split(rng)
    k_t, k_noise = jax.random.split(k_diff)
    b = batch["mels"].shape[0]
    t = jax.random.randint(k_t, (b,), 0, HP["timesteps"] + 1)
    noise = jax.random.normal(k_noise, batch["mels"].shape, jnp.float32)
    return torch.tensor(np.asarray(t)).long(), torch.tensor(np.asarray(noise))


@functools.lru_cache(maxsize=1)
def _jax():
    """(jax model, randomized numpy params, jitted value_and_grad of the
    JAX loss with dropout off): one compile shared by this file."""
    batch = _jax_batch(_batch(0))
    jm = JGD(vocab_size=VOCAB, hp=HP, out_dims=80)
    params = jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        batch["txt_tokens"], batch["time_mel_masks"][..., None], batch["mel2ph"],
        None, batch["mels"], batch["f0"], batch["uv"])["params"]
    params = _randomize(params, 2)
    loss_fn = j_make_loss_fn(jm, HP, sil_token_ids=SIL, train=False)
    return jm, params, loss_fn, jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _port_model(params):
    tm = GaussianDiffusion(VOCAB, HP, 80)
    tm.load_state_dict(params_from_jax(params, HP))
    return tm


def test_loss_and_every_gradient_match_jax():
    jm, params, _, grad_fn = _jax()
    batch = _batch(0)
    rng = jax.random.PRNGKey(5)
    (j_total, j_losses), j_grads = grad_fn(params, _jax_batch(batch), rng)
    tm = _port_model(params)
    t, noise = _jax_draws(rng, batch)
    total, losses = make_loss_fn(tm, HP, SIL, train=False)(
        _torch_batch(batch), t=t, noise=noise)
    total.backward()
    assert sorted(losses) == sorted(j_losses)
    assert set(losses) == {"l1_coarse", "ssim_coarse", "pdur", "wdur", "sdur",
                           "uv", "f0"}
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()), float(j_losses[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=1e-4)
    ref = params_from_jax(jax.tree.map(np.asarray, j_grads), HP)
    named = dict(tm.named_parameters())
    assert sorted(named) == sorted(ref)
    for name, p in named.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), **GRAD_TOL,
                                   err_msg=name)


def _train_step(model):
    return TrainStep(model, HP, make_loss_fn(model, HP, SIL, train=False))


def _adam(opt_state):
    return next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _assert_state_matches(step, state, tol=1e-4):
    named = dict(step.model.named_parameters())
    adam = _adam(state.opt_state)
    for tree, get in ((state.params, lambda p: p.detach()),
                      (adam.mu, lambda p: step.optimizer.state[p]["exp_avg"]),
                      (adam.nu, lambda p: step.optimizer.state[p]["exp_avg_sq"])):
        ref = params_from_jax(jax.tree.map(np.asarray, tree), HP)
        for name, p in named.items():
            np.testing.assert_allclose(get(p).numpy(), ref[name].numpy(),
                                       atol=tol, rtol=tol, err_msg=name)


@functools.lru_cache(maxsize=1)
def _jax_train_step():
    jm, params, loss_fn, _ = _jax()
    tx = j_optimizer(HP)
    return tx, make_train_step(loss_fn, tx)


def test_two_train_steps_match_jax_with_warmup():
    """Step 0 runs at lr 0 (optax evaluates the schedule before counting),
    step 1 at lr/2: params and Adam moments agree after both."""
    _, params, _, _ = _jax()
    tx, j_step = _jax_train_step()
    state = TrainState.create(params, tx)
    step = _train_step(_port_model(params))
    start = {k: v.clone() for k, v in step.model.state_dict().items()}
    for i, seed in enumerate((0, 1)):
        batch = _batch(seed)
        rng = jax.random.PRNGKey(10 + i)
        state, j_metrics = j_step(state, _jax_batch(batch), rng)
        t, noise = _jax_draws(rng, batch)
        metrics = step(_torch_batch(batch), t=t, noise=noise)
        for k in ("total_loss", "grad_norm", "nan_grads"):
            np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                       rtol=1e-4, err_msg=k)
        if i == 0:   # lr 0: nothing moved, but the moments did
            for k, v in step.model.state_dict().items():
                torch.testing.assert_close(v, start[k], rtol=0, atol=0)
    assert step.updates == 2 and step.step == 2
    assert not torch.equal(step.model.state_dict()["denoise_fn.mlp.0.weight"],
                           start["denoise_fn.mlp.0.weight"])
    _assert_state_matches(step, state)


def test_nan_tripwire_skips_the_update_in_both():
    _, params, _, _ = _jax()
    tx, j_step = _jax_train_step()
    good = _batch(0)
    step = _train_step(_port_model(params))
    state = TrainState.create(params, tx)
    rng = jax.random.PRNGKey(3)
    state, _ = j_step(state, _jax_batch(good), rng)
    step(_torch_batch(good), None, *_jax_draws(rng, good))
    before = {k: v.clone() for k, v in step.model.state_dict().items()}
    moments = {id(p): {k: v.clone() for k, v in s.items()}
               for p, s in step.optimizer.state.items()}
    bad = dict(good, mels=good["mels"].copy())
    bad["mels"][0, 4, 7] = np.inf
    rng = jax.random.PRNGKey(4)
    state, j_metrics = j_step(state, _jax_batch(bad), rng)
    metrics = step(_torch_batch(bad), None, *_jax_draws(rng, bad))
    assert float(j_metrics["nan_grads"]) == 1.0 and float(metrics["nan_grads"]) == 1.0
    assert int(state.step) == 2 and step.step == 2 and step.updates == 1
    for k, v in step.model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    for p, s in step.optimizer.state.items():
        for k, v in s.items():
            torch.testing.assert_close(v, moments[id(p)][k], rtol=0, atol=0)
    _assert_state_matches(step, state)


@pytest.mark.parametrize("kind", ["none", "warmup", "rsqrt"])
def test_lr_schedules_match_optax(kind):
    hp = dict(HP, scheduler=kind, lr=2e-4, warmup_updates=8000, hidden_size=192)
    ours, ref = build_lr_schedule(hp), j_schedule(hp)
    for step in (0, 1, 7, 9000):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6,
                                   err_msg=f"step {step}")


def _loss_inputs(rs, b=2, s=9, t=23):
    target = rs.randn(b, t, 80).astype(np.float32) * 0.5 - 1
    target[1, 17:] = 0                      # padded frames: weight 0
    mel_out = (target + rs.randn(b, t, 80) * 0.3).astype(np.float32)
    tokens = rs.randint(1, 6, (b, s))
    tokens[1, 6:] = 0
    mel2ph = np.sort(rs.randint(1, s + 1, (b, t)), axis=1)
    mel2ph[1, 17:] = 0
    dur_pred = (rs.rand(b, s) * 4).astype(np.float32)
    pitch_pred = rs.randn(b, t, 2).astype(np.float32)
    f0 = rs.randn(b, t).astype(np.float32)
    uv = (rs.rand(b, t) < 0.3).astype(np.float32)
    return mel_out, target, tokens, mel2ph, dur_pred, pitch_pred, f0, uv


@pytest.mark.parametrize("term", ["l1", "mse", "ssim", "mel_spec", "dur", "pitch"])
def test_loss_terms_match_jax(rng, term):
    mel_out, target, tokens, mel2ph, dur_pred, pitch_pred, f0, uv = _loss_inputs(rng)
    j = lambda *a: [jnp.asarray(x) for x in a]
    t = lambda *a: [torch.tensor(x) for x in a]
    got, ref = {}, {}
    if term in ("l1", "mse", "ssim"):
        got[term] = getattr(tl, f"{term}_loss")(*t(mel_out, target))
        ref[term] = getattr(jl, f"{term}_loss")(*j(mel_out, target))
    elif term == "mel_spec":
        tl.add_mel_loss(got, *t(mel_out, target), "l1:0.5|ssim:0.25|mse", "_c")
        jl.add_mel_loss(ref, *j(mel_out, target), "l1:0.5|ssim:0.25|mse", "_c")
    elif term == "dur":
        sil_t = tl.sil_token_mask(torch.tensor(tokens), (1, 3))
        sil_j = jl.sil_token_mask(jnp.asarray(tokens), (1, 3))
        np.testing.assert_array_equal(sil_t.numpy(), np.asarray(sil_j))
        tl.dur_loss(got, *t(dur_pred, mel2ph, tokens), sil_t, HP)
        jl.dur_loss(ref, *j(dur_pred, mel2ph, tokens), sil_j, HP)
    else:
        tl.pitch_loss(got, *t(pitch_pred, f0, uv, mel2ph), HP)
        jl.pitch_loss(ref, *j(pitch_pred, f0, uv, mel2ph), HP)
    assert sorted(got) == sorted(ref) and got
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_f0_denorm_pred_matches_jax():
    jm, params, _, _ = _jax()
    batch = _batch(1)
    jb = _jax_batch(batch)
    ref = jax.jit(functools.partial(jm.apply, method=jm.compute_cond))(
        {"params": params}, jb["txt_tokens"], jb["time_mel_masks"][..., None],
        jb["mel2ph"], None, jb["mels"], jb["f0"], jb["uv"])
    tb = _torch_batch(batch)
    with torch.no_grad():
        out = _port_model(params).compute_cond(
            tb["txt_tokens"], tb["time_mel_masks"][..., None], tb["mel2ph"], None,
            tb["mels"], tb["f0"], tb["uv"])
    np.testing.assert_allclose(out["f0_denorm_pred"].numpy(),
                               np.asarray(ref["f0_denorm_pred"]), atol=1e-3, rtol=1e-4)


def test_predictor_dropout_follows_its_generator():
    torch.manual_seed(0)
    pred = DurationPredictor(16, 16, 2, 3, dropout_rate=0.5)
    x, pad = torch.randn(2, 11, 16), torch.zeros(2, 11, dtype=torch.bool)
    run = lambda seed: pred(x, pad, train=True,
                            generator=torch.Generator().manual_seed(seed))
    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))
    torch.testing.assert_close(pred(x, pad, train=False), pred(x, pad))
    assert not torch.equal(run(1), pred(x, pad))


def test_trainer_steps_on_cpu_reproducibly():
    """Two trainers from one seed take the same dropout and diffusion draws."""
    batches = [_batch(s) for s in (0, 1, 2)]
    runs = []
    for _ in range(2):
        trainer = Trainer.from_hp(HP, device="cpu", seed=3, vocab_size=VOCAB,
                                  sil_token_ids=SIL)
        runs.append([{k: float(v) for k, v in trainer.step(b).items()}
                     for b in (batches * 2)[:4]])
        assert trainer.global_step == 4 and trainer.train_step.updates == 4
    assert runs[0] == runs[1] and len(runs[0]) == 4
    for m in runs[0]:
        assert set(m) >= {"total_loss", "grad_norm", "nan_grads", "l1_coarse", "f0"}
        assert all(np.isfinite(v) for v in m.values()) and m["nan_grads"] == 0
