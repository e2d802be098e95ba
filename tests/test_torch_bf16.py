"""PyTorch port, bf16 training (``use_bf16``) against the JAX package on
the CPU: the bf16 forms of K1 and K5 (their plain versions, which the card's
kernels are held to in ``chip_smoke.py``) and ``DiffNetBlockFunction``'s
bf16 gradients against the Pallas block and its ``jax.vjp`` in interpret
mode; the batch-cast rules of the bf16 wrap; one bf16 train step of the
shipped FluentSpeech config against ``make_train_step(use_bf16=True)``; and
the eval step staying float32.

JAX runs compiled with ``xla_allow_excess_precision=False``: XLA's CPU
default may keep a chain of bf16 operations in float32, so that the same
program rounds differently jitted and eager. With the flag off it rounds
each bf16 operation as written, as eager JAX and the port do.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from speech_editing_tpu.models.spec_denoiser.spec_denoiser import \
    GaussianDiffusion as JGD
from speech_editing_tpu.ops.pallas.diffnet_block import _fwd_call, fused_diffnet_block
from speech_editing_tpu.training.optim import build_optimizer as j_optimizer
from speech_editing_tpu.training.tasks.spec_denoiser import \
    SpecDenoiserTask as JSpecDenoiserTask
from speech_editing_tpu.training.tasks.spec_denoiser import \
    make_loss_fn as j_make_loss_fn
from speech_editing_tpu.training.train_state import TrainState, make_train_step
from speech_editing_tpu_torch.config.hparams import load_config
from speech_editing_tpu_torch.ops.cuda.diffnet_block import (diffnet_block_bwd_plain,
                                                             diffnet_block_plain,
                                                             diffnet_block_train)
from speech_editing_tpu_torch.training.tasks.spec_denoiser import (GaussianDiffusion,
                                                                   make_loss_fn)
from speech_editing_tpu_torch.training.train_state import (TrainStep, bf16_loss,
                                                           cast_floats)
from speech_editing_tpu_torch.training.trainer import Trainer
from speech_editing_tpu_torch.utils.convert_jax_params import params_from_jax
from tests.helpers import TINY_HP
from tests.test_torch_stutter import random_params
from tests.test_torch_train import _batch
from tests.test_torch_train_kernels import _block_inputs
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

BF = torch.bfloat16
EXACT = {"xla_allow_excess_precision": False}
VOCAB, SIL = 30, (1, 2)
REPO_EGS = __file__.rsplit("/tests/", 1)[0] + "/egs/spec_denoiser.yaml"


def _to_jax(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _np(x):
    """bf16 (torch or JAX) -> float32 numpy, exactly."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_within_ulp(got, ref, name):
    """Within one bf16 ulp of the largest element (2^-7 of it): what the
    f32 sums' order may flip in a rounding. Measured: bit-equal."""
    got, ref = _np(got), _np(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -7 * np.abs(ref).max(),
                               err_msg=name)


@functools.lru_cache(maxsize=1)
def _pallas_bf16():
    """The block's bf16 inputs, cotangents, outputs (x', skip, h) and
    ``jax.vjp`` of the Pallas block in interpret mode: one compile."""
    rs = np.random.RandomState(0)
    args = _block_inputs(rs)
    cot = tuple(rs.randn(*args[0].shape).astype(np.float32) for _ in range(2))

    def run(args, cot):
        args = [_to_jax(a) for a in args]
        out, vjp = jax.vjp(fused_diffnet_block, *args)
        return out, _fwd_call(*args)[2], vjp(tuple(_to_jax(c) for c in cot))

    jargs = [jnp.asarray(a) for a in args]
    jcot = tuple(jnp.asarray(c) for c in cot)
    (xo, sk), h, grads = jax.jit(run).lower(jargs, jcot).compile(EXACT)(jargs, jcot)
    tensors = [torch.tensor(a).to(BF) for a in args]
    return tensors, [torch.tensor(c).to(BF) for c in cot], (xo, sk, h), grads


def test_k1_k5_bf16_plain_versions_match_pallas():
    """The bf16 plain versions of K1 (x', skip, h) and K5 (dx) against the
    Pallas kernels' bf16 arithmetic (unmasked, dilation 1)."""
    t, (dxo, dsk), ref, grads = _pallas_bf16()
    out = diffnet_block_plain(t[0], t[1], t[2], None, *t[3:], return_h=True)
    assert all(o.dtype == BF for o in out)
    for name, o, r in zip(("x'", "skip", "h"), out, ref):
        _assert_within_ulp(o, r, name)
    dx, dh, g = diffnet_block_bwd_plain(out[2], dxo, dsk, None, t[3], t[7])
    assert dx.dtype == dh.dtype == g.dtype == BF
    _assert_within_ulp(dx, grads[0], "dx")


def test_block_function_bf16_grads_match_pallas_vjp():
    """``DiffNetBlockFunction`` in bf16: every gradient bf16, within one ulp
    of ``_vjp_bwd``'s (f32 accumulation, cast to the weight's dtype)."""
    t, (dxo, dsk), _, grads = _pallas_bf16()
    leaves = [a.clone().requires_grad_(True) for a in t]
    xo, sk = diffnet_block_train(leaves[0], leaves[1], leaves[2], None, *leaves[3:])
    assert xo.dtype == sk.dtype == BF
    got = torch.autograd.grad((xo, sk), leaves, (dxo, dsk))
    for name, g, ref in zip(("x", "cond", "step", "wd", "bd", "wc", "bc", "wo", "bo"),
                            got, grads):
        assert g.dtype == BF, name
        _assert_within_ulp(g, ref, name)


def test_bf16_wrap_casts_floats_and_keeps_integers():
    batch = {"mels": torch.randn(2, 3), "mel2ph": torch.arange(6).view(2, 3),
             "keep": torch.ones(2, dtype=torch.bool), "global_step": torch.tensor(7.0)}
    cast = cast_floats(batch, BF)
    assert cast["mels"].dtype == cast["global_step"].dtype == BF
    assert cast["mel2ph"].dtype == torch.int64 and cast["keep"].dtype == torch.bool
    assert torch.equal(cast["mel2ph"], batch["mel2ph"])

    model = torch.nn.Linear(3, 2)
    seen = {}

    def loss_fn(b, generator=None, noise=None):
        seen.update({k: v.dtype for k, v in b.items()}, weight=model.weight.dtype,
                    noise=noise.dtype)
        out = model(b["mels"]) * b["global_step"]
        return out.sum(), {"out": out.sum()}

    total, _ = bf16_loss(model, loss_fn)(batch, noise=torch.randn(2))
    assert seen == {"mels": BF, "mel2ph": torch.int64, "keep": torch.bool,
                    "global_step": BF, "weight": BF, "noise": torch.float32}
    assert total.dtype == torch.float32
    total.backward()
    assert model.weight.dtype == model.weight.grad.dtype == torch.float32
    assert model.bias.grad is not None


def _shipped_hp(**kw):
    """``egs/spec_denoiser.yaml`` as shipped (``use_bf16: true``, the conv
    encoder, speaker embeddings) at tiny widths."""
    hp = load_config(REPO_EGS)
    hp.update(TINY_HP)
    hp.update(residual_channels=16, residual_layers=2, enc_dilations=[1],
              dur_predictor_layers=1, binary_data_dir="", **kw)
    assert hp["use_bf16"] and hp["encoder_type"] == "conv" and hp["use_spk_embed"]
    return hp


def _shipped_batch():
    batch = _batch(0)
    batch["spk_embed"] = (np.random.RandomState(1).randn(2, 256) * 0.3).astype(np.float32)
    return batch


def _port_step(hp, params):
    model = GaussianDiffusion(VOCAB, hp, 80)
    model.load_state_dict(params_from_jax(params, hp))
    return TrainStep(model, hp, make_loss_fn(model, hp, SIL, train=False))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_bf16_train_step_matches_jax():
    """One step of the shipped config in bf16 (lr constant, so that the
    update moves the parameters) against JAX's ``make_train_step(use_bf16=
    True)``, JAX's own bf16 draws injected.

    The bars, from measurement (in brackets): the port's DiffNet blocks
    round as K1/K5 do (h, x', skip), the JAX editing model's plain
    ``nn.Conv`` branch after every conv and add; flax's Dense and Conv
    round the product before adding the bias, torch's layers add it
    inside. The conditioner is otherwise bit-equal. So the loss terms
    within 1e-2 [1.6e-3], the total within 2e-3 [3.0e-4], the gradient
    norm within 1e-2 [1.7e-3; XLA's own two rounding modes differ by 3.5e-3
    here]; each parameter's gradient (Adam's first moment) within 0.4
    [0.195] in relative L2, 0.05 [0.012] at the median: far closer to
    JAX's than either bf16 gradient is to the float32 one [medians 0.125,
    0.121; maxima 0.875, 0.863]. Adam's first step moves a parameter by lr
    times its gradient's sign, so a parameter agrees with JAX's or, where a
    near-zero gradient's sign flipped, lies 2 lr away [0.024 of them; bar
    0.1]."""
    hp = _shipped_hp(scheduler="none", lr=1e-3)
    batch = _shipped_batch()
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
          for k, v in batch.items()}
    jm = JGD(vocab_size=VOCAB, hp=hp, out_dims=80)
    # no bias or output projection zero, as flax's initializers leave them
    params = random_params(JSpecDenoiserTask(dict(hp, vocab_size=VOCAB)), batch, 2)
    tx = j_optimizer(hp)
    state = TrainState.create(params, tx)
    step_fn = make_train_step(j_make_loss_fn(jm, hp, SIL, train=False), tx,
                              use_bf16=True, jit=False)
    rng = jax.random.PRNGKey(7)
    new, j_metrics = jax.jit(step_fn).lower(state, jb, rng).compile(EXACT)(state, jb, rng)
    # the draws of JAX's loss: t, and noise in the mels' dtype (bf16)
    k_t, k_noise = jax.random.split(jax.random.split(rng)[0])
    t = torch.tensor(np.asarray(jax.random.randint(k_t, (2,), 0, hp["timesteps"] + 1)))
    noise = torch.tensor(_np(jax.random.normal(k_noise, batch["mels"].shape, jnp.bfloat16)))

    step = _port_step(hp, params)
    metrics = step({k: torch.tensor(v) for k, v in batch.items()}, t=t.long(), noise=noise)
    assert step.updates == 1 and float(metrics["nan_grads"]) == 0.0
    for k in ("l1_coarse", "ssim_coarse", "pdur", "wdur", "uv", "f0"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=1e-2,
                                   err_msg=k)
    np.testing.assert_allclose(float(metrics["total_loss"]), float(j_metrics["total_loss"]),
                               rtol=2e-3)
    assert metrics["total_loss"].dtype == torch.float32
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(j_metrics["grad_norm"]),
                               rtol=1e-2)

    adam = next(s for s in jax.tree.leaves(
        new.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    mu = params_from_jax(jax.tree.map(np.asarray, adam.mu), hp)
    new_params = params_from_jax(jax.tree.map(np.asarray, new.params), hp)
    errs, moved_apart = [], []
    for name, p in step.model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        errs.append(_rel_l2(step.optimizer.state[p]["exp_avg"].numpy(), mu[name].numpy()))
        diff = np.abs(p.detach().numpy() - new_params[name].numpy())
        assert diff.max() <= 2 * hp["lr"] * 1.001, name
        moved_apart.append(np.mean(diff > 1e-6))
    assert max(errs) <= 0.4 and np.median(errs) <= 0.05, (max(errs), np.median(errs))
    assert np.mean(moved_apart) <= 0.1


def test_eval_step_stays_float32():
    """Under ``use_bf16`` only the train step is wrapped: the eval step runs
    the float32 model and equals a float32 trainer's."""
    hp = _shipped_hp(vocab_size=VOCAB)
    batch = _shipped_batch()
    trainers = [Trainer.from_hp(dict(hp, use_bf16=flag), device="cpu", seed=3,
                                vocab_size=VOCAB, sil_token_ids=SIL) for flag in (True, False)]
    draws = dict(t=torch.tensor([1, 3]), noise=torch.tensor(
        np.random.RandomState(4).randn(*batch["mels"].shape).astype(np.float32)))
    outs = [tr.eval_step(tr.to_device(batch), **draws) for tr in trainers]
    for k, v in outs[0].items():
        assert v.dtype == torch.float32, k
        assert torch.equal(v, outs[1][k]), k
    assert all(p.dtype == torch.float32 for p in trainers[0].model.parameters())
