"""PyTorch port, bf16 training (``use_bf16``) of every family against the
JAX package on the CPU: one bf16 loss and every gradient, the port's
``bf16_loss`` (JAX's ``bf16_wrap``: bf16 copies of float32 masters, the
batch's floats cast to bf16) against ``jax.value_and_grad(bf16_wrap(
loss_fn))`` on the same numpy weights, batch and draws. This file holds the
harness, the flagship (the fft text encoder, so attention runs the bf16
K3/K4 plain versions, and the DiffNet blocks the bf16 K1/K5 ones) and the
trainer's acceptance of ``use_bf16`` for every family; the other families
have a file each (``test_torch_bf16_{campnet,a3t,editspeech,stutter,
predictor}.py``), so that the suite's workers share them: each file is one
JAX compile, about 20 s alone.

JAX is compiled with ``xla_allow_excess_precision=False`` (each bf16
operation rounds as written, as eager JAX and the port do; see
``test_torch_bf16.py``), but for A3T, whose compile takes minutes with it.

Where the two differ, and why the bars are what they are: attention in the
port rounds where the Pallas kernel rounds (p to bf16 before P.V), JAX's
CPU path where its einsum rounds (the normalised weights); flax's Dense and
Conv round the product to bf16 before adding the bias, torch's layers add
it inside; the DiffNet blocks round as K1/K5 do, JAX's plain branch after
every conv and add. Each loss term must agree within ``LOSS_RTOL`` of
JAX's (bf16 scalars within ``ulps`` bf16 units in the last place), the
total within ``TOTAL_RTOL``, and each parameter's gradient within
``max_l2`` in relative L2 (the median over parameters within
``median_l2``); every gradient bar is at or under test_torch_bf16.py's
(0.4 and 0.05). The readings are in each family's ``Bars``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.training.tasks.a3t import A3TTask as JA3T
from speech_editing_tpu.training.tasks.campnet import CampNetTask as JCampNet
from speech_editing_tpu.training.tasks.editspeech import EditSpeechTask as JEditSpeech
from speech_editing_tpu.training.tasks.spec_denoiser import SpecDenoiserTask as JSpecDenoiser
from speech_editing_tpu.training.tasks.stutter_speech import \
    StutterPredictorTask as JPredictor
from speech_editing_tpu.training.tasks.stutter_speech import StutterSpeechTask as JStutter
from speech_editing_tpu.training.train_state import bf16_wrap
from speech_editing_tpu_torch.training.tasks.a3t import A3TTask
from speech_editing_tpu_torch.training.tasks.campnet import CampNetTask
from speech_editing_tpu_torch.training.tasks.editspeech import EditSpeechTask
from speech_editing_tpu_torch.training.tasks.spec_denoiser import SpecDenoiserTask
from speech_editing_tpu_torch.training.tasks.stutter_speech import (StutterPredictorTask,
                                                                    StutterSpeechTask)
from speech_editing_tpu_torch.training.train_state import bf16_loss
from speech_editing_tpu_torch.training.trainer import Trainer
from tests.helpers import TINY_HP
from tests.test_torch_model import VOCAB
from tests.test_torch_stutter import HP as STUTTER_HP
from tests.test_torch_stutter import _batch as stutter_batch
from tests.test_torch_stutter import random_params
from tests.test_torch_train import HP as FLAGSHIP_HP
from tests.test_torch_train import SIL, _jax_batch, _torch_batch
from tests.test_torch_train import _batch as train_batch
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

EXACT = {"xla_allow_excess_precision": False}


LOSS_RTOL, TOTAL_RTOL = 1e-2, 2e-3
FAMILY_HP = dict(TINY_HP, vocab_size=VOCAB, binary_data_dir="", lstm_hidden=32)


def family_batch(seed):
    batch = train_batch(seed)
    batch["spk_embed"] = np.random.RandomState(seed + 100).randn(2, 256).astype(np.float32)
    return batch


@dataclasses.dataclass(frozen=True)
class Family:
    jax_task: type
    port_task: type
    hp: dict
    batch: tuple              # (maker, its arguments)
    draws: str = ""           # "diffusion": t and noise; "coin": teacher forcing
    global_step: bool = False
    exact: bool = True        # EXACT compile options (else XLA's default)


FAMILIES = {
    "flagship": Family(JSpecDenoiser, SpecDenoiserTask,
                       dict(FLAGSHIP_HP, vocab_size=VOCAB, binary_data_dir=""),
                       (train_batch, 1), "diffusion"),
    # the flagship under both activation-recomputation switches
    # (``test_torch_remat.py``)
    "flagship_remat": Family(JSpecDenoiser, SpecDenoiserTask,
                             dict(FLAGSHIP_HP, vocab_size=VOCAB, binary_data_dir="",
                                  remat_diffnet=True, remat_fft=True),
                             (train_batch, 1), "diffusion"),
    "campnet": Family(JCampNet, CampNetTask, FAMILY_HP, (family_batch, 1)),
    "a3t": Family(JA3T, A3TTask, FAMILY_HP, (family_batch, 1), exact=False),
    "editspeech": Family(JEditSpeech, EditSpeechTask, FAMILY_HP, (family_batch, 1), "coin"),
    "stutter": Family(JStutter, StutterSpeechTask, STUTTER_HP, (stutter_batch, 0),
                      "diffusion", global_step=True),
    "predictor": Family(JPredictor, StutterPredictorTask, STUTTER_HP,
                        (functools.partial(stutter_batch, t=48), 4), global_step=True),
}


@dataclasses.dataclass(frozen=True)
class Bars:
    max_l2: float
    median_l2: float
    loss_rtol: float = LOSS_RTOL
    total_rtol: float = TOTAL_RTOL
    ulps: int = 0             # bf16 loss scalars: within this many bf16 ulps


def _bf16_np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _coin_key(heads: bool):
    """A key whose teacher-forcing draw in the JAX loss comes out ``heads``."""
    for seed in range(100):
        rng = jax.random.PRNGKey(seed)
        if bool(jax.random.uniform(jax.random.split(rng)[0], ()) < 0.5) == heads:
            return rng
    raise AssertionError("no key found")


@functools.lru_cache(maxsize=None)
def _jax(name):
    """(params, the batch, the compiled value-and-grad of JAX's bf16-wrapped
    loss with dropout off): one compile a family."""
    fam = FAMILIES[name]
    task = type("Task", (fam.jax_task,), {"sil_token_ids": SIL})(dict(fam.hp))
    maker, arg = fam.batch
    batch = maker(arg)
    params = random_params(task, batch, 3)
    jb = _jax_batch(batch)
    if fam.global_step:
        jb["global_step"] = jnp.asarray(0.0, jnp.float32)
    fn = jax.jit(jax.value_and_grad(bf16_wrap(task.make_loss_fn(task.build_model(),
                                                                train=False)),
                                    has_aux=True))
    rng = jax.random.PRNGKey(5)
    compiled = fn.lower(params, jb, rng).compile(EXACT if fam.exact else None)
    return params, batch, jb, compiled


@functools.lru_cache(maxsize=None)
def readings(name, heads=True):
    """Both sides' loss terms and total, and each gradient's relative L2
    error against JAX's ({parameter: error}, and the two gradients of the
    parameters whose gradient is zero in exact arithmetic, A3T's key
    biases: a softmax row does not move when every score in it does)."""
    fam = FAMILIES[name]
    params, batch, jb, compiled = _jax(name)
    rng = _coin_key(heads) if fam.draws == "coin" else jax.random.PRNGKey(5)
    (j_total, j_losses), j_grads = compiled(params, jb, rng)
    draws = {}
    if fam.draws == "diffusion":   # the draws of JAX's loss: noise in the mels' dtype
        k_t, k_noise = jax.random.split(jax.random.split(rng)[0])
        b = batch["mels"].shape[0]
        t = jax.random.randint(k_t, (b,), 0, fam.hp["timesteps"] + 1)
        noise = jax.random.normal(k_noise, batch["mels"].shape, jnp.bfloat16)
        draws = dict(t=torch.tensor(np.asarray(t)).long(), noise=torch.tensor(_bf16_np(noise)))
    elif fam.draws == "coin":
        draws = dict(teacher_forcing=float(heads))
    task = fam.port_task(dict(fam.hp))
    task.sil_token_ids = SIL
    model = task.build_model()
    model.load_state_dict(task.params_from_jax(params, task.hp))
    tb = _torch_batch(batch)
    if fam.global_step:
        tb["global_step"] = torch.tensor(0.0)
    total, losses = bf16_loss(model, task.make_loss_fn(model, train=False))(tb, **draws)
    total.backward()
    ref = task.params_from_jax(jax.tree.map(np.asarray, j_grads), task.hp)
    errors, zero_by_math = {}, {}
    for n, p in model.named_parameters():
        if not p.requires_grad:
            continue
        assert p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        r = ref[n].numpy()
        if n.endswith("self_attn.linear_k.bias"):
            zero_by_math[n] = (g, r)
        else:
            errors[n] = float(np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30))
    return dict(total=(float(total.detach()), float(j_total)), total_dtype=total.dtype,
                losses={k: (losses[k], j_losses[k]) for k in losses},
                jax_keys=set(j_losses), errors=errors, zero_by_math=zero_by_math)


def check_losses(name, bars, heads=True):
    """Every loss term (float32 ones in relative terms, bf16 scalars in bf16
    ulps of JAX's) and the total, as ``bars`` holds them."""
    r = readings(name, heads)
    assert r["total_dtype"] == torch.float32
    assert set(r["losses"]) == r["jax_keys"]
    for k, (got, want) in r["losses"].items():
        want_f = float(np.asarray(want, np.float32))
        got_f = float(got.detach().float())
        if got.dtype == torch.bfloat16:
            assert str(want.dtype) == "bfloat16", k
            ulp = 2.0 ** (np.floor(np.log2(abs(want_f))) - 7) if want_f else 0.0
            assert abs(got_f - want_f) <= bars.ulps * ulp, (k, got_f, want_f)
        else:
            np.testing.assert_allclose(got_f, want_f, rtol=bars.loss_rtol, atol=1e-6,
                                       err_msg=k)
    got, want = r["total"]
    np.testing.assert_allclose(got, want, rtol=bars.total_rtol, err_msg="total")


def check_gradients(name, bars, heads=True):
    """Every gradient within ``bars.max_l2`` of JAX's in relative L2, the
    median over parameters within ``bars.median_l2``."""
    errors = readings(name, heads)["errors"]
    worst = max(errors.items(), key=lambda kv: kv[1])
    assert worst[1] <= bars.max_l2, worst
    assert np.median(list(errors.values())) <= bars.median_l2, np.median(list(errors.values()))


# -- the flagship: fft text encoder, bf16 K3/K4 and K1/K5 plain versions -------

# readings: loss terms within 2.1e-3 (uv), total 3.0e-4; gradients 0.22 at
# worst (the pitch predictor's, whose input carries the encoder's attention
# rounding), median 0.031
FLAGSHIP = Bars(max_l2=0.4, median_l2=0.05)


def test_flagship_bf16_losses_match_jax():
    check_losses("flagship", FLAGSHIP)


def test_flagship_bf16_gradients_match_jax():
    check_gradients("flagship", FLAGSHIP)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_trainer_takes_use_bf16_for_every_family(family):
    """No family is refused under ``use_bf16``, and a step on the CPU keeps
    float32 masters and applies a finite update."""
    fam = FAMILIES[family]
    hp = dict(fam.hp, use_bf16=True, lr=1e-3, scheduler="none")
    task = fam.port_task(hp)
    task.sil_token_ids = SIL
    trainer = Trainer(task, task.hp, "cpu", dropout=False)
    maker, arg = fam.batch
    metrics = trainer.train_step(_torch_batch(maker(arg)),
                                 generator=torch.Generator().manual_seed(0))
    assert float(metrics["nan_grads"]) == 0.0 and trainer.train_step.updates == 1
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
