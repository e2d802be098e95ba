"""PyTorch port, activation recomputation (``remat_diffnet``, ``remat_fft``)
against the JAX package on the CPU.

``remat_diffnet`` keeps no DiffNet block's pre-activation ``h`` for the
backward, which launches K1 again to recompute it before K5
(``DiffNetBlockRematFunction``), as the JAX package wraps each block in
``nn.remat``; ``remat_fft`` recomputes each FFT layer in the backward, as
JAX's ``nn.remat(body, prevent_cse=False)`` does. With both switches on,
SpecDenoiser (fft text encoder), StutterSpeech, DiffSpeech and FastSpeech
(fft encoder and decoder) give JAX's loss terms and every gradient (JAX
built with the same switches, its diffusion draws injected) within atol =
rtol = 1e-4; the flagship's bf16 loss holds to JAX's ``bf16_wrap`` at the
flagship's bars of ``test_torch_bf16_families.py``; the port's remat loss
and gradients equal its own without remat within 1e-6; the remat loss saves
no ``h`` for the backward; each kernel's wrapper is called as often as its
kernel launches on the card (K1 twice a block, K5 once, K3 twice a layer,
K4 once); and a parameter tree built with either switch converts.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.training.tasks.spec_denoiser import SpecDenoiserTask as JSpecDenoiser
from speech_editing_tpu.training.tasks.stutter_speech import StutterSpeechTask as JStutter
from speech_editing_tpu.training.tasks.tts import DiffSpeechTask as JDiffSpeech
from speech_editing_tpu.training.tasks.tts import FastSpeechTask as JFastSpeech
from speech_editing_tpu_torch.ops import flash_attention
from speech_editing_tpu_torch.ops.cuda import diffnet_block
from speech_editing_tpu_torch.training.tasks.spec_denoiser import SpecDenoiserTask
from speech_editing_tpu_torch.training.tasks.stutter_speech import StutterSpeechTask
from speech_editing_tpu_torch.training.tasks.tts import DiffSpeechTask, FastSpeechTask
from tests.test_torch_bf16_families import FLAGSHIP, check_gradients, check_losses
from tests.test_torch_model import VOCAB
from tests.test_torch_stutter import HP as STUTTER_HP
from tests.test_torch_stutter import _batch as stutter_batch
from tests.test_torch_stutter import random_params
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_train import HP as TRAIN_HP
from tests.test_torch_train import SIL, _jax_batch, _torch_batch
from tests.test_torch_train import _batch as train_batch
from tests.test_torch_tts_diffspeech import DS_HP
from tests.test_torch_tts_fs import HP as TTS_HP
from tests.test_torch_tts_fs import tts_batch

TOL = dict(atol=1e-4, rtol=1e-4)
SELF_TOL = 1e-6           # the port's remat step against its own plain step
REMAT = dict(remat_diffnet=True, remat_fft=True)


@dataclasses.dataclass(frozen=True)
class Model:
    jax_task: type
    port_task: type
    hp: dict
    batch: tuple              # (maker, its argument)
    t_high: int | None        # diffusion draws: t in [0, t_high); None: no draws
    global_step: bool = False


MODELS = {
    "spec_denoiser": Model(JSpecDenoiser, SpecDenoiserTask,
                           dict(TRAIN_HP, vocab_size=VOCAB, binary_data_dir=""),
                           (train_batch, 0), TRAIN_HP["timesteps"] + 1),
    "stutter_speech": Model(JStutter, StutterSpeechTask, dict(STUTTER_HP, encoder_type="fft"),
                            (stutter_batch, 0), STUTTER_HP["timesteps"] + 1, global_step=True),
    "diffspeech": Model(JDiffSpeech, DiffSpeechTask, DS_HP, (tts_batch, 6),
                        DS_HP["timesteps"]),
    "fastspeech": Model(JFastSpeech, FastSpeechTask,
                        dict(TTS_HP, encoder_type="fft", decoder_type="fft"), (tts_batch, 6),
                        None),
}


def _hp(name, **switches):
    return dict(MODELS[name].hp, **switches)


def _jax_task(name, hp):
    return type("Task", (MODELS[name].jax_task,), {"sil_token_ids": SIL})(hp)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(the batch, JAX's draws key, parameters drawn at random in the shapes
    of the remat-built model's init)."""
    m = MODELS[name]
    maker, arg = m.batch
    batch = maker(arg)
    params = random_params(_jax_task(name, _hp(name, **REMAT)), batch, 11)
    return batch, jax.random.PRNGKey(5), params


def _draws(name, batch, rng):
    """The diffusion draws of JAX's loss from ``rng`` (the loss splits it
    into the diffusion and dropout keys, the model the first)."""
    m = MODELS[name]
    if m.t_high is None:
        return {}
    k_t, k_noise = jax.random.split(jax.random.split(rng)[0])
    t = jax.random.randint(k_t, (batch["mels"].shape[0],), 0, m.t_high)
    noise = jax.random.normal(k_noise, batch["mels"].shape, jnp.float32)
    return dict(t=torch.tensor(np.asarray(t)).long(), noise=torch.tensor(np.asarray(noise)))


def _port(name, hp, params):
    task = MODELS[name].port_task(hp)
    task.sil_token_ids = SIL
    model = task.build_model()
    model.load_state_dict(task.params_from_jax(params, task.hp))
    return task, model


def _port_loss(name, **switches):
    """The port's loss terms, total and every gradient, with ``switches``."""
    batch, rng, params = _setup(name)
    task, model = _port(name, _hp(name, **switches), params)
    tb = _torch_batch(batch)
    if MODELS[name].global_step:
        tb["global_step"] = torch.tensor(0.0)
    total, losses = task.make_loss_fn(model, train=False)(tb, **_draws(name, batch, rng))
    total.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    return task, float(total.detach()), {k: float(v.detach()) for k, v in losses.items()}, grads


@pytest.mark.parametrize("name", sorted(MODELS))
def test_remat_loss_and_every_gradient_match_jax(name):
    """One JAX compile a model: ``value_and_grad`` of its task's loss, built
    with both switches on."""
    batch, rng, params = _setup(name)
    jtask = _jax_task(name, _hp(name, **REMAT))
    jb = _jax_batch(batch)
    if MODELS[name].global_step:
        jb["global_step"] = jnp.asarray(0.0, jnp.float32)
    grad_fn = jax.jit(jax.value_and_grad(jtask.make_loss_fn(jtask.build_model(), train=False),
                                         has_aux=True))
    (j_total, j_losses), j_grads = grad_fn(params, jb, rng)
    task, total, losses, grads = _port_loss(name, **REMAT)
    assert set(losses) == set(j_losses)
    for k, v in losses.items():
        np.testing.assert_allclose(v, float(j_losses[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(total, float(j_total), **TOL)
    ref = task.params_from_jax(jax.tree.map(np.asarray, j_grads), task.hp)
    assert sorted(grads) == sorted(ref)
    for n, g in grads.items():
        assert g is not None, n
        np.testing.assert_allclose(g.numpy(), ref[n].numpy(), **TOL, err_msg=n)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_remat_loss_and_gradients_equal_the_plain_ones(name):
    _, total, losses, grads = _port_loss(name, **REMAT)
    _, total0, losses0, grads0 = _port_loss(name)
    assert losses.keys() == losses0.keys() and grads.keys() == grads0.keys()
    for k, v in losses.items():
        assert abs(v - losses0[k]) <= SELF_TOL * max(abs(losses0[k]), 1.0), k
    assert abs(total - total0) <= SELF_TOL * max(abs(total0), 1.0)
    for n, g in grads.items():
        err = float((g - grads0[n]).norm() / grads0[n].norm().clamp_min(1e-30))
        assert err <= SELF_TOL, (n, err)


def test_remat_bf16_losses_match_jax():
    check_losses("flagship_remat", FLAGSHIP)


def test_remat_bf16_gradients_match_jax():
    check_gradients("flagship_remat", FLAGSHIP)


def _saved_shapes(**switches):
    """The shapes of the tensors that the spec_denoiser loss saves for its
    backward."""
    batch, rng, params = _setup("spec_denoiser")
    task, model = _port("spec_denoiser", _hp("spec_denoiser", **switches), params)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        total, _ = task.make_loss_fn(model, train=False)(
            _torch_batch(batch), **_draws("spec_denoiser", batch, rng))
    total.backward()
    return shapes


def test_remat_saves_no_pre_activation():
    """Without remat each DiffNet block saves its ``h`` [B, T, 2C]; with
    ``remat_diffnet`` none is saved, and the two switches together save
    fewer elements than either alone."""
    hp = MODELS["spec_denoiser"].hp
    b, t = train_batch(0)["mels"].shape[:2]
    h_shape = (b, t, 2 * hp["residual_channels"])
    assert _saved_shapes().count(h_shape) == hp["residual_layers"]
    assert _saved_shapes(remat_diffnet=True).count(h_shape) == 0
    size = lambda shapes: sum(int(np.prod(s)) for s in shapes)
    both = size(_saved_shapes(**REMAT))
    assert both < size(_saved_shapes(remat_diffnet=True))
    assert both < size(_saved_shapes(remat_fft=True)) < size(_saved_shapes())


def test_remat_calls_each_kernel_wrapper_as_its_kernel_launches(monkeypatch):
    """On the CPU the wrappers run their plain versions; each call here is a
    launch on the card: under both switches a step calls K1's wrapper twice
    a block (the backward's with ``h``), K5's once, K3's twice a layer
    and K4's once."""
    calls = {"k1": 0, "k1_h": 0, "k5": 0, "k3": 0, "k4": 0}

    def counted(module, name, key, h_key=None):
        real = getattr(module, name)

        def wrapper(*args, **kwargs):
            calls[h_key if h_key and kwargs.get("return_h") else key] += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)

    counted(diffnet_block, "diffnet_block", "k1", "k1_h")
    counted(diffnet_block, "diffnet_block_bwd", "k5")
    counted(flash_attention, "flash_mha", "k3")
    counted(flash_attention, "flash_mha_bwd", "k4")
    _port_loss("spec_denoiser", **REMAT)
    hp = MODELS["spec_denoiser"].hp
    layers, enc = hp["residual_layers"], hp["enc_layers"]
    assert calls == {"k1": layers, "k1_h": layers, "k5": layers, "k3": 2 * enc, "k4": enc}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_a_remat_built_parameter_tree_converts(name):
    """flax's lifted ``nn.remat`` keeps the parameter paths (``residual_{i}``,
    ``layers_{i}``): the tree of a model built with both switches is the
    plain one's, and the converter loads it into the port's model."""
    batch = MODELS[name].batch[0](MODELS[name].batch[1])

    def paths(**switches):
        task = _jax_task(name, _hp(name, **switches))
        tree = jax.eval_shape(lambda: task.init_model(task.build_model(), batch,
                                                      jax.random.PRNGKey(0)))["params"]
        return [(jax.tree_util.keystr(path), leaf.shape)
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert paths(**REMAT) == paths()
    _, _, params = _setup(name)
    _port(name, _hp(name, **REMAT), params)      # load_state_dict is strict
