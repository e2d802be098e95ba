"""PyTorch port, StutterSpeech against the JAX package on CPU: the new
modules (``ConditionalConvBlocks``, ``WN``, ``ConvMelPrenet``,
``FrameStutterHead``, ``StutterPredictor``, ``StutterGaussianDiffusion``
in training with JAX's diffusion draws and at inference with its per-step
noise), the focal loss and the cross entropy, the label collapse and the
block labels (exhaustively on small arrays), both tasks' losses and every
gradient at two ``global_step`` values, dropout's rate and scaling, the
weight round trip through the unchanged ``convert_stutter_gaussian_diffusion``,
the predictor's warm start (from a port and from a JAX checkpoint, and its
two errors) and ``TrainStep``'s use of the task's loss and ``global_step``
(flax's initializers on the new models: ``test_torch_init.py``).

Weights come from flax's ``init``, every leaf perturbed, and cross by
``stutter_speech_params_from_jax`` / ``stutter_predictor_params_from_jax``.
Modules agree within atol = rtol = 1e-4, the whole reverse diffusion
within 1e-3, the losses within 1e-6; the task losses within rtol 1e-4 and
the gradients within atol 1e-4, rtol 1e-3 (``GRAD_TOL``), dropout off.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.models.stutter_speech import ConvMelPrenet as JConvMelPrenet
from speech_editing_tpu.models.stutter_speech import FrameStutterHead as JFrameStutterHead
from speech_editing_tpu.modules.conv import ConditionalConvBlocks as JCondConvBlocks
from speech_editing_tpu.modules.wavenet import WN as JWN
from speech_editing_tpu.ops import diffusion as j_diff
from speech_editing_tpu.training import losses as jl
from speech_editing_tpu.training.checkpoint import save_checkpoint as j_save_checkpoint
from speech_editing_tpu.training.optim import build_optimizer as j_optimizer
from speech_editing_tpu.training.tasks.stutter_speech import \
    StutterPredictorTask as JPredictorTask
from speech_editing_tpu.training.tasks.stutter_speech import \
    StutterSpeechTask as JStutterTask
from speech_editing_tpu.training.tasks.stutter_speech import \
    collapse_stutter_labels as j_collapse
from speech_editing_tpu.training.train_state import TrainState
from speech_editing_tpu.utils.convert_torch_ckpt import convert_stutter_gaussian_diffusion
from speech_editing_tpu_torch.models.stutter_speech import (ConvMelPrenet, FrameStutterHead,
                                                            StutterGaussianDiffusion,
                                                            StutterPredictor)
from speech_editing_tpu_torch.modules.conv import ConditionalConvBlocks
from speech_editing_tpu_torch.modules.predictors import dropout
from speech_editing_tpu_torch.modules.wavenet import WN
from speech_editing_tpu_torch.training import losses as tl
from speech_editing_tpu_torch.training.checkpoint import save_checkpoint
from speech_editing_tpu_torch.training.tasks.stutter_speech import (StutterPredictorTask,
                                                                    StutterSpeechTask,
                                                                    block_labels,
                                                                    collapse_stutter_labels)
from speech_editing_tpu_torch.training.train_state import TrainStep
from speech_editing_tpu_torch.utils import convert_jax_params as cjp
from speech_editing_tpu_torch.utils.init import init_like_flax
from tests.test_torch_conv_encoder import HP as CONV_HP
from tests.test_torch_model import VOCAB, _randomize
from tests.test_torch_train import GRAD_TOL, SIL, _jax_batch, _jax_draws, _torch_batch
from tests.test_torch_train import _batch as _train_batch
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=1e-4, rtol=1e-4)
HP = dict(CONV_HP, vocab_size=VOCAB, binary_data_dir="", stutter_block_size=16)
STEPS = (0.0, 50000.0)     # global_step values: the annealed weights at both ends


def _np(tree):
    return jax.tree.map(np.array, tree)


def random_params(task, batch, seed):
    """A JAX task's parameter tree drawn at random in the shapes its
    ``init_model`` gives (traced, not compiled): each kernel normal with
    variance 1 / fan_in, each bias, norm offset or other vector 0.05 of
    noise about 0 (about 1 for a norm's ``scale``)."""
    shapes = jax.eval_shape(lambda: task.init_model(task.build_model(), batch,
                                                    jax.random.PRNGKey(0)))["params"]
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        if len(s.shape) <= 1:
            base = 1.0 if "scale" in str(path[-1]) else 0.0
            return (base + 0.05 * rs.randn(*s.shape)).astype(np.float32)
        return (rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _labels(rs, mel2ph):
    """Per-frame labels as the binarizer writes them: 0 fluent, 1 stutter in
    spans of 2-5 frames (about 10 % of frames), -1 (``stutter_pad_idx``) at
    padding."""
    b, t = mel2ph.shape
    lab = np.zeros((b, t), np.int64)
    for i in range(b):
        for start in rs.choice(t, max(1, t // 20), replace=False):
            lab[i, start:start + rs.randint(2, 6)] = 1
    return np.where(mel2ph > 0, lab, -1)


def _batch(seed, t=36):
    """The FluentSpeech training batch (row 1 shorter, its tail padded) with
    a speaker embedding and per-frame stutter labels."""
    batch = _train_batch(seed, t=t)
    rs = np.random.RandomState(seed + 100)
    batch["spk_embed"] = rs.randn(2, 256).astype(np.float32)
    batch["stutter_mel_masks"] = _labels(rs, batch["mel2ph"])
    return batch


def _grads_match(model, j_grads, convert):
    ref = convert(_np(j_grads), HP)
    named = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert sorted(named) == sorted(ref)
    for name, p in named.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), **GRAD_TOL, err_msg=name)


# -- modules ------------------------------------------------------------------------


def test_conditional_conv_blocks_match_jax_with_padding():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 21, 32).astype(np.float32)
    cond = rs.randn(2, 21, 24).astype(np.float32)
    nonpad = np.ones((2, 21, 1), np.float32)
    nonpad[1, 15:] = 0
    jm = JCondConvBlocks(32, 32, (1, 2), 5, layers_in_block=2, dropout=0.3)
    args = [jnp.asarray(a) for a in (x, cond, nonpad)]
    params = _randomize(_np(jax.jit(jm.init)(jax.random.PRNGKey(0), *args)["params"]), 1)
    ref = jax.jit(jm.apply)({"params": params}, *args)
    m = ConditionalConvBlocks(32, 24, 32, (1, 2), 5, layers_in_block=2, dropout=0.3)
    sd = {}
    cjp._conv(sd, "g_prenet", params["g_prenet"])
    cjp._conv_blocks(sd, "", params["conv"], 2, 2)
    m.load_state_dict(sd)
    with torch.no_grad():
        out = m(*(torch.tensor(a) for a in (x, cond, nonpad)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not out[1, 15:].any()


@pytest.mark.parametrize("masked", [False, True])
def test_wn_matches_jax(masked):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 19, 16).astype(np.float32)
    cond = rs.randn(2, 19, 24).astype(np.float32)
    nonpad = np.ones((2, 19, 1), np.float32)
    nonpad[0, 12:] = 0
    jm = JWN(16, kernel_size=5, dilation_rate=2, n_layers=3, c_cond=24, dropout=0.3)
    jargs = (jnp.asarray(x), jnp.asarray(nonpad) if masked else None, jnp.asarray(cond))
    params = _randomize(_np(jax.jit(jm.init)(jax.random.PRNGKey(0), *jargs)["params"]), 2)
    ref = jax.jit(jm.apply)({"params": params}, *jargs)
    m = WN(16, kernel_size=5, dilation_rate=2, n_layers=3, c_cond=24, dropout=0.3)
    state: dict = {}
    cjp._conv(state, "cond_layer", params["cond_layer"])
    for i in range(3):
        cjp._conv(state, f"in_layers.{i}", params[f"in_{i}"])
        cjp._conv(state, f"res_skip_layers.{i}", params[f"res_skip_{i}"])
    m.load_state_dict(state)
    with torch.no_grad():
        out = m(torch.tensor(x), torch.tensor(nonpad) if masked else None, torch.tensor(cond))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_conv_mel_prenet_matches_jax():
    x = np.random.RandomState(2).randn(2, 48, 80).astype(np.float32)
    jm = JConvMelPrenet(hidden_size=32)
    params = _randomize(_np(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]), 3)
    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    m = ConvMelPrenet(80, 32)
    sd: dict = {}
    cjp._mel_prenet(sd, "p", params)
    m.load_state_dict({k[2:]: v for k, v in sd.items()})
    with torch.no_grad():
        out = m(torch.tensor(x))
    assert out.shape == (2, 3, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_frame_stutter_head_matches_jax():
    rs = np.random.RandomState(3)
    x, cond = (rs.randn(2, 23, 32).astype(np.float32) for _ in range(2))
    nonpad = np.ones((2, 23, 1), np.float32)
    nonpad[1, 17:] = 0
    jm = JFrameStutterHead(32)
    args = [jnp.asarray(a) for a in (x, cond, nonpad)]
    params = _randomize(_np(jax.jit(jm.init)(jax.random.PRNGKey(0), *args)["params"]), 4)
    ref = jax.jit(jm.apply)({"params": params}, *args)
    m = FrameStutterHead(32)
    sd: dict = {}
    cjp._conv(sd, "conv.g_prenet", params["conv"]["g_prenet"])
    cjp._conv_blocks(sd, "conv.", params["conv"]["conv"], 4, 2)
    cjp._linear(sd, "linear", params["linear"])
    m.load_state_dict(sd)
    with torch.no_grad():
        out = m(*(torch.tensor(a) for a in (x, cond, nonpad)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_dropout_rate_and_scaling_on_one_layer():
    """The frame head's dropout (0.3) keeps about 70 % of the values, scaled
    by 1 / 0.7, with masks from the generator alone; off without ``train``."""
    x = torch.ones(64, 200, 32)
    y = dropout(x, 0.3, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    torch.testing.assert_close(y, dropout(x, 0.3, torch.Generator().manual_seed(0)))
    head = init_like_flax(FrameStutterHead(32))
    rs = np.random.RandomState(5)
    args = [torch.tensor(rs.randn(2, 23, 32).astype(np.float32)) for _ in range(2)]
    with torch.no_grad():
        plain = head(*args)
        a = head(*args, train=True, generator=torch.Generator().manual_seed(1))
        b = head(*args, train=True, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, plain)


# -- losses and labels -----------------------------------------------------------------


def test_focal_and_cross_entropy_losses_match_jax():
    rs = np.random.RandomState(6)
    logits = (rs.randn(3, 17, 3) * 2).astype(np.float32)
    target = rs.randint(0, 3, (3, 17))
    ignored = target.copy()
    ignored[1, 4:] = -1
    pairs = [(tl.multi_focal_loss(torch.tensor(logits), torch.tensor(target)),
              jl.multi_focal_loss(jnp.asarray(logits), jnp.asarray(target)))]
    for tgt in (target, ignored):
        pairs.append((tl.cross_entropy_loss(torch.tensor(logits), torch.tensor(tgt)),
                      jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(tgt))))
    pairs.append((tl.cross_entropy_loss(torch.tensor(logits), torch.tensor(target), 2),
                  jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(target), 2)))
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    assert float(pairs[2][0]) != float(pairs[1][0])


def test_label_collapse_and_block_labels_match_jax_exhaustively():
    """Every value in -3..3, and every sequence of 8 frames over {-1, 0, 1}
    (6,561) cut into blocks of 2, 4 and 8."""
    values = np.arange(-3, 4)[None]
    np.testing.assert_array_equal(collapse_stutter_labels(torch.tensor(values)).numpy(),
                                  np.asarray(j_collapse(jnp.asarray(values))))
    seqs = np.array(list(itertools.product((-1, 0, 1), repeat=8)), np.int64)
    for bs in (2, 4, 8):
        task = JPredictorTask(dict(HP, stutter_block_size=bs))
        want = np.asarray(task._block_labels(jnp.asarray(seqs)))
        got = block_labels(torch.tensor(seqs), bs).numpy()
        assert got.shape == (len(seqs), 8 // bs)
        np.testing.assert_array_equal(got, want)


# -- StutterSpeech -----------------------------------------------------------------------


class _JStutterTask(JStutterTask):
    sil_token_ids = SIL


@functools.lru_cache(maxsize=1)
def _stutter():
    """(jax model, perturbed numpy params, jitted value_and_grad of the JAX
    task's loss with dropout off)."""
    task = _JStutterTask(HP)
    jm = task.build_model()
    params = random_params(task, _batch(0), 7)
    loss_fn = task.make_loss_fn(jm, train=False)
    return jm, params, jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _port_task(cls, **hp):
    task = cls(dict(HP, **hp))
    task.sil_token_ids = SIL
    return task


def _stutter_model(params):
    model = StutterGaussianDiffusion(VOCAB, HP, 80)
    model.load_state_dict(cjp.stutter_speech_params_from_jax(params, HP))
    return model


@pytest.mark.parametrize("step", STEPS)
def test_stutter_speech_loss_and_every_gradient_match_jax(step):
    jm, params, grad_fn = _stutter()
    batch = _batch(0)
    rng = jax.random.PRNGKey(5)
    jbatch = dict(_jax_batch(batch), global_step=jnp.asarray(step, jnp.float32))
    (j_total, j_losses), j_grads = grad_fn(params, jbatch, rng)
    model = _stutter_model(params)
    t, noise = _jax_draws(rng, batch)
    tbatch = dict(_torch_batch(batch), global_step=torch.tensor(step))
    total, losses = _port_task(StutterSpeechTask).make_loss_fn(model, train=False)(
        tbatch, t=t, noise=noise)
    total.backward()
    assert set(losses) == set(j_losses) == {"l1_coarse", "ssim_coarse", "pdur", "wdur",
                                            "sdur", "uv", "f0", "ce", "focal"}
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()), float(j_losses[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=1e-4)
    _grads_match(model, j_grads, cjp.stutter_speech_params_from_jax)


def test_stutter_diffusion_training_forward_matches_jax():
    """The training forward with JAX's own t and noise: the x0 prediction,
    the frame head's logits and the stutter-conditioned ``cond``."""
    jm, params, _ = _stutter()
    batch = _batch(1)
    jb = _jax_batch(batch)
    tm = jb["time_mel_masks"][..., None]
    labels = j_collapse(jb["stutter_mel_masks"])
    rng = jax.random.PRNGKey(9)
    ref = jax.jit(functools.partial(jm.apply, infer=False))(
        {"params": params}, jb["txt_tokens"], tm, labels, jb["mel2ph"], jb["spk_embed"],
        jb["mels"], jb["f0"], jb["uv"], rng=rng)
    k_t, k_noise = jax.random.split(rng)
    t = torch.tensor(np.asarray(jax.random.randint(k_t, (2,), 0, HP["timesteps"] + 1)))
    noise = torch.tensor(np.asarray(jax.random.normal(k_noise, batch["mels"].shape)))
    tb = _torch_batch(batch)
    with torch.no_grad():
        out = _stutter_model(params).forward_train(
            tb["txt_tokens"], tb["time_mel_masks"][..., None], tb["mel2ph"], tb["spk_embed"],
            tb["mels"], tb["f0"], tb["uv"], t=t.long(), noise=noise, train=False,
            stutter_labels=collapse_stutter_labels(tb["stutter_mel_masks"]))
    for key in ("mel_out", "stutter_predictor_out", "dur", "pitch_pred"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL, err_msg=key)


def test_stutter_diffusion_inference_matches_jax_with_injected_noise():
    """The reverse run with JAX's per-row noise injected step by step:
    within 1e-3 for the whole run; the frame head's logits within 1e-4."""
    jm, params, _ = _stutter()
    batch = _batch(2)
    jb = _jax_batch(batch)
    tm = jb["time_mel_masks"][..., None]
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    ref = jax.jit(functools.partial(jm.apply, infer=True))(
        {"params": params}, jb["txt_tokens"], tm, j_collapse(jb["stutter_mel_masks"]),
        jb["mel2ph"], jb["spk_embed"], jb["mels"], jb["f0"], jb["uv"], rng=keys)
    big_t, t_mel = HP["timesteps"], batch["mels"].shape[1]
    noise = [torch.tensor(np.asarray(j_diff.per_row_noise(keys, s, (t_mel, 80))))
             for s in [big_t] + list(range(big_t - 1, -1, -1))]
    tb = _torch_batch(batch)
    model = _stutter_model(params).eval()
    with torch.no_grad():
        out = model(tb["txt_tokens"], tb["time_mel_masks"][..., None], tb["mel2ph"],
                    tb["spk_embed"], tb["mels"], tb["f0"], tb["uv"], noise=noise)
    np.testing.assert_allclose(out["mel_out"].numpy(), np.asarray(ref["mel_out"]),
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(out["stutter_predictor_out"].numpy(),
                               np.asarray(ref["stutter_predictor_out"]), **TOL)


def test_stutter_state_dict_round_trips_through_the_reference_converter():
    """port state_dict -> the JAX package's convert_stutter_gaussian_diffusion
    (the reference torch layout) -> stutter_speech_params_from_jax: the same
    state_dict, exactly."""
    torch.manual_seed(0)
    model = init_like_flax(StutterGaussianDiffusion(VOCAB, HP, 80))
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    back = cjp.stutter_speech_params_from_jax(convert_stutter_gaussian_diffusion(sd, HP), HP)
    assert sorted(back) == sorted(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


# -- the stutter predictor -----------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _predictor():
    task = JPredictorTask(HP)
    jm = task.build_model()
    params = random_params(task, _batch(0, t=48), 8)
    return jm, params, jax.jit(jax.value_and_grad(task.make_loss_fn(jm, train=False),
                                                  has_aux=True))


def _predictor_model(params):
    model = StutterPredictor(VOCAB, HP, 16, 80)
    model.load_state_dict(cjp.stutter_predictor_params_from_jax(params, HP))
    return model


def test_stutter_predictor_matches_jax():
    """Rows of 48 and 43 frames (the second not a multiple of 16, padded)."""
    jm, params, _ = _predictor()
    batch = _batch(3, t=48)
    jb = _jax_batch(batch)
    ref = jax.jit(jm.apply)({"params": params}, jb["txt_tokens"], jb["mels"], jb["mel2ph"])
    with torch.no_grad():
        out = _predictor_model(params)(*(torch.tensor(batch[k])
                                         for k in ("txt_tokens", "mels", "mel2ph")))
    assert out["logits"].shape == (2, 3, 3)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(ref["logits"]), **TOL)


@pytest.mark.parametrize("step", STEPS)
def test_stutter_predictor_loss_and_every_gradient_match_jax(step):
    jm, params, grad_fn = _predictor()
    batch = _batch(4, t=48)
    jbatch = dict(_jax_batch(batch), global_step=jnp.asarray(step, jnp.float32))
    (j_total, j_losses), j_grads = grad_fn(params, jbatch, jax.random.PRNGKey(0))
    model = _predictor_model(params)
    tbatch = dict(_torch_batch(batch), global_step=torch.tensor(step))
    total, losses = _port_task(StutterPredictorTask).make_loss_fn(model, train=False)(tbatch)
    total.backward()
    assert set(losses) == set(j_losses) == {"ce", "focal", "acc", "acc_1"}
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()), float(j_losses[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=1e-4)
    _grads_match(model, j_grads, cjp.stutter_predictor_params_from_jax)


# -- the warm start ------------------------------------------------------------------------


def test_warm_start_from_port_and_jax_checkpoints_and_its_errors(tmp_path):
    """The predictor's ``txt_encoder`` becomes an editor's ``fs.encoder``, bit
    for bit, from a port work dir and from a JAX checkpoint file; a work
    dir without a checkpoint and an editor with the fft encoder raise."""
    torch.manual_seed(1)
    editor = init_like_flax(StutterGaussianDiffusion(VOCAB, HP, 80))
    save_checkpoint(str(tmp_path / "port"), {"model": editor.state_dict()}, 5)
    task = _port_task(StutterPredictorTask, spec_denoiser_work_dir=str(tmp_path / "port"))
    model = task.build_model()
    enc = {k[len("fs.encoder."):]: v for k, v in editor.state_dict().items()
           if k.startswith("fs.encoder.")}
    for k, v in model.txt_encoder.state_dict().items():
        assert torch.equal(v, enc[k]), k

    _, params, _ = _stutter()
    tx = j_optimizer(dict(HP, lr=1e-3))
    j_save_checkpoint(str(tmp_path / "jax"), TrainState.create(params, tx), 7)
    path = str(tmp_path / "jax" / "model_ckpt_steps_7.ckpt")
    model = _port_task(StutterPredictorTask, spec_denoiser_work_dir=path).build_model()
    want = cjp.text_conv_encoder_params_from_jax(params["fs"]["encoder"], 2)
    for k, v in model.txt_encoder.state_dict().items():
        assert torch.equal(v, want[k]), k

    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="has no checkpoint"):
        _port_task(StutterPredictorTask,
                   spec_denoiser_work_dir=str(tmp_path / "empty")).build_model()
    fft_hp = dict(HP, encoder_type="fft", enc_layers=1)
    torch.manual_seed(2)
    fft_editor = init_like_flax(StutterGaussianDiffusion(VOCAB, fft_hp, 80))
    save_checkpoint(str(tmp_path / "fft"), {"model": fft_editor.state_dict()}, 3)
    with pytest.raises(ValueError, match="does not match"):
        _port_task(StutterPredictorTask,
                   spec_denoiser_work_dir=str(tmp_path / "fft")).build_model()


# -- the train step ------------------------------------------------------------------------


def test_train_step_uses_the_tasks_loss_and_passes_global_step():
    """``TrainStep`` calls the loss it is given; its batch carries
    ``global_step``, a 0-d float tensor on the batch's device counting the
    calls before (a skipped, non-finite update counts too), as JAX's
    ``state.step``; the draws it is given reach the loss."""
    model = torch.nn.Linear(3, 1)
    seen = []

    def loss_fn(batch, generator=None, **draws):
        seen.append((batch["global_step"], sorted(draws)))
        y = model(batch["x"]).mean() * batch["scale"]
        return y, {"y": y}

    step = TrainStep(model, dict(lr=1e-3, scheduler="none", clip_grad_norm=1,
                                 clip_grad_value=0, weight_decay=0), loss_fn)
    good = {"x": torch.ones(2, 3), "scale": torch.tensor(1.0)}
    step(good, t=torch.zeros(2))
    step(dict(good, scale=torch.tensor(float("nan"))))
    step(good, teacher_forcing=1.0)
    assert [float(s) for s, _ in seen] == [0.0, 1.0, 2.0]
    assert all(s.dim() == 0 and s.dtype == torch.float32 and s.device == good["x"].device
               for s, _ in seen)
    assert [d for _, d in seen] == [["t"], [], ["teacher_forcing"]]
    assert step.step == 3 and step.updates == 2
