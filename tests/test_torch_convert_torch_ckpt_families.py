"""PyTorch port, released reference checkpoints of the other editing
families (``utils/convert_torch_ckpt.py``: StutterSpeech, CampNet,
EditSpeech, A3T) against the JAX package's converters, on CPU.

Each reference-layout state dict is built from seeded tensors, with what a
reference checkpoint holds beyond the port's names: the schedule buffers
and the conditioner's decoder (StutterSpeech, EditSpeech), the parent
FastSpeech's leftovers and the encoder's unused ``pre_net`` (CampNet, A3T),
A3T's BatchNorm statistics; EditSpeech's reference lacks the duration
embedding. The JAX package's ``convert_*`` followed by its forward equals
the port's converter followed by the port's forward within 1e-4 (the
StutterSpeech reverse run within 1e-3), and the converted state dicts
equal the JAX trees carried across by ``convert_jax_params``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.models.a3t import A3T as JA3T
from speech_editing_tpu.models.campnet import CampNet as JCampNet
from speech_editing_tpu.models.editspeech import EditSpeech as JEditSpeech
from speech_editing_tpu.models.stutter_speech import StutterGaussianDiffusion as JSGD
from speech_editing_tpu.ops import diffusion as j_diff
from speech_editing_tpu.training.tasks.stutter_speech import \
    collapse_stutter_labels as j_collapse
from speech_editing_tpu.utils import convert_torch_ckpt as jconv
from speech_editing_tpu_torch.models.a3t import A3T
from speech_editing_tpu_torch.models.campnet import CampNet
from speech_editing_tpu_torch.models.editspeech import EditSpeech
from speech_editing_tpu_torch.models.stutter_speech import StutterGaussianDiffusion
from speech_editing_tpu_torch.utils import convert_jax_params as cjp
from speech_editing_tpu_torch.utils import convert_torch_ckpt as conv
from tests.helpers import TINY_HP
from tests.test_torch_a3t import NAMES as A3T_NAMES
from tests.test_torch_a3t import data  # noqa: F401  (module fixture)
from tests.test_torch_convert_torch_ckpt import assert_state_dicts_close, seeded
from tests.test_torch_editspeech import NAMES as EDITSPEECH_NAMES
from tests.test_torch_stutter import HP as STUTTER_HP
from tests.test_torch_stutter import VOCAB as STUTTER_VOCAB
from tests.test_torch_stutter import _batch as stutter_batch
from tests.test_torch_train import _jax_batch, _torch_batch
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=1e-4, rtol=1e-4)
V = 12


def leftovers(sd: dict, hidden: int, seed: int, prefixes) -> dict:
    """``sd`` plus seeded tensors under ``prefixes`` (weights a reference
    checkpoint holds and the port does not use)."""
    rs = np.random.RandomState(seed)
    return dict(sd, **{f"{p}weight": rs.randn(hidden, hidden).astype(np.float32)
                       for p in prefixes})


@pytest.fixture(scope="module")
def editspeech_data():
    rs = np.random.RandomState(0)
    b, t, s = 3, 40, 9
    frames, tokens = (40, 30, 21), (9, 6, 4)
    txt = rs.randint(3, V, (b, s))
    mels = rs.randn(b, t, 80).astype(np.float32)
    m2p = np.zeros((b, t), np.int64)
    for i in range(b):
        txt[i, tokens[i]:] = 0
        mels[i, frames[i]:] = 0
        m2p[i, :frames[i]] = np.minimum(np.arange(frames[i]) * tokens[i] // frames[i] + 1,
                                        tokens[i])
    tm = np.zeros((b, t, 1), np.float32)
    tm[:, 8:17] = 1
    f0 = (rs.rand(b, t) * 2).astype(np.float32)
    uv = (rs.rand(b, t) > 0.7).astype(np.float32)
    return dict(txt=txt, tm=tm, m2p=m2p, spk=rs.randn(b, 256).astype(np.float32), mels=mels,
                f0=f0 * (m2p > 0), uv=uv * (m2p > 0))


def test_stutter_speech_matches_jax_converter_and_reverse_run():
    hp = STUTTER_HP
    sd = seeded(StutterGaussianDiffusion(STUTTER_VOCAB, hp, 80), 0, 0.05)
    sd = leftovers(sd, hp["hidden_size"], 1, ("fs.decoder.layers.0.op.ffn.ffn_2.", "fs.mel_out."))
    sd["posterior_variance"] = np.ones(hp["timesteps"], np.float32)
    params = jconv.convert_stutter_gaussian_diffusion(sd, hp)
    port_sd = conv.convert_stutter_gaussian_diffusion(sd, hp)
    assert_state_dicts_close(port_sd, cjp.stutter_speech_params_from_jax(params, hp), atol=0)
    batch = stutter_batch(2)
    jb, tb = _jax_batch(batch), _torch_batch(batch)
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    ref = jax.jit(functools.partial(JSGD(STUTTER_VOCAB, hp, 80).apply, infer=True))(
        {"params": params}, jb["txt_tokens"], jb["time_mel_masks"][..., None],
        j_collapse(jb["stutter_mel_masks"]), jb["mel2ph"], jb["spk_embed"], jb["mels"],
        jb["f0"], jb["uv"], rng=keys)
    big_t, t_mel = hp["timesteps"], batch["mels"].shape[1]
    noise = [torch.tensor(np.asarray(j_diff.per_row_noise(keys, s, (t_mel, 80))))
             for s in [big_t] + list(range(big_t - 1, -1, -1))]
    model = StutterGaussianDiffusion(STUTTER_VOCAB, hp, 80).eval()
    model.load_state_dict(port_sd, strict=True)
    with torch.no_grad():
        out = model(tb["txt_tokens"], tb["time_mel_masks"][..., None], tb["mel2ph"],
                    tb["spk_embed"], tb["mels"], tb["f0"], tb["uv"], noise=noise)
    np.testing.assert_allclose(out["mel_out"].numpy(), np.asarray(ref["mel_out"]), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(out["stutter_predictor_out"].numpy(),
                               np.asarray(ref["stutter_predictor_out"]), **TOL)


def test_campnet_matches_jax_converter_and_forward(data):  # noqa: F811
    hp = dict(TINY_HP)
    sd = seeded(CampNet(V, hp), 2, 0.05)
    sd = leftovers(sd, hp["hidden_size"], 3, ("pitch_embed.", "mel_out.", "encoder.pre_net.0.",
                                              "dur_predictor.linear."))
    with pytest.raises(KeyError, match="decoder_stray"):
        conv.convert_campnet(dict(sd, **{"decoder_stray.weight": np.ones(1)}), hp)
    params = jconv.convert_campnet(sd, hp)
    port_sd = conv.convert_campnet(sd, hp)
    assert_state_dicts_close(port_sd, cjp.campnet_params_from_jax(params, hp), atol=0)
    args = [data[k] for k in ("txt", "mels", "tm")]
    ref = jax.jit(functools.partial(JCampNet(V, hp).apply, infer=True))(
        {"params": params}, *map(jnp.asarray, args))
    model = CampNet(V, hp).eval()
    model.load_state_dict(port_sd, strict=True)
    with torch.no_grad():
        out = model(*map(torch.tensor, args))
    for k in ("mel_out_coarse", "mel_out_fine", "attn"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL, err_msg=k)


def test_editspeech_matches_jax_converter_and_forward(editspeech_data):
    """The reference's plain FastSpeech has no duration embedding: the port
    keeps its initialisation there, as the JAX package merges onto its init
    tree (inference never reads it)."""
    hp = dict(TINY_HP, decoder_type="fft")
    d = editspeech_data
    full = seeded(EditSpeech(V, hp), 4, 0.05)
    sd = {k: v for k, v in full.items() if not k.startswith("fs.dur_embed.")}
    sd = leftovers(sd, hp["hidden_size"], 5, ("fs.mel_out.",))
    jm = JEditSpeech(V, hp)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "teacher": jax.random.PRNGKey(1)},
        *(jnp.asarray(d[k]) for k in EDITSPEECH_NAMES)))["params"]
    init = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    params = jconv.merge_params(init, jconv.convert_editspeech(sd, hp))
    port_sd = conv.convert_editspeech(sd, hp)
    want = cjp.editspeech_params_from_jax(params, hp)
    want["fs.dur_embed.weight"] = port_sd["fs.dur_embed.weight"]
    # the JAX package sums the LSTM's two biases into the h side
    summed = dict(port_sd)
    for k in [k for k in port_sd if "bias_ih_l" in k]:
        summed[k.replace("bias_ih", "bias_hh")] = port_sd[k] + port_sd[k.replace("bias_ih",
                                                                                 "bias_hh")]
        summed[k] = torch.zeros_like(port_sd[k])
    assert_state_dicts_close(summed, want, atol=0)
    ref = jax.jit(functools.partial(jm.apply, infer=True))(
        {"params": params}, *(jnp.asarray(d[k]) for k in EDITSPEECH_NAMES))
    model = EditSpeech(V, hp).eval()
    model.load_state_dict(port_sd, strict=True)
    with torch.no_grad():
        out = model(*(torch.tensor(d[k]) for k in EDITSPEECH_NAMES))
    for k in ("forward_outputs", "backward_outputs"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL, err_msg=k)


def test_a3t_matches_jax_converter_with_batchnorm_folded(data):  # noqa: F811
    hp = dict(TINY_HP, espnet_bn_affine=True)
    sd = seeded(A3T(V, hp), 6, 0.05)
    rs = np.random.RandomState(7)
    for k in sd:        # the reference's eval-mode statistics
        if k.endswith("running_mean"):
            sd[k] = (0.3 * rs.randn(*sd[k].shape)).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = (0.5 + rs.rand(*sd[k].shape)).astype(np.float32)
    sd = leftovers(sd, hp["hidden_size"], 8, ("mel_out.", "pitch_predictor.linear."))
    with pytest.raises(ValueError, match="espnet_bn_affine"):
        conv.convert_a3t(sd, TINY_HP)
    params = jconv.convert_a3t(sd, hp)
    port_sd = conv.convert_a3t(sd, hp)
    assert_state_dicts_close(port_sd, cjp.a3t_params_from_jax(params, hp))
    ref = jax.jit(functools.partial(JA3T(V, hp).apply, infer=True))(
        {"params": params}, *(jnp.asarray(data[k]) for k in A3T_NAMES))
    model = A3T(V, hp).eval()
    model.load_state_dict(port_sd, strict=True)
    with torch.no_grad():
        out = model(*(torch.tensor(data[k]) for k in A3T_NAMES))
    for k in ("mel_out_decoder", "mel_out_postnet"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL, err_msg=k)
