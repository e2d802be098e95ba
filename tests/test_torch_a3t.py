"""PyTorch port, A3T (``models/a3t.py``) and its conformer
(``modules/conformer.py``) against the JAX package's, on the same seeded
inputs with padded tokens and frames.

The legacy rel-shift and its true-length form equal JAX's bit for bit at
every T up to 7 and every true length; at the true length a row's shift is
the shift of its unpadded sequence. The relative-position attention, the
conformer stack and the model (the training ``ln`` norms, the pad-safe
serving mode and the reference's BatchNorm under ``espnet_bn_affine``)
agree within atol = rtol = 1e-4, with weights carried across by
``a3t_params_from_jax``; under ``serve_pad_safe_a3t`` bucket padding is
inert; a port ``state_dict`` with BatchNorm statistics goes through the JAX
package's ``convert_a3t`` and gives the JAX model the port's outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.models.a3t import A3T as JA3T
from speech_editing_tpu.modules.conformer import ConformerLayers as JConformerLayers
from speech_editing_tpu.modules.conformer import _legacy_rel_shift as j_legacy
from speech_editing_tpu.modules.conformer import _true_len_rel_shift as j_true_len
from speech_editing_tpu.modules.conformer import espnet_rel_pos_emb as j_rel_pos_emb
from speech_editing_tpu.utils.convert_torch_ckpt import convert_a3t
from speech_editing_tpu_torch.models.a3t import A3T
from speech_editing_tpu_torch.modules.conformer import (ConformerLayers,
                                                        RelPositionMultiHeadAttention,
                                                        espnet_rel_pos_emb, legacy_rel_shift,
                                                        true_len_rel_shift)
from speech_editing_tpu_torch.utils import convert_jax_params as cjp
from speech_editing_tpu_torch.utils.init import init_like_flax
from tests.helpers import TINY_HP, perturb_biases
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=1e-4, rtol=1e-4)
B, T, S, V = 3, 40, 9, 12
FRAMES, TOKENS = (40, 30, 21), (9, 6, 4)
NAMES = ("txt", "mels", "m2p", "tm")
MODES = {"ln": {}, "pad_safe": {"serve_pad_safe_a3t": True}, "bn": {"espnet_bn_affine": True}}


def _np(tree):
    return jax.tree.map(np.array, tree)


@pytest.mark.parametrize("t", range(1, 8))
def test_rel_shifts_equal_jax_exhaustively(t):
    rs = np.random.RandomState(t)
    x = rs.randn(2, 3, t, t).astype(np.float32)
    np.testing.assert_array_equal(legacy_rel_shift(torch.tensor(x)).numpy(),
                                  np.asarray(j_legacy(jnp.asarray(x))))
    for lengths in {(t, t), (1, t), (max(t - 1, 1), max(t - 2, 1))}:
        got = true_len_rel_shift(torch.tensor(x), torch.tensor(lengths)).numpy()
        np.testing.assert_array_equal(got, np.asarray(j_true_len(jnp.asarray(x),
                                                                 jnp.asarray(lengths))))
        for b, n in enumerate(lengths):
            # a row at its true length: the legacy shift of its unpadded sequence
            np.testing.assert_array_equal(got[b, :, :n, :n],
                                          legacy_rel_shift(torch.tensor(x[b:b + 1, :, :n, :n]))
                                          .numpy()[0])
    np.testing.assert_array_equal(
        true_len_rel_shift(torch.tensor(x), torch.tensor([t, t])).numpy(),
        legacy_rel_shift(torch.tensor(x)).numpy())


def test_rel_pos_table_equals_jax():
    np.testing.assert_array_equal(espnet_rel_pos_emb(37, 16).numpy(), j_rel_pos_emb(37, 16))


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(0)
    txt = rs.randint(3, V, (B, S))
    mels = rs.randn(B, T, 80).astype(np.float32)
    m2p = np.zeros((B, T), np.int64)
    for b in range(B):
        txt[b, TOKENS[b]:] = 0
        mels[b, FRAMES[b]:] = 0
        m2p[b, :FRAMES[b]] = np.minimum(np.arange(FRAMES[b]) * TOKENS[b] // FRAMES[b] + 1,
                                        TOKENS[b])
    tm = np.zeros((B, T, 1), np.float32)
    tm[:, 8:17] = 1
    return dict(txt=txt, mels=mels, m2p=m2p, tm=tm,
                x=rs.randn(B, T, 32).astype(np.float32) * (m2p > 0)[:, :, None])


@pytest.mark.parametrize("pad_safe", [False, True])
def test_conformer_layers_match_jax(data, pad_safe):
    """Macaron blocks with the relative-position attention, key-masked; the
    conv masked and the shift at the true length in pad-safe mode."""
    jc = JConformerLayers(32, num_layers=2, kernel_size=9, pad_safe=pad_safe)
    x = jnp.asarray(data["x"])
    params = _np(perturb_biases(jc.init(jax.random.PRNGKey(0), x)["params"]))
    ref = jc.apply({"params": params}, x)
    layers = ConformerLayers(32, 2, 9, pad_safe=pad_safe)
    sd = {}
    cjp._conformer(sd, "", params, affine=False)
    layers.load_state_dict(sd)
    with torch.no_grad():
        out = layers(torch.tensor(data["x"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.fixture(scope="module")
def jax_a3t(data):
    out = {}
    for mode, extra in MODES.items():
        hp = dict(TINY_HP, **extra)
        params = JA3T(V, hp).init(jax.random.PRNGKey(0),
                                  *(jnp.asarray(data[k]) for k in NAMES))["params"]
        out[mode] = hp, _np(perturb_biases(params))
    return out


def _port(hp, sd):
    model = A3T(V, hp)
    model.load_state_dict(sd)
    return model.eval()


def _run(model, data, rows=slice(None)):
    with torch.no_grad():
        return model(*(torch.tensor(data[k][rows]) for k in NAMES))


@pytest.mark.parametrize("mode", list(MODES))
def test_a3t_matches_jax(data, jax_a3t, mode):
    hp, params = jax_a3t[mode]
    ref = JA3T(V, hp).apply({"params": params}, *(jnp.asarray(data[k]) for k in NAMES),
                            infer=True)
    out = _run(_port(hp, cjp.a3t_params_from_jax(params, hp)), data)
    for k in ("mel_out_decoder", "mel_out_postnet"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL, err_msg=k)


def test_pad_safe_padding_is_inert(data, jax_a3t):
    """``serve_pad_safe_a3t``: each padded row's frames equal its exact-fit
    run; by default they do not (the bucket shifts mel-text distances)."""
    for mode, same in (("pad_safe", True), ("ln", False)):
        hp, params = jax_a3t[mode]
        model = _port(hp, cjp.a3t_params_from_jax(params, hp))
        padded = _run(model, data)["mel_out_postnet"]
        for b in (1, 2):
            n, s = FRAMES[b], TOKENS[b]
            row = {k: data[k][b:b + 1, :n] for k in ("mels", "m2p", "tm")}
            row["txt"] = data["txt"][b:b + 1, :s]
            exact = _run(model, row)["mel_out_postnet"][0]
            assert torch.allclose(padded[b, :n], exact, atol=1e-5, rtol=1e-5) == same, (mode, b)


def test_state_dict_round_trips_through_jax_convert_a3t(data, jax_a3t):
    """The reference layout with BatchNorm statistics (``espnet_bn_affine``):
    the JAX package folds them into its affine norms."""
    hp, _ = jax_a3t["bn"]
    torch.manual_seed(0)
    model = init_like_flax(A3T(V, hp)).eval()
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.rand_like(t) + 0.5)
            elif t.is_floating_point() and t.ndim <= 1:
                t.add_(torch.randn_like(t) * 0.05)
    params = convert_a3t({k: v.numpy() for k, v in model.state_dict().items()}, hp)
    ref = JA3T(V, hp).apply({"params": params}, *(jnp.asarray(data[k]) for k in NAMES),
                            infer=True)
    out = _run(model, data)
    np.testing.assert_allclose(out["mel_out_postnet"].numpy(), np.asarray(ref["mel_out_postnet"]),
                               **TOL)


def test_init_like_flax_draws_pos_biases_fan_avg_uniform():
    torch.manual_seed(0)
    att = init_like_flax(RelPositionMultiHeadAttention(256, 4))     # A3T's heads at hidden 256
    limit = (3.0 / ((4 + 64) / 2)) ** 0.5         # [4 heads, 64]: fan_avg 34
    for p in (att.pos_bias_u, att.pos_bias_v):
        m = float(p.detach().abs().max())
        assert 0.9 * limit < m <= limit
