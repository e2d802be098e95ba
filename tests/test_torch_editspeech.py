"""PyTorch port, EditSpeech (``models/editspeech.py``) and its LSTM decoder
(``modules/lstm.py``) against the JAX package's, on the same seeded
inputs with padded tokens and frames.

Weights come from flax's ``init`` with every bias perturbed and are carried
across by ``editspeech_params_from_jax`` (flax's per-gate LSTM kernels onto
``nn.LSTM``'s stacked ones). The LSTM decoder, the model's two directions
(the backward one scanned from each row's true end, and over the full axis
under ``ref_pad_compat``) and ``bidirectional_fusion`` agree within
atol = rtol = 1e-4; at padded lengths the backward decoder gives each
row's exact-fit result; a port ``state_dict`` goes through the JAX
package's ``convert_editspeech`` and gives the JAX model the port's
outputs; ``init_like_flax`` draws the LSTM's kernels as flax's cell does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.models.editspeech import EditSpeech as JEditSpeech
from speech_editing_tpu.models.editspeech import bidirectional_fusion as j_fusion
from speech_editing_tpu.modules.lstm import LSTMDecoder as JLSTMDecoder
from speech_editing_tpu.utils.convert_torch_ckpt import convert_editspeech, merge_params
from speech_editing_tpu_torch.models.editspeech import (EditSpeech, bidirectional_fusion,
                                                        fusion_index)
from speech_editing_tpu_torch.modules.lstm import LSTMDecoder
from speech_editing_tpu_torch.utils import convert_jax_params as cjp
from speech_editing_tpu_torch.utils.init import init_like_flax
from tests.helpers import TINY_HP, perturb_biases
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=1e-4, rtol=1e-4)
B, T, S, V = 3, 40, 9, 12
FRAMES, TOKENS = (40, 30, 21), (9, 6, 4)
NAMES = ("txt", "tm", "m2p", "spk", "mels", "f0", "uv")


def _np(tree):
    return jax.tree.map(np.array, tree)


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
    f0 = (rs.rand(B, T) * 2).astype(np.float32)
    uv = (rs.rand(B, T) > 0.7).astype(np.float32)
    return dict(txt=txt, tm=tm, m2p=m2p, spk=rs.randn(B, 256).astype(np.float32), mels=mels,
                f0=f0 * (m2p > 0), uv=uv * (m2p > 0), xs=rs.randn(B, T, 24).astype(np.float32))


def test_lstm_decoder_matches_jax(data):
    """flax's scanned OptimizedLSTMCell stack and head, and nn.LSTM with the
    gates stacked i, f, g, o."""
    jd = JLSTMDecoder(48, 80)
    xs = jnp.asarray(data["xs"])
    params = _np(perturb_biases(jd.init(jax.random.PRNGKey(0), xs)["params"]))
    ref = jd.apply({"params": params}, xs)
    dec = LSTMDecoder(24, 48, 80)
    sd = {}
    cjp._lstm(sd, "lstm", params["stack"])
    cjp._linear(sd, "linear", params["linear"])
    dec.load_state_dict(sd)
    with torch.no_grad():
        out = dec(torch.tensor(data["xs"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.fixture(scope="module")
def jax_editspeech(data):
    hp = dict(TINY_HP)
    model = JEditSpeech(V, hp)
    params = model.init({"params": jax.random.PRNGKey(0), "teacher": jax.random.PRNGKey(1)},
                        *(jnp.asarray(data[k]) for k in NAMES))["params"]
    return hp, _np(perturb_biases(params))


def _port(hp, sd):
    model = EditSpeech(V, hp)
    model.load_state_dict(sd)
    return model.eval()


def _run(model, data, rows=slice(None)):
    with torch.no_grad():
        return model(*(torch.tensor(data[k][rows]) for k in NAMES))


@pytest.mark.parametrize("ref_pad_compat", [False, True])
def test_editspeech_matches_jax(data, jax_editspeech, ref_pad_compat):
    hp, params = jax_editspeech
    hp = dict(hp, ref_pad_compat=ref_pad_compat)
    ref = JEditSpeech(V, hp).apply({"params": params}, *(jnp.asarray(data[k]) for k in NAMES),
                                   infer=True)
    out = _run(_port(hp, cjp.editspeech_params_from_jax(params, hp)), data)
    for k in ("forward_outputs", "backward_outputs"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL, err_msg=k)
    fused = bidirectional_fusion(out["forward_outputs"], out["backward_outputs"],
                                 torch.tensor(data["mels"]), torch.tensor(data["tm"]))
    ref_fused = j_fusion(ref["forward_outputs"], ref["backward_outputs"],
                         jnp.asarray(data["mels"]), jnp.asarray(data["tm"]))
    np.testing.assert_allclose(fused.numpy(), np.asarray(ref_fused), **TOL)


def test_backward_decoder_starts_at_each_rows_true_end(data, jax_editspeech):
    """At padded lengths each row's outputs equal its exact-fit outputs; the
    reference's full-axis flip (``ref_pad_compat``) does not."""
    hp, params = jax_editspeech
    sd = cjp.editspeech_params_from_jax(params, hp)
    for compat, same in ((False, True), (True, False)):
        model = _port(dict(hp, ref_pad_compat=compat), sd)
        padded = _run(model, data)["backward_outputs"]
        for b in (1, 2):
            n, s = FRAMES[b], TOKENS[b]
            row = {k: data[k][b:b + 1] for k in NAMES}
            row.update({k: row[k][:, :n] for k in ("tm", "m2p", "mels", "f0", "uv")},
                       txt=row["txt"][:, :s])
            exact = _run(model, row)["backward_outputs"][0]
            close = torch.allclose(padded[b, :n], exact, atol=1e-5, rtol=1e-5)
            assert close == same, (compat, b)


def test_fusion_splices_at_the_least_disagreement():
    fwd = torch.zeros(2, 8, 4)
    bwd = torch.ones(2, 8, 4)
    bwd[0, 5] = 0.0          # row 0 agrees best at frame 5; row 1 ties: the first masked frame
    tm = torch.zeros(2, 8, 1)
    tm[:, 2:7] = 1
    ref = torch.full((2, 8, 4), -3.0)
    assert fusion_index(fwd, bwd, tm).tolist() == [5, 2]
    out = bidirectional_fusion(fwd, bwd, ref, tm)
    assert torch.equal(out[0, 2:5], fwd[0, 2:5]) and torch.equal(out[0, 5:7], bwd[0, 5:7])
    assert torch.equal(out[1, 2:7], bwd[1, 2:7]) and torch.equal(out[:, 7:], ref[:, 7:])


def test_state_dict_round_trips_through_jax_convert_editspeech(data, jax_editspeech):
    hp, params = jax_editspeech
    torch.manual_seed(0)
    model = init_like_flax(EditSpeech(V, hp)).eval()
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim <= 1:
                p.add_(torch.randn_like(p) * 0.05)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    # the converter asks for the fft decoder, which skip_decoder never builds
    conv = merge_params(params, convert_editspeech(sd, dict(hp, decoder_type="fft")))
    ref = JEditSpeech(V, hp).apply({"params": conv}, *(jnp.asarray(data[k]) for k in NAMES),
                                   infer=True)
    out = _run(model, data)
    for k in ("forward_outputs", "backward_outputs"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL, err_msg=k)


def test_init_like_flax_draws_lstm_kernels_as_flax():
    torch.manual_seed(0)
    lstm = init_like_flax(LSTMDecoder(64, 128, 80)).lstm
    h = 128
    for n in range(2):
        w_ih, w_hh = getattr(lstm, f"weight_ih_l{n}"), getattr(lstm, f"weight_hh_l{n}")
        fan_in = w_ih.shape[1]
        for g in range(4):
            block = w_hh[g * h:(g + 1) * h].detach()
            torch.testing.assert_close(block @ block.T, torch.eye(h), atol=1e-5, rtol=0)
            assert abs(float(w_ih[g * h:(g + 1) * h].detach().std()) * fan_in ** 0.5 - 1) < 0.1
        assert not getattr(lstm, f"bias_ih_l{n}").any() and not getattr(lstm, f"bias_hh_l{n}").any()
