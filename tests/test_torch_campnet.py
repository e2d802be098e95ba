"""PyTorch port, CampNet (``models/campnet.py``) and the transformer pieces it
adds (``modules/transformer.py``: cross-attention with a weight readout,
the causal conv-FFN, ``DecSALayer``, ``TransformerDecoder``) against the
JAX package's, on the same seeded inputs with padded tokens and frames.

Weights come from flax's ``init`` with every bias perturbed (so padding is
not inert by accident) and are carried across by
``campnet_params_from_jax``. Modules and the model agree within
atol = rtol = 1e-4, with the reference's value-only masking
(``ref_pad_compat``) and without it; a port ``state_dict`` goes through
the JAX package's ``convert_campnet`` and gives the JAX model the port's
outputs; ``init_like_flax`` draws the new parameter kinds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.models.campnet import CampNet as JCampNet
from speech_editing_tpu.modules.transformer import DecSALayer as JDecSALayer
from speech_editing_tpu.modules.transformer import MultiheadAttention as JMHA
from speech_editing_tpu.modules.transformer import TransformerDecoder as JDecoder
from speech_editing_tpu.utils.convert_torch_ckpt import convert_campnet
from speech_editing_tpu_torch.models.campnet import CampNet
from speech_editing_tpu_torch.modules.transformer import (DecSALayer, MultiheadAttention,
                                                          TransformerDecoder)
from speech_editing_tpu_torch.utils import convert_jax_params as cjp
from speech_editing_tpu_torch.utils.init import init_like_flax
from tests.helpers import TINY_HP, perturb_biases
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=1e-4, rtol=1e-4)
B, T, S, V, H = 3, 40, 9, 12, 32
FRAMES, TOKENS = (40, 30, 21), (9, 6, 4)


def _np(tree):
    return jax.tree.map(np.array, tree)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(0)
    txt = rs.randint(3, V, (B, S))
    mels = rs.randn(B, T, 80).astype(np.float32)
    for b in range(B):
        txt[b, TOKENS[b]:] = 0
        mels[b, FRAMES[b]:] = 0
    tm = np.zeros((B, T, 1), np.float32)
    tm[:, 8:17] = 1
    x = rs.randn(B, T, H).astype(np.float32)
    enc = rs.randn(B, S, H).astype(np.float32)
    return dict(txt=txt, mels=mels, tm=tm, x=x, enc=enc, frame_pad=mels[..., 0] == 0,
                tok_pad=txt == 0)


def _mha_sd(p):
    sd = {}
    cjp._mha(sd, "m", p)
    return {k.split(".", 1)[1]: v for k, v in sd.items()}


def test_cross_attention_with_weights_matches_jax(data):
    """Queries over frames, keys and values over tokens, pad tokens masked,
    probabilities returned (the einsum branch in both packages)."""
    jm = JMHA(H, 2)
    args = (jnp.asarray(data["x"]), jnp.asarray(data["enc"]), jnp.asarray(data["enc"]))
    params = _np(jm.init(jax.random.PRNGKey(0), *args)["params"])
    ref, ref_w = jm.apply({"params": params}, *args,
                          key_padding_mask=jnp.asarray(data["tok_pad"]), return_weights=True)
    tm = MultiheadAttention(H, 2)
    tm.load_state_dict(_mha_sd(params))
    with torch.no_grad():
        out, w = tm(torch.tensor(data["x"]), torch.tensor(data["tok_pad"]),
                    key=torch.tensor(data["enc"]), return_weights=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), **TOL)
    assert (w.numpy() * data["tok_pad"][:, None, None, :]).max() == 0     # pad tokens


def _dec_layer_sd(p):
    sd = {}
    for n in ("layer_norm1", "layer_norm2", "layer_norm3"):
        cjp._layer_norm(sd, n, p[n])
    cjp._mha(sd, "self_attn", p["self_attn"])
    cjp._mha(sd, "encoder_attn", p["encoder_attn"])
    cjp._conv(sd, "ffn.ffn_1.1", p["ffn"]["ffn_1"])
    cjp._linear(sd, "ffn.ffn_2", p["ffn"]["ffn_2"])
    return sd


def test_dec_sa_layer_matches_jax(data):
    """Self-attention (K3's plain version) with frame key padding, the
    cross-attention and the causal (LEFT-padded) conv-FFN."""
    jl = JDecSALayer(H, 2, kernel_size=9)
    args = (jnp.asarray(data["x"]), jnp.asarray(data["enc"]), jnp.asarray(data["tok_pad"]),
            jnp.asarray(data["frame_pad"]))
    params = _np(perturb_biases(jl.init(jax.random.PRNGKey(1), *args)["params"]))
    ref, ref_w = jl.apply({"params": params}, *args)
    layer = DecSALayer(H, 2, 9)
    layer.load_state_dict(_dec_layer_sd(params))
    with torch.no_grad():
        out, w = layer(*(torch.tensor(data[k]) for k in ("x", "enc", "tok_pad", "frame_pad")))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), **TOL)


def test_causal_ffn_reads_no_later_frame(data):
    layer = init_like_flax(DecSALayer(H, 2, 9)).ffn
    x = torch.tensor(data["x"])
    y = x.clone()
    y[:, 20:] = 7.0
    with torch.no_grad():
        torch.testing.assert_close(layer(y)[:, :20], layer(x)[:, :20])
        assert not torch.allclose(layer(y)[:, 20:], layer(x)[:, 20:])


@pytest.mark.parametrize("self_attn_pad", [True, False])
def test_transformer_decoder_matches_jax(data, self_attn_pad):
    """Learned-alpha positions over the frames that are not padding,
    re-masking after each layer, and the first layer's head-mean
    cross-attention as ``attn``; frame keys masked or not."""
    jd = JDecoder(H, num_layers=2, ffn_kernel_size=9, num_heads=2)
    sa_pad = jnp.asarray(data["frame_pad"]) if self_attn_pad else None
    args = (jnp.asarray(data["x"]), jnp.asarray(data["enc"]))
    kw = dict(encoder_padding_mask=jnp.asarray(data["tok_pad"]), self_attn_padding_mask=sa_pad,
              padding_mask=jnp.asarray(data["frame_pad"]))
    params = _np(perturb_biases(jd.init(jax.random.PRNGKey(2), *args, **kw)["params"]))
    ref, ref_attn = jd.apply({"params": params}, *args, **kw)
    dec = TransformerDecoder(H, 2, 9, 2)
    sd = {"pos_embed_alpha": torch.tensor(params["pos_embed_alpha"])}
    for i in range(2):
        sd.update({f"layers.{i}.op.{k}": v for k, v in _dec_layer_sd(params[f"layers_{i}"]).items()})
    cjp._layer_norm(sd, "layer_norm", params["layer_norm"])
    dec.load_state_dict(sd)
    with torch.no_grad():
        out, attn = dec(torch.tensor(data["x"]), torch.tensor(data["enc"]),
                        torch.tensor(data["tok_pad"]),
                        torch.tensor(data["frame_pad"]) if self_attn_pad else None,
                        torch.tensor(data["frame_pad"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(ref_attn), **TOL)


@pytest.fixture(scope="module")
def jax_campnet(data):
    hp = dict(TINY_HP)
    model = JCampNet(V, hp)
    args = [jnp.asarray(data[k]) for k in ("txt", "mels", "tm")]
    params = _np(perturb_biases(model.init(jax.random.PRNGKey(0), *args)["params"]))
    # flax draws mask_emb as zeros; a trained one is not
    params["mask_emb"] = np.random.RandomState(5).randn(1, 1, 80).astype(np.float32)
    return hp, params


def _port_campnet(hp, sd):
    model = CampNet(V, hp)
    model.load_state_dict(sd)
    return model.eval()


@pytest.mark.parametrize("ref_pad_compat", [False, True])
def test_campnet_matches_jax(data, jax_campnet, ref_pad_compat):
    hp, params = jax_campnet
    hp = dict(hp, ref_pad_compat=ref_pad_compat)
    args = [data[k] for k in ("txt", "mels", "tm")]
    ref = JCampNet(V, hp).apply({"params": params}, *map(jnp.asarray, args), infer=True)
    model = _port_campnet(hp, cjp.campnet_params_from_jax(params, hp))
    with torch.no_grad():
        out = model(*map(torch.tensor, args))
    for k in ("mel_out_coarse", "mel_out_fine", "attn"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL, err_msg=k)
    # outside the mask the fine output is the source mel
    keep = data["tm"][..., 0] == 0
    np.testing.assert_array_equal(out["mel_out_fine"].numpy()[keep], data["mels"][keep])


def test_campnet_padding_is_inert_with_key_masking(data, jax_campnet):
    """Without ``ref_pad_compat`` a row's frames do not depend on the frames
    padded after it."""
    hp, params = jax_campnet
    model = _port_campnet(hp, cjp.campnet_params_from_jax(params, hp))
    b, n, s = 1, FRAMES[1], TOKENS[1]
    args = [torch.tensor(data[k][b:b + 1]) for k in ("txt", "mels", "tm")]
    with torch.no_grad():
        padded = model(*args)["mel_out_fine"][0, :n]
        exact = model(args[0][:, :s], args[1][:, :n], args[2][:, :n])["mel_out_fine"][0]
    torch.testing.assert_close(padded, exact, atol=1e-5, rtol=1e-5)


def test_state_dict_round_trips_through_jax_convert_campnet(data, jax_campnet):
    """A port state_dict, read by the JAX package's converter of reference
    checkpoints, gives the JAX model the port's outputs."""
    hp, _ = jax_campnet
    torch.manual_seed(0)
    model = init_like_flax(CampNet(V, hp)).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim <= 1 or name == "mask_emb":
                p.add_(torch.randn_like(p) * 0.05)
    params = convert_campnet({k: v.numpy() for k, v in model.state_dict().items()}, hp)
    args = [data[k] for k in ("txt", "mels", "tm")]
    ref = JCampNet(V, hp).apply({"params": params}, *map(jnp.asarray, args), infer=True)
    with torch.no_grad():
        out = model(*map(torch.tensor, args))
    np.testing.assert_allclose(out["mel_out_fine"].numpy(), np.asarray(ref["mel_out_fine"]),
                               **TOL)


def test_init_like_flax_draws_the_new_parameters():
    torch.manual_seed(0)
    model = init_like_flax(CampNet(V, dict(TINY_HP)))
    assert torch.equal(model.mask_emb, torch.zeros(1, 1, 80))
    assert torch.equal(model.decoder_coarse.pos_embed_alpha, torch.ones(1))
    w = model.decoder_coarse.layers[0].op.ffn.ffn_1[1].weight    # [4H, H, 9]: lecun, fan_in 9H
    assert abs(float(w.detach().std()) * (9 * H) ** 0.5 - 1.0) < 0.1
