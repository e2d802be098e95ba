"""PyTorch port, the TTS baselines' small pieces against the JAX package on
CPU: the bidirectional GRU (flax's scanned ``GRUCell`` against
``nn.GRU`` through the converter's bias mapping), ``cwt2f0`` and
``norm_f0``; and the weight round trip of a port FastSpeech state_dict (fft
and conv encoders, fft decoder) through the unchanged
``convert_fastspeech(..., include_decoder=True)``. Within atol = rtol =
1e-4 (``cwt2f0`` and ``norm_f0`` 1e-5 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.modules.rnn import BiGRU as JBiGRU
from speech_editing_tpu.training.tasks.tts import FastSpeechTask as JFastSpeechTask
from speech_editing_tpu.utils.audio.cwt import cwt2f0 as j_cwt2f0
from speech_editing_tpu.utils.audio.pitch import norm_f0 as j_norm_f0
from speech_editing_tpu.utils.convert_torch_ckpt import convert_fastspeech
from speech_editing_tpu_torch.models.fs import FastSpeech
from speech_editing_tpu_torch.modules.rnn import BiGRU
from speech_editing_tpu_torch.utils import convert_jax_params as cjp
from speech_editing_tpu_torch.utils.audio.cwt import cwt2f0
from speech_editing_tpu_torch.utils.audio.pitch import norm_f0
from speech_editing_tpu_torch.utils.init import init_like_flax
from tests.test_torch_tts_fs import HP, VOCAB, jax_task, np_tree, one_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


def test_bigru_matches_flax_scanned_gru_cells():
    """Both directions over the whole padded length, every bias non-zero
    (flax's ``hn`` bias sits inside the reset gate's product, as
    ``nn.GRU``'s ``bias_hh_n`` does)."""
    x = np.random.RandomState(0).randn(3, 17, 12).astype(np.float32)
    jm = JBiGRU(8)
    params = np_tree(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    rs = np.random.RandomState(1)
    params = jax.tree.map(lambda a: a + 0.3 * rs.randn(*a.shape).astype(np.float32), params)
    assert "bias" in params["fwd"]["cell"]["hn"] and "bias" not in params["fwd"]["cell"]["hr"]
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    m = BiGRU(12, 8)
    sd: dict = {}
    cjp._bigru(sd, "rnn", params)
    m.load_state_dict({k[len("rnn."):]: v for k, v in sd.items()})
    with torch.no_grad():
        out = m(torch.tensor(x)).numpy()
    assert out.shape == ref.shape == (3, 17, 16)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("b,t", [(1, 40), (3, 129)])
def test_cwt2f0_and_norm_f0_match_jax(b, t):
    rs = np.random.RandomState(t)
    spec = rs.randn(b, t, 10).astype(np.float32)
    mean = (5.0 + rs.rand(b)).astype(np.float32)
    std = (0.1 + 0.3 * rs.rand(b)).astype(np.float32)
    ref = np.asarray(j_cwt2f0(jnp.asarray(spec), jnp.asarray(mean), jnp.asarray(std)))
    got = cwt2f0(torch.tensor(spec), torch.tensor(mean), torch.tensor(std)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    uv = (rs.rand(b, t) < 0.3).astype(np.float32)
    for u in (None, uv):
        want = np.asarray(j_norm_f0(jnp.asarray(ref), None if u is None else jnp.asarray(u)))
        have = norm_f0(torch.tensor(got), None if u is None else torch.tensor(u)).numpy()
        np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("encoder", ["fft", "conv"])
def test_fastspeech_state_dict_round_trips_through_convert_fastspeech(encoder):
    """A port state_dict (flax's initial distributions, from torch's
    generator) through the JAX package's ``convert_fastspeech(...,
    include_decoder=True)`` gives a flax tree of the JAX model's structure,
    which ``fastspeech_params_from_jax`` maps back bit for bit."""
    hp = dict(HP, encoder_type=encoder, decoder_type="fft")
    torch.manual_seed(3)
    sd = init_like_flax(FastSpeech(VOCAB, hp, decoder=True, masked=False)).state_dict()
    tree = convert_fastspeech({k: v.numpy() for k, v in sd.items()}, hp,
                              include_decoder=True)
    _, _, ref = jax_task(JFastSpeechTask, hp, seed=0)
    flat = lambda t: {jax.tree_util.keystr(p): np.shape(v)
                      for p, v in jax.tree_util.tree_leaves_with_path(t)}
    assert flat(tree) == flat(ref)
    back = cjp.fastspeech_params_from_jax(tree, hp)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
