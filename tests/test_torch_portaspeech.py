"""PyTorch port, the PortaSpeech family's modules against the JAX package
on CPU: the word-level sequence ops; flax's conv geometry that the port
rebuilds (the FVAE's strided convs with their explicit asymmetric padding,
its ``ConvTranspose``, the discriminator's stride-2 ``SAME`` 2-D conv);
``ResFlow`` and ``Glow`` forward (with Glow's log-determinant) and reverse,
each reverse inverting its forward; the FVAE in training (KL) and at
inference; ``PortaSpeech`` and ``PortaSpeechFlow`` in training and at
inference, free-running and with the dataset's ``mel2word``; the
multi-window discriminator with given window starts, its hiddens
included. JAX's own random draws are injected (regenerated from the same
key splits). Weights are random draws in the shapes of the JAX modules'
``init`` (traced, not compiled) and cross by the new converters, which are
checked to read every flax leaf and fill every ``state_dict`` key.
Tolerance atol = rtol = 1e-4.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.models import portaspeech as jps
from speech_editing_tpu.modules import flows as jflows
from speech_editing_tpu.modules.multi_window_disc import MultiWindowDiscriminator as JDisc
from speech_editing_tpu.ops import seq_ops as jseq
from speech_editing_tpu_torch.models import portaspeech as tps
from speech_editing_tpu_torch.modules import flows as tflows
from speech_editing_tpu_torch.modules.multi_window_disc import MultiWindowDiscriminator
from speech_editing_tpu_torch.modules.multi_window_disc import _pad_same
from speech_editing_tpu_torch.ops import seq_ops as tseq
from speech_editing_tpu_torch.utils import convert_jax_params as cjp
from tests.helpers import TINY_HP
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=1e-4, rtol=1e-4)
VOCAB, WORDS = 12, 30
# tests/test_portaspeech.py's tiny PortaSpeech widths
PS_HP = dict(TINY_HP, vocab_size=VOCAB, binary_data_dir="", use_spk_embed=True,
             use_pitch_embed=True, encoder_type="fft", use_word_encoder=True,
             word_enc_layers=1, dur_level="word", text_encoder_postnet=True, add_word_pos=True,
             use_fvae=True, fvae_enc_dec_hidden=32, latent_size=8, fvae_kernel_size=5,
             fvae_enc_n_layers=2, fvae_dec_n_layers=2, fvae_strides=4, use_prior_flow=True,
             prior_flow_hidden=16, prior_flow_kernel_size=3, prior_flow_n_blocks=2,
             lambda_kl=1.0, kl_min=0.0, kl_start_steps=100, noise_scale=0.8,
             post_glow_hidden=16, post_glow_n_blocks=2, sigmoid_scale=False,
             word_dict_size=WORDS, frames_multiple=4, max_frames=64, posterior_start_steps=0)


class Tracked(dict):
    """A parameter tree that records the paths of the leaves read from it."""

    def __init__(self, tree, read, path=()):
        super().__init__({k: Tracked(v, read, path + (k,)) if isinstance(v, dict) else v
                          for k, v in tree.items()})
        self.read, self.path = read, path

    def __getitem__(self, key):
        value = super().__getitem__(key)
        if not isinstance(value, dict):
            self.read.add(self.path + (key,))
        return value


def convert_all(convert, params, hp, model: torch.nn.Module) -> dict:
    """``convert(params, hp)``, asserting that it reads every leaf of
    ``params`` and fills every key of ``model``'s ``state_dict`` in its
    shape."""
    read: set = set()
    sd = convert(Tracked(jax.tree.map(np.asarray, params), read), hp)
    leaves = {tuple(getattr(k, "key", k) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert read == leaves, sorted(leaves - read)
    want = model.state_dict()
    assert sorted(sd) == sorted(want), sorted(set(want) ^ set(sd))
    for k, v in want.items():
        assert sd[k].shape == v.shape, k
    return sd


def random_tree(shapes, seed):
    """Kernels normal with variance 1 / fan_in, vectors 0.1 of noise about
    0 (1 for a norm's scale); 2-D square leaves (the flows' 1x1 products)
    orthogonal plus noise, so their inverses are well conditioned."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(path[-1])
        if len(s.shape) <= 1:
            return ((1.0 if "scale" in name else 0.0) + 0.1 * rs.randn(*s.shape)
                    ).astype(np.float32)
        if "weight" in name:
            q = np.linalg.qr(rs.randn(*s.shape))[0]
            return (q + 0.1 * rs.randn(*s.shape)).astype(np.float32)
        return (rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def init_shapes(module, *args, **kwargs):
    return jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "fvae": jax.random.PRNGKey(1)}, *args, **kwargs))[
        "params"]


def np_(x):
    return np.asarray(x)


def fast_jit(fn, *args):
    """``fn`` (or a jitted function) compiled for ``args`` at XLA's backend
    optimisation level 0, which halves the compile of these graphs on this
    CPU and gives the same numbers here; returns its output."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    return jitted.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


# -- the sequence ops ------------------------------------------------------------------

def test_word_seq_ops_match_jax():
    rs = np.random.RandomState(0)
    h = rs.randn(2, 9, 5).astype(np.float32)
    ph2word = np.array([[1, 1, 2, 3, 3, 3, 4, 0, 0], [1, 2, 2, 3, 0, 0, 0, 0, 0]])
    mel2ph = np.array([[1, 1, 2, 3, 4, 5, 6, 7, 7, 0], [1, 2, 2, 3, 4, 0, 0, 0, 0, 0]])
    for got, ref in zip(tseq.group_hidden_by_segs(torch.tensor(h), torch.tensor(ph2word), 5),
                        jseq.group_hidden_by_segs(jnp.asarray(h), jnp.asarray(ph2word), 5)):
        np.testing.assert_allclose(got.numpy(), np_(ref), **TOL)
    mel2word = np_(jseq.mel2ph_to_mel2word(jnp.asarray(mel2ph), jnp.asarray(ph2word)))
    np.testing.assert_array_equal(
        tseq.build_word_mask(torch.tensor(mel2word), torch.tensor(ph2word)).numpy(),
        np_(jseq.build_word_mask(jnp.asarray(mel2word), jnp.asarray(ph2word))))
    dur = rs.rand(2, 9).astype(np.float32)
    ref = jax.vmap(lambda w, v: jax.ops.segment_sum(v, w, num_segments=6))(
        jnp.asarray(ph2word), jnp.asarray(dur))
    np.testing.assert_allclose(tseq.segment_sum(torch.tensor(dur), torch.tensor(ph2word),
                                                6).numpy(), np_(ref), **TOL)
    pos = rs.rand(2, 7).astype(np.float32) * 3
    np.testing.assert_allclose(tps.sinusoidal_pos_emb(torch.tensor(pos), 32).numpy(),
                               np_(jps.sinusoidal_pos_emb(jnp.asarray(pos), 32)), **TOL)


# -- flax's conv geometry, each alone --------------------------------------------------

@pytest.mark.parametrize("t", [64, 61])
def test_strided_conv_and_conv_transpose_match_flax(t):
    s, rs = 4, np.random.RandomState(t)
    x = rs.randn(2, t, 6).astype(np.float32)
    conv = fnn.Conv(5, (2 * s,), strides=(s,), padding=((s // 2, 2 * s - s // 2 - 1),))
    p = random_tree(init_shapes(conv, x), 1)
    ref = conv.apply({"params": p}, x)
    tconv = torch.nn.Conv1d(6, 5, 2 * s, stride=s)
    sd: dict = {}
    cjp._conv(sd, "c", p)
    tconv.load_state_dict({k[2:]: v for k, v in sd.items()})
    np.testing.assert_allclose(tps._strided_conv(tconv, torch.tensor(x)).detach().numpy(),
                               np_(ref), **TOL)
    z = rs.randn(2, t // s, 6).astype(np.float32)
    up = fnn.ConvTranspose(5, (s,), strides=(s,))
    p = random_tree(init_shapes(up, z), 2)
    ref = up.apply({"params": p}, z)
    tup = torch.nn.ConvTranspose1d(6, 5, s, stride=s)
    sd = {}
    cjp._conv_transpose(sd, "c", p)
    tup.load_state_dict({k[2:]: v for k, v in sd.items()})
    got = tup(torch.tensor(z).transpose(1, 2)).transpose(1, 2).detach().numpy()
    assert got.shape == ref.shape == (2, t // s * s, 5)
    np.testing.assert_allclose(got, np_(ref), **TOL)


@pytest.mark.parametrize("shape", [(32, 80), (17, 9)])
def test_stride2_same_conv2d_matches_flax(shape):
    rs = np.random.RandomState(shape[0])
    x = rs.randn(2, *shape, 3).astype(np.float32)
    conv = fnn.Conv(4, (3, 3), strides=(2, 2), padding="SAME")
    p = random_tree(init_shapes(conv, x), 3)
    ref = conv.apply({"params": p}, x)
    tconv = torch.nn.Conv2d(3, 4, (3, 3), stride=2)
    sd: dict = {}
    cjp._conv2d(sd, "c", p)
    tconv.load_state_dict({k[2:]: v for k, v in sd.items()})
    got = tconv(_pad_same(torch.tensor(x).permute(0, 3, 1, 2), (3, 3), 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np_(ref), **TOL)


# -- the flows -------------------------------------------------------------------------

def _flow_inputs(seed, c=8, t=16, c_cond=12):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, t, c).astype(np.float32)
    nonpad = np.ones((2, t, 1), np.float32)
    nonpad[1, t - 5:] = 0
    cond = rs.randn(2, t, c_cond).astype(np.float32)
    return x * nonpad, nonpad, cond


def _load(module, convert, jparams):
    """``module`` with ``convert(sd, "m", jparams)``'s parameters."""
    sd: dict = {}
    convert(sd, "m", jax.tree.map(np_, jparams))
    module.load_state_dict({k[2:]: v for k, v in sd.items()})
    return module


def test_resflow_forward_and_reverse_match_jax():
    x, nonpad, cond = _flow_inputs(0)
    jflow = jflows.ResFlow(8, 16, 3, n_flow_steps=2, n_flow_layers=2, c_cond=12)
    p = random_tree(init_shapes(jflow, x, nonpad, cond), 4)
    flow = _load(tflows.ResFlow(8, 16, 3, 2, 2, 12), cjp._couplings, p)
    tx, tn, tc = map(torch.tensor, (x, nonpad, cond))
    ref = jflow.apply({"params": p}, x, nonpad, cond)
    with torch.no_grad():
        z = flow(tx, tn, tc)
        np.testing.assert_allclose(z.numpy(), np_(ref), **TOL)
        back = flow(z, tn, tc, reverse=True)
    np.testing.assert_allclose(back.numpy(), np_(jflow.apply({"params": p}, ref, nonpad, cond,
                                                             reverse=True)), **TOL)
    np.testing.assert_allclose(back.numpy(), x, **TOL)


def test_glow_forward_logdet_and_reverse_match_jax():
    x, nonpad, cond = _flow_inputs(1)
    jglow = jflows.Glow(8, 16, 3, n_blocks=2, n_layers=2, c_cond=12)
    p = random_tree(init_shapes(jglow, x, nonpad, cond), 5)
    glow = _load(tflows.Glow(8, 16, 3, 2, 2, 12), cjp._glow, p)
    tx, tn, tc = map(torch.tensor, (x, nonpad, cond))
    z_ref, logdet_ref = jglow.apply({"params": p}, x, nonpad, cond)
    with torch.no_grad():
        z, logdet = glow(tx, tn, tc)
        back, none = glow(z, tn, tc, reverse=True)
    np.testing.assert_allclose(z.numpy(), np_(z_ref), **TOL)
    np.testing.assert_allclose(logdet.numpy(), np_(logdet_ref), **TOL)
    x_ref, _ = jglow.apply({"params": p}, z_ref, nonpad, cond, reverse=True)
    assert none is None
    np.testing.assert_allclose(back.numpy(), np_(x_ref), **TOL)
    np.testing.assert_allclose(back.numpy(), x, **TOL)


def test_affine_coupling_starts_as_the_identity():
    glow = tflows.Glow(8, 16, 3, 2, 2, 12)
    x, nonpad, cond = map(torch.tensor, _flow_inputs(2))
    with torch.no_grad():
        for cp in glow.couplings:
            out, logdet = cp(x, nonpad, cond)
            np.testing.assert_array_equal(out.numpy(), x.numpy())
            assert not logdet.any()


# -- the FVAE --------------------------------------------------------------------------

def _fvae_inputs(seed, t=64):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, t, 80).astype(np.float32)
    nonpad = np.ones((2, t, 1), np.float32)
    nonpad[1, t - 12:] = 0
    return x * nonpad, nonpad, (rs.randn(2, t, 32) * nonpad).astype(np.float32)


@pytest.mark.parametrize("prior_flow", [True, False])
def test_fvae_train_and_infer_match_jax(prior_flow):
    x, nonpad, cond = _fvae_inputs(3)
    args = (80, 32, 8, 5, 2, 2, 32, 4, prior_flow, 16, 3, 2)
    jf = jps.FVAE(*args)
    rng = jax.random.PRNGKey(7)
    both = lambda m, x, n, c, r: (m(x, n, c, r), m.decoder(jnp.zeros((2, 16, 8)), n, c))
    p = random_tree(init_shapes(jf, x, nonpad, cond, rng, method=both), 6)
    vae = _load(tps.FVAE(*args), cjp._fvae, p)
    ref = jf.apply({"params": p}, x, nonpad, cond, rng)
    eps = torch.tensor(np_(jax.random.normal(rng, ref["m_q"].shape)))
    tx, tn, tc = map(torch.tensor, (x, nonpad, cond))
    with torch.no_grad():
        out = vae(tx, tn, tc, eps=eps)
    for k in ("z_q", "kl", "m_q", "logs_q", "g") + (("z_p",) if prior_flow else ()):
        np.testing.assert_allclose(out[k].numpy(), np_(ref[k]), **TOL, err_msg=k)
    ref = jf.apply({"params": p}, None, nonpad, cond, rng, infer=True, noise_scale=0.8)
    z_prior = torch.tensor(np_(jax.random.normal(rng, (2, 16, 8))))
    with torch.no_grad():
        out = vae(None, tn, tc, infer=True, noise_scale=0.8, z_prior=z_prior)
        mel = vae.decoder(out["z_q"], tn, tc)
    np.testing.assert_allclose(out["z_q"].numpy(), np_(ref["z_q"]), **TOL)
    ref_mel = jf.apply({"params": p}, ref["z_q"], nonpad, cond,
                       method=lambda m, *a: m.decoder(*a))
    np.testing.assert_allclose(mel.numpy(), np_(ref_mel), **TOL)


# -- PortaSpeech and PortaSpeechFlow ---------------------------------------------------

def word_batch(seed, b=2, s=8, t=64) -> dict:
    """Two rows of s and s - 1 phones, two phones a word, t and t - 8
    frames; speaker embeddings and coarse pitch (numpy)."""
    rs = np.random.RandomState(seed)
    tokens, ph2word = np.zeros((b, s), np.int64), np.zeros((b, s), np.int64)
    words = np.zeros((b, s // 2), np.int64)
    mel2ph, mel2word = np.zeros((b, t), np.int64), np.zeros((b, t), np.int64)
    mels, pitch = np.zeros((b, t, 80), np.float32), np.zeros((b, t), np.int64)
    for i in range(b):
        n, frames = s - i, t - 8 * i
        tokens[i, :n] = rs.randint(3, VOCAB, n)
        ph2word[i, :n] = np.arange(n) // 2 + 1
        words[i, :ph2word[i].max()] = rs.randint(3, WORDS, ph2word[i].max())
        bounds = np.sort(rs.choice(np.arange(1, frames), n - 1, replace=False))
        mel2ph[i, :frames] = np.searchsorted(bounds, np.arange(frames), side="right") + 1
        mel2word[i] = np.where(mel2ph[i] > 0, ph2word[i][mel2ph[i] - 1], 0)
        mels[i, :frames] = rs.randn(frames, 80) * 0.5 - 2
        pitch[i, :frames] = rs.randint(1, 256, frames)
    return {"txt_tokens": tokens, "word_tokens": words, "ph2word": ph2word,
            "mel2word": mel2word, "mel2ph": mel2ph, "mels": mels, "pitch": pitch,
            "spk_embed": rs.randn(b, 256).astype(np.float32)}


def jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in batch.items()}


def torch_batch(batch: dict) -> dict:
    return {k: torch.tensor(v) for k, v in batch.items()}


def jax_model(flow: bool, warm: bool = False, widths: dict | None = None, seed: int = 8):
    """(the JAX model, parameters drawn in its init's shapes, the port's
    model with them loaded); ``warm``: ``posterior_start_steps`` 50;
    ``widths``: hp that override ``PS_HP``'s."""
    return _jax_model(flow, warm, tuple(sorted((widths or {}).items())), seed)


@functools.lru_cache(maxsize=4)
def _jax_model(flow, warm, widths, seed):
    hp = dict(PS_HP, **dict(widths), posterior_start_steps=50 if warm else 0)
    cls = jps.PortaSpeechFlow if flow else jps.PortaSpeech
    model = cls(VOCAB, WORDS, hp, 80)
    b = jax_batch(word_batch(0))
    shapes = init_shapes(model, b["txt_tokens"], b["word_tokens"], b["ph2word"],
                         mel2word=b["mel2word"], spk_embed=b["spk_embed"], pitch=b["pitch"],
                         tgt_mels=b["mels"])
    params = random_tree(shapes, seed)
    params["dur_predictor"]["linear"]["bias"] += 2.5     # words last a few frames
    for name, coupling in params.get("post_flow", {}).items():
        if name.startswith("coupling_"):
            # flax starts these at zero; at full scale the reverse's exp(-logs)
            # turns the noise into a mel of +-10, past float32's 1e-4 there
            coupling["post"]["kernel"] *= 0.1
    port = (tps.PortaSpeechFlow if flow else tps.PortaSpeech)(VOCAB, WORDS, hp)
    port.load_state_dict(convert_all(cjp.portaspeech_params_from_jax, params, hp, port))
    return model, params, port.eval()


def jax_draws(flow: bool, rng, b: int, t: int, infer: bool) -> dict:
    """The draws JAX's model takes from ``rng``, for the port's forward."""
    if flow:
        rng, k_flow = jax.random.split(rng)
    out = {}
    if infer:
        out["z_prior"] = jax.random.normal(rng, (b, t // 4, 8))
        if flow:
            out["z_flow"] = jax.random.normal(k_flow, (b, t, 80))
    else:
        k_vae, k_warm = jax.random.split(rng)
        out["eps"] = jax.random.normal(k_vae, (b, t // 4, 8))
        out["warm_noise"] = jax.random.normal(k_warm, (b, t // 4, 8))
    return {k: torch.tensor(np_(v)) for k, v in out.items()}


@pytest.mark.parametrize("flow", [False, True], ids=["ps", "ps_flow"])
def test_portaspeech_train_and_infer_match_jax(flow):
    jm, params, model = jax_model(flow)
    batch = word_batch(1)
    jb, tb = jax_batch(batch), torch_batch(batch)
    rng = jax.random.PRNGKey(3)
    common = dict(spk_embed=jb["spk_embed"], pitch=jb["pitch"])
    ref = fast_jit(lambda p, b, r: jm.apply({"params": p}, b["txt_tokens"], b["word_tokens"],
                                            b["ph2word"], mel2word=b["mel2word"],
                                            spk_embed=b["spk_embed"], pitch=b["pitch"],
                                            tgt_mels=b["mels"], rng=r), params, jb, rng)
    with torch.no_grad():
        out = model(tb["txt_tokens"], tb["word_tokens"], tb["ph2word"], mel2word=tb["mel2word"],
                    spk_embed=tb["spk_embed"], pitch=tb["pitch"], tgt_mels=tb["mels"],
                    eps=jax_draws(flow, rng, 2, 64, infer=False)["eps"])
    keys = ["mel_out", "dur", "decoder_inp", "attn", "kl"] + (["postflow_nll"] if flow else [])
    for k in keys:
        np.testing.assert_allclose(out[k].numpy(), np_(ref[k]), **TOL, err_msg=k)
    assert not out["mel_out"][1, 56:].any()
    # inference: the dataset's mel2word, then (PortaSpeech) free-running to max_frames
    for given in (True, False) if not flow else (True,):
        m2w = jb["mel2word"] if given else None
        ref = fast_jit(lambda p, r, m: jm.apply({"params": p}, jb["txt_tokens"],
                                                jb["word_tokens"], jb["ph2word"], mel2word=m,
                                                infer=True, rng=r, **common), params, rng, m2w)
        t = ref["mel_out"].shape[1]
        with torch.no_grad():
            out = model(tb["txt_tokens"], tb["word_tokens"], tb["ph2word"],
                        mel2word=tb["mel2word"] if given else None, spk_embed=tb["spk_embed"],
                        pitch=tb["pitch"], infer=True, **jax_draws(flow, rng, 2, t, infer=True))
        np.testing.assert_array_equal(out["mel2word"].numpy(), np_(ref["mel2word"]))
        assert (out["mel2word"] > 0).sum() > 20
        for k in ("mel_out", "mel_out_fvae", "dur"):
            np.testing.assert_allclose(out[k].numpy(), np_(ref[k]), **TOL, err_msg=k)


# -- the discriminator -----------------------------------------------------------------

def test_multi_window_disc_with_given_starts_matches_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(3, 80, 80).astype(np.float32)
    x_len = np.array([80, 64, 40])
    jd = JDisc(time_lengths=(16, 32, 64), hidden_size=16)
    p = random_tree(init_shapes(jd, x, x_len, rng=jax.random.PRNGKey(0)), 9)
    disc = MultiWindowDiscriminator((16, 32, 64), hidden_size=16)
    disc.load_state_dict(convert_all(lambda t, _: cjp.multi_window_disc_params_from_jax(t), p,
                                     None, disc))
    ref = fast_jit(lambda p, x, n, r: jd.apply({"params": p}, x, n, rng=r),
                   p, x, x_len, jax.random.PRNGKey(5))
    starts = [torch.tensor(np_(s)).long() for s in ref["start_frames"]]
    with torch.no_grad():
        out = disc(torch.tensor(x), torch.tensor(x_len), start_frames=starts)
    np.testing.assert_allclose(out["y"].numpy(), np_(ref["y"]), **TOL)
    assert len(out["h"]) == len(ref["h"]) == 9
    for got, want in zip(out["h"], ref["h"]):
        np.testing.assert_allclose(got.numpy(), np_(want), **TOL)
    assert not out["h"][-1][2].any()         # row 2 (40 frames) has no 64-frame window
    # drawn starts lie in [0, max(x_len - win, 1))
    drawn = disc(torch.tensor(x), torch.tensor(x_len), torch.Generator().manual_seed(0))
    for win, s in zip((16, 32, 64), drawn["start_frames"]):
        assert ((s >= 0) & (s < torch.tensor(x_len - win).clamp(min=1))).all()
