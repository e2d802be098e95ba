"""PyTorch port, kernels K1-K3: their plain versions (what each wrapper runs
on a CPU tensor) against the JAX package's kernels and reference paths.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each of them against these plain versions there. Pallas kernels run here in
interpret mode, as the JAX package's own tests run them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.modules.transformer import MultiheadAttention as JMHA
from speech_editing_tpu.modules.wavenet import DiffNetResidualBlock as JBlock
from speech_editing_tpu.ops.mel import MelConfig as JMelConfig
from speech_editing_tpu.ops.mel import mel_spectrogram as jmel_xla
from speech_editing_tpu.ops.pallas.diffnet_block import fused_diffnet_block
from speech_editing_tpu.ops.pallas.mel_kernel import mel_spectrogram_pallas
from speech_editing_tpu_torch.modules.transformer import MultiheadAttention
from speech_editing_tpu_torch.ops.cuda.diffnet_block import (diffnet_block,
                                                             diffnet_block_plain)
from speech_editing_tpu_torch.ops.cuda.mel_kernel import mel_spectrogram
from speech_editing_tpu_torch.ops.flash_attention import attention_plain, flash_mha
from speech_editing_tpu_torch.ops.mel import MelConfig
from speech_editing_tpu_torch.utils.convert_jax_params import _linear
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=1e-4, rtol=1e-4)


def _block_inputs(rs, b=2, t=37, c=32, hdim=24):
    f = lambda *s, scale=1.0: (rs.randn(*s) * scale).astype(np.float32)
    return (f(b, t, c), f(b, t, hdim, scale=0.5), f(b, c, scale=0.3),
            f(3 * c, 2 * c, scale=0.1), f(2 * c, scale=0.1),
            f(hdim, 2 * c, scale=0.1), f(2 * c, scale=0.1),
            f(c, 2 * c, scale=0.1), f(2 * c, scale=0.1))


def test_k1_plain_matches_pallas_block(rng):
    """No mask, dilation 1: the Pallas forward (interpret mode)."""
    x, cond, step, wd, bd, wc, bc, wo, bo = _block_inputs(rng)
    xo_j, sk_j = fused_diffnet_block(*(jnp.asarray(a) for a in
                                       (x, cond, step, wd, bd, wc, bc, wo, bo)))
    t = [torch.tensor(a) for a in (x, cond, step, wd, bd, wc, bc, wo, bo)]
    xo_t, sk_t = diffnet_block(t[0], t[1], t[2], None, *t[3:])
    np.testing.assert_allclose(xo_t.numpy(), np.asarray(xo_j), **TOL)
    np.testing.assert_allclose(sk_t.numpy(), np.asarray(sk_j), **TOL)


@pytest.mark.parametrize("dilation", [1, 2])
def test_k1_plain_matches_masked_block(rng, dilation):
    """With a nonpadding mask (the default denoiser path): the plain branch
    of the flax DiffNetResidualBlock, weights in K1's layout."""
    b, t, c, hdim = 2, 29, 16, 24
    x = rng.randn(b, t, c).astype(np.float32)
    cond = (rng.randn(b, t, hdim) * 0.5).astype(np.float32)
    step_emb = rng.randn(b, c).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[1, 20:] = 0.0
    block = JBlock(c, dilation)
    params = block.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(cond),
                        jnp.asarray(step_emb), jnp.asarray(mask)[..., None])["params"]
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(np.float32), params)
    xo_j, sk_j = block.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond),
                             jnp.asarray(step_emb), jnp.asarray(mask)[..., None])
    sd = {}
    _linear(sd, "proj", params["diffusion_projection"])
    step = torch.tensor(step_emb) @ sd["proj.weight"].T + sd["proj.bias"]
    k = lambda name: torch.tensor(params[name]["kernel"]).reshape(-1, 2 * c)
    bias = lambda name: torch.tensor(params[name]["bias"])
    xo_t, sk_t = diffnet_block(
        torch.tensor(x), torch.tensor(cond), step, torch.tensor(mask),
        k("dilated_conv"), bias("dilated_conv"), k("conditioner_projection"),
        bias("conditioner_projection"), k("output_projection"),
        bias("output_projection"), dilation=dilation)
    np.testing.assert_allclose(xo_t.numpy(), np.asarray(xo_j), **TOL)
    np.testing.assert_allclose(sk_t.numpy(), np.asarray(sk_j), **TOL)


def test_k1_mask_is_applied_before_the_conv(rng):
    """Zeroed mask rows contribute nothing to their neighbours' conv."""
    args = [torch.tensor(a) for a in _block_inputs(rng, b=1, t=12)]
    mask = torch.ones(1, 12)
    mask[0, 8:] = 0
    xo, _ = diffnet_block_plain(args[0], args[1], args[2], mask, *args[3:])
    x2 = args[0].clone()
    x2[0, 8:] = 1e3                    # masked rows change ...
    xo2, _ = diffnet_block_plain(x2, args[1], args[2], mask, *args[3:])
    torch.testing.assert_close(xo2[0, :8], xo[0, :8])   # ... real rows do not


@pytest.mark.parametrize("n_samples", [256 * 77, 256 * 130 + 17])
def test_k2_plain_matches_pallas_and_xla(rng, n_samples):
    wav = (rng.randn(2, n_samples) * 0.2).astype(np.float32)
    out = mel_spectrogram(torch.tensor(wav), MelConfig()).numpy()
    assert out.shape == (2, n_samples // 256 + 1, 80)
    for ref in (mel_spectrogram_pallas(jnp.asarray(wav), JMelConfig()),
                jmel_xla(jnp.asarray(wav), JMelConfig())):
        d = np.abs(out - np.asarray(ref))
        # log10 units; the eps floor amplifies tiny magnitude differences
        assert d.max() < 2e-2 and d.mean() < 2e-3, (d.max(), d.mean())


def test_k3_plain_matches_mha_einsum_path(rng):
    """The port's MultiheadAttention (K3's plain version inside) against the
    flax module's einsum path (flash is off on the CPU backend)."""
    b, t, e, h = 2, 13, 32, 2
    x = rng.randn(b, t, e).astype(np.float32)
    pad = np.zeros((b, t), bool)
    pad[1, 9:] = True
    jm = JMHA(e, h)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(x),
                     jnp.asarray(x))["params"]
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                   key_padding_mask=jnp.asarray(pad))
    tm = MultiheadAttention(e, h)
    wq, wk, wv = (np.asarray(params[n]["kernel"]).reshape(e, e).T
                  for n in ("q_proj", "k_proj", "v_proj"))
    tm.load_state_dict({
        "in_proj_weight": torch.tensor(np.concatenate([wq, wk, wv])),
        "out_proj.weight": torch.tensor(np.asarray(params["out_proj"]["kernel"])
                                        .reshape(e, e).T)})
    out = tm(torch.tensor(x), torch.tensor(pad))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


def test_k3_plain_gives_pad_keys_zero_weight(rng):
    q, k, v = (torch.tensor(rng.randn(1, 9, 2, 96).astype(np.float32)) for _ in range(3))
    pad = torch.zeros(1, 9, dtype=torch.bool)
    pad[0, 6:] = True
    out = flash_mha(q, k, v, pad)
    k2, v2 = k.clone(), v.clone()
    k2[0, 6:] = 50.0
    v2[0, 6:] = -7.0
    torch.testing.assert_close(flash_mha(q, k2, v2, pad), out)
    torch.testing.assert_close(out, attention_plain(q, k[:, :6], v[:, :6]))
    # q arrives pre-scaled: no extra 1/sqrt(d)
    w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k[:, :6]), -1)
    torch.testing.assert_close(out, torch.einsum("bhqk,bkhd->bqhd", w, v[:, :6]))


def test_wrappers_reject_unsupported_devices():
    x = torch.zeros(1, 4, 32, device="meta")
    with pytest.raises(ValueError):
        diffnet_block(x, x, x[:, 0], None, x, x, x, x, x, x)
    with pytest.raises(ValueError):
        mel_spectrogram(torch.zeros(1, 1024, device="meta"))
    with pytest.raises(ValueError):
        flash_mha(x[..., None], x[..., None], x[..., None])
