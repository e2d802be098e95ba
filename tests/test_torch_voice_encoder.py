"""PyTorch port, the binarizer's speaker encoder against the JAX package
on CPU: the module at full width (3-layer LSTM(40 -> 256), Linear(256,
256)) against flax ``VoiceEncoder`` with the weights carried over by
``voice_encoder_params_from_jax``; the 40-band mel front end and the
partial slices, equal; one resemblyzer-format checkpoint (``torch.save``
of seeded weights) loaded by both packages' ``load_voice_encoder`` and
the utterance embeddings compared; the context's device and weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.models import voice_encoder as jve
from speech_editing_tpu_torch.models import voice_encoder as tve
from speech_editing_tpu_torch.utils.convert_jax_params import voice_encoder_params_from_jax
from tests.test_torch_bf16_families import one_thread  # noqa: F401  (autouse fixture)

SR = 22050


def _wav(seconds, f0, seed):
    rs = np.random.RandomState(seed)
    t = np.arange(int(SR * seconds)) / SR
    wav = sum(0.3 / k * np.sin(2 * np.pi * f0 * k * t + rs.rand()) for k in range(1, 5))
    return (wav + 0.01 * rs.randn(len(t))).astype(np.float32)


def test_forward_at_full_width_matches_flax():
    model = jve.VoiceEncoder()
    mels = np.abs(np.random.RandomState(0).randn(3, jve.VE_PARTIAL_FRAMES,
                                                 jve.VE_N_MELS)).astype(np.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(mels))["params"]
    params = jax.tree.map(np.array, params)
    params["linear"]["bias"] = 0.05 * np.random.RandomState(1).randn(256).astype(np.float32)
    ref = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(mels)))
    port = tve.VoiceEncoder()
    port.load_state_dict(voice_encoder_params_from_jax(params))
    with torch.no_grad():
        out = port(torch.from_numpy(mels)).numpy()
    assert out.shape == (3, 256) and (out > 0).any()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seconds", [0.4, 1.2, 3.7])
def test_front_end_and_partial_slices_equal(seconds):
    from scipy.signal import resample_poly

    wav = resample_poly(_wav(seconds, 140, 0), 160, 441).astype(np.float32)
    mel = tve.ve_mel(wav)
    np.testing.assert_array_equal(mel, jve.ve_mel(wav))
    for n in (1, 100, 159, 160, 161, 290, len(mel), 1000, 1234):
        assert tve.compute_partial_slices(n) == jve.compute_partial_slices(n), n


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A resemblyzer-format checkpoint of seeded weights, with the GE2E
    similarity parameters resemblyzer's file also holds."""
    sd = tve.seeded_state_dict(torch.Generator().manual_seed(3))
    sd["similarity_weight"], sd["similarity_bias"] = torch.tensor([10.0]), torch.tensor([-5.0])
    path = str(tmp_path_factory.mktemp("ve") / "pretrained.pt")
    torch.save({"model_state": sd}, path)
    return path


def test_both_packages_load_one_checkpoint_and_embed_alike(checkpoint):
    jctx = jve.load_voice_encoder(checkpoint)
    ctx = tve.load_voice_encoder(checkpoint, "cpu")
    assert ctx.device == torch.device("cpu")
    embeds = []
    for seconds, f0, seed in ((0.5, 120, 0), (1.2, 180, 1), (4.1, 240, 2)):
        wav = _wav(seconds, f0, seed).astype(np.float16)
        got = ctx.embed_utterance(wav.astype(np.float64), source_sr=SR)
        ref = jctx.embed_utterance(wav.astype(np.float64), source_sr=SR)
        assert got.dtype == np.float32 and got.shape == (256,)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
        assert abs(np.linalg.norm(got) - 1) < 1e-5
        embeds.append(got)
    assert not np.allclose(embeds[0], embeds[2], atol=1e-3)


def test_context_device_and_weights():
    gen = torch.Generator().manual_seed(3)
    a = tve.VoiceEncoderCtx(device="cpu", generator=gen)
    b = tve.VoiceEncoderCtx(tve.seeded_state_dict(torch.Generator().manual_seed(3)), "cpu")
    for (k, v), (_, w) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(v, w), k
    bound = 256 ** -0.5
    assert all(float(p.detach().abs().max()) <= bound for p in a.model.parameters())
    with pytest.raises(ValueError):
        tve.VoiceEncoderCtx(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tve.VoiceEncoderCtx(device="cuda", generator=gen)
