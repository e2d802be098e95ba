"""PyTorch port, int8 weight-only serving (``infer/quant.py``) against the
JAX package's ``infer/quant.py``.

``quantize`` over a port ``state_dict`` lands on the int8 values and scales
of JAX's ``quantize_tree`` over the flax tree, leaf for leaf after the
layout map of ``utils/convert_jax_params.py``, with the same set of
quantized leaves: for the shipped conv config, the flagship fft config (its
attention ``DenseGeneral`` kernels take one scale per head width, shared
across heads) and HiFi-GAN. ``max_quant_error`` and ``quantized_bytes``
equal JAX's, the round trip stays within the error, and an int8 server
edit (JAX's noise injected) and an int8 HiFi-GAN agree with JAX's.
"""

import jax
import numpy as np
import pytest
import torch

import speech_editing_tpu.infer.serving as jserving
import speech_editing_tpu.infer.spec_denoiser as jsd
from speech_editing_tpu.infer.quant import _is_qleaf, _QKEY, _SKEY
from speech_editing_tpu.infer.quant import max_quant_error as j_max_quant_error
from speech_editing_tpu.infer.quant import quantize_tree
from speech_editing_tpu.infer.quant import quantized_bytes as j_quantized_bytes
from speech_editing_tpu.infer.vocoder import get_vocoder_cls as j_vocoder_cls
from speech_editing_tpu.training.tasks.spec_denoiser import SpecDenoiserTask as JTask
from speech_editing_tpu_torch.infer.quant import (QLeaf, QuantizedWeights, channel_views,
                                                  dequantize, max_quant_error, quantize,
                                                  quantized_bytes)
from speech_editing_tpu_torch.infer.serving import BatchedEditServer
from speech_editing_tpu_torch.infer.spec_denoiser import SpecDenoiserInfer
from speech_editing_tpu_torch.infer.vocoder import get_vocoder_cls
from speech_editing_tpu_torch.models.vocoder.hifigan import HifiGanGenerator
from speech_editing_tpu_torch.training.tasks.spec_denoiser import build_model
from speech_editing_tpu_torch.utils.convert_jax_params import (params_from_jax,
                                                               vocoder_params_from_jax)
from tests.helpers import TINY_HP, perturb_biases
from tests.test_serving import REQ_A, REQ_B, REQ_C, _make_request
from tests.test_torch_infer_edit import VHP, _save_jax_vocoder
from tests.test_torch_serving import KW, jax_chunk_noise, serve_env
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

MIN_SIZE = 512      # small enough to quantize the tiny attention kernels [32, 2, 16]


def _jax_params(hp):
    task = JTask(hp)
    rs = np.random.RandomState(0)
    t, s = 32, 8
    batch = {"txt_tokens": rs.randint(3, task.vocab_size, (1, s)),
             "time_mel_masks": np.zeros((1, t), np.float32),
             "mel2ph": np.clip(np.sort(rs.randint(1, s, (1, t))), 1, s),
             "mels": rs.randn(1, t, 80).astype(np.float32),
             "f0": rs.rand(1, t).astype(np.float32), "uv": np.zeros((1, t), np.float32),
             "spk_embed": np.zeros((1, 256), np.float32)}
    params = task.init_model(task.build_model(), batch, jax.random.PRNGKey(0))["params"]
    return task.vocab_size, jax.tree.map(np.array, perturb_biases(params))


def _acoustic(encoder):
    hp = dict(TINY_HP, encoder_type=encoder, use_spk_embed=True)
    vocab, jp = _jax_params(hp)
    model = build_model(vocab, hp)
    model.load_state_dict(params_from_jax(jp, hp))
    return model, jp, lambda tree: params_from_jax(tree, hp)


def _vocoder():
    gen = HifiGanGenerator(VHP)
    jp = jax.tree.map(np.array, perturb_biases(jax.jit(gen_init)(jax.random.PRNGKey(3))))
    gen.load_state_dict(vocoder_params_from_jax(jp, VHP))
    return gen, jp, lambda tree: vocoder_params_from_jax(tree, VHP)


def gen_init(key):
    from speech_editing_tpu.models.vocoder import HifiGanGenerator as JHifiGan

    return JHifiGan(hp=VHP).init(key, jax.numpy.zeros((1, 23, 80)))["params"]


@pytest.mark.parametrize("which", ["conv", "fft", "hifigan"])
def test_quantize_equals_jax_leaf_for_leaf(which):
    model, jp, to_torch = _vocoder() if which == "hifigan" else _acoustic(which)
    min_size = 64 if which == "hifigan" else MIN_SIZE
    jq = quantize_tree(jp, min_size=min_size)
    sd = model.state_dict()
    q = quantize(sd, channel_views(model), min_size)

    def mapped(fn):
        return to_torch(jax.tree.map(lambda ql, p: fn(ql, p), jq, jp, is_leaf=_is_qleaf))
    flags = mapped(lambda ql, p: np.full(p.shape, float(_is_qleaf(ql)), np.float32))
    values = mapped(lambda ql, p: ql[_QKEY].astype(np.float32) if _is_qleaf(ql)
                    else np.zeros(p.shape, np.float32))
    scales = mapped(lambda ql, p: np.broadcast_to(ql[_SKEY], p.shape).astype(np.float32)
                    if _is_qleaf(ql) else np.zeros(p.shape, np.float32))
    assert sorted(flags) == sorted(q)
    n_quantized = 0
    for name, leaf in q.items():
        flag = flags[name]
        assert bool(flag.all()) or not bool(flag.any()), name
        assert isinstance(leaf, QLeaf) == bool(flag.all()), name
        if isinstance(leaf, QLeaf):
            n_quantized += 1
            assert leaf.q8.dtype == torch.int8
            torch.testing.assert_close(leaf.q8.reshape(leaf.shape).float(), values[name],
                                       atol=0, rtol=0)
            torch.testing.assert_close(leaf.scale.expand(leaf.q8.shape).reshape(leaf.shape),
                                       scales[name], atol=0, rtol=0)
        else:
            assert torch.equal(leaf, sd[name])
    assert n_quantized >= 10
    if which == "fft":
        assert isinstance(q["fs.encoder.layers.0.op.self_attn.in_proj_weight"], QLeaf)
    err = max_quant_error(sd, q)
    assert err == j_max_quant_error(jp, jq) > 0
    assert quantized_bytes(q) == j_quantized_bytes(jq) < sum(
        t.numel() * 4 for t in sd.values())
    deq = dequantize(q)
    assert max(float((deq[k] - sd[k]).abs().max()) for k in sd) == err


def test_quantized_weights_run_the_model_dequantized():
    """``QuantizedWeights`` drops the float copies; inside ``dequantized``
    the model holds exactly ``dequantize(quantize(w))``, and after it the
    quantized weights are gone again."""
    model, _, _ = _acoustic("conv")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    want = dequantize(quantize(sd, channel_views(model), MIN_SIZE))
    qw = QuantizedWeights(model, MIN_SIZE, "cpu")
    name = "denoise_fn.residual_layers.0.dilated_conv.weight"
    assert name in qw.qstate and model.denoise_fn.residual_layers[0].dilated_conv.weight is None
    with qw.dequantized() as m:
        got = m.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert model.denoise_fn.residual_layers[0].dilated_conv.weight is None
    assert qw.bytes < qw.f32_bytes


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return serve_env(tmp_path_factory.mktemp("torch_quant"))


def test_int8_server_matches_jax_with_injected_noise(env, capsys):
    hp = dict(env, serve_quant_int8=True, quant_min_size=MIN_SIZE)
    reqs = [_make_request(**REQ_A), _make_request(**REQ_B), _make_request(**REQ_C)]
    ref = jserving.BatchedEditServer(jsd.SpecDenoiserInfer(hp), **KW).edit_many(reqs, seed=7)
    f32 = jserving.BatchedEditServer(jsd.SpecDenoiserInfer(env), **KW).edit_many(reqs, seed=7)
    pinf = SpecDenoiserInfer(hp, device="cpu")
    assert "| int8 weight-only serving (acoustic model): max quant err" in capsys.readouterr().out
    srv = BatchedEditServer(pinf, **KW)
    srv.chunk_noise = jax_chunk_noise(7, hp["timesteps"])
    got = srv.edit_many(reqs, seed=7)
    moved = 0.0
    for r, r_ref, r32 in zip(got, ref, f32):
        assert r["t_frames"] == r_ref["t_frames"]
        np.testing.assert_allclose(r["mel_out"], r_ref["mel_out"], atol=1e-3, rtol=1e-3)
        if r32["t_frames"] == r["t_frames"]:
            moved = max(moved, float(np.abs(r32["mel_out"] - r_ref["mel_out"]).max()))
    assert moved > 0     # int8 changed the numbers, on both sides alike


def test_int8_hifigan_matches_jax(tmp_path, capsys):
    ckpt_dir = str(tmp_path / "voc")
    mel, _ = _save_jax_vocoder(ckpt_dir, as_gan_state=True)
    hp = {"vocoder_ckpt": ckpt_dir, "serve_quant_int8": True, "quant_min_size": 64}
    voc = get_vocoder_cls("hifigan")(hp, "cpu")
    assert "| int8 weight-only serving (HiFi-GAN)" in capsys.readouterr().out
    ref = j_vocoder_cls("HifiGAN")(hp).spec2wav(mel[0])
    f32 = get_vocoder_cls("hifigan")(dict(hp, serve_quant_int8=False), "cpu").spec2wav(mel[0])
    got = voc.spec2wav(mel[0])
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    assert np.abs(got - f32).max() > 1e-6
