"""PyTorch port, the batch server (``infer/serving.py::BatchedEditServer``)
against the JAX package's, and the port's own serving contract.

Both packages' servers load the same tiny JAX checkpoint
(``tests/helpers.py::make_spec_denoiser_serve_env``, non-zero biases so
padding cannot be inert by accident, and a non-zero DiffNet output
projection so the sample depends on its noise). With JAX's per-row draws
(``per_row_noise`` of ``request_prng_key``) injected in place of the
port's, three requests of different lengths give equal durations and
``mel_out`` within 1e-3. On the port alone, as the JAX package's
``tests/test_serving.py`` holds its server: a request's mel is bit-identical
whatever row, chunk order or co-batched requests it meets; at the exact-fit
bucket it is the per-item driver's bit for bit; a padded frame bucket
leaves real frames within 1e-5 and padded frames exactly 0, as does a
padded token bucket; ``serve_wav_int16`` gives ``save_wav``'s samples bit
for bit with HiFi-GAN and with Griffin-Lim; ``serve_fetch_mel`` "f16" and
"off"; ``example_run`` with ``serve_batched``; the online scheduler equals
``edit_many`` bit for bit; after ``warmup`` traffic adds no program shape.
"""

import copy

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from scipy.io import wavfile

import speech_editing_tpu.infer.serving as jserving
import speech_editing_tpu.infer.spec_denoiser as jsd
import speech_editing_tpu_torch.infer.spec_denoiser as psd
from speech_editing_tpu.ops.diffusion import per_row_noise
from speech_editing_tpu.training.checkpoint import get_last_checkpoint, load_checkpoint
from speech_editing_tpu.training.checkpoint import save_checkpoint as save_checkpoint_jax
from speech_editing_tpu_torch.config.hparams import dump_yaml
from speech_editing_tpu_torch.infer.online import OnlineEditServer
from speech_editing_tpu_torch.infer.serving import BatchedEditServer, _pad_to
from speech_editing_tpu_torch.models.vocoder.hifigan import HifiGanGenerator
from speech_editing_tpu_torch.training.checkpoint import save_checkpoint
from speech_editing_tpu_torch.utils.audio.io import save_wav
from speech_editing_tpu_torch.utils.init import init_like_flax
from tests.helpers import make_spec_denoiser_serve_env
from tests.test_serving import REQ_A, REQ_B, REQ_C, _make_request
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

TOL = dict(atol=1e-3, rtol=1e-3)
KW = dict(max_batch=4, frame_buckets=(64, 128), token_buckets=(32, 64))
# a tiny HiFi-GAN whose upsampling (8 x 8 x 4) is the mel hop of 256 samples
VHP = {"upsample_rates": [8, 8, 4], "upsample_kernel_sizes": [16, 16, 8],
       "upsample_initial_channel": 32, "resblock": "2", "resblock_kernel_sizes": [3],
       "resblock_dilation_sizes": [[1, 3]]}


def serve_env(tmp) -> dict:
    """``make_spec_denoiser_serve_env``'s checkpoint with DiffNet's output
    projection drawn non-zero, as trained weights have it (at flax's zero
    init the sample does not depend on the noise), saved as step 2."""
    hp = make_spec_denoiser_serve_env(tmp)
    ckpt, _ = get_last_checkpoint(hp["work_dir"])
    state = load_checkpoint(ckpt)["state"]
    kernel = state.params["denoise_fn"]["output_projection"]["kernel"]
    state.params["denoise_fn"]["output_projection"]["kernel"] = (
        np.random.RandomState(3).randn(*np.shape(kernel)) * 0.2).astype(np.float32)
    save_checkpoint_jax(hp["work_dir"], state, steps=2)
    return hp


def write_vocoder(voc_dir) -> str:
    """A tiny HiFi-GAN checkpoint of seeded weights with its config.yaml."""
    torch.manual_seed(0)
    save_checkpoint(str(voc_dir), {"model": init_like_flax(HifiGanGenerator(VHP))
                                   .state_dict()}, 1)
    (voc_dir / "config.yaml").write_text(dump_yaml(VHP))
    return str(voc_dir)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serving")
    hp = serve_env(tmp)
    return {"hp": hp, "port": psd.SpecDenoiserInfer(hp, device="cpu"),
            "voc_dir": write_vocoder(tmp / "voc")}


def _with_hp(pinf, **kw):
    """``pinf`` (its model and vocoder) under other serving settings."""
    other = copy.copy(pinf)
    other.hp = dict(pinf.hp, **kw)
    return other


def _requests():
    return [_make_request(**REQ_A), _make_request(**dict(REQ_B), n_sec=1.5),
            _make_request(**REQ_C)]


def _record_durations(server) -> list:
    """Each request's float durations, as the server passes them on."""
    seen = []
    advance = server._advance_to_diff

    def wrapped(r):
        seen.append(np.asarray(r.dur_pred))
        advance(r)
    server._advance_to_diff = wrapped
    return seen


def jax_chunk_noise(seed: int, steps: int):
    """A ``BatchedEditServer.chunk_noise`` giving the JAX server's draws:
    ``per_row_noise`` of each row's ``request_prng_key`` at the bucket's
    length, the initial noise first."""
    base = jax.random.PRNGKey(seed)

    def chunk_noise(reqs, t_b, b_eff):
        rows = reqs + reqs[:1] * (b_eff - len(reqs))
        keys = jax.numpy.stack([jsd.request_prng_key(base, r.item) for r in rows])
        return torch.stack([torch.tensor(np.asarray(per_row_noise(keys, step, (t_b, 80))))
                            for step in range(steps, -1, -1)])
    return chunk_noise


def test_server_matches_jax_with_injected_noise(env):
    hp = env["hp"]
    jax_srv = jserving.BatchedEditServer(jsd.SpecDenoiserInfer(hp), **KW)
    jax_durs = _record_durations(jax_srv)
    ref = jax_srv.edit_many(_requests(), seed=7)

    srv = BatchedEditServer(env["port"], **KW)
    durs = _record_durations(srv)
    srv.chunk_noise = jax_chunk_noise(7, hp["timesteps"])
    got = srv.edit_many(_requests(), seed=7)
    assert len(durs) == len(jax_durs) == 3
    for d, d_ref in zip(durs, jax_durs):
        np.testing.assert_allclose(d, d_ref, atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(np.round(d), np.round(d_ref))
    assert len({r["t_frames"] for r in ref}) > 1
    for r, r_ref in zip(got, ref):
        assert r["t_frames"] == r_ref["t_frames"]
        np.testing.assert_allclose(r["mel_out"], r_ref["mel_out"], **TOL)
        np.testing.assert_array_equal(r["ref_mels"], r_ref["ref_mels"])
        np.testing.assert_array_equal(r["time_mel_masks"], r_ref["time_mel_masks"])


def test_result_is_independent_of_row_chunk_order_and_batch(env):
    pinf, hp = env["port"], env["hp"]
    res = BatchedEditServer(pinf, **KW).edit_many(_requests(), seed=7)
    for r in res:
        assert np.isfinite(r["mel_out"]).all() and r["mel_out"].shape == (r["t_frames"], 80)
        assert len(r["wav_out"]) == r["t_frames"] * hp["hop_size"]
    srv = BatchedEditServer(pinf, max_batch=2, frame_buckets=(64, 128), token_buckets=(64,))
    alone = srv.edit_many([_make_request(**REQ_A)], seed=7)[0]
    # a request before A in its bucket moves A from row 0 to row 1
    ba = srv.edit_many([_make_request(**REQ_B), _make_request(**REQ_A)], seed=7)
    np.testing.assert_array_equal(alone["mel_out"], ba[1]["mel_out"])
    # a longer request lands in another frame bucket, running first
    xa = srv.edit_many([_make_request(**dict(REQ_B, name="x_long"), n_sec=1.5),
                        _make_request(**REQ_A)], seed=7)
    assert xa[0]["t_frames"] != alone["t_frames"]
    np.testing.assert_array_equal(alone["mel_out"], xa[1]["mel_out"])


def _splice(pinf, inp):
    item = pinf.preprocess_input(inp)
    spk = pinf.spk_embedder(item["wav"])[None]
    m2p, m2w, _ = pinf.inpaint_durations(item, spk)
    return item, spk, psd.splice_edit(item, m2p, m2w, 1)


def test_exact_fit_equals_the_per_item_driver(env):
    pinf = env["port"]
    inp = _make_request(**REQ_A)
    item, _, sp = _splice(pinf, inp)
    srv = BatchedEditServer(pinf, max_batch=1, frame_buckets=(len(item["mel2ph"]), sp["t_new"]),
                            token_buckets=(len(item["edited_ph_token"]),))
    res = srv.edit_many([inp])[0]
    assert res["t_frames"] == sp["t_new"]
    np.testing.assert_array_equal(res["mel_out"], pinf.forward_model(item)[2])


def test_padded_buckets_are_inert(env):
    """A request served at a padded frame bucket and token bucket agrees
    with the exact fit within 1e-5: its noise is drawn at its own length,
    and the sampler masks x every step, so the padded frames of the
    diffusion program come back exactly 0."""
    pinf = env["port"]
    inp = _make_request(**REQ_A)
    item, spk, sp = _splice(pinf, inp)
    t_new, t_src, s_fit = sp["t_new"], len(item["mel2ph"]), len(item["edited_ph_token"])
    exact = BatchedEditServer(pinf, max_batch=1, frame_buckets=(t_src, t_new),
                              token_buckets=(s_fit,)).edit_many([inp])[0]["mel_out"]
    for frames, tokens in ((t_new + 24, s_fit), (t_new + 24, s_fit + 8)):
        srv = BatchedEditServer(pinf, max_batch=2, frame_buckets=(frames,),
                                token_buckets=(tokens,))
        np.testing.assert_allclose(srv.edit_many([inp])[0]["mel_out"], exact, atol=1e-5)

    gen = psd.request_generator(11, item, "cpu")
    noise = psd.request_noise(gen, pinf.model.num_timesteps, t_new, 80)[:, None]
    padded = pinf._infer(
        _pad_to(item["edited_ph_token"], s_fit)[None],
        *(_pad_to(sp[k], t_new + 24)[None] for k in ("time_mel_masks", "mel2ph")), spk,
        *(_pad_to(sp[k], t_new + 24)[None] for k in ("ref_mels", "f0", "uv")),
        F.pad(noise, (0, 0, 0, 24)))[0].numpy()
    assert np.abs(padded[:t_new]).max() > 0
    np.testing.assert_array_equal(padded[t_new:], 0.0)


@pytest.mark.parametrize("vocoder", ["HifiGAN", "GriffinLim"])
def test_wav_int16_is_save_wavs_pcm(env, tmp_path, vocoder):
    hp = dict(env["hp"], vocoder=vocoder, vocoder_ckpt=env["voc_dir"])
    pinf = psd.SpecDenoiserInfer(hp, device="cpu")
    assert pinf.vocoder.device_batched == (vocoder == "HifiGAN")
    reqs = [_make_request(**REQ_A), _make_request(**REQ_C)]
    f32 = BatchedEditServer(pinf, **KW).edit_many(reqs, seed=7)
    pcm = BatchedEditServer(_with_hp(pinf, serve_wav_int16=True), **KW).edit_many(reqs, seed=7)
    for i, (a, b) in enumerate(zip(f32, pcm)):
        assert a["wav_out"].dtype == np.float32 and b["wav_out"].dtype == np.int16
        save_wav(a["wav_out"], str(tmp_path / f"{i}.wav"), hp["audio_sample_rate"])
        np.testing.assert_array_equal(wavfile.read(str(tmp_path / f"{i}.wav"))[1], b["wav_out"])
        np.testing.assert_array_equal(a["mel_out"], b["mel_out"])


def test_fetch_mel_f16_and_off(env):
    pinf = env["port"]
    reqs = [_make_request(**REQ_A), _make_request(**REQ_B)]
    f32, f16, off = (BatchedEditServer(_with_hp(pinf, serve_fetch_mel=m), **KW)
                     .edit_many(reqs, seed=7) for m in ("f32", "f16", "off"))
    with pytest.raises(ValueError, match="serve_fetch_mel"):
        BatchedEditServer(_with_hp(pinf, serve_fetch_mel="f64"), **KW)
    for a, b, c in zip(f32, f16, off):
        assert b["mel_out"].dtype == np.float16
        np.testing.assert_array_equal(b["mel_out"], a["mel_out"].astype(np.float16))
        assert c["mel_out"] is None
        np.testing.assert_array_equal(c["wav_out"], a["wav_out"])


def test_example_run_serve_batched(env, tmp_path):
    hp = dict(env["hp"], serve_batched=True, serve_max_batch=4)
    wav_fn = str(tmp_path / "src.wav")
    save_wav(_make_request(**REQ_A)["wav"], wav_fn, 22050)
    rows = [dict(item_name=f"csv_item_{i}", text=REQ_A["text"],
                 edited_text=REQ_A["edited_text"], region=REQ_A["region"],
                 edited_region=REQ_A["edited_region"], wav_fn_orig=wav_fn,
                 mel2ph=_make_request(**REQ_A)["mel2ph"]) for i in range(2)]
    psd.SpecDenoiserInfer.example_run(rows, hp, out_dir=str(tmp_path / "out"), device="cpu")
    for i in range(2):
        for suffix in ("", "_ref"):
            sr, wav = wavfile.read(str(tmp_path / "out" / f"csv_item_{i}{suffix}.wav"))
            assert sr == 22050 and wav.dtype == np.int16 and len(wav) > 0


def test_online_equals_edit_many_and_warmup_covers_traffic(env):
    """Online results equal ``edit_many`` bit for bit whatever the arrival
    pattern (a lone request, then two sharing a chunk, then two scheduler
    threads); a warmed server's shape log holds every shape traffic runs,
    and traffic after ``warmup`` adds none."""
    pinf = env["port"]
    kw = dict(max_batch=2, frame_buckets=(64, 128, 256), token_buckets=(32, 64))
    offline = BatchedEditServer(pinf, **kw).edit_many(_requests(), seed=7)

    warmed = BatchedEditServer(pinf, **kw)
    n = warmed.warmup(workers=2)
    # (token bucket, frame bucket) pairs x the dur and diff programs
    assert n == len(warmed.program_shapes) == 2 * 3 * 2
    shapes = set(warmed.program_shapes)
    assert warmed.warmup() == 0

    class Clock:
        t = 0.0
    srv = OnlineEditServer(warmed, max_wait_ms=50, clock=lambda: Clock.t, start=False)
    reqs = _requests()
    futures = [srv.submit(reqs[0], seed=7)]
    srv.drain()
    futures += [srv.submit(r, seed=7) for r in reqs[1:]]
    srv.drain()
    for f, off in zip(futures, offline):
        np.testing.assert_array_equal(f.result(0)["mel_out"], off["mel_out"])
    with OnlineEditServer(warmed, max_wait_ms=5, workers=2) as threaded:
        results = [f.result(timeout=120) for f in
                   [threaded.submit(r, seed=7) for r in _requests()]]
    for r, off in zip(results, offline):
        np.testing.assert_array_equal(r["mel_out"], off["mel_out"])
    assert warmed.program_shapes == shapes
