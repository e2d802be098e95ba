"""PyTorch port, the CSV region-edit API (``SpecDenoiserInfer``) and the
vocoder registry against the JAX package.

Both packages' SpecDenoiserInfer load the same tiny JAX checkpoint. For each edit (lengthening,
shortening, same length, a tail outside the stated region that
re-phonemizes differently) the float durations agree at 1e-4, and with
JAX's per-request draws (``per_row_noise(request_prng_key(...))``)
injected, ``mel_out`` agrees at 1e-3; a predicted duration within 1e-4 of
a .5 rounding boundary takes JAX's rounding, and the count is printed.
Griffin-Lim agrees exactly; HiFi-GAN loaded from a JAX ``GanTrainState``
checkpoint (or a plain ``{"gen", "disc"}`` tree) with a PyYAML-written
``config.yaml`` at 1e-4 of flax's ``apply``.
"""

import functools
import json
import os
import pickle
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import speech_editing_tpu.infer.spec_denoiser as jsd
import speech_editing_tpu_torch.infer.spec_denoiser as psd
from speech_editing_tpu.infer.vocoder import get_vocoder_cls as j_vocoder_cls
from speech_editing_tpu.models.vocoder import HifiGanGenerator as JHifiGan
from speech_editing_tpu.ops.diffusion import per_row_noise
from speech_editing_tpu.training.checkpoint import save_checkpoint as j_save_checkpoint
from speech_editing_tpu.training.optim import build_optimizer
from speech_editing_tpu.training.tasks.hifigan import GanTrainState
from speech_editing_tpu.training.tasks.spec_denoiser import SpecDenoiserTask as JTask
from speech_editing_tpu.training.train_state import TrainState
from speech_editing_tpu_torch.config.hparams import dump_yaml
from speech_editing_tpu_torch.infer.vocoder import get_vocoder_cls
from speech_editing_tpu_torch.training.checkpoint import load_checkpoint
from speech_editing_tpu_torch.utils.audio.dsp import wav2spec
from speech_editing_tpu_torch.utils.audio.io import load_wav, save_wav
from tests.helpers import TINY_HP, perturb_biases
from tests.test_torch_infer_frontend import EDITS, harmonic_wav, phone_list, write_textgrid
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

SR, HOP = 22050, 256
TOL = dict(atol=1e-3, rtol=1e-3)
DUR_TOL = 1e-4
VHP = {"upsample_rates": [4, 4], "upsample_kernel_sizes": [8, 8],
       "upsample_initial_channel": 16, "resblock": "1", "resblock_kernel_sizes": [3, 5],
       "resblock_dilation_sizes": [[1, 3], [1, 3]], "audio_num_mel_bins": 80}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A tiny JAX checkpoint, its phone set, one wav and TextGrid per
    ``EDITS`` row, and both packages' SpecDenoiserInfer over them on the CPU."""
    tmp = tmp_path_factory.mktemp("infer_edit")
    data_dir, work_dir = str(tmp / "binary"), str(tmp / "work")
    os.makedirs(data_dir)
    with open(f"{data_dir}/phone_set.json", "w") as f:
        json.dump(phone_list(), f)
    hp = dict(TINY_HP, binary_data_dir=data_dir, work_dir=work_dir, infer=True,
              use_spk_embed=True, f0_min=80, f0_max=600, language="en",
              vocoder="GriffinLim", seed=1234)
    task = JTask(hp)
    model = task.build_model()
    rs = np.random.RandomState(0)
    t, s = 64, 10
    batch = {"txt_tokens": rs.randint(3, task.vocab_size, (1, s)),
             "time_mel_masks": np.zeros((1, t), np.float32),
             "mel2ph": np.clip(np.sort(rs.randint(1, s, (1, t))), 1, s),
             "mels": rs.randn(1, t, 80).astype(np.float32),
             "f0": rs.rand(1, t).astype(np.float32), "uv": np.zeros((1, t), np.float32),
             "spk_embed": np.zeros((1, 256), np.float32)}
    params = task.init_model(model, batch, jax.random.PRNGKey(0))["params"]
    # non-zero biases and a non-zero DiffNet output projection, as trained weights have
    params = perturb_biases(params)
    params["denoise_fn"]["output_projection"]["kernel"] = (
        rs.randn(*np.shape(params["denoise_fn"]["output_projection"]["kernel"])) * 0.2
    ).astype(np.float32)
    j_save_checkpoint(work_dir, TrainState.create(params, build_optimizer(hp)), 1)
    inputs = []
    for i, (text, edited, region, edited_region) in enumerate(EDITS):
        wav_fn = str(tmp / f"row{i}.wav")
        save_wav(harmonic_wav(0.9 + 0.2 * i, 120 + 20 * i, i), wav_fn, SR)
        spec = wav2spec(wav_fn, fmin=hp["fmin"], fmax=hp["fmax"])
        tg = str(tmp / f"row{i}.TextGrid")
        write_textgrid(tg, text, spec["mel"].shape[0])
        inputs.append(dict(item_name=f"row{i}", text=text, edited_text=edited,
                           region=region, edited_region=edited_region, wav_fn_orig=wav_fn,
                           mfa_textgrid=tg, mel=spec["mel"], wav=spec["wav"]))
    return {"tmp": tmp, "hp": hp, "inputs": inputs,
            "jax": jsd.SpecDenoiserInfer(hp),
            "port": psd.SpecDenoiserInfer(hp, device="cpu")}


def _jax_durations(jinf, item):
    """JAX's predicted float durations, as its ``inpaint_durations`` runs them."""
    masked_dur, masked_mel2ph, edit_frames = jsd.dur_inpaint_prep(item)
    out = jinf._predict_dur(
        jinf.variables, jnp.asarray(item["edited_ph_token"])[None],
        jnp.asarray(edit_frames.astype(np.float32))[None, :, None],
        jnp.asarray(masked_mel2ph)[None], jnp.asarray(masked_dur)[None],
        jnp.zeros((1, 256), jnp.float32))
    return np.asarray(out["dur"], np.float32)[0]


# the lengthening, the shortening and the tail-mismatch rows (one JAX
# compile each); the same-length row runs in the port-only test below
@pytest.mark.parametrize("row", [0, 1, 3])
def test_edit_matches_jax_with_injected_noise(env, row, capsys):
    jinf, pinf, hp = env["jax"], env["port"], env["hp"]
    inp = env["inputs"][row]
    item = jinf.preprocess_input(inp)
    ref = jinf.forward_model(item)
    dur_ref = _jax_durations(jinf, item)

    got_item = pinf.preprocess_input(inp)
    dur = pinf.predict_durations(got_item, np.zeros((1, 256), np.float32))
    np.testing.assert_allclose(dur, dur_ref, atol=DUR_TOL, rtol=DUR_TOL)
    flipped = np.round(dur) != np.round(dur_ref)
    assert np.all(np.abs(np.abs(dur_ref[flipped] - np.floor(dur_ref[flipped])) - 0.5)
                  <= DUR_TOL), "a duration rounded differently away from a .5 boundary"
    print(f"row {row}: {int(flipped.sum())} of {len(dur)} durations replay JAX's rounding")

    t_new = ref[2].shape[0]
    key = jsd.request_prng_key(jax.random.PRNGKey(hp["seed"]), item)[None]
    noise = [torch.tensor(np.asarray(per_row_noise(key, step, (t_new, 80))))
             for step in range(hp["timesteps"], -1, -1)]
    got = pinf.forward_model(got_item, noise=noise, dur_int=np.round(dur_ref))
    wav_out, wav_gt, mel_out, mel, ref_mels, masked_mel_gt = got
    np.testing.assert_allclose(mel_out, ref[2], **TOL)
    for a, b in ((wav_gt, ref[1]), (mel, ref[3]), (ref_mels, ref[4]), (masked_mel_gt, ref[5])):
        np.testing.assert_array_equal(a, b)
    assert wav_out.shape == ref[0].shape == (t_new * HOP,) and np.isfinite(wav_out).all()
    # the head and tail are the source's frames; the edited span is generated
    kept = np.any(ref_mels != 0, axis=1)
    np.testing.assert_array_equal(mel_out[kept], ref_mels[kept])
    assert (~kept).any() and not np.allclose(mel_out[~kept], 0)
    assert f"row {row}:" in capsys.readouterr().out


def test_request_noise_depends_only_on_seed_and_request(env):
    pinf, inp = env["port"], env["inputs"][2]
    item = pinf.preprocess_input(inp)
    first, again = pinf.forward_model(item)[2], pinf.forward_model(item)[2]
    assert np.array_equal(first, again)
    renamed = pinf.forward_model(dict(item, item_name="other"))[2]
    assert first.shape == renamed.shape and not np.array_equal(first, renamed)
    g1 = psd.request_generator(1234, item, "cpu")
    g2 = psd.request_generator(1234, dict(item, item_name="other"), "cpu")
    g3 = psd.request_generator(1235, item, "cpu")
    draws = [torch.randn(8, generator=g) for g in (g1, g2, g3)]
    assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])


@functools.lru_cache(maxsize=1)
def _jax_vocoder():
    """(mel, a JAX HiFi-GAN's parameters with perturbed biases, its output
    on mel): one init and one apply, shared by the checkpoints saved below."""
    mel = (np.random.RandomState(1).randn(1, 23, 80) * 0.5 - 2).astype(np.float32)
    gen = JHifiGan(hp=VHP)
    params = jax.tree.map(np.asarray, jax.jit(gen.init)(jax.random.PRNGKey(3),
                                                        jnp.asarray(mel))["params"])
    params = perturb_biases(params, seed=2)
    return mel, params, np.asarray(jax.jit(gen.apply)({"params": params}, jnp.asarray(mel)))


def _save_jax_vocoder(ckpt_dir, as_gan_state: bool):
    mel, params, ref = _jax_vocoder()
    if as_gan_state:
        state = GanTrainState(step=np.int32(5), gen_params=params, gen_opt=None,
                              disc_params={"w": np.zeros(3, np.float32)}, disc_opt=None)
    else:
        state = {"params": {"gen": params, "disc": {"w": np.zeros(3, np.float32)}}}
    j_save_checkpoint(ckpt_dir, state, 5)
    with open(os.path.join(ckpt_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(dict(VHP, task_cls="HifiGanTask", lr=2e-4), f, sort_keys=True)
    return mel, ref


@pytest.mark.parametrize("saved", ["gan_train_state", "gen_disc_tree"])
def test_hifigan_from_a_jax_checkpoint_matches_flax(env, tmp_path, saved, capsys):
    ckpt_dir = str(tmp_path / "voc")
    mel, ref = _save_jax_vocoder(ckpt_dir, saved == "gan_train_state")
    hp = dict(env["hp"], vocoder="HifiGAN", vocoder_ckpt=ckpt_dir)
    voc = get_vocoder_cls("hifigan")(hp, "cpu")
    assert voc.kind == "hifigan" and "| vocoder: HiFi-GAN from" in capsys.readouterr().out
    np.testing.assert_allclose(voc.spec2wav(mel[0]), ref[0], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(voc.spec2wav_batch(np.concatenate([mel, mel])),
                               np.concatenate([ref, ref]), atol=1e-4, rtol=1e-4)
    if saved == "gan_train_state":    # the JAX package's vocoder reads the same files
        jvoc = j_vocoder_cls("HifiGAN")(hp)
        np.testing.assert_allclose(voc.spec2wav(mel[0]), jvoc.spec2wav(mel[0]), atol=1e-4,
                                   rtol=1e-4)
    payload = load_checkpoint(os.path.join(ckpt_dir, "model_ckpt_steps_5.ckpt"))
    assert payload["steps"] == 5 and "conv_pre" in payload["jax_params"]


def test_jax_checkpoint_loader_refuses_other_classes(tmp_path):
    path = str(tmp_path / "model_ckpt_steps_1.ckpt")
    with open(path, "wb") as f:
        pickle.dump({"state": {"params": shutil.copyfile}, "steps": 1}, f)
    with pytest.raises(pickle.UnpicklingError, match="shutil.copyfile"):
        load_checkpoint(path)


def test_griffin_lim_and_the_fallback_match_jax(env, capsys):
    mel = env["inputs"][0]["mel"][:40]
    hp = dict(env["hp"], vocoder_ckpt=str(env["tmp"] / "no_vocoder_here"))
    ref = j_vocoder_cls("GriffinLim")(hp).spec2wav(mel)
    np.testing.assert_array_equal(get_vocoder_cls("GriffinLim")(hp).spec2wav(mel), ref)
    fallback = get_vocoder_cls("HifiGAN")(hp, "cpu")
    assert fallback.kind == "griffinlim"
    assert "| vocoder: Griffin-Lim" in capsys.readouterr().out
    np.testing.assert_array_equal(fallback.spec2wav(mel), ref)
    np.testing.assert_array_equal(j_vocoder_cls("HifiGAN")(hp).spec2wav(mel), ref)


def test_serving_settings_not_ported_raise(env):
    """Every serving setting is ported now: ``serve_quant_int8`` builds for
    FluentSpeech, whose driver makes ``BatchedEditServer``, and each
    in-place family's driver makes ``BatchedInPlaceEditServer``
    (tests/test_torch_serving.py and tests/test_torch_inplace_serving.py
    run them); nothing raises."""
    from speech_editing_tpu_torch.infer.editors import infer_cls_for_hp
    from speech_editing_tpu_torch.infer.serving import (BatchedEditServer,
                                                        BatchedInPlaceEditServer)

    hp = env["hp"]
    assert psd.SpecDenoiserInfer(dict(hp, serve_quant_int8=True), device="cpu").quant is not None
    stub = types.SimpleNamespace(hp=hp)
    assert isinstance(psd.SpecDenoiserInfer.make_server(stub), BatchedEditServer)
    for task_cls in ("tasks.campnet.CampNetTask", "tasks.a3t.A3TTask",
                     "tasks.editspeech.EditSpeechTask"):
        cls = infer_cls_for_hp(dict(hp, task_cls=task_cls))
        stub = types.SimpleNamespace(hp=dict(hp, task_cls=task_cls))
        assert isinstance(cls.make_server(stub), BatchedInPlaceEditServer)


def test_csv_command_line_writes_each_edit(env, tmp_path, monkeypatch, capsys):
    """``python -m speech_editing_tpu_torch.infer.spec_denoiser --device
    cpu`` over a CSV, with the TextGrids where ``mfa_align: false`` reads
    them."""
    hp, rows = env["hp"], env["inputs"][:2]
    monkeypatch.chdir(tmp_path)
    shutil.copytree(hp["work_dir"], "checkpoints/tiny")
    os.makedirs("inference/audio/mfa_out")
    lines = ["id,item_name,text,edited_text,wav_fn_orig,edited_region,region"]
    for i, r in enumerate(rows):
        shutil.copyfile(r["mfa_textgrid"], f"inference/audio/mfa_out/{r['item_name']}.TextGrid")
        lines.append(f'{i},{r["item_name"]},"{r["text"]}","{r["edited_text"]}",'
                     f'{r["wav_fn_orig"]},"{r["edited_region"]}","{r["region"]}"')
    (tmp_path / "edits.csv").write_text("\n".join(lines) + "\n")
    cfg = {k: v for k, v in hp.items() if k not in ("work_dir", "infer")}
    (tmp_path / "tiny.yaml").write_text(dump_yaml(dict(cfg, infer_csv="edits.csv",
                                                       mfa_align=False)))
    psd.main(["--config", "tiny.yaml", "--exp_name", "tiny", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "| loaded checkpoints/tiny/model_ckpt_steps_1.ckpt (step 1)" in out
    for r in rows:
        for suffix in ("", "_ref"):
            wav, sr = load_wav(f"inference/out/{r['item_name']}{suffix}.wav")
            assert sr == SR and len(wav) > 0 and np.isfinite(wav).all()
