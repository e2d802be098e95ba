"""PyTorch port, the command-line tools (``speech_editing_tpu_torch/scripts``)
against the JAX package's ``scripts/``, on CPU and without starting a
training process: ``write_structured_corpus`` writes JAX's corpus bit for
bit; ``seg_mcd``/``full_mcd`` equal JAX's on the same directories; the
acceptance's configuration is JAX's, but for the widths of the families
that run DiffNet on the GPU (the smallest the DiffNet block kernel is
compiled for);
``e2e_acceptance`` (its training runs replaced by stand-ins in both
packages), ``quant_quality_ab`` (on a checkpoint of seeded weights with
``--reuse-workdir``), ``copy_synthesis`` (Griffin-Lim, both packages run
for real) and ``make_example_audio`` print JAX's JSON keys (the port's add
``widths``, ``seed``, ``device`` and ``wall_s``); the tools refuse to run without a
GPU unless given ``--device cpu``."""

import ast
import glob
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from speech_editing_tpu.data.indexed_dataset import IndexedDataset as JIndexedDataset
from speech_editing_tpu_torch.config.hparams import dump_yaml
from speech_editing_tpu_torch.data.indexed_dataset import IndexedDataset
from speech_editing_tpu_torch.scripts import (copy_synthesis, e2e_acceptance,
                                              make_example_audio, quant_quality_ab)
from speech_editing_tpu_torch.training.checkpoint import save_checkpoint
from speech_editing_tpu_torch.training.tasks.spec_denoiser import build_model
from speech_editing_tpu_torch.utils.audio.io import save_wav
from speech_editing_tpu_torch.utils.init import init_like_flax
from tests.helpers import TINY_HP
from tests.test_torch_bf16_families import one_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_infer_frontend import harmonic_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ONLY_KEYS = {"widths", "seed", "device", "wall_s"}


def jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed_json(capsys) -> dict:
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def test_tiny_hp_is_the_tests_copy():
    assert e2e_acceptance.TINY_HP == TINY_HP


def test_structured_corpus_is_bit_equal_to_jaxs(tmp_path):
    jax_e2e = jax_script("e2e_acceptance")
    jax_e2e.write_structured_corpus(str(tmp_path / "jax"), n_items=5)
    e2e_acceptance.write_structured_corpus(str(tmp_path / "port"), n_items=5)
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(np.load(tmp_path / f"port/{split}_lengths.npy"),
                                      np.load(tmp_path / f"jax/{split}_lengths.npy"))
        got, ref = IndexedDataset(str(tmp_path / f"port/{split}")), \
            JIndexedDataset(str(tmp_path / f"jax/{split}"))
        assert len(got) == len(ref) > 0
        for i in range(len(ref)):
            a, b = got[i], ref[i]
            assert sorted(a) == sorted(b)
            for k in b:
                if isinstance(b[k], np.ndarray):
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                else:
                    assert a[k] == b[k], k


def _gen_dir(root) -> str:
    """A generated_* dir: [G_SEG]/[P_SEG] and [G]/[P] pairs of harmonic wavs."""
    wavs = os.path.join(root, "wavs")
    os.makedirs(wavs)
    for i in range(2):
        g, p = harmonic_wav(0.6, 120 + 30 * i, i), harmonic_wav(0.6, 128 + 30 * i, 10 + i)
        for tag, wav in (("G", g), ("P", p)):
            save_wav(wav, os.path.join(wavs, f"[{tag}_SEG]item{i}.wav"), 22050)
            save_wav(wav[::-1].copy(), os.path.join(wavs, f"[{tag}]item{i}.wav"), 22050)
    return root


def test_seg_and_full_mcd_equal_jaxs(tmp_path):
    jax_e2e = jax_script("e2e_acceptance")
    gen = _gen_dir(str(tmp_path / "generated_3_test"))
    for fn in ("seg_mcd", "full_mcd"):
        got, ref = getattr(e2e_acceptance, fn)(gen), getattr(jax_e2e, fn)(gen)
        assert np.isfinite(got) and got > 0
        np.testing.assert_allclose(got, ref, rtol=1e-12, err_msg=fn)


def test_acceptance_config_is_jaxs_but_the_card_widths(tmp_path):
    jax_e2e = jax_script("e2e_acceptance")
    for model in ("spec_denoiser", "campnet", "a3t", "editspeech", "stutter_speech"):
        assert e2e_acceptance.TASKS[model].rsplit(".", 1)[1] == \
            jax_e2e.TASKS[model].rsplit(".", 1)[1]
        cpu = e2e_acceptance.acceptance_hp(model, "D", 600, "cpu")
        card = e2e_acceptance.acceptance_hp(model, "D", 600, "cuda")
        diff = {k: (cpu[k], card[k]) for k in cpu if cpu[k] != card[k]}
        # only a family that runs DiffNet takes the kernel's widths
        assert diff == ({"hidden_size": (64, 192), "residual_channels": (32, 128)}
                        if model in ("spec_denoiser", "stutter_speech") else {}), model
    assert e2e_acceptance.FAMILY_EXTRA == jax_e2e.FAMILY_EXTRA
    assert set(e2e_acceptance.TASKS) == set(jax_e2e.TASKS)
    card = e2e_acceptance.acceptance_hp("diffspeech", "D", 600, "cuda")
    assert (card["hidden_size"], card["residual_channels"]) == (192, 128)


def _fake_runs(ckpt_root):
    """A stand-in for the training entry: ``--infer`` leaves a generated_*
    dir in the run's work dir."""
    calls = []

    def run_cli(cfg, exp, *extra):
        calls.append((exp, extra))
        if "--infer" in extra:
            os.makedirs(os.path.join(ckpt_root or "", exp, "generated_1_test", "wavs"),
                        exist_ok=True)
        return ""
    return run_cli, calls


def test_e2e_acceptance_prints_jaxs_keys(tmp_path, monkeypatch, capsys):
    scores = iter([4.0, 2.0, 4.0, 2.0])
    jax_e2e = jax_script("e2e_acceptance")
    jax_run, jax_calls = _fake_runs(os.path.join(jax_e2e.REPO, "checkpoints"))
    monkeypatch.setattr(jax_e2e, "run_cli", jax_run)
    monkeypatch.setattr(jax_e2e, "seg_mcd", lambda gen: next(scores))
    monkeypatch.setattr(sys, "argv", ["e2e", "--steps", "3", "--workdir", str(tmp_path / "j")])
    jax_e2e.main()
    ref = printed_json(capsys)
    port_run, port_calls = _fake_runs(None)
    monkeypatch.setattr(e2e_acceptance, "run_cli", port_run)
    monkeypatch.setattr(e2e_acceptance, "seg_mcd", lambda gen: next(scores))
    got = e2e_acceptance.main(["--steps", "3", "--workdir", str(tmp_path / "p"),
                               "--device", "cpu"])
    assert printed_json(capsys) == got
    assert set(got) - PORT_ONLY_KEYS == set(ref)
    assert {k: got[k] for k in ref} == ref
    assert got["pass"] is True and got["device"] == "cpu" and got["seed"] == 0
    assert got["widths"] == {"hidden_size": 64, "residual_channels": 32, "residual_layers": 4,
                             "num_heads": 2}
    assert [extra[:1] for _, extra in port_calls] == [("--reset",), ("--infer",)] * 2
    assert all(extra[-2:] == ("--device", "cpu") for _, extra in port_calls)
    assert len(jax_calls) == 4


def test_quant_quality_ab_prints_jaxs_keys(tmp_path, capsys):
    """The port's A/B on a checkpoint of seeded weights (``--reuse-workdir``):
    every key of the JAX script's JSON line, finite values."""
    wd = tmp_path / "ab"
    data_dir = str(wd / "binary")
    e2e_acceptance.write_structured_corpus(data_dir, n_items=2)
    hp = e2e_acceptance.acceptance_hp("spec_denoiser", data_dir, 2, "cpu")
    hp.update(timesteps=2)
    (wd / "cfg.yaml").write_text(dump_yaml(hp))
    torch.manual_seed(0)
    model = init_like_flax(build_model(100, hp))
    with torch.no_grad():
        model.denoise_fn.output_projection.weight.normal_(0, 0.1)
    save_checkpoint(str(wd / "checkpoints" / "quant_ab_spec_denoiser"),
                    {"model": model.state_dict()}, 2)
    got = quant_quality_ab.main(["--workdir", str(wd), "--reuse-workdir", "--device", "cpu"])
    assert printed_json(capsys) == got
    tree = ast.parse(open(os.path.join(REPO, "scripts", "quant_quality_ab.py")).read())
    dumps = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", "") == "dumps"]
    ref_keys = {k.value for k in dumps[-1].args[0].keys}
    assert set(got) - PORT_ONLY_KEYS == ref_keys
    for k in ("value", "mcd_fp32", "mcd_int8", "stoi_fp32", "stoi_int8", "max_weight_quant_err"):
        assert np.isfinite(got[k]), k
    assert 0 < got["max_weight_quant_err"] < 0.05


def test_copy_synthesis_matches_jaxs_griffin_lim(tmp_path, monkeypatch, capsys):
    in_wav = str(tmp_path / "in.wav")
    save_wav(harmonic_wav(0.5, 140, 0), in_wav, 22050)
    jax_cs = jax_script("copy_synthesis")
    monkeypatch.setattr(sys, "argv", ["cs", in_wav, str(tmp_path / "jax.wav"),
                                      "--vocoder", "griffinlim"])
    jax_cs.main()
    ref = printed_json(capsys)
    got = copy_synthesis.main([in_wav, str(tmp_path / "port.wav"), "--vocoder", "griffinlim",
                               "--device", "cpu"])
    assert printed_json(capsys) == got
    assert set(got) == set(ref)
    assert got["frames"] == ref["frames"]
    np.testing.assert_allclose(got["mel_consistency_l1"], ref["mel_consistency_l1"], atol=1e-4)
    assert open(tmp_path / "port.wav", "rb").read() == open(tmp_path / "jax.wav", "rb").read()


def test_make_example_audio_writes_jaxs_wav(tmp_path, capsys):
    jax_make = jax_script("make_example_audio")
    jax_make.main(str(tmp_path / "jax" / "demo.wav"))
    make_example_audio.main(str(tmp_path / "port" / "demo.wav"))
    out = capsys.readouterr().out
    assert "| wrote" in out
    assert open(tmp_path / "port/demo.wav", "rb").read() == \
        open(tmp_path / "jax/demo.wav", "rb").read()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a GPU")
def test_tools_refuse_without_a_gpu(tmp_path):
    in_wav = str(tmp_path / "in.wav")
    save_wav(harmonic_wav(0.2, 140, 0), in_wav, 22050)
    for call in (lambda: copy_synthesis.main([in_wav, str(tmp_path / "o.wav")]),
                 lambda: e2e_acceptance.main(["--workdir", str(tmp_path / "e")]),
                 lambda: quant_quality_ab.main(["--workdir", str(tmp_path / "q")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not glob.glob(str(tmp_path / "e" / "*"))


def test_diffspeech_denoise_mae_runs_on_a_seeded_checkpoint(tmp_path):
    data_dir = str(tmp_path / "binary")
    e2e_acceptance.write_structured_corpus(data_dir, n_items=2)
    hp = e2e_acceptance.acceptance_hp("diffspeech", data_dir, 2, "cpu")
    from speech_editing_tpu_torch.run import task_class

    model = task_class(hp["task_cls"])(hp).build_model()
    save_checkpoint(str(tmp_path / "ck"), {"model": model.state_dict()}, 1)
    mae = e2e_acceptance.diffspeech_denoise_mae(hp, str(tmp_path / "ck"))
    assert np.isfinite(mae) and mae > 0
