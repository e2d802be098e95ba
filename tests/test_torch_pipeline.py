"""PyTorch port, the offline data pipeline against the JAX package on
CPU: the raw corpus of ``tests/test_pipeline.py`` (with its TextGrids in
place of the aligner's) goes through each package's preprocess and
``align_and_binarize`` with ``--skip-align``, each in a directory of its
own under the same relative paths, and the outputs are compared:
``metadata.json``, the maps, the ``.lab`` files and ``mfa_dict.txt`` and
the lengths files identical; every item's integer fields identical, its
float arrays within 1e-6 (``spk_embed`` within 1e-5). Here the spectral
fallback embedding and the voice encoder (``VOICE_ENCODER_CKPT``, one
resemblyzer-format checkpoint for both), the port's spawned worker pools,
the corpus read across (each package's ``EditingDataset`` on the other's
output), a CPU training step of the shipped config on the port's corpus,
and the entry points' refusal to run without a GPU unless asked. The
binarizer's options are in ``test_torch_pipeline_options.py``."""

import json
import os

import numpy as np
import pytest
import torch

import speech_editing_tpu.data.binarizer as jbin
from speech_editing_tpu.data.align_and_binarize import align_and_binarize as j_align_and_binarize
from speech_editing_tpu.data.datasets import EditingDataset as JEditingDataset
from speech_editing_tpu.data.indexed_dataset import IndexedDataset as JIndexedDataset
from speech_editing_tpu.data.preprocess import BasePreprocessor as JPreprocessor
from speech_editing_tpu.utils.multiprocess import multiprocess_run_tqdm as j_run_tqdm
from speech_editing_tpu_torch.data import align_and_binarize as t_ab
from speech_editing_tpu_torch.data.datasets import EditingDataset
from speech_editing_tpu_torch.data.preprocess import BasePreprocessor
from speech_editing_tpu_torch.models.voice_encoder import seeded_state_dict
from speech_editing_tpu_torch.utils.audio.io import save_wav
from speech_editing_tpu_torch.utils.text.text_encoder import is_sil_phoneme
from tests.test_pipeline import _write_textgrid
from tests.test_torch_bf16_families import one_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_data import assert_same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 22050
TEXTS = ["hello world", "speech editing works", "one two three", "this is data",
         "more audio here", "final test case"]
PROCESSED, BINARY = "data/processed/corpus", "data/binary/corpus"
HP = {"ds_name": "vctk", "processed_data_dir": PROCESSED, "binary_data_dir": BINARY,
      "use_mfa": True, "num_spk": 10, "with_spk_embed": True, "valid_range": [0, 2],
      "test_range": [0, 2], "train_range": [2, -1], "min_mel_length": 10}
DS_HP = {"binary_data_dir": BINARY, "use_spk_embed": True, "use_spk_id": False,
         "use_pitch_embed": True, "infer": False, "max_frames": 200, "max_input_tokens": 80,
         "seed": 1, "mask_type": "alignment_aware", "training_mask_ratio": 0.8,
         "sort_by_len": True, "test_ids": [], "min_frames": 0, "frames_multiple": 1}


def tone(seconds, f0, seed):
    """Three partials of ``f0`` over a little noise, float32."""
    rs = np.random.RandomState(seed)
    t = np.arange(int(SR * seconds)) / SR
    wav = sum(0.3 / k * np.sin(2 * np.pi * f0 * k * t) for k in (1, 2, 3))
    return (wav + 0.003 * rs.randn(len(t))).astype(np.float32)


def write_vctk(raw, seconds=1.2):
    """``TEXTS`` as a vctk corpus of two speakers (``wav48/<spk>``, ``txt/<spk>``)."""
    for i, txt in enumerate(TEXTS):
        spk = f"p{225 + i % 2}"
        os.makedirs(f"{raw}/wav48/{spk}", exist_ok=True)
        os.makedirs(f"{raw}/txt/{spk}", exist_ok=True)
        save_wav(tone(seconds, 150 + 30 * i, i), f"{raw}/wav48/{spk}/utt{i}.wav", SR)
        with open(f"{raw}/txt/{spk}/utt{i}.txt", "w") as f:
            f.write(txt)


def write_textgrids(seconds=1.2):
    """The aligner's output for the preprocessed items: each item's phones
    spread evenly, silences unlabelled."""
    with open(f"{PROCESSED}/metadata.json") as f:
        meta = json.load(f)
    os.makedirs(f"{PROCESSED}/mfa_outputs", exist_ok=True)
    for it in meta:
        _write_textgrid(f"{PROCESSED}/mfa_outputs/{it['item_name']}.TextGrid",
                        [p if not is_sil_phoneme(p) else "" for p in it["ph"].split(" ")],
                        total_sec=seconds)


def _jax_in_process(fn, args, num_workers=None, **kw):
    """JAX's pool, run in process: its speaker pass forks two workers
    whatever ``N_PROC`` says, and a forked child of this process would run
    JAX (the voice encoder's jit) after the parent has."""
    return j_run_tqdm(fn, args, num_workers=1, **kw)


def run_pipeline(package, root, hp, monkeypatch, before_binarize=None, seconds=1.2):
    """Preprocess, the TextGrids, then ``align_and_binarize(skip_align)``
    of ``package`` ("jax" or "port") in ``root``; returns ``root``."""
    os.makedirs(root, exist_ok=True)
    monkeypatch.chdir(root)
    monkeypatch.setenv("N_PROC", "1")
    monkeypatch.setattr(jbin, "multiprocess_run_tqdm", _jax_in_process)
    (JPreprocessor if package == "jax" else BasePreprocessor)(dict(hp)).process()
    write_textgrids(seconds)
    if before_binarize is not None:
        before_binarize()
    if package == "jax":
        j_align_and_binarize(dict(hp), skip_align=True)
    else:
        t_ab.main(["--config", write_config(hp), "--skip-align", "--device", "cpu"])
    return root


def write_config(hp):
    from speech_editing_tpu_torch.config.hparams import dump_yaml

    with open("pipeline.yaml", "w") as f:
        f.write(dump_yaml(hp))
    return "pipeline.yaml"


def _files(root, sub):
    out = {}
    for d, _, fs in os.walk(os.path.join(root, sub)):
        for f in fs:
            if f.endswith((".json", ".txt", ".lab", ".npy")):
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _same_value(got, ref, where):
    if isinstance(ref, np.ndarray) and ref.dtype.kind == "f":
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype, where
        tol = 1e-5 if where.endswith("spk_embed") else 1e-6
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0, err_msg=where)
    elif isinstance(ref, float):
        assert type(got) is float and abs(got - ref) <= 1e-6, where
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype, where
        np.testing.assert_array_equal(got, ref, err_msg=where)
    else:
        assert got == ref and type(got) is type(ref), where


def compare_outputs(jroot, troot):
    """The two packages' processed and binary directories, as the module
    doc says; returns the number of items compared."""
    jfiles, tfiles = _files(jroot, "data"), _files(troot, "data")
    assert sorted(jfiles) == sorted(tfiles)
    assert any(k.endswith(".lab") for k in jfiles) and any(
        k.endswith("_lengths.npy") for k in jfiles)
    for k in jfiles:
        if k.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(troot, k)),
                                          np.load(os.path.join(jroot, k)), err_msg=k)
        else:
            assert tfiles[k] == jfiles[k], k
    n = 0
    for split in ("valid", "test", "train"):
        ref = JIndexedDataset(os.path.join(jroot, BINARY, split))
        got = JIndexedDataset(os.path.join(troot, BINARY, split))
        assert len(got) == len(ref) > 0
        for i in range(len(ref)):
            a, b = got[i], ref[i]
            assert sorted(a) == sorted(b), (split, i)
            for k in b:
                _same_value(a[k], b[k], f"{split}[{i}].{k}")
            n += 1
    return n


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("raw") / "vctk")
    write_vctk(d)
    return d


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ve") / "pretrained.pt")
    torch.save({"model_state": seeded_state_dict(torch.Generator().manual_seed(5))}, path)
    return path


@pytest.mark.parametrize("embed", ["fallback", "voice_encoder"])
def test_preprocess_and_binarize_match_jax(raw, checkpoint, tmp_path, monkeypatch, embed):
    if embed == "voice_encoder":
        monkeypatch.setenv("VOICE_ENCODER_CKPT", checkpoint)
    else:
        monkeypatch.delenv("VOICE_ENCODER_CKPT", raising=False)
    hp = dict(HP, raw_data_dir=raw)
    jroot = run_pipeline("jax", str(tmp_path / "jax"), hp, monkeypatch)
    troot = run_pipeline("port", str(tmp_path / "port"), hp, monkeypatch)
    assert compare_outputs(jroot, troot) == 8
    emb = JIndexedDataset(os.path.join(troot, BINARY, "train"))[0]["spk_embed"]
    fallback = np.count_nonzero(emb[160:]) == 0      # the spectral stats' zero tail
    assert fallback == (embed == "fallback")


def test_spawned_binarize_workers_give_the_same_corpus(raw, tmp_path, monkeypatch):
    """``N_PROC=2``: the port's per-item binarize pass in two spawned
    workers gives the corpus of ``N_PROC=1`` (the train split's four items;
    a split of one item runs in process)."""
    monkeypatch.delenv("VOICE_ENCODER_CKPT", raising=False)
    hp = dict(HP, raw_data_dir=raw, valid_range=[0, 1], test_range=[0, 1])
    one = run_pipeline("port", str(tmp_path / "one"), hp, monkeypatch)
    two = run_pipeline("port", str(tmp_path / "two"), hp, monkeypatch,
                       before_binarize=lambda: monkeypatch.setenv("N_PROC", "2"))
    assert compare_outputs(one, two) == 6


def test_multiprocess_run_tqdm_matches_jax():
    """Two spawned workers, each with its ``init_ctx_func`` context, give
    JAX's in-process results in order (a failing job: ``None``)."""
    from speech_editing_tpu_torch.utils.multiprocess import multiprocess_run_tqdm
    from tests.pool_jobs import ctx, job

    args = [{"x": x} for x in range(6)]
    ref = dict((i, r if r is None else r[0]) for i, r in
               j_run_tqdm(job, args, num_workers=1, init_ctx_func=ctx))
    got = list(multiprocess_run_tqdm(job, args, num_workers=2, init_ctx_func=ctx))
    assert [i for i, _ in got] == list(range(6))
    assert {i: r if r is None else r[0] for i, r in got} == ref
    pids = {r[1] for _, r in got if r is not None}
    assert 1 <= len(pids) <= 2 and os.getpid() not in pids


@pytest.fixture(scope="module")
def corpora(raw, checkpoint, tmp_path_factory):
    """(JAX root, port root), binarized with the voice encoder."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("VOICE_ENCODER_CKPT", checkpoint)
        tmp = tmp_path_factory.mktemp("corpora")
        hp = dict(HP, raw_data_dir=raw)
        roots = (run_pipeline("jax", str(tmp / "jax"), hp, mp),
                 run_pipeline("port", str(tmp / "port"), hp, mp))
    finally:
        mp.undo()
    return roots


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_packages_dataset_reads_the_others_corpus(corpora, writer):
    root = corpora[0 if writer == "jax" else 1]
    hp = dict(DS_HP, binary_data_dir=os.path.join(root, BINARY))
    port, ref = EditingDataset("train", hp), JEditingDataset("train", hp)
    assert len(port) == len(ref) == 4
    for i in range(len(ref)):
        item = port[i]
        assert_same(item, ref[i], f"{writer} item {i}")
        assert item["spk_embed"].shape == (256,) and (item["f0"] != 0).any()
    assert_same(port.collater([port[0], port[1]]), ref.collater([ref[0], ref[1]]))


def test_the_shipped_config_steps_on_the_ports_corpus(corpora, tmp_path):
    """One CPU step of ``egs/spec_denoiser.yaml`` as shipped (conv encoder,
    ``use_spk_embed: true``, bf16) on the port-binarized corpus."""
    from speech_editing_tpu_torch.run import run

    data = os.path.join(corpora[1], BINARY)
    trainer = run(["--config", os.path.join(REPO, "egs", "spec_denoiser.yaml"), "--exp_name",
                   str(tmp_path / "exp"), "--device", "cpu", "-hp",
                   f"binary_data_dir={data},max_updates=1,ds_workers=0,"
                   "num_sanity_val_steps=0,val_check_interval=1000"])
    assert trainer.hp["use_spk_embed"] is True and trainer.hp["encoder_type"] == "conv"
    assert trainer.global_step == 1


def test_entry_points_refuse_the_cpu_unless_asked(raw, tmp_path, monkeypatch):
    from speech_editing_tpu_torch.data.binarizer import BaseBinarizer
    from speech_editing_tpu_torch.data.binarizer import main as binarizer_main

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.chdir(tmp_path)
    config = write_config(dict(HP, raw_data_dir=raw))
    for call in (lambda: BaseBinarizer(dict(HP)), lambda: binarizer_main(["--config", config]),
                 lambda: t_ab.main(["--config", config, "--skip-align"]),
                 lambda: t_ab.align_and_binarize(dict(HP), skip_align=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not os.path.exists(PROCESSED)
