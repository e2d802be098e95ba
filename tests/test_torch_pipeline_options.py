"""PyTorch port, the binarizer's options against the JAX package on CPU,
through each package's preprocess and ``align_and_binarize`` with
``--skip-align`` as in ``test_torch_pipeline.py``: ``trim_eos_bos`` (with
the wav kept, which it trims too), ``with_f0cwt``, ``with_wav``, and a
``stutter_set`` corpus (its ``metadata.csv`` and ``video_spk.txt`` meta
loader, frame labels from ``stutter_labels/``)."""

import os

import numpy as np
import pytest

from speech_editing_tpu.data.indexed_dataset import IndexedDataset as JIndexedDataset
from speech_editing_tpu_torch.utils.audio.io import save_wav
from tests.test_torch_bf16_families import one_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_pipeline import (BINARY, HP, PROCESSED, TEXTS, compare_outputs,
                                       run_pipeline, tone, write_vctk)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("raw") / "vctk")
    write_vctk(d)
    return d


@pytest.mark.parametrize("option", [{"trim_eos_bos": True, "with_wav": True},
                                    {"with_f0cwt": True}, {"with_wav": True}],
                         ids=["trim_eos_bos", "with_f0cwt", "with_wav"])
def test_binarizer_options_match_jax(raw, tmp_path, monkeypatch, option):
    monkeypatch.delenv("VOICE_ENCODER_CKPT", raising=False)
    hp = dict(HP, raw_data_dir=raw, **option)
    jroot = run_pipeline("jax", str(tmp_path / "jax"), hp, monkeypatch)
    troot = run_pipeline("port", str(tmp_path / "port"), hp, monkeypatch)
    assert compare_outputs(jroot, troot) == 8
    item = JIndexedDataset(os.path.join(troot, BINARY, "train"))[0]
    assert ("wav" in item) == bool(option.get("with_wav"))
    assert ("cwt_spec" in item) == bool(option.get("with_f0cwt"))
    if option.get("trim_eos_bos"):
        assert len(item["mel2ph"]) == len(item["mel"]) == item["len"] == len(item["f0"])


def write_stutter_set(raw, seconds=1.2):
    """``TEXTS`` as a stutter_set corpus: ``metadata.csv`` rows ``wav|text``,
    ``video_spk.txt`` mapping the names' first 13 characters (the video) to
    a speaker; two videos, three utterances each."""
    os.makedirs(f"{raw}/wavs", exist_ok=True)
    rows, names = [], []
    for i, txt in enumerate(TEXTS):
        name = f"vid{i // 3:010d}_u{i:02d}"
        save_wav(tone(seconds, 140 + 25 * i, i), f"{raw}/wavs/{name}.wav", 22050)
        rows.append(f"{raw}/wavs/{name}.wav|{txt}\n")
        names.append(name)
    with open(f"{raw}/metadata.csv", "w") as f:
        f.writelines(rows)
    with open(f"{raw}/video_spk.txt", "w") as f:
        f.writelines(f"vid{v:010d} spk{v}\n" for v in range(2))
    return names


def test_stutter_set_corpus_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("VOICE_ENCODER_CKPT", raising=False)
    raw = str(tmp_path / "raw" / "stutter_set")
    names = write_stutter_set(raw)

    def labels():
        """Labelled spans (seconds, type) for every item but the last."""
        rs = np.random.RandomState(0)
        for name in names[:-1]:
            d = f"{PROCESSED}/stutter_labels/{name[:17]}"
            os.makedirs(d, exist_ok=True)
            starts = np.sort(rs.uniform(0, 1.0, 2))
            spans = [[s, s + rs.uniform(0.05, 0.2), rs.randint(0, 3)] for s in starts]
            np.save(f"{d}/{name}.npy", np.asarray(spans))

    hp = dict(HP, ds_name="stutter_set", raw_data_dir=raw)
    jroot = run_pipeline("jax", str(tmp_path / "jax"), hp, monkeypatch, before_binarize=labels)
    troot = run_pipeline("port", str(tmp_path / "port"), hp, monkeypatch,
                         before_binarize=labels)
    assert compare_outputs(jroot, troot) == 8
    items = [JIndexedDataset(os.path.join(troot, BINARY, "train"))[i] for i in range(4)]
    assert all(len(it["stutter_mel_mask"]) == it["len"] for it in items)
    assert any(it["stutter_mel_mask"].any() for it in items)
    assert {it["spk_name"] for it in items} == {"spk0\n", "spk1\n"}
