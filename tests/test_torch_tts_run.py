"""PyTorch port, the TTS baselines through their entry points on the CPU:
``run`` on ``egs/fs.yaml``, ``egs/fs2_orig.yaml`` and ``egs/diffspeech.yaml``
(as shipped but for tiny widths and 4 diffusion steps) over a tiny
binarized corpus with the binarizer's CWT targets: two steps with a
validation and a checkpoint, ``--validate``, ``--infer`` (``[P]``/``[G]``
wavs, their figures in ``plot/``, ``meta.csv``), and ``tts_infer.main``
synthesising one sentence from text (the fallback g2p's phones) into a
wav."""

import csv
import json
import os

import numpy as np
import pytest
import torch

from speech_editing_tpu.data.indexed_dataset import IndexedDatasetBuilder
from speech_editing_tpu_torch.config.hparams import dump_yaml
from speech_editing_tpu_torch.infer.tts_infer import (DiffSpeechInfer, FastSpeechInfer,
                                                      FS2OrigInfer, infer_cls_for)
from speech_editing_tpu_torch.infer.tts_infer import main as tts_main
from speech_editing_tpu_torch.models.vocoder.hifigan import HifiGanGenerator
from speech_editing_tpu_torch.run import run
from speech_editing_tpu_torch.training.checkpoint import save_checkpoint
from speech_editing_tpu_torch.utils.audio.cwt import f0_to_cwt
from speech_editing_tpu_torch.utils.audio.io import load_wav
from speech_editing_tpu_torch.utils.init import init_like_flax
from tests.helpers import TINY_HP, synth_corpus_items
from tests.test_torch_family_run import VHP
from tests.test_torch_tts_fs import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the corpus's phones, then the fallback g2p's phones of "hello world"
PHONES = ["|", ",", "<BOS>", "<EOS>", "HH", "EH1", "L", "AA1", "W", "AO1", "R", "D"]
TASKS = {"fs": ("FastSpeechTask", FastSpeechInfer),
         "fs2_orig": ("FastSpeech2OrigTask", FS2OrigInfer),
         "diffspeech": ("DiffSpeechTask", DiffSpeechInfer)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three splits of 6 synthetic items with ``cwt_spec``/``cwt_mean``/
    ``cwt_std`` as the binarizer writes them under ``with_f0cwt``, and a
    tiny HiFi-GAN."""
    d = tmp_path_factory.mktemp("tts_run")
    data = d / "data"
    os.makedirs(data)
    (data / "phone_set.json").write_text(json.dumps(PHONES))
    rs = np.random.RandomState(0)
    for split in ("train", "valid", "test"):
        items = synth_corpus_items(rs, 6)
        builder = IndexedDatasetBuilder(str(data / split))
        for item in items:
            cwt = f0_to_cwt(np.asarray(item["f0"], np.float32))
            builder.add_item(dict(item, cwt_spec=cwt["cwt_spec"], cwt_mean=cwt["cwt_mean"],
                                  cwt_std=cwt["cwt_std"]))
        builder.finalize()
        np.save(str(data / f"{split}_lengths.npy"), np.asarray([len(it["mel"]) for it in items]))
    torch.manual_seed(0)
    save_checkpoint(str(d / "voc"), {"model": init_like_flax(HifiGanGenerator(VHP)).state_dict()},
                    1)
    (d / "voc" / "config.yaml").write_text(dump_yaml(VHP))
    return d


def _config(d, name: str) -> str:
    cfg = dict(TINY_HP, base_config=os.path.join(REPO, "egs", f"{name}.yaml"),
               encoder_type="fft", decoder_type="fft", binary_data_dir=str(d / "data"),
               max_updates=2, val_check_interval=2, num_sanity_val_steps=0,
               eval_max_batches=1, tb_log_interval=1, max_sentences=3, ds_workers=0,
               vocoder="HifiGAN", vocoder_ckpt=str(d / "voc"), test_save_workers=1,
               test_num=3, max_frames=128)
    path = d / f"{name}.yaml"
    path.write_text(dump_yaml(cfg))
    return str(path)


@pytest.mark.parametrize("name", list(TASKS))
def test_tts_config_trains_validates_infers_and_synthesises(corpus, tmp_path, name):
    task_name, infer_cls = TASKS[name]
    cfg, work = _config(corpus, name), str(tmp_path / name)
    argv = ["--config", cfg, "--exp_name", work, "--device", "cpu"]
    trainer = run(argv)
    assert type(trainer.task).__name__ == task_name and trainer.global_step == 2
    assert trainer.hp["encoder_type"] == trainer.hp["decoder_type"] == "fft"
    assert os.path.exists(os.path.join(work, "model_ckpt_steps_2.ckpt"))
    assert run(argv + ["--validate"]).global_step == 2
    run(argv + ["--infer"])
    gen = os.path.join(work, "generated_2_test")
    wavs = sorted(os.listdir(os.path.join(gen, "wavs")))
    assert len([w for w in wavs if w.startswith("[P]") and w.endswith(".wav")]) == 3
    assert len([w for w in wavs if w.startswith("[G]")]) == 3
    assert len([p for p in os.listdir(os.path.join(gen, "plot")) if p.endswith(".png")]) == 6
    with open(os.path.join(gen, "meta.csv")) as f:
        assert len(list(csv.reader(f))) == 4
    assert infer_cls_for(trainer.hp) is infer_cls
    out = str(tmp_path / "hello.wav")
    assert tts_main(argv[:4] + ["--text", "hello world", "--out", out, "--device", "cpu"]) == out
    wav, sr = load_wav(out)
    assert sr == 22050 and len(wav) > 256 and np.isfinite(wav).all()
