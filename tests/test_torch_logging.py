"""PyTorch port, the trainer's logging (the JAX trainer's): the terminal
``Tee``; the meters; TensorBoard scalars, the validation media (the first
item's mel figure and vocoded audio) read back from the event files; the
``save_codes`` snapshot; the test loop's ``plot/`` figures; and each of
them a no-op, the run unharmed, when tensorboard or matplotlib cannot be
imported (monkeypatched away)."""

import glob
import os
import sys

import numpy as np
import pytest
import torch

from speech_editing_tpu_torch.run import run
from speech_editing_tpu_torch.training.result_saver import save_test_result
from speech_editing_tpu_torch.utils.meters import AvgrageMeter, Tee, Timer, profile_trace
from tests.test_torch_tts_fs import one_thread  # noqa: F401
from tests.test_torch_tts_run import _config, corpus  # noqa: F401

LOGGED = "save_codes=True,valid_infer_interval=1,num_valid_plots=1,tb_log_interval=1"


def _events(work: str):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    files = glob.glob(os.path.join(work, "tb_logs", "events.out.tfevents.*"))
    assert files, os.listdir(work)
    accs = [EventAccumulator(f).Reload() for f in files]
    tags = {kind: set().union(*(a.Tags()[kind] for a in accs))
            for kind in ("scalars", "images", "audio")}
    return accs, tags


def test_tee_mirrors_stdout_into_its_file(tmp_path, capsys):
    fn = str(tmp_path / "log.txt")
    tee = Tee(fn)
    print("| step 1 | loss=0.5")
    tee.close()
    print("after")
    assert open(fn).read() == "| step 1 | loss=0.5\n"
    assert capsys.readouterr().out == "| step 1 | loss=0.5\nafter\n"


def test_meters_and_profile_trace(tmp_path):
    m = AvgrageMeter()
    for v, n in ((1.0, 1), (4.0, 3)):
        m.update(v, n)
    assert (m.sum, m.cnt, m.avg) == (13.0, 4, 3.25)
    with Timer("tts_test", enable=True):
        torch.ones(3).sum()
    assert Timer.timer_map["tts_test"] > 0
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert glob.glob(str(tmp_path / "trace" / "*.json"))
    with profile_trace(""):
        pass


def test_fit_logs_scalars_media_the_terminal_and_the_code(corpus, tmp_path):  # noqa: F811
    work = str(tmp_path / "fs")
    argv = ["--config", _config(corpus, "fs"), "--exp_name", work, "--device", "cpu",
            "-hp", LOGGED]
    run(argv)
    accs, tags = _events(work)
    assert {"tr/total_loss", "tr/it_per_sec", "tr/grad_norm", "val/total_loss",
            "val/l1"} <= tags["scalars"]
    assert tags["images"] == {"mel_val_0"} and tags["audio"] == {"wav_val_0"}
    steps = sorted(e.step for a in accs if "tr/total_loss" in a.Tags()["scalars"]
                   for e in a.Scalars("tr/total_loss"))
    assert steps == [1, 2]
    logs = glob.glob(os.path.join(work, "terminal_logs", "log_*.txt"))
    assert len(logs) == 1 and "| step 2 |" in open(logs[0]).read()
    assert not isinstance(sys.stdout, Tee)
    codes = glob.glob(os.path.join(work, "codes", "*", "speech_editing_tpu_torch"))
    assert len(codes) == 1
    assert os.path.exists(os.path.join(codes[0], "training", "trainer.py"))
    assert not glob.glob(os.path.join(codes[0], "**", "__pycache__"), recursive=True)


@pytest.mark.parametrize("missing", ["tensorboard", "matplotlib"])
def test_logging_is_a_noop_without_its_library(corpus, tmp_path, monkeypatch,  # noqa: F811
                                               missing):
    if missing == "tensorboard":
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    else:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    work = str(tmp_path / "fs")
    argv = ["--config", _config(corpus, "fs"), "--exp_name", work, "--device", "cpu"]
    assert run(argv + ["-hp", LOGGED]).global_step == 2
    assert glob.glob(os.path.join(work, "terminal_logs", "log_*.txt"))
    if missing == "tensorboard":
        assert not glob.glob(os.path.join(work, "tb_logs", "events.*"))
    else:
        _, tags = _events(work)
        assert "val/total_loss" in tags["scalars"] and not tags["images"]
        assert tags["audio"] == {"wav_val_0"}
    run(argv + ["--infer"])
    gen = os.path.join(work, "generated_2_test")
    assert len(glob.glob(os.path.join(gen, "wavs", "[[]P[]]*.wav"))) == 3
    assert (missing == "tensorboard") == bool(glob.glob(os.path.join(gen, "plot", "*.png")))


def test_save_test_result_draws_a_figure_only_when_asked(tmp_path):
    rs = np.random.RandomState(0)
    wav, mel = (rs.randn(40 * 256) * 0.1).astype(np.float32), rs.randn(40, 80) - 3
    os.makedirs(tmp_path / "wavs")
    hp_plot = {"hop_size": 256, "mel_vmin": -6, "mel_vmax": 1.5}
    save_test_result(wav, mel, "[P]a", str(tmp_path), 22050, True, hp_plot, "a b c",
                     np.repeat([1, 2, 3], [10, 20, 10]))
    save_test_result(wav, mel, "[G]a", str(tmp_path), 22050)
    assert sorted(os.listdir(tmp_path / "plot")) == ["[P]a.png"]
    assert sorted(os.listdir(tmp_path / "wavs")) == ["[G]a.wav", "[P]a.wav", "[P]a_mel.npy"]
