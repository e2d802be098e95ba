"""PyTorch port, HiFi-GAN's GAN training end to end on CPU: the training
entry (``speech_editing_tpu_torch.run``) on ``egs/hifigan.yaml`` at tiny
widths over a synthetic mel + wav corpus trains with sanity validation,
validates and checkpoints, resumes (both nets and both optimizers bit for
bit), and ``--infer`` writes copy-synthesis wavs of the test split; the
vocoder registry's ``HifiGAN`` loads the trained work dir and vocodes a
mel as the generator does; a port GAN checkpoint round-trips both nets
and both optimizers (the next step equal); and ``VocoderDataset``'s
crops equal the JAX package's.
"""

import os

import numpy as np
import pytest
import torch

from speech_editing_tpu.data.vocoder_dataset import VocoderDataset as JVocoderDataset
from speech_editing_tpu_torch.data.vocoder_dataset import VocoderDataset
from speech_editing_tpu_torch.infer.vocoder import HifiGAN
from speech_editing_tpu_torch.run import run
from speech_editing_tpu_torch.training.checkpoint import get_last_checkpoint, load_checkpoint
from speech_editing_tpu_torch.training.tasks.hifigan import HifiGanTask
from speech_editing_tpu_torch.training.trainer import Trainer
from tests.helpers import TINY_VOC_HP, write_voc_corpus
from tests.test_torch_data import assert_same
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

REPO = __file__.rsplit("/tests/", 1)[0]
TINY = dict({k: v for k, v in TINY_VOC_HP.items() if k != "vocab_size"},
            disc_periods=[2, 3], msd_scales=2, max_sentences=2, max_valid_sentences=2,
            max_tokens=None, num_sanity_val_steps=1, eval_max_batches=1, tb_log_interval=1,
            val_check_interval=2, test_num=2, ds_workers=0, test_save_workers=1,
            vocoder="GriffinLim", save_gt=False)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("voc"))
    write_voc_corpus(d, np.random.RandomState(0))
    return d


@pytest.fixture(scope="module")
def corpus_256(tmp_path_factory):
    """Items at ``egs/hifigan.yaml``'s hop of 256 samples."""
    d = str(tmp_path_factory.mktemp("voc256"))
    write_voc_corpus(d, np.random.RandomState(1), hop=256)
    return d


# egs/hifigan.yaml as shipped (ResBlock1, upsampling 8·8·2·2) at tiny widths:
# 32 initial channels, periods 2 and 3, two scales, 2048-sample crops
TINY_HP = ("upsample_initial_channel=32,disc_periods=[2,3],msd_scales=2,max_samples=2048,"
           "max_sentences=2,max_valid_sentences=2,num_sanity_val_steps=1,eval_max_batches=1,"
           "tb_log_interval=1,val_check_interval=2,test_num=2,ds_workers=0,"
           "test_save_workers=1,vocoder=GriffinLim,save_gt=False")


def test_run_trains_validates_resumes_and_infers(tmp_path, corpus_256):
    """``run --config egs/hifigan.yaml`` with a tiny ``-hp``: trains with
    sanity validation, validates and checkpoints, resumes, infers."""
    work = str(tmp_path / "voc")
    entry = ["--config", os.path.join(REPO, "egs/hifigan.yaml"), "--exp_name", work,
             "--device", "cpu"]
    hp = f"binary_data_dir={corpus_256},{TINY_HP}"
    first = run(entry + ["-hp", hp + ",max_updates=3"])
    assert isinstance(first.task, HifiGanTask) and first.global_step == 3
    path, steps = get_last_checkpoint(work)
    # beside the trainer's logs (terminal_logs/, tb_logs/)
    assert steps == 3 and sorted(f for f in os.listdir(work) if not f.endswith("_logs")) == [
        "config.yaml", "model_ckpt_steps_2.ckpt", "model_ckpt_steps_3.ckpt"]
    saved = load_checkpoint(path)["state"]
    assert set(saved) == {"model", "disc", "gen_opt", "disc_opt", "step"}
    assert saved["step"] == 3 and len(saved["disc_opt"]["state"]) > 0

    resumed = Trainer(first.task, dict(first.hp, max_updates=5), device="cpu")
    resumed._build_state()
    for key in ("model", "disc"):
        for k, v in saved[key].items():
            assert torch.equal(resumed.train_step.state_dict()[key][k], v), k
    for key in ("gen_opt", "disc_opt"):
        got = resumed.train_step.state_dict()[key]["state"]
        for i, s in saved[key]["state"].items():
            for k, v in s.items():
                assert torch.equal(got[i][k], v), (key, i, k)
    second = run(entry + ["-hp", hp + ",max_updates=5"])
    assert second.global_step == 5 and get_last_checkpoint(work)[1] == 5

    tester = run(entry + ["--infer", "-hp", hp])
    gen_dir = os.path.join(work, "generated_5_test")
    wavs = sorted(os.listdir(os.path.join(gen_dir, "wavs")))
    assert [w for w in wavs if w.endswith(".wav")] == ["[P]v0.wav", "[P]v1.wav"]
    assert tester.global_step == 5

    # the trained work dir as a vocoder: the generator found where it is read
    vocoder = HifiGAN(dict(second.hp, vocoder_ckpt=work), device="cpu")
    assert vocoder.kind == "hifigan"
    mel = np.random.RandomState(2).randn(20, 80).astype(np.float32) - 2
    with torch.no_grad():
        direct = second.model.eval()(torch.tensor(mel)[None])[0].numpy()
    np.testing.assert_array_equal(vocoder.spec2wav(mel), direct)


def test_port_gan_checkpoint_round_trips(tmp_path, corpus):
    """Both nets and both optimizers through ``save`` and a resume: the
    next step of each trainer gives the same metrics and weights."""
    hp = dict(TINY, binary_data_dir=corpus, work_dir=str(tmp_path / "w"))
    a = Trainer(HifiGanTask(hp), hp, device="cpu")
    with a._loader("train", shuffle=True) as loader:
        batches = [b for _, b in zip(range(2), loader)]
    a.step(batches[0])
    a.save()
    b = Trainer(HifiGanTask(dict(hp, seed=99)), dict(hp, seed=99), device="cpu")
    b._build_state()
    assert b.global_step == a.global_step == 1
    ma, mb = a.step(batches[1]), b.step(batches[1])
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for net in ("model", "disc"):
        for (n, p), q in zip(getattr(a, net).named_parameters(),
                             getattr(b, net).parameters()):
            assert torch.equal(p, q), n


@pytest.mark.parametrize("prefix", ["train", "test"])
def test_vocoder_crops_match_jax(corpus, prefix):
    """The training crops (``max_samples // hop`` frames at the item rng's
    offset, the wav cut to match) and the test split's items (all but the
    last frame), over two epochs."""
    hp = dict(TINY_VOC_HP, binary_data_dir=corpus, max_samples=4096)
    port, ref = VocoderDataset(prefix, hp, shuffle=True), JVocoderDataset(prefix, hp,
                                                                          shuffle=True)
    assert port.avail_idxs == ref.avail_idxs and port.sizes == ref.sizes
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        idx = list(port.ordered_indices())
        got = port.collater([port[i] for i in idx])
        want = ref.collater([ref[i] for i in idx])
        assert_same(got, want, f"{prefix} epoch {epoch}")
    if prefix == "train":
        crop = hp["max_samples"] // hp["hop_size"]
        assert got["mels"].shape[1] == crop and got["wavs"].shape[1] == crop * hp["hop_size"]
        assert len(port) < 6                    # items too short to crop are left out
