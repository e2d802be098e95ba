"""PyTorch port, a two-step ``run`` and ``--infer`` on the CPU for
StutterSpeech and CampNet (``egs/stutter_speech.yaml`` and
``egs/campnet.yaml`` at tiny widths) over a tiny binarized corpus with
per-frame stutter labels: two steps with validation and a checkpoint,
one validation batch's losses equal to the JAX package's eval step (rtol
1e-4, the same diffusion draws), then ``--infer`` writes the wavs, the
``[P]`` mels and ``meta.csv``, with every frame outside the dataset's mask
the ground truth's; and ``egs/stutter_predictor.yaml`` warm-started from
the StutterSpeech run's checkpoint (its text encoder that checkpoint's
``fs.encoder`` bit for bit), whose ``--infer`` writes each item's block
labels into ``meta.csv``."""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.data.indexed_dataset import IndexedDatasetBuilder
from speech_editing_tpu.training.tasks.campnet import CampNetTask as JCampNetTask
from speech_editing_tpu.training.tasks.stutter_speech import \
    StutterSpeechTask as JStutterTask
from speech_editing_tpu.training.train_state import make_eval_step as j_make_eval_step
from speech_editing_tpu.utils.convert_torch_ckpt import (convert_campnet,
                                                         convert_stutter_gaussian_diffusion)
from speech_editing_tpu_torch.config.hparams import dump_yaml
from speech_editing_tpu_torch.models.vocoder.hifigan import HifiGanGenerator
from speech_editing_tpu_torch.run import run
from speech_editing_tpu_torch.training.checkpoint import save_checkpoint
from speech_editing_tpu_torch.training.trainer import Trainer
from speech_editing_tpu_torch.utils.init import init_like_flax
from tests.helpers import TINY_HP, VOCAB, synth_corpus_items
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PHONES = ["|", ",", "sil"] + [f"P{i}" for i in range(VOCAB - 6)]
VHP = {"upsample_rates": [8, 8, 4], "upsample_kernel_sizes": [16, 16, 8],
       "upsample_initial_channel": 32, "resblock": "2", "resblock_kernel_sizes": [3],
       "resblock_dilation_sizes": [[1, 3]]}
N_ITEMS = 6


def write_labelled_corpus(data_dir: str, rs: np.random.RandomState) -> None:
    """The test helpers' synthetic items (40-79 frames, most lengths not a
    multiple of 16) with per-frame stutter labels: 0 fluent, 1 in spans of
    2-5 frames."""
    os.makedirs(data_dir)
    (open(os.path.join(data_dir, "phone_set.json"), "w")).write(json.dumps(PHONES))
    for split in ("train", "valid", "test"):
        items = synth_corpus_items(rs, N_ITEMS)
        builder = IndexedDatasetBuilder(os.path.join(data_dir, split))
        for item in items:
            t = len(item["mel"])
            lab = np.zeros(t, np.int64)
            for start in rs.choice(t, 2, replace=False):
                lab[start:start + rs.randint(2, 6)] = 1
            builder.add_item(dict(item, stutter_mel_mask=lab))
        builder.finalize()
        np.save(os.path.join(data_dir, f"{split}_lengths.npy"),
                np.asarray([len(it["mel"]) for it in items]))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("family_run")
    write_labelled_corpus(str(d / "data"), np.random.RandomState(0))
    torch.manual_seed(0)
    save_checkpoint(str(d / "voc"), {"model": init_like_flax(HifiGanGenerator(VHP)).state_dict()},
                    1)
    (d / "voc" / "config.yaml").write_text(dump_yaml(VHP))
    return d


def _config(d, family: str) -> str:
    cfg = dict(TINY_HP, base_config=os.path.join(REPO, "egs", f"{family}.yaml"), decoder_type="fft",
               binary_data_dir=str(d / "data"), max_updates=2, val_check_interval=2,
               num_sanity_val_steps=0, eval_max_batches=1, tb_log_interval=1,
               max_sentences=3, ds_workers=0, vocoder="HifiGAN", vocoder_ckpt=str(d / "voc"),
               test_save_workers=1, test_num=3)
    if family == "stutter_predictor":   # the config's frames_multiple: 16 holds
        del cfg["frames_multiple"]
    path = d / f"{family}.yaml"
    path.write_text(dump_yaml(cfg))
    return str(path)


def _eval_matches_jax(trainer, jtask_cls, convert, rng_draws):
    """One validation batch: the port's eval step equals the JAX package's
    with the same draws."""
    with trainer._loader("valid", shuffle=False, max_sentences_key="max_valid_sentences") \
            as loader:
        raw = next(iter(loader))
    keys = trainer.task.effective_batch_keys()
    hp = trainer.hp
    sd = {k: v.detach().numpy() for k, v in trainer.model.state_dict().items()}
    jtask = jtask_cls(hp)
    j_eval = j_make_eval_step(jtask.make_loss_fn(jtask.build_model(), train=False))
    rng = jax.random.PRNGKey(3)
    jb = {k: jnp.asarray(raw[k].astype(np.int32) if raw[k].dtype == np.int64 else raw[k])
          for k in keys}
    ref = j_eval(convert(sd, hp), jb, rng)
    got = trainer.eval_step(trainer._device_batch(raw), **rng_draws(rng, raw, hp))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _diffusion_draws(rng, raw, hp):
    k_t, k_noise = jax.random.split(jax.random.split(rng)[0])
    t = jax.random.randint(k_t, (len(raw["id"]),), 0, hp["timesteps"] + 1)
    noise = jax.random.normal(k_noise, raw["mels"].shape, jnp.float32)
    return dict(t=torch.tensor(np.asarray(t)).long(), noise=torch.tensor(np.asarray(noise)))


@pytest.mark.parametrize("family", ["stutter_speech", "campnet"])
def test_two_step_run_and_infer_on_the_cpu(corpus, family, capsys):
    config, exp = _config(corpus, family), str(corpus / f"exp_{family}")
    argv = ["--config", config, "--exp_name", exp, "--device", "cpu"]
    trainer = run(argv)
    out = capsys.readouterr().out
    assert trainer.global_step == 2 and "| step 2 |" in out
    assert "| validation @ step 2:" in out
    assert os.path.exists(os.path.join(exp, "model_ckpt_steps_2.ckpt"))
    if family == "stutter_speech":
        assert type(trainer.task).__name__ == "StutterSpeechTask"
        assert "stutter_mel_masks" in trainer.task.effective_batch_keys()
        _eval_matches_jax(trainer, JStutterTask, convert_stutter_gaussian_diffusion,
                          _diffusion_draws)
    else:
        _eval_matches_jax(trainer, JCampNetTask, convert_campnet, lambda *a: {})
    tester = run(argv + ["--infer"])
    out = capsys.readouterr().out
    gen_dir = os.path.join(exp, "generated_2_test")
    assert tester.global_step == 2 and f"| test done: 3 items -> {gen_dir}" in out
    with open(os.path.join(gen_dir, "meta.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["item_name", "wav_fn_pred", "wav_fn_gt"] and len(rows) == 4
    with tester._loader("test", shuffle=False, max_sentences_key="max_valid_sentences") \
            as loader:
        raw = next(iter(loader))
    name = raw["item_name"][0]
    t_len = int(raw["mel_lengths"][0])
    mel = np.load(os.path.join(gen_dir, "wavs", f"[P]{name}_mel.npy"))
    keep = np.asarray(raw["time_mel_masks"])[0, :t_len] == 0
    assert mel.shape == (t_len, 80) and np.isfinite(mel).all()
    np.testing.assert_array_equal(mel[keep], np.asarray(raw["mels"])[0, :t_len][keep])
    assert not np.array_equal(mel[~keep], np.asarray(raw["mels"])[0, :t_len][~keep])
    for prefix in ("[P]", "[G]", "[P_SEG]", "[G_SEG]"):
        assert os.path.exists(os.path.join(gen_dir, "wavs", f"{prefix}{name}.wav"))


def test_predictor_run_warm_starts_and_writes_its_block_labels(corpus, capsys):
    """``egs/stutter_predictor.yaml`` with ``spec_denoiser_work_dir`` the
    StutterSpeech run's work dir: its ``txt_encoder`` starts as that
    checkpoint's ``fs.encoder``; ``--infer`` writes each item's block labels
    (one a 16 frames) into ``meta.csv`` and its ground-truth mel."""
    editor = str(corpus / "exp_stutter_speech")
    if not os.path.exists(os.path.join(editor, "model_ckpt_steps_2.ckpt")):
        run(["--config", _config(corpus, "stutter_speech"), "--exp_name", editor,
             "--device", "cpu"])
    exp = str(corpus / "exp_stutter_predictor")
    argv = ["--config", _config(corpus, "stutter_predictor"), "--exp_name", exp, "--device",
            "cpu", "-hp", f"spec_denoiser_work_dir={editor}"]
    enc = {k[len("fs.encoder."):]: v for k, v in torch.load(
        os.path.join(editor, "model_ckpt_steps_2.ckpt"), weights_only=True)["state"]["model"]
        .items() if k.startswith("fs.encoder.")}
    seen = []
    orig = Trainer.fit
    Trainer.fit = lambda self: (seen.append({k: v.clone() for k, v in
                                           self.model.txt_encoder.state_dict().items()}),
                                 orig(self))
    try:
        trainer = run(argv)
    finally:
        Trainer.fit = orig
    assert f"| warm-started txt_encoder <- {editor}/model_ckpt_steps_2.ckpt" in \
        capsys.readouterr().out
    assert sorted(seen[0]) == sorted(enc)
    assert all(torch.equal(seen[0][k], v) for k, v in enc.items())
    assert trainer.global_step == 2
    run(argv + ["--infer"])
    gen_dir = os.path.join(exp, "generated_2_test")
    with open(os.path.join(gen_dir, "meta.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["item_name", "wav_fn_pred", "wav_fn_gt", "stutter_pred"]
    assert len(rows) == 4
    for name, _, _, labels in rows[1:]:
        mel = np.load(os.path.join(gen_dir, "wavs", f"[P]{name}_mel.npy"))
        assert mel.shape[0] % 16 == 0 and len(labels.split()) == mel.shape[0] // 16
        assert set(labels.split()) <= {"0", "1", "2"}
