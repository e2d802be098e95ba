"""PyTorch port, test-set inference ``python -m speech_editing_tpu_torch.run
--infer --device cpu`` on a tiny config over ``egs/spec_denoiser.yaml`` and
a tiny synthetic corpus: after two training steps, ``--infer`` writes the
``[P]``/``[G]``/``[P_SEG]``/``[G_SEG]`` wavs, the ``[P]`` mels and
``meta.csv`` through a HiFi-GAN vocoder checkpoint; frames outside the
dataset's mask are the ground truth's; one item's ``mel_out`` equals the
JAX package's test-loop ``infer_fn`` with the same injected noise at 1e-3.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.models.spec_denoiser.spec_denoiser import GaussianDiffusion as JGD
from speech_editing_tpu.training.tasks.spec_denoiser import SpecDenoiserTask as JTask
from speech_editing_tpu.utils.convert_torch_ckpt import convert_gaussian_diffusion
from speech_editing_tpu_torch.config.hparams import dump_yaml
from speech_editing_tpu_torch.data.datasets import EditingDataset
from speech_editing_tpu_torch.models.vocoder.hifigan import HifiGanGenerator
from speech_editing_tpu_torch.run import run
from speech_editing_tpu_torch.training.checkpoint import save_checkpoint
from speech_editing_tpu_torch.training.result_saver import save_test_result
from speech_editing_tpu_torch.training.tasks.spec_denoiser import SpecDenoiserTask
from speech_editing_tpu_torch.training.trainer import Trainer
from speech_editing_tpu_torch.utils.audio.io import load_wav
from speech_editing_tpu_torch.utils.init import init_like_flax
from speech_editing_tpu_torch.utils.multiprocess import ResultSaverPool
from tests.helpers import TINY_HP, VOCAB, write_synth_corpus
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHONES = ["|", ",", "sil"] + [f"P{i}" for i in range(VOCAB - 6)]
# a tiny HiFi-GAN whose upsampling (8 x 8 x 4) is the mel hop of 256 samples
VHP = {"upsample_rates": [8, 8, 4], "upsample_kernel_sizes": [16, 16, 8],
       "upsample_initial_channel": 32, "resblock": "2", "resblock_kernel_sizes": [3],
       "resblock_dilation_sizes": [[1, 3]]}
N_TEST = 8


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(config path, exp dir): a corpus, a HiFi-GAN checkpoint of seeded
    weights with its ``config.yaml``, a tiny config whose base is the
    shipped ``egs/spec_denoiser.yaml``, and two training steps."""
    d = tmp_path_factory.mktemp("infer_run")
    write_synth_corpus(str(d / "data"), np.random.RandomState(0), n_items=N_TEST)
    (d / "data" / "phone_set.json").write_text(json.dumps(PHONES))
    torch.manual_seed(0)
    save_checkpoint(str(d / "voc"), {"model": init_like_flax(HifiGanGenerator(VHP)).state_dict()},
                    1)
    (d / "voc" / "config.yaml").write_text(dump_yaml(VHP))
    cfg = dict(TINY_HP, base_config=os.path.join(REPO, "egs", "spec_denoiser.yaml"),
               binary_data_dir=str(d / "data"), decoder_type="fft", residual_channels=16,
               max_updates=2, val_check_interval=2, num_sanity_val_steps=0,
               eval_max_batches=1, tb_log_interval=1, max_sentences=4, ds_workers=0,
               vocoder="HifiGAN", vocoder_ckpt=str(d / "voc"), test_save_workers=1)
    (d / "tiny.yaml").write_text(dump_yaml(cfg))
    config, exp = str(d / "tiny.yaml"), str(d / "exp")
    run(["--config", config, "--exp_name", exp, "--device", "cpu", "-hp", "use_bf16=False"])
    return config, exp


def test_infer_writes_the_test_set(setup, capsys):
    config, exp = setup
    trainer = run(["--config", config, "--exp_name", exp, "--device", "cpu", "-hp",
                   "use_bf16=False", "--infer"])
    out = capsys.readouterr().out
    assert trainer.global_step == 2 and "| vocoder: HiFi-GAN from" in out
    gen_dir = os.path.join(exp, "generated_2_test")
    assert f"| test done: {N_TEST} items -> {gen_dir}" in out
    with open(os.path.join(gen_dir, "meta.csv")) as f:
        rows = list(csv.reader(f))
    data = EditingDataset("test", trainer.hp)
    names = [data[i]["item_name"] for i in range(N_TEST)]
    assert rows[0] == ["item_name", "wav_fn_pred", "wav_fn_gt"]
    assert [r[0] for r in rows[1:]] == sorted(names)
    wavs = os.path.join(gen_dir, "wavs")
    for i, name in enumerate(names):
        sample = data[i]
        t, seg = sample["mel"].shape[0], sample["time_mel_mask"] == 1
        assert seg.any() and not seg.all()
        mel = np.load(os.path.join(wavs, f"[P]{name}_mel.npy"))
        assert mel.shape == (t, 80) and np.isfinite(mel).all()
        np.testing.assert_array_equal(mel[~seg], sample["mel"][~seg])
        assert not np.allclose(mel[seg], sample["mel"][seg])
        for prefix, frames in (("P", t), ("G", t), ("P_SEG", seg.sum()), ("G_SEG", seg.sum())):
            wav, sr = load_wav(os.path.join(wavs, f"[{prefix}]{name}.wav"))
            assert sr == 22050 and len(wav) == frames * 256
    assert len(os.listdir(wavs)) == 5 * N_TEST


def _jax_noise(rng, shape, timesteps):
    """The draws the JAX test loop's ``infer_fn`` takes from ``rng``: the
    initial noise, then one draw a reverse step."""
    key, sub = jax.random.split(rng)
    noise = [jax.random.normal(sub, shape, jnp.float32)]
    for _ in range(timesteps):
        key, sub = jax.random.split(key)
        noise.append(jax.random.normal(sub, shape, jnp.float32))
    return [torch.tensor(np.asarray(n)) for n in noise]


def test_infer_mel_equals_the_jax_test_loop(setup):
    config, exp = setup
    trainer = run(["--config", config, "--exp_name", exp, "--device", "cpu", "-hp",
                   "use_bf16=False,test_num=1,gen_dir_name=jax", "--infer"])
    hp = trainer.hp
    sd = {k: v.detach().numpy() for k, v in trainer.model.state_dict().items()}
    jm = JGD(vocab_size=trainer.task.vocab_size, hp=hp, out_dims=80)
    j_infer = JTask(hp).build_infer_fn(jm)
    rng = jax.random.PRNGKey(11)
    seen = []

    def noise_fn(raw):
        seen.append(raw)
        return _jax_noise(rng, tuple(raw["mels"].shape), hp["timesteps"])

    gen_dir = Trainer(SpecDenoiserTask(hp), hp, "cpu").test(noise_fn=noise_fn)
    raw = seen[0]
    keys = trainer.task.effective_batch_keys()
    jb = {k: jnp.asarray(raw[k].astype(np.int32) if raw[k].dtype == np.int64 else raw[k])
          for k in keys}
    ref = np.asarray(j_infer({"params": convert_gaussian_diffusion(sd, hp)}, jb, rng)["mel_out"])
    name, t = raw["item_name"][0], int(raw["mel_lengths"][0])
    got = np.load(os.path.join(gen_dir, "wavs", f"[P]{name}_mel.npy"))
    assert len(seen) == 1 and got.shape == (t, 80)
    np.testing.assert_allclose(got, ref[0, :t], atol=1e-3, rtol=1e-3)
    seg = raw["time_mel_masks"][0, :t] == 1
    assert seg.any() and np.abs(got[seg] - raw["mels"][0, :t][seg]).max() > 1e-2


def test_result_saver_pool_writes_in_spawned_workers(tmp_path):
    os.makedirs(tmp_path / "wavs")
    wav = np.sin(np.arange(512) / 9.0).astype(np.float32)
    mel = np.ones((2, 80), np.float32)
    for workers in (2, 1):
        pool = ResultSaverPool(workers)
        assert (pool._pool is not None) == (workers > 1)
        pool.add_job(save_test_result, (wav, mel, f"[P]a{workers}", str(tmp_path), 22050, True))
        pool.add_job(save_test_result, (wav, None, f"[P_SEG]a{workers}", str(tmp_path), 22050))
        pool.add_job(save_test_result, (wav, None, "missing/x", str(tmp_path / "no"), 22050))
        assert pool.drain() == [f"[P]a{workers}", f"[P_SEG]a{workers}", None]
        np.testing.assert_array_equal(np.load(tmp_path / "wavs" / f"[P]a{workers}_mel.npy"),
                                      mel)
        got, sr = load_wav(str(tmp_path / "wavs" / f"[P_SEG]a{workers}.wav"))
        assert sr == 22050 and np.abs(got - wav).max() < 1e-4
