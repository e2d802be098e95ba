"""The PyTorch port stands alone: importing every module of
``speech_editing_tpu_torch`` (the in-place editing families' models, their
modules and ``infer/editors.py``, StutterSpeech's models and the training
tasks of all six editing families, HiFi-GAN's GAN task and the TTS
baselines and the parallel layer among them) loads neither JAX, flax,
optax, PyYAML nor the JAX package, and its entry points (the edit
pipeline, the trainer, the entry ``run`` with and without ``--infer`` on
each family's config and as a torchrun rank, a rank's
``init_distributed``, the multi-rank dry run, the CSV
region-edit APIs of FluentSpeech and of the in-place families, their
drivers, the HiFi-GAN vocoder, the batch server, the serve CLI, the
binarizer, ``align_and_binarize``, the speaker encoder, the TTS
synthesis command line, the gradio demo and the tools under ``scripts/``)
refuse to fall back to the CPU on their own. The
offline data pipeline, its speaker encoder and ``evals/`` are among the
modules imported, and so are the native DSP bindings, the reference
checkpoint converters, the gradio demo and the tools under ``scripts/``,
which import neither the repository's tests nor gradio."""

import os
import subprocess
import sys
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import torch
import speech_editing_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 20, names
for served in ("infer.online", "infer.quant", "infer.serve", "infer.serving",
               "infer.editors", "models.campnet", "models.editspeech", "models.a3t",
               "modules.lstm", "modules.conformer", "models.stutter_speech",
               "training.tasks.stutter_speech", "training.tasks.campnet",
               "training.tasks.a3t", "training.tasks.editspeech", "training.tasks.hifigan",
               "models.vocoder.losses", "data.vocoder_dataset", "data.preprocess",
               "data.binarizer", "data.align_and_binarize", "data.wav_processors",
               "models.voice_encoder", "utils.audio.vad", "utils.audio.cwt", "evals.dtw",
               "evals.mcd", "evals.stoi", "evals.pesq_np", "evals.pesq_metric",
               "evals.get_metrics", "evals.batch_tools", "evals.attention_metrics",
               "models.fs2_orig", "models.diffspeech", "modules.rnn",
               "modules.rel_transformer", "training.tasks.tts", "infer.tts_infer",
               "utils.plot", "utils.meters", "parallel.mesh", "parallel.tp",
               "parallel.dryrun", "utils.audio.native", "utils.convert_torch_ckpt",
               "infer.gradio_app", "scripts.e2e_acceptance", "scripts.quant_quality_ab",
               "scripts.copy_synthesis", "scripts.make_example_audio"):
    assert f"speech_editing_tpu_torch.{served}" in names, served
leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "flax", "optax", "yaml", "speech_editing_tpu", "tests",
                 "helpers", "gradio"))
assert not leaked, leaked
if not torch.cuda.is_available():
    from speech_editing_tpu_torch.infer.edit import EditPipeline
    from speech_editing_tpu_torch.infer.editors import A3TInfer, CampNetInfer, EditSpeechInfer
    from speech_editing_tpu_torch.infer.editors import main as editors_main
    from speech_editing_tpu_torch.infer.serve import main as serve_main
    from speech_editing_tpu_torch.infer.serving import BatchedEditServer
    from speech_editing_tpu_torch.infer.spec_denoiser import SpecDenoiserInfer, main
    from speech_editing_tpu_torch.infer.vocoder import HifiGAN
    from speech_editing_tpu_torch.run import run
    from speech_editing_tpu_torch.training.trainer import Trainer
    from speech_editing_tpu_torch.data.align_and_binarize import align_and_binarize
    from speech_editing_tpu_torch.data.align_and_binarize import main as align_main
    from speech_editing_tpu_torch.data.binarizer import BaseBinarizer
    from speech_editing_tpu_torch.data.binarizer import main as binarizer_main
    from speech_editing_tpu_torch.models.voice_encoder import VoiceEncoderCtx
    from speech_editing_tpu_torch.infer.tts_infer import main as tts_main
    from speech_editing_tpu_torch.parallel.dryrun import dryrun_multichip
    from speech_editing_tpu_torch.parallel.mesh import init_distributed
    from speech_editing_tpu_torch.infer.gradio_app import main as gradio_main
    from speech_editing_tpu_torch.scripts.copy_synthesis import main as copy_main
    from speech_editing_tpu_torch.scripts.e2e_acceptance import main as e2e_main
    from speech_editing_tpu_torch.scripts.quant_quality_ab import main as quant_main

    def torchrun_rank(argv):
        import os
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT="1")
        try:
            run(argv)
        finally:
            for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
                del os.environ[k]
    never = {"processed_data_dir": "never_made/processed", "binary_data_dir": "never_made/bin"}
    train_argv = ["--config", "egs/spec_denoiser.yaml", "--exp_name", "never_made",
                  "-hp", "use_bf16=False"]
    for entry, args in ((EditPipeline, ({}, {})), (Trainer.from_hp, ({},)),
                        (run, (train_argv,)), (run, (train_argv + ["--infer"],)),
                        (SpecDenoiserInfer, ({},)), (SpecDenoiserInfer.example_run, ([], {})),
                        (main, (train_argv,)), (HifiGAN, ({},)),
                        (CampNetInfer, ({},)), (A3TInfer, ({},)), (EditSpeechInfer, ({},)),
                        (editors_main, (["--config", "egs/campnet.yaml", "--exp_name",
                                         "never_made"],)),
                        (BatchedEditServer, (None, {})),
                        (serve_main, (train_argv[:4] + ["--jsonl", "never_read.jsonl"],)),
                        (BaseBinarizer, (never,)), (align_and_binarize, (never, True)),
                        (binarizer_main, (["--config", "egs/spec_denoiser.yaml"],)),
                        (align_main, (["--config", "egs/spec_denoiser.yaml", "--skip-align"],)),
                        (VoiceEncoderCtx, (None, "cuda", torch.Generator())),
                        (init_distributed, ("gloo", "tcp://127.0.0.1:1", 1, 0)),
                        (torchrun_rank, (train_argv,)), (dryrun_multichip, (2,)),
                        (gradio_main, (train_argv,)),
                        (copy_main, (["never_read.wav", "never_made.wav"],)),
                        (e2e_main, (["--workdir", "never_made"],)),
                        (quant_main, (["--workdir", "never_made"],)),
                        *((run, (["--config", f"egs/{family}.yaml", "--exp_name", "never_made"]
                                 + infer,))
                          for family in ("stutter_speech", "stutter_predictor", "campnet",
                                         "a3t", "editspeech", "hifigan", "fs", "fs2_orig",
                                         "diffspeech")
                          for infer in ([], ["--infer"])),
                        *((tts_main, (["--config", f"egs/{tts}.yaml", "--exp_name", "never_made",
                                       "--text", "never said"],))
                          for tts in ("fs", "fs2_orig", "diffspeech"))):
        try:
            entry(*args)
        except RuntimeError as e:
            assert "no CUDA device" in str(e), e
        else:
            raise AssertionError(f"{entry.__name__}() ran without a GPU")
    import os
    assert not os.path.exists("checkpoints/never_made") and not os.path.exists("never_made")
print("ISOLATED", len(names))
"""


def test_port_imports_no_jax_and_needs_a_gpu_by_default():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED" in res.stdout
