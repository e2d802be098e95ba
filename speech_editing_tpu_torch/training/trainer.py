"""The training loop around :class:`TrainStep` (or a GAN task's
:class:`~speech_editing_tpu_torch.training.tasks.hifigan.GanTrainStep`):
loader, validation, checkpoints, resume, logging, and the test loop.

The port of the JAX package's ``training/trainer.py``. ``fit`` builds the
state (resuming from the work dir's last checkpoint), runs
``num_sanity_val_steps`` validation batches,
then steps through the endless training loader until ``max_updates``
(an update of ``accumulate_grad_batches`` microbatches each, but for a
GAN task, which ignores it as the JAX trainer does):
every ``tb_log_interval`` steps it prints the metrics (``max_nan_intervals``
such intervals in a row with skipped, non-finite updates abort the run),
every ``val_check_interval`` steps it validates and writes a checkpoint,
and it writes one on ``KeyboardInterrupt`` and at the end. ``test``
(``--infer``) generates the test split with the last checkpoint and writes
wavs, their mel figures (``plot/``) and ``meta.csv``.

Logging, as in the JAX trainer: ``fit`` mirrors the terminal into
``<work_dir>/terminal_logs/log_<time>.txt``, snapshots the package into
``<work_dir>/codes/<time>/`` when ``save_codes`` is set, and writes the
training and validation scalars to TensorBoard (``<work_dir>/tb_logs``);
each validation also logs the mel figure of its first item's inference
(``num_valid_plots`` > 0, ``mel_vmin``/``mel_vmax``) and, once training
has begun and ``valid_infer_interval`` is set, its vocoded audio. Without
tensorboard the scalars and media are not written, and without matplotlib
no figure is drawn: neither is an error.

In a job of several ranks (``parallel/mesh.py::init_distributed``, or
``torchrun``) the trainer builds a mesh from ``tp_size``: ``{"data":
world // tp_size, "model": tp_size}``. Every rank iterates the same seeded
global batch stream, pads each batch to a multiple of the data axis's size
with all-zero rows and keeps its own rows (``shard_batch``), as the JAX
package's multi-process loader does; the losses are the global batch's and
the gradients are summed over the data group (``training/train_state.py``,
``GanTrainStep``). Rank 0 alone prints, keeps the terminal log, writes
TensorBoard, ``save_codes`` and the validation media, and writes the
checkpoints, which every rank gathers together. ``test`` runs
single-process only.
"""

from __future__ import annotations

import csv
import os
import shutil
import sys
import time
import types
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from speech_editing_tpu_torch.data.datasets import DataLoader
from speech_editing_tpu_torch.parallel.mesh import (make_mesh, pad_batch_to_multiple,
                                                    replicate_tree, shard_batch, world)
from speech_editing_tpu_torch.parallel.tp import make_tp_mesh, param_partition_specs
from speech_editing_tpu_torch.training.checkpoint import (get_last_checkpoint,
                                                          load_checkpoint,
                                                          save_checkpoint)
from speech_editing_tpu_torch.training.tasks.spec_denoiser import SpecDenoiserTask
from speech_editing_tpu_torch.training.train_state import TrainStep, make_eval_step

_INT_KEYS = ("txt_tokens", "mel2ph", "spk_ids", "stutter_mel_masks", "word_tokens",
             "ph2word", "mel2word", "pitch")


def cuda_or_cpu(device: Any, who: str) -> torch.device:
    """``device`` as asked; a CUDA device raises when there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to run the "
                           "plain versions")
    return device


def float32_on_card() -> None:
    """Float32 matrix products and cuDNN convolutions on the card, not TF32
    (cuDNN's default): the port computes in float32, as its checks against
    the CPU hold it; and bf16 products that reduce in float32 (no bf16
    split-K reduction), as JAX's ``preferred_element_type=f32`` asks. The
    command lines call it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class TensorBoardLogger:
    """A ``SummaryWriter`` into ``log_dir``, or nothing (every call a no-op)
    when tensorboard is missing or ``log_dir`` is None."""

    def __init__(self, log_dir: Optional[str]):
        self.writer = None
        if log_dir is None:
            return
        # with TensorFlow installed, tensorboard writes its files through
        # TensorFlow's gfile and imports all of TensorFlow first, most of
        # the logger's start-up; the marker module ``tensorboard.compat.notf``
        # makes it use its own writer, which is all the logger needs
        if "tensorflow" not in sys.modules:
            sys.modules.setdefault("tensorboard.compat.notf",
                                   types.ModuleType("tensorboard.compat.notf"))
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self.writer = SummaryWriter(log_dir)

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), int(step))

    def add_audio(self, tag: str, wav, step: int, sr: int) -> None:
        if self.writer is not None:
            self.writer.add_audio(tag, torch.as_tensor(np.asarray(wav))[None], int(step),
                                  sample_rate=int(sr))

    def add_figure(self, tag: str, fig, step: int) -> None:
        if self.writer is not None:
            self.writer.add_figure(tag, fig, int(step))

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


class Trainer:
    """Trains ``task``'s model on ``device`` (default ``"cuda"``, which
    raises when no GPU is present; ``"cpu"`` runs every kernel's plain
    version). Weights are drawn from ``hp["seed"]`` until a checkpoint
    loads. ``dropout=False`` turns the model's dropout off. Checkpoints go to
    ``hp["work_dir"]``, by default ``checkpoints/<exp_name>``. A GAN task
    (``task.is_gan``) also builds its discriminators (``self.disc``) from
    the seed; its parameter shapes come from the hp, so the state needs no
    batch to be built, where the JAX trainer's ``init`` takes the first.
    In a job of several ranks it trains on the job's mesh (see the module
    doc)."""

    def __init__(self, task: Any, hp: Any, device: Any = "cuda", dropout: bool = True):
        self.device = cuda_or_cpu(device, "Trainer")
        self.task, self.hp = task, hp
        tp = int(hp.get("tp_size", 1) or 1)
        self.mesh = mesh = make_tp_mesh(world()[1], tp) if tp > 1 else make_mesh()
        self.work_dir = hp.get("work_dir") or os.path.join(
            "checkpoints", hp.get("exp_name") or "default")
        seed = int(hp.get("seed", 1234))
        self.is_gan = bool(getattr(task, "is_gan", False))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = task.build_model()
            self.disc = task.build_discriminators() if self.is_gan else None
        self.model.to(self.device).train()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if self.is_gan:
            self.disc.to(self.device).train()
            self.train_step = task.make_gan_train_step(self.model, self.disc, mesh)
            self.eval_step = task.make_gan_eval_step(self.model, mesh)
            self.accum = 1
        else:
            specs = param_partition_specs(self.model, tp) if tp > 1 else None
            self.train_step = TrainStep(self.model, hp,
                                        task.make_loss_fn(self.model, train=dropout),
                                        mesh, specs)
            self.eval_step = make_eval_step(task.make_loss_fn(self.model, train=False), mesh)
            self.accum = int(hp.get("accumulate_grad_batches", 1) or 1)
        self._nan_intervals = 0
        self.logger = TensorBoardLogger(None)   # opened by fit and validate_only
        self._val_vocoder = None

    @classmethod
    def from_hp(cls, hp: Any, device: Any = "cuda", seed: int = 0, vocab_size: int = 80,
                sil_token_ids: Sequence[int] = (), dropout: bool = True) -> "Trainer":
        """A FluentSpeech trainer without a corpus, for batches the caller
        passes to :meth:`step` (each rank the whole global batch)."""
        task = SpecDenoiserTask(dict(hp, seed=seed, vocab_size=vocab_size,
                                     binary_data_dir=""))
        task.sil_token_ids = tuple(sil_token_ids)
        return cls(task, task.hp, device, dropout)

    @property
    def global_step(self) -> int:
        return self.train_step.step

    # -- data ---------------------------------------------------------------------

    def _loader(self, prefix: str, shuffle: bool, endless: bool = False,
                max_sentences_key: str = "max_sentences") -> DataLoader:
        hp = self.hp
        max_sent = hp.get(max_sentences_key, 16)
        if max_sent in (-1, None):
            max_sent = hp.get("max_sentences", 16)
        # worker processes for the training stream only, as in the JAX package
        workers = int(hp.get("ds_workers", 0)) if prefix == "train" else 0
        return DataLoader(self.task.dataset_cls(prefix, hp, shuffle=shuffle),
                          max_tokens=hp.get("max_tokens"), max_sentences=max_sent,
                          endless=endless, num_workers=workers,
                          pin_memory=self.device.type == "cuda")

    def to_device(self, batch: dict) -> dict:
        """Arrays or tensors -> tensors on the device (int64 ids, float32
        otherwise); the copy does not block, which from the loader's pinned
        batches makes it asynchronous."""
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v)
            v = v.long() if k in _INT_KEYS else v.float()
            out[k] = v.to(self.device, non_blocking=True)
        return out

    def _device_batch(self, raw: dict, shard: bool = True) -> dict:
        """The step's keys of a global host batch on the device; with
        ``shard`` padded to a multiple of the data axis and this rank's
        rows alone."""
        batch = {k: raw[k] for k in self.task.effective_batch_keys() if k in raw}
        if shard and self.mesh.data_size > 1:
            batch = shard_batch(pad_batch_to_multiple(batch, self.mesh.data_size), self.mesh)
        return self.to_device(batch)

    def _rows(self, raw: dict) -> int:
        """The rows of a global host batch, before padding."""
        return len(next(raw[k] for k in self.task.effective_batch_keys() if k in raw))

    @property
    def is_main(self) -> bool:
        return self.mesh.is_main

    def _print(self, *args) -> None:
        if self.is_main:
            print(*args, flush=True)

    # -- state --------------------------------------------------------------------

    def _build_state(self) -> None:
        """Resume from the work dir's last checkpoint, if any: a port
        checkpoint restores the parameters, Adam's moments and the counts; a
        JAX one, through the task's converter (a layout map, which carries
        Adam's moments as it carries the parameters), the parameters, Adam's
        moments and count, the schedule's count and the step count."""
        ckpt_path, _ = get_last_checkpoint(self.work_dir)
        if ckpt_path is not None:
            # onto the CPU: the modules and optimizers copy their state to the
            # device, Adam's step counts stay host scalars (on the card each
            # would cost a synchronisation a parameter every step)
            payload = load_checkpoint(ckpt_path, map_location="cpu")
            if "jax_params" in payload and self.is_gan:
                self._load_jax_gan(ckpt_path, payload)
            elif "jax_params" in payload:
                to_sd = lambda tree: self.task.params_from_jax(tree, self.hp)
                self.model.load_state_dict(to_sd(payload["jax_params"]))
                self.train_step.step = payload["steps"]
                adam = payload["jax_adam"]
                if adam is None:
                    raise ValueError(f"{ckpt_path}: no Adam state in the JAX checkpoint")
                self.train_step.load_moments(to_sd(adam["mu"]), to_sd(adam["nu"]),
                                             adam["count"], adam["schedule_count"])
                self._print(f"| loaded JAX checkpoint {ckpt_path} (step {self.global_step}): "
                            f"parameters, Adam's moments and {adam['count']} updates")
            else:
                self.train_step.load_state_dict(payload["state"])
                self._print(f"| loaded checkpoint {ckpt_path} (step {self.global_step})")
        if self.mesh.size > 1:
            # every rank holds rank 0's weights (seeded, or read from one work dir)
            replicate_tree(dict(self.model.named_parameters()), self.mesh)
            if self.is_gan:
                replicate_tree(dict(self.disc.named_parameters()), self.mesh)
            else:
                self.train_step.sync_split()
        n_params = sum(p.numel() for p in self.model.parameters())
        self._print(f"| model params: {n_params / 1e6:.3f}M | device: {self.device} | "
                    f"mesh: {self.mesh}")

    def _load_jax_gan(self, ckpt_path: str, payload: dict) -> None:
        """A JAX ``GanTrainState``: both nets and both Adam states."""
        adams = (payload.get("jax_gen_adam"), payload.get("jax_disc_adam"))
        if None in adams:
            raise ValueError(f"{ckpt_path}: not a JAX GanTrainState with both Adam states")
        task, hp = self.task, self.hp
        maps = (lambda tree: task.params_from_jax(tree, hp),
                lambda tree: task.disc_params_from_jax(tree, hp))
        gen_adam, disc_adam = ({"mu": to_sd(a["mu"]), "nu": to_sd(a["nu"]), "count": a["count"]}
                               for to_sd, a in zip(maps, adams))
        self.train_step.load_jax(maps[0](payload["jax_params"]),
                                 maps[1](payload["jax_disc_params"]), gen_adam, disc_adam,
                                 payload["steps"])
        self._print(f"| loaded JAX checkpoint {ckpt_path} (step {self.global_step}): both "
                    f"nets and both Adam states ({adams[0]['count']} updates)")

    def save(self, val_loss: Optional[float] = None) -> str:
        """Every rank gathers the state; rank 0 writes it."""
        hp = self.hp
        return save_checkpoint(self.work_dir, self.train_step.state_dict(),
                               self.global_step, val_loss=val_loss,
                               num_ckpt_keep=int(hp.get("num_ckpt_keep", 3)),
                               save_best=bool(hp.get("save_best", False)))

    # -- train --------------------------------------------------------------------

    def step(self, raw: dict, *more: dict) -> dict:
        """One training step on a collated host batch, or with ``more``
        one update from the gradients of all of them
        (``TrainStep.accumulate``); its metrics as 0-d device tensors."""
        if not more:
            return self.train_step(self._device_batch(raw), self.generator,
                                   rows=self._rows(raw))
        return self.train_step.accumulate(
            (self._device_batch(r) for r in (raw, *more)), self.generator,
            rows=[self._rows(r) for r in (raw, *more)])

    def fit(self) -> None:
        tee = self._start_logging()
        try:
            self._fit()
        finally:
            self.logger.close()
            if tee is not None:
                tee.close()

    def _fit(self) -> None:
        hp = self.hp
        max_updates = int(hp.get("max_updates", 100000))
        val_interval = int(hp.get("val_check_interval", 2000))
        log_interval = int(hp.get("tb_log_interval", 100))
        num_sanity = int(hp.get("num_sanity_val_steps", 5))
        self._build_state()
        # the stream restarts at epoch 0 on a resume, as in the JAX package
        loader = self._loader("train", shuffle=True, endless=True)
        try:
            batches = iter(loader)   # starts the workers, which boot during sanity validation
            if num_sanity > 0:
                self.validate(max_batches=num_sanity, log=False)
            t0 = time.time()
            while self.global_step < max_updates:
                metrics = self.step(*(next(batches) for _ in range(self.accum)))
                if self.global_step % log_interval == 0:
                    self._log(metrics, log_interval / max(time.time() - t0, 1e-9))
                    t0 = time.time()
                if self.global_step % val_interval == 0:
                    self.save(self.validate())
        except KeyboardInterrupt:
            self._print("| KeyboardInterrupt: saving checkpoint before exit")
            self.save()
            raise
        finally:
            loader.close()
        self.save()
        self._print(f"| training done at step {self.global_step}")

    def _start_logging(self):
        """On rank 0, the terminal tee, the ``save_codes`` snapshot and the
        TensorBoard logger; returns the tee (None elsewhere)."""
        from speech_editing_tpu_torch.utils.meters import Tee

        if not self.is_main:
            return None
        stamp = time.strftime("%Y%m%d%H%M%S")
        log_dir = os.path.join(self.work_dir, "terminal_logs")
        os.makedirs(log_dir, exist_ok=True)
        tee = Tee(os.path.join(log_dir, f"log_{stamp}.txt"))
        if self.hp.get("save_codes"):
            src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            dst = os.path.join(self.work_dir, "codes", stamp, os.path.basename(src))
            shutil.copytree(src, dst, dirs_exist_ok=True,
                            ignore=shutil.ignore_patterns("__pycache__", "_build"))
            print(f"| source snapshot -> {dst}", flush=True)
        self.logger = TensorBoardLogger(os.path.join(self.work_dir, "tb_logs"))
        return tee

    def _log(self, metrics: dict, steps_per_s: float) -> None:
        m = {k: float(v) for k, v in metrics.items()}
        self._print(f"| step {self.global_step} | {steps_per_s:.2f} it/s | "
                    + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())))
        for k, v in m.items():
            self.logger.add_scalar(f"tr/{k}", v, self.global_step)
        self.logger.add_scalar("tr/it_per_sec", steps_per_s, self.global_step)
        if m.get("nan_grads", 0) > 0:
            self._nan_intervals += 1
            self._print(f"| WARNING: non-finite gradients at step {self.global_step}; update "
                        f"was skipped ({self._nan_intervals} consecutive intervals)")
            if self._nan_intervals >= int(self.hp.get("max_nan_intervals", 5)):
                raise RuntimeError(f"gradients non-finite for {self._nan_intervals} "
                                   "consecutive log intervals; aborting (set "
                                   "max_nan_intervals to tune)")
        else:
            self._nan_intervals = 0

    # -- validation ---------------------------------------------------------------

    def _eval_batch(self, raw: dict) -> dict:
        return self.eval_step(self._device_batch(raw), self.generator, rows=self._rows(raw))

    def validate(self, max_batches: Optional[int] = None, log: bool = True) -> Optional[float]:
        """Mean metrics over the valid split (``max_valid_sentences`` a
        batch; at most ``eval_max_batches`` batches, -1 for all); returns
        the mean ``total_loss``."""
        if max_batches is None:
            mb = int(self.hp.get("eval_max_batches", -1))
            max_batches = None if mb == -1 else mb
        totals: dict = {}
        n, first = 0, None
        with self._loader("valid", shuffle=False,
                          max_sentences_key="max_valid_sentences") as loader:
            for raw in loader:
                if max_batches is not None and n >= max_batches:
                    break
                first = raw if first is None else first
                for k, v in self._eval_batch(raw).items():
                    totals[k] = totals.get(k, 0.0) + float(v)
                n += 1
        if n == 0:
            return None
        means = {k: v / n for k, v in totals.items()}
        if log:
            self._print(f"| validation @ step {self.global_step}: "
                        + " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items())))
            for k, v in means.items():
                self.logger.add_scalar(f"val/{k}", v, self.global_step)
            if int(self.hp.get("num_valid_plots", 0)) > 0 and self.is_main:
                self._log_valid_media(first)
        return means.get("total_loss")

    def _log_valid_media(self, raw: dict) -> None:
        """The first validation item's inference: its mel beside the ground
        truth as a figure, and from step 1 on with ``valid_infer_interval``
        its vocoded audio. Nothing is run without a TensorBoard writer, and
        no figure is drawn without matplotlib; a failure is printed, never
        raised (as in JAX). The inference's noise comes from a generator
        seeded by ``seed`` and the step, so the training draws do not move."""
        from speech_editing_tpu_torch.utils.plot import have_matplotlib, spec_to_figure

        hp = self.hp
        if self.is_gan or self.logger.writer is None:
            return
        want_audio = self.global_step > 0 and bool(hp.get("valid_infer_interval"))
        if not (have_matplotlib() or want_audio):
            return
        was_training = self.model.training
        try:
            self.model.eval()
            gen = torch.Generator(device=self.device).manual_seed(
                int(hp.get("seed", 1234)) + self.global_step)
            out = self.task.build_infer_fn(self.model)(self._device_batch(raw, shard=False),
                                                       generator=gen)
            mel_pred = out["mel_out"][0].float().cpu().numpy()
            mel_gt = torch.as_tensor(raw["mels"])[0].numpy()
            if have_matplotlib():
                self.logger.add_figure("mel_val_0", spec_to_figure(
                    np.concatenate([mel_gt, mel_pred], -1), vmin=hp.get("mel_vmin", -6),
                    vmax=hp.get("mel_vmax", 1.5)), self.global_step)
            if want_audio:
                from speech_editing_tpu_torch.infer.vocoder import get_vocoder_cls

                if self._val_vocoder is None:
                    self._val_vocoder = get_vocoder_cls(hp.get("vocoder", "GriffinLim"))(
                        hp, self.device)
                self.logger.add_audio("wav_val_0", self._val_vocoder.spec2wav(mel_pred),
                                      self.global_step, hp["audio_sample_rate"])
        except Exception as e:      # media must never stop training
            print(f"| WARN valid media logging failed: {e!r}", flush=True)
        finally:
            self.model.train(was_training)

    def validate_only(self) -> Optional[float]:
        """``--validate``: restore the last checkpoint and validate once."""
        self._build_state()
        if self.is_main:
            self.logger = TensorBoardLogger(os.path.join(self.work_dir, "tb_logs"))
        try:
            return self.validate()
        finally:
            self.logger.close()


    # -- test ---------------------------------------------------------------------

    def _infer_batch(self, raw: dict, infer_fn, generator: torch.Generator,
                     noise_fn: Optional[Callable] = None) -> dict:
        """One test batch's inference forward; ``noise_fn(raw)`` gives its
        diffusion noise in place of ``generator``'s draws (tests only)."""
        batch = self._device_batch(raw)
        noise = None if noise_fn is None else noise_fn(raw)
        return infer_fn(batch, generator=generator, noise=noise)

    def _phones(self, raw: dict, b: int, t_len: int):
        """Row ``b``'s phones (space-separated, from the corpus's phone set)
        and its first ``t_len`` frames of ``mel2ph``, for its figure."""
        enc = getattr(self.task, "token_encoder", None)
        str_phs = None
        if enc is not None and "txt_tokens" in raw:
            str_phs = enc.decode([int(t) for t in torch.as_tensor(raw["txt_tokens"])[b] if t > 0])
        m2p = torch.as_tensor(raw["mel2ph"])[b, :t_len].numpy() if "mel2ph" in raw else None
        return str_phs, m2p

    def test(self, noise_fn: Optional[Callable] = None) -> Optional[str]:
        """``--infer``: the last checkpoint generates the ``test`` split
        (``max_valid_sentences`` a batch, the first ``test_num`` items) with
        the dataset's ``mel2ph`` and inference masks, composited with the
        ground truth outside the mask (each task's ``build_infer_fn``; the
        stutter predictor's ``mel_out`` is the ground truth, and its block
        labels go into ``meta.csv``); the registry's vocoder
        (``hp["vocoder"]``) writes ``[P]`` and, with ``save_gt``, ``[G]``
        wavs, and for each item with a mask ``[P_SEG]``/``[G_SEG]`` wavs of
        the masked frames only, into
        ``<work_dir>/generated_<step>_<gen_dir_name or test>/wavs/``, with
        ``[P]<item>_mel.npy`` and a ``meta.csv`` index. A GAN task's
        ``[P]`` wav is its generator's (copy synthesis), and its items have
        no mask. Writes go through
        ``test_save_workers`` spawned processes (at most 1: in this one).
        The diffusion noise comes from a device generator seeded by
        ``hp["seed"]``. Returns the generation directory."""
        from speech_editing_tpu_torch.infer.vocoder import get_vocoder_cls
        from speech_editing_tpu_torch.training.result_saver import save_test_result
        from speech_editing_tpu_torch.utils.multiprocess import ResultSaverPool

        if self.mesh.size > 1:
            raise RuntimeError("Trainer.test (--infer) runs single-process: launch it without "
                               "torchrun (checkpoints load at any world size)")
        hp = self.hp
        with self._loader("test", shuffle=False,
                          max_sentences_key="max_valid_sentences") as loader:
            if len(loader.dataset) == 0:
                print("| empty test set", flush=True)
                return None
            self._build_state()
            self.model.eval()
            infer_fn = self.task.build_infer_fn(self.model)
            vocoder = get_vocoder_cls(hp.get("vocoder", "GriffinLim"))(hp, self.device)
            gen_dir = os.path.join(
                self.work_dir, f"generated_{self.global_step}_{hp.get('gen_dir_name') or 'test'}")
            os.makedirs(os.path.join(gen_dir, "wavs"), exist_ok=True)
            sr = int(hp["audio_sample_rate"])
            saver = ResultSaverPool(hp.get("test_save_workers"))
            hp_plot = {"hop_size": int(hp.get("hop_size", 256)),
                       "mel_vmin": hp.get("mel_vmin", -6), "mel_vmax": hp.get("mel_vmax", 1.5)}
            generator = torch.Generator(device=self.device).manual_seed(
                int(hp.get("seed", 1234)))
            n_done, test_num = 0, int(hp.get("test_num", 100))
            columns: dict = {}
            for raw in loader:
                if n_done >= test_num:
                    break
                out = self._infer_batch(raw, infer_fn, generator, noise_fn)
                mel_pred = out["mel_out"].cpu().numpy()
                wav_pred = out["wav_out"].cpu().numpy() if "wav_out" in out else None
                mels = torch.as_tensor(raw["mels"]).numpy()
                masks = (torch.as_tensor(raw["time_mel_masks"]).numpy()
                         if "time_mel_masks" in raw else None)
                for b in range(mel_pred.shape[0]):
                    if n_done >= test_num:
                        break
                    item_name = raw["item_name"][b]
                    t_len = int(raw["mel_lengths"][b])
                    columns[item_name] = self.task.meta_columns(out, b, t_len)
                    mel_p, mel_g = mel_pred[b, :t_len], mels[b, :t_len]
                    # vocode here (device work); the file writes go to the pool
                    wav_p = (vocoder.spec2wav(mel_p) if wav_pred is None
                             else wav_pred[b, :t_len * int(hp.get("hop_size", 256))])
                    str_phs, m2p = self._phones(raw, b, t_len)
                    saver.add_job(save_test_result, (wav_p, mel_p, f"[P]{item_name}", gen_dir,
                                                     sr, True, hp_plot, str_phs, m2p))
                    if hp.get("save_gt", True):
                        saver.add_job(save_test_result, (vocoder.spec2wav(mel_g), mel_g,
                                                         f"[G]{item_name}", gen_dir, sr, False,
                                                         hp_plot, str_phs, m2p))
                    # the masked frames alone, for segment-level evaluation
                    seg = masks[b, :t_len] == 1 if masks is not None else None
                    if seg is not None and seg.any():
                        saver.add_job(save_test_result, (vocoder.spec2wav(mel_p[seg]), None,
                                                         f"[P_SEG]{item_name}", gen_dir, sr))
                        saver.add_job(save_test_result, (vocoder.spec2wav(mel_g[seg]), None,
                                                         f"[G_SEG]{item_name}", gen_dir, sr))
                    n_done += 1
            saver.drain()
        names = sorted(f[3:-8] for f in os.listdir(f"{gen_dir}/wavs")
                       if f.startswith("[P]") and f.endswith("_mel.npy"))
        extra = sorted({k for c in columns.values() for k in c})
        with open(f"{gen_dir}/meta.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["item_name", "wav_fn_pred", "wav_fn_gt"] + extra)
            for name in names:
                w.writerow([name, f"wavs/[P]{name}.wav", f"wavs/[G]{name}.wav"]
                           + [columns.get(name, {}).get(k, "") for k in extra])
        print(f"| test done: {n_done} items -> {gen_dir}", flush=True)
        return gen_dir
