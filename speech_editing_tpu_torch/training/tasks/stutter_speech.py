"""StutterSpeech tasks: the stutter-conditioned diffusion editor and the
standalone block-level stutter predictor; the port of the JAX package's
``training/tasks/stutter_speech.py``.

* :class:`StutterSpeechTask`: the per-frame stutter labels collapsed to
  {0 fluent, 1 stutter, 2 padding}; the masked mel losses, the duration and
  pitch losses, and on the frame head's logits a cross entropy weighted
  8e-3 + 5e-3 (step + 1) / 1e5 and the focal loss.
* :class:`StutterPredictorTask`: block labels (any stutter frame in 16
  marks the block); a cross entropy weighted min(1e-2, 1e-2 * 6000 / step)
  and the focal loss; ``acc`` (fluent and stutter blocks right over all
  blocks) and ``acc_1`` (stutter recall) among the metrics. With
  ``spec_denoiser_work_dir`` its text encoder starts from a trained
  editor's ``fs.encoder``.

``step`` is the batch's ``global_step`` (the train step's count); the
validation batches carry none, and the weights take step 0 (StutterSpeech)
and 1 (the predictor), as in the JAX package.
"""

from __future__ import annotations

from typing import Any

import torch

from speech_editing_tpu_torch.models.stutter_speech import (StutterGaussianDiffusion,
                                                            StutterPredictor)
from speech_editing_tpu_torch.parallel.mesh import global_sums
from speech_editing_tpu_torch.training.checkpoint import get_last_checkpoint, load_subtree
from speech_editing_tpu_torch.training.losses import (add_mel_loss, cross_entropy_loss,
                                                      dur_loss, multi_focal_loss,
                                                      pitch_loss, ratio, sil_token_mask)
from speech_editing_tpu_torch.training.tasks.base import BaseTask
from speech_editing_tpu_torch.utils.convert_jax_params import (
    stutter_predictor_params_from_jax, stutter_speech_params_from_jax,
    text_conv_encoder_params_from_jax)
from speech_editing_tpu_torch.utils.dtypes import weak
from speech_editing_tpu_torch.utils.init import init_like_flax


def collapse_stutter_labels(stutter_mel_masks: torch.Tensor) -> torch.Tensor:
    """> 0 -> 1 (stutter), < 0 -> 2 (padding), 0 -> 0 (fluent); int64."""
    s = stutter_mel_masks
    return torch.where(s > 0, 1, torch.where(s < 0, 2, 0)).long()


def block_labels(stutter_mel_masks: torch.Tensor, block_size: int = 16) -> torch.Tensor:
    """Frame labels [B, T] (T a multiple of ``block_size``) -> block labels
    [B, T / block_size] by the sign of each block's sum: 1 stutter, 2
    padding, 0 fluent."""
    b, t = stutter_mel_masks.shape
    return collapse_stutter_labels(
        stutter_mel_masks.reshape(b, t // block_size, block_size).sum(-1))


def _step(batch: dict, default: float, like: torch.Tensor) -> torch.Tensor:
    step = batch.get("global_step")
    return torch.tensor(default, device=like.device) if step is None else step


class StutterSpeechTask(BaseTask):
    array_batch_keys = ("txt_tokens", "mels", "mel2ph", "f0", "uv", "time_mel_masks",
                        "stutter_mel_masks")

    def build_model(self) -> StutterGaussianDiffusion:
        return init_like_flax(StutterGaussianDiffusion(
            self.vocab_size, self.hp, self.hp.get("audio_num_mel_bins", 80)))

    def make_loss_fn(self, model: StutterGaussianDiffusion, train: bool = True):
        """``loss_fn(batch, generator=None, t=None, noise=None)``; ``t`` and
        ``noise`` fix the diffusion draw, as FluentSpeech's."""
        hp = self.hp
        mel_spec = hp.get("mel_losses", "l1:0.5|ssim:0.5")
        use_pitch = hp.get("use_pitch_embed", True)
        sil_ids = self.sil_token_ids

        def loss_fn(batch, generator=None, t=None, noise=None):
            tm = batch["time_mel_masks"][..., None].to(batch["mels"].dtype)
            labels = collapse_stutter_labels(batch["stutter_mel_masks"])
            out = model.forward_train(
                batch["txt_tokens"], tm, batch["mel2ph"], batch.get("spk_embed"),
                batch["mels"], batch["f0"], batch["uv"], t=t, noise=noise,
                generator=generator, train=train, stutter_labels=labels)
            losses: dict = {}
            add_mel_loss(losses, out["mel_out"] * tm, batch["mels"] * tm, mel_spec,
                         postfix="_coarse")
            is_sil = sil_token_mask(batch["txt_tokens"], sil_ids)
            dur_loss(losses, out["dur"], batch["mel2ph"], batch["txt_tokens"], is_sil, hp)
            if use_pitch:
                pitch_loss(losses, out["pitch_pred"], batch["f0"], batch["uv"],
                           batch["mel2ph"], hp)
            logits = out["stutter_predictor_out"]
            step = _step(batch, 0.0, logits)
            ce_w = weak(8e-3, step) + weak(5e-3, step) * (step + 1.0) / weak(1e5, step)
            losses["ce"] = cross_entropy_loss(logits, labels) * ce_w
            losses["focal"] = multi_focal_loss(logits, labels)
            return sum(losses.values()), losses

        return loss_fn

    def params_from_jax(self, params, hp: Any) -> dict:
        return stutter_speech_params_from_jax(params, hp)


class StutterPredictorTask(BaseTask):
    array_batch_keys = ("txt_tokens", "mels", "mel2ph", "stutter_mel_masks")

    @property
    def block_size(self) -> int:
        return int(self.hp.get("stutter_block_size", 16))

    def build_model(self) -> StutterPredictor:
        model = init_like_flax(StutterPredictor(self.vocab_size, self.hp, self.block_size,
                                                self.hp.get("audio_num_mel_bins", 80)))
        work_dir = self.hp.get("spec_denoiser_work_dir")
        if work_dir:
            self.warm_start_text_encoder(model, work_dir)
        return model

    def warm_start_text_encoder(self, model: StutterPredictor, work_dir_or_ckpt: str) -> str:
        """Copy a trained editor's ``fs.encoder`` into ``model.txt_encoder``,
        from a checkpoint file or a work dir's last checkpoint, of the port
        or of the JAX package; raises ``FileNotFoundError`` when there is
        none and ``ValueError`` when its encoder is not this one's (the
        editor's ``encoder_type`` and widths must match). Returns the
        checkpoint's path."""
        path = work_dir_or_ckpt
        if not path.endswith(".ckpt"):
            path, _ = get_last_checkpoint(work_dir_or_ckpt)
            if path is None:
                raise FileNotFoundError(
                    f"spec_denoiser_work_dir has no checkpoint: {work_dir_or_ckpt}")
        enc = load_subtree(path, "fs.encoder")
        want = model.txt_encoder.state_dict()
        if not all(isinstance(v, torch.Tensor) for v in enc.values()):   # a JAX subtree
            try:
                enc = text_conv_encoder_params_from_jax(
                    enc, len(self.hp["enc_dilations"]), self.hp.get("layers_in_block", 2))
            except KeyError as e:
                raise ValueError("the pretrained fs.encoder is not a conv text encoder "
                                 f"(encoder_type must match the denoiser's): no {e}") from e
        if sorted(enc) != sorted(want):
            raise ValueError("pretrained fs.encoder does not match txt_encoder (encoder_type "
                             f"must match the denoiser's):\n saved={sorted(enc)}\n "
                             f"want={sorted(want)}")
        for k, v in want.items():
            if tuple(enc[k].shape) != tuple(v.shape):
                raise ValueError(f"warm-start shape mismatch at {k}: "
                                 f"{tuple(enc[k].shape)} vs {tuple(v.shape)}")
        model.txt_encoder.load_state_dict(enc)
        print(f"| warm-started txt_encoder <- {path}:fs/encoder", flush=True)
        return path

    def make_loss_fn(self, model: StutterPredictor, train: bool = True):
        """``loss_fn(batch, generator=None)``."""
        bs = self.block_size

        def loss_fn(batch, generator=None):
            labels = block_labels(batch["stutter_mel_masks"], bs)
            logits = model(batch["txt_tokens"], batch["mels"], batch["mel2ph"], train=train,
                           generator=generator)["logits"]
            step = _step(batch, 1.0, logits)
            ce_w = torch.clamp(1e-2 * 6000.0 / torch.clamp(step, min=1.0), max=1e-2)
            losses = {"ce": cross_entropy_loss(logits, labels) * ce_w,
                      "focal": multi_focal_loss(logits, labels)}
            total = losses["ce"] + losses["focal"]
            with torch.no_grad():
                pred = logits.argmax(-1)
                right, n = global_sums(((pred == labels) & (pred <= 1)).sum(),
                                       torch.tensor(float(labels.numel()), device=pred.device))
                losses["acc"] = right / n
                stutter = labels == 1
                losses["acc_1"] = ratio(((pred == 1) & stutter).sum(), stutter.sum())
            return total, losses

        return loss_fn

    def build_infer_fn(self, model: StutterPredictor):
        """``stutter_pred`` [B, T / 16] (argmax of the logits); ``mel_out``
        is the ground-truth mel."""

        @torch.inference_mode()
        def infer_fn(batch, generator=None, noise=None):
            out = model(batch["txt_tokens"], batch["mels"], batch["mel2ph"])
            out["stutter_pred"] = out["logits"].argmax(-1)
            out["mel_out"] = batch["mels"]
            return out

        return infer_fn

    def meta_columns(self, out: dict, b: int, t_len: int) -> dict:
        n_blocks = -(-t_len // self.block_size)
        pred = out["stutter_pred"][b, :n_blocks].tolist()
        return {"stutter_pred": " ".join(str(int(p)) for p in pred)}

    def params_from_jax(self, params, hp: Any) -> dict:
        return stutter_predictor_params_from_jax(params, hp)
