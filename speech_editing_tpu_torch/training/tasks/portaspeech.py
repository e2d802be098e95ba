"""The PortaSpeech tasks: PortaSpeech (word-level VAE TTS) and
PortaSpeech-flow (with the Glow post-flow); the port of the JAX package's
``training/tasks/portaspeech.py``.

Losses: the mel losses (``mel_losses``, l1 and ssim by default), the KL
floored at ``kl_min``, warmed up linearly over ``kl_start_steps`` by the
step count (``global_step``, which ``TrainStep`` puts in the batch; the
eval step has none and takes the full weight) and scaled by
``lambda_kl``; the word-duration loss (the log-domain MSE of the predicted
word durations against those of ``mel2word``, over the words that are not
padding, times ``lambda_word_dur``); and PortaSpeech-flow's post-flow NLL.
The corpus is ``WordSpeechDataset``'s; the word vocabulary is the corpus's
``word_set.json`` (``hp["word_dict_size"]`` without one). ``--infer`` runs
the model with the dataset's ``mel2word`` and the prior's sample.

On the card each of the phone encoder's, the word encoder's (run twice)
and ``ph2word_encoder``'s self-attention layers is K3, and K4 in the
backward: 16 K3 and 16 K4 launches a step at the shipped four layers each.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from speech_editing_tpu_torch.data.datasets import WordSpeechDataset
from speech_editing_tpu_torch.models.portaspeech import PortaSpeech, PortaSpeechFlow
from speech_editing_tpu_torch.ops.seq_ops import mel2token_to_dur
from speech_editing_tpu_torch.training.losses import _weighted_mean, add_mel_loss
from speech_editing_tpu_torch.training.tasks.base import BaseTask
from speech_editing_tpu_torch.utils.convert_jax_params import portaspeech_params_from_jax
from speech_editing_tpu_torch.utils.init import init_like_flax
from speech_editing_tpu_torch.utils.text.text_encoder import build_token_encoder


def word_dur_loss(dur: torch.Tensor, mel2word: torch.Tensor,
                  word_tokens: torch.Tensor) -> torch.Tensor:
    """(log1p(predicted) - log1p(mel2word's durations))^2 over the words
    that are not padding."""
    nonpadding = (word_tokens != 0).float()
    dur_gt = mel2token_to_dur(mel2word, word_tokens.shape[1]).float() * nonpadding
    return _weighted_mean((torch.log1p(dur) - torch.log1p(dur_gt)) ** 2, nonpadding)


class PortaSpeechTask(BaseTask):
    dataset_cls = WordSpeechDataset
    array_batch_keys = ("txt_tokens", "word_tokens", "ph2word", "mel2word", "mels", "pitch")
    model_cls = PortaSpeech

    def __init__(self, hp: Any):
        super().__init__(hp)
        fn = os.path.join(hp.get("binary_data_dir", ""), "word_set.json")
        if os.path.exists(fn):
            self.word_encoder = build_token_encoder(fn)
            self.word_dict_size = self.word_encoder.vocab_size
        else:
            self.word_encoder = None
            self.word_dict_size = int(hp.get("word_dict_size", 10000))

    def build_model(self):
        return init_like_flax(self.model_cls(self.vocab_size, self.word_dict_size, self.hp,
                                             self.hp.get("audio_num_mel_bins", 80)))

    def forward(self, model, batch: dict, train: bool, generator=None, **draws) -> dict:
        """The training forward on a device batch; ``draws``: the model's
        (``eps``, ``warm_noise``)."""
        return model(batch["txt_tokens"], batch["word_tokens"], batch["ph2word"],
                     mel2word=batch["mel2word"], spk_embed=batch.get("spk_embed"),
                     pitch=batch.get("pitch"), tgt_mels=batch["mels"], train=train,
                     generator=generator, global_step=batch.get("global_step"), **draws)

    def add_losses(self, losses: dict, out: dict, batch: dict) -> None:
        """The mel losses against the target cut to the decoded frames."""
        add_mel_loss(losses, out["mel_out"], batch["mels"][:, :out["mel_out"].shape[1]],
                     self.hp.get("mel_losses", "l1:0.5|ssim:0.5"))

    def make_loss_fn(self, model, train: bool = True):
        """``loss_fn(batch, generator=None, **draws) -> (total, losses)``."""
        hp = self.hp
        lambda_kl = float(hp.get("lambda_kl", 1.0))
        kl_min = float(hp.get("kl_min", 0.0))
        kl_start = float(hp.get("kl_start_steps", 10000))

        def loss_fn(batch, generator=None, **draws):
            out = self.forward(model, batch, train, generator, **draws)
            losses: dict = {}
            self.add_losses(losses, out, batch)
            warm = torch.clamp(torch.as_tensor(batch.get("global_step", kl_start)) / kl_start,
                               max=1.0)
            losses["kl"] = out["kl"].clamp(min=kl_min) * warm * lambda_kl
            losses["wdur"] = (word_dur_loss(out["dur"], batch["mel2word"], batch["word_tokens"])
                              * hp.get("lambda_word_dur", 1.0))
            if "postflow_nll" in out:
                losses["postflow"] = out["postflow_nll"]
            return sum(losses.values()), losses

        return loss_fn

    def build_infer_fn(self, model):
        """``infer_fn(batch, generator=None, noise=None, **draws) -> out``:
        the dataset's ``mel2word``, the prior's sample at ``noise_scale``
        (``draws``: the model's ``z_prior``, ``z_flow``)."""
        hp = self.hp

        @torch.inference_mode()
        def infer_fn(batch, generator=None, noise=None, **draws):
            return model(batch["txt_tokens"], batch["word_tokens"], batch["ph2word"],
                         mel2word=batch.get("mel2word"), spk_embed=batch.get("spk_embed"),
                         pitch=batch.get("pitch"), infer=True, generator=generator,
                         noise_scale=hp.get("noise_scale", 0.8), **draws)

        return infer_fn

    def params_from_jax(self, params, hp: Any) -> dict:
        return portaspeech_params_from_jax(params, hp)


class PortaSpeechFlowTask(PortaSpeechTask):
    model_cls = PortaSpeechFlow
