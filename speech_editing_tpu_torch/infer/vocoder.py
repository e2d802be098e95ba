"""Vocoder registry (mel -> wav): the port's ``infer/vocoder.py``.

``hp["vocoder"]`` names the class (lowercased class names: ``hifigan``,
``griffinlim``). A vocoder's ``spec2wav(mel [T, 80]) -> wav [N]`` and
``spec2wav_batch(mels [B, T, 80]) -> wav [B, N]`` take and return numpy.
``HifiGAN`` loads the last checkpoint of ``hp["vocoder_ckpt"]`` (a port
checkpoint or a JAX one) with the directory's ``config.yaml`` into the
port's generator on the device; as in the JAX package it falls back to
Griffin-Lim when no checkpoint is there, and says so. ``kind`` names the
vocoder that runs. A vocoder whose ``device_batched`` is set also takes
device tensors (``spec2wav_batch_dev``), for the batch server, which pads
its chunks to static shapes for it. :func:`pcm16` is ``save_wav``'s 16-bit
conversion on a tensor.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from speech_editing_tpu_torch.infer.quant import maybe_quantized, weights

VOCODERS: dict = {}


def register_vocoder(name: Optional[str] = None):
    def wrap(cls):
        VOCODERS[(name or cls.__name__).lower()] = cls
        return cls
    return wrap


def get_vocoder_cls(name: str):
    return VOCODERS[name.lower()]


def pcm16(wav: torch.Tensor) -> torch.Tensor:
    """16-bit PCM of a float wav on its own device, bit for bit the samples
    ``utils/audio/io.py::save_wav`` writes: clip to [-1, 1], times 32767 in
    float32, truncated to int16."""
    return (wav.float().clamp(-1.0, 1.0) * 32767.0).to(torch.int16)


class BaseVocoder:
    kind = ""
    #: True when ``spec2wav_batch_dev`` runs one device program on the
    #: whole batch (the server then vocodes its padded chunks on the device)
    device_batched = False

    def spec2wav(self, mel: np.ndarray, **kw) -> np.ndarray:
        raise NotImplementedError

    def spec2wav_batch(self, mels: np.ndarray, **kw) -> np.ndarray:
        """mels [B, T, 80] -> wavs [B, N], one item at a time."""
        return np.stack([self.spec2wav(m, **kw) for m in np.asarray(mels)])


@register_vocoder("GriffinLim")
class GriffinLim(BaseVocoder):
    """Host numpy Griffin-Lim over the filterbank's pseudo-inverse."""

    kind = "griffinlim"

    def __init__(self, hp: Any, device: Any = None):
        self.hp = hp

    def spec2wav(self, mel: np.ndarray, **kw) -> np.ndarray:
        from speech_editing_tpu_torch.utils.audio.griffin_lim import mel2wav_griffin_lim

        hp = self.hp
        return mel2wav_griffin_lim(
            np.asarray(mel), sample_rate=hp["audio_sample_rate"], n_fft=hp["fft_size"],
            hop_size=hp["hop_size"], num_mels=hp["audio_num_mel_bins"], fmin=hp["fmin"],
            fmax=hp["fmax"])


@register_vocoder("HifiGAN")
class HifiGAN(BaseVocoder):
    """HiFi-GAN from ``hp["vocoder_ckpt"]``: a directory holding
    ``model_ckpt_steps_*.ckpt`` and the generator's ``config.yaml``. A port
    checkpoint holds the generator's ``state_dict`` under
    ``state["model"]``; a JAX one a ``GanTrainState`` or a parameter tree
    (``training/checkpoint.py``). ``device`` defaults to ``"cuda"``, which
    raises without a GPU. ``serve_quant_int8`` keeps the generator's
    weights in int8 (``infer/quant.py``), as the JAX package's vocoder
    does."""

    def __init__(self, hp: Any, device: Any = "cuda"):
        from speech_editing_tpu_torch.config.hparams import read_yaml
        from speech_editing_tpu_torch.models.vocoder.hifigan import HifiGanGenerator
        from speech_editing_tpu_torch.training.checkpoint import (get_last_checkpoint,
                                                                  load_checkpoint)
        from speech_editing_tpu_torch.training.trainer import cuda_or_cpu
        from speech_editing_tpu_torch.utils.convert_jax_params import vocoder_params_from_jax

        self.hp = hp
        self.device = cuda_or_cpu(device, "HifiGAN")
        ckpt_dir = hp.get("vocoder_ckpt", "") or ""
        config_path = os.path.join(ckpt_dir, "config.yaml")
        ckpt_path = get_last_checkpoint(ckpt_dir)[0] if os.path.isdir(ckpt_dir) else None
        self.generator = None
        if ckpt_path and os.path.exists(config_path):
            vhp = read_yaml(config_path)
            payload = load_checkpoint(ckpt_path)
            sd = (vocoder_params_from_jax(payload["jax_params"], vhp)
                  if "jax_params" in payload else payload["state"]["model"])
            self.generator = HifiGanGenerator(vhp)
            self.generator.load_state_dict(sd)
            self.generator.to(self.device).eval()
            self.quant = maybe_quantized(hp, self.generator, self.device, "HiFi-GAN")
            self.kind = "hifigan"
            self.device_batched = True
            print(f"| vocoder: HiFi-GAN from {ckpt_path} on {self.device}", flush=True)
        else:
            self._fallback = GriffinLim(hp)
            self.kind = GriffinLim.kind
            print(f"| vocoder: Griffin-Lim on the host (no HiFi-GAN checkpoint and "
                  f"config.yaml in vocoder_ckpt {ckpt_dir!r})", flush=True)

    @torch.inference_mode()
    def spec2wav_batch_dev(self, mels: torch.Tensor) -> torch.Tensor:
        """mels [B, T, 80] on the device -> wavs [B, N] there, one generator
        call; only with ``device_batched``."""
        with weights(self.quant):
            return self.generator(mels)

    def _generate(self, mels: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(mels, np.float32)).to(self.device)
        return self.spec2wav_batch_dev(x).cpu().numpy()

    def spec2wav(self, mel: np.ndarray, **kw) -> np.ndarray:
        if self.generator is None:
            return self._fallback.spec2wav(mel, **kw)
        return self._generate(np.asarray(mel)[None])[0]

    def spec2wav_batch(self, mels: np.ndarray, **kw) -> np.ndarray:
        if self.generator is None:
            return self._fallback.spec2wav_batch(mels, **kw)
        return self._generate(mels)
