"""The region-edit entry point: wav + edit spec -> (edited wav, edited mel).

``EditPipeline`` runs the FluentSpeech edit end to end on one device:
log-mel (kernel K2) and f0 of the source wav, the masked conditioner and
the reverse diffusion (kernels K3 and K1), the composite of the generated
region into the source mel, and HiFi-GAN.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from speech_editing_tpu_torch.models.spec_denoiser.spec_denoiser import GaussianDiffusion
from speech_editing_tpu_torch.models.vocoder.hifigan import HifiGanGenerator
from speech_editing_tpu_torch.ops.cuda.mel_kernel import mel_spectrogram
from speech_editing_tpu_torch.ops.mel import MelConfig
from speech_editing_tpu_torch.ops.pitch import extract_pitch, norm_interp_f0
from speech_editing_tpu_torch.utils.init import init_like_flax


class EditPipeline:
    """Weights are seeded random, drawn as flax draws them
    (``utils/init.py``), until loaded through ``model`` and
    ``vocoder`` (``load_state_dict``; see ``utils/convert_jax_params.py``).

    ``device`` defaults to ``"cuda"`` and raises when no GPU is present;
    ``device="cpu"`` runs every kernel's plain version."""

    def __init__(self, hp: Any, vocoder_hp: Any, device="cuda", vocab_size: int = 80,
                 mel_cfg: MelConfig = MelConfig(), seed: int = 0):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("EditPipeline: no CUDA device; pass device='cpu' "
                               "to run the plain versions")
        self.mel_cfg = mel_cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = init_like_flax(GaussianDiffusion(vocab_size, hp, mel_cfg.num_mels))
            self.vocoder = init_like_flax(HifiGanGenerator(vocoder_hp))
        self.model.to(self.device).eval()
        self.vocoder.to(self.device).eval()

    @torch.inference_mode()
    def __call__(self, wav: torch.Tensor, txt_tokens: torch.Tensor,
                 mel2ph: torch.Tensor, time_mel_masks: torch.Tensor,
                 generator: torch.Generator | None = None,
                 noise: Sequence[torch.Tensor] | None = None):
        """wav [B, N]; txt_tokens [B, S]; mel2ph [B, T]; time_mel_masks
        [B, T, 1] (1 = regenerate). Returns (wav_out [B, T * hop_total],
        mel_out [B, T, M]): the generated region composited into the mel of
        ``wav``. ``generator`` / ``noise``: see ``GaussianDiffusion.forward``."""
        cfg = self.mel_cfg
        t = mel2ph.shape[1]
        mel = mel_spectrogram(wav, cfg)[:, :t]
        f0, uv = zip(*(norm_interp_f0(extract_pitch(
            row, cfg.hop_size, cfg.sample_rate, 80.0, 600.0)[:t]) for row in wav))
        out = self.model(txt_tokens, time_mel_masks, mel2ph, None, mel,
                         torch.stack(f0), torch.stack(uv),
                         generator=generator, noise=noise)
        mel_out = out["mel_out"] * time_mel_masks + mel * (1 - time_mel_masks)
        return self.vocoder(mel_out), mel_out
