"""The speaker (d-vector) encoder of the binarizer's ``with_spk_embed``
pass: resemblyzer's ``VoiceEncoder`` (GE2E, Wan et al. 2018), the port of
the JAX package's ``models/voice_encoder.py``.

A 3-layer LSTM(40 -> 256) over 160-frame partials of a 40-band power mel
at 16 kHz, then Linear(256, 256) and ReLU on the last step and an L2
normalisation; an utterance's embedding is the L2-normalised mean of its
overlapping partials' embeddings. The module's ``state_dict`` names are
resemblyzer's, so its ``pretrained.pt`` (``{"model_state": ...}``) loads
directly (``load_voice_encoder``). ``nn.LSTM`` runs on cuDNN on the card.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

VE_SR = 16000
VE_N_FFT = 400
VE_HOP = 160
VE_N_MELS = 40
VE_PARTIAL_FRAMES = 160


class VoiceEncoder(nn.Module):
    """Partial mels [B, T, 40] -> d-vectors [B, 256], L2-normalised."""

    def __init__(self, hidden: int = 256, n_layers: int = 3, out_dim: int = 256):
        super().__init__()
        self.lstm = nn.LSTM(VE_N_MELS, hidden, n_layers, batch_first=True)
        self.linear = nn.Linear(hidden, out_dim)

    def forward(self, mels: torch.Tensor) -> torch.Tensor:
        out, _ = self.lstm(mels)
        raw = F.relu(self.linear(out[:, -1]))
        return raw / (torch.linalg.vector_norm(raw, dim=-1, keepdim=True) + 1e-8)


@torch.no_grad()
def seeded_state_dict(generator: torch.Generator) -> dict[str, torch.Tensor]:
    """A :class:`VoiceEncoder` ``state_dict`` drawn from ``generator`` (a CPU
    generator): every weight and bias uniform in +-1/sqrt(256), torch's
    default range for the LSTM and the Linear."""
    model = VoiceEncoder()
    bound = model.lstm.hidden_size ** -0.5
    for p in model.parameters():
        p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
    return model.state_dict()


def ve_mel(wav_16k: np.ndarray) -> np.ndarray:
    """The 40-band power mel [T, 40] of a 16 kHz wav at resemblyzer's front
    end (n_fft 400, hop 160, no log)."""
    from speech_editing_tpu_torch.utils.audio.dsp import mel_filterbank, stft

    spec = np.abs(stft(wav_16k, VE_N_FFT, VE_HOP, VE_N_FFT)) ** 2
    fb = mel_filterbank(VE_SR, VE_N_FFT, VE_N_MELS, 0, VE_SR / 2)
    return (fb @ spec).T.astype(np.float32)


def compute_partial_slices(n_frames: int, rate: float = 1.3,
                           min_coverage: float = 0.75) -> list[tuple[int, int]]:
    """Overlapping [start, end) frame slices of VE_PARTIAL_FRAMES frames; a
    last slice that covers under ``min_coverage`` of a partial is dropped
    unless it is the only one."""
    frame_step = max(1, int(round(VE_SR / rate / VE_HOP)))
    slices = []
    for start in range(0, max(1, n_frames - VE_PARTIAL_FRAMES + frame_step + 1), frame_step):
        slices.append((start, min(start + VE_PARTIAL_FRAMES, n_frames)))
    if len(slices) > 1:
        last_start, last_end = slices[-1]
        if (last_end - last_start) / VE_PARTIAL_FRAMES < min_coverage:
            slices = slices[:-1]
    return slices


class VoiceEncoderCtx:
    """The binarizer's encoder: wav -> 256-d utterance embedding, the
    encoder on ``device`` (a CUDA device raises when there is none). Its
    weights are ``state_dict`` (resemblyzer's names) or, without one, drawn
    from ``generator`` (:func:`seeded_state_dict`)."""

    def __init__(self, state_dict: Optional[dict] = None, device: Any = "cuda",
                 generator: Optional[torch.Generator] = None):
        from speech_editing_tpu_torch.training.trainer import cuda_or_cpu

        self.device = cuda_or_cpu(device, "voice encoder")
        if state_dict is None:
            if generator is None:
                raise ValueError("VoiceEncoderCtx needs a state_dict or a generator")
            state_dict = seeded_state_dict(generator)
        self.model = VoiceEncoder()
        self.model.load_state_dict({k: v for k, v in state_dict.items()
                                    if k.startswith(("lstm.", "linear."))})
        self.model.to(self.device).eval()

    def partials(self, wav: np.ndarray, source_sr: int = 22050) -> np.ndarray:
        """The utterance's partial mels [n, 160, 40]: resampled to 16 kHz,
        the tail partial zero-padded."""
        from scipy.signal import resample_poly

        wav = np.asarray(wav, np.float32)
        if source_sr != VE_SR:
            g = np.gcd(int(source_sr), VE_SR)
            wav = resample_poly(wav, VE_SR // g, source_sr // g).astype(np.float32)
        mel = ve_mel(wav)
        parts = []
        for s, e in compute_partial_slices(len(mel)):
            p = mel[s:e]
            if len(p) < VE_PARTIAL_FRAMES:
                p = np.pad(p, ((0, VE_PARTIAL_FRAMES - len(p)), (0, 0)))
            parts.append(p)
        return np.stack(parts)

    @torch.no_grad()
    def embed_utterance(self, wav: np.ndarray, source_sr: int = 22050) -> np.ndarray:
        """The L2-normalised mean of the partials' embeddings, float32 [256]."""
        batch = torch.from_numpy(self.partials(wav, source_sr)).to(self.device)
        embeds = self.model(batch).cpu().numpy()
        mean = embeds.mean(0)
        return (mean / (np.linalg.norm(mean) + 1e-8)).astype(np.float32)


def load_voice_encoder(ckpt_path: str, device: Any = "cuda") -> VoiceEncoderCtx:
    """A context from a resemblyzer checkpoint (``torch.save`` of
    ``{"model_state": state_dict}`` or of the ``state_dict`` itself)."""
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    return VoiceEncoderCtx(payload.get("model_state", payload), device)
