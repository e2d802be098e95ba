"""Training losses of the editing families, on torch tensors.

Port of the JAX package's ``training/losses.py``: the weighted mel losses
(spec string "l1:0.5|ssim:0.5"), the phoneme/word/sentence duration losses,
the uv-BCE + f0-L1 pitch loss, and StutterSpeech's class-weighted focal
loss and cross entropy. The word-duration sums run over a static
``S + 1`` word segments (a word count never exceeds the token count) with
``segment_sum``.

Every normaliser is the global batch's: inside
``parallel.mesh.data_parallel`` a weighted mean divides the sum over all
ranks' rows by the sum of all ranks' weights, and a plain mean counts every
rank's elements (the padding rows that ``pad_batch_to_multiple`` adds
among them, as JAX's means over a padded batch count them), so each rank
holds the loss of the global batch, as JAX's loss over a batch-sharded
input is.
"""

from __future__ import annotations

from typing import Dict

import torch

from speech_editing_tpu_torch.ops.seq_ops import (mel2token_to_dur, segment_sum,
                                                  weights_nonzero_speech)
from speech_editing_tpu_torch.ops.ssim import ssim_map
from speech_editing_tpu_torch.parallel.mesh import active_data_mesh, global_mean, global_sums


def parse_mel_losses(spec: str) -> Dict[str, float]:
    """'l1:0.5|ssim:0.5' -> {'l1': 0.5, 'ssim': 0.5}."""
    out: Dict[str, float] = {}
    for part in spec.split("|"):
        if not part:
            continue
        if ":" in part:
            name, w = part.split(":")
            out[name] = float(w)
        else:
            out[part] = 1.0
    return out


def _weighted_mean(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return ratio((values * weights).sum(), weights.sum())


def ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / max(den, 1)`` of the global batch's sums (``den`` carries no
    gradient)."""
    if active_data_mesh() is None:
        return num / den.clamp(min=1.0)
    dtype = num.dtype
    num, den = global_sums(num, den)
    return (num / den.clamp(min=1.0)).to(dtype)


def l1_loss(mel_out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return _weighted_mean((mel_out - target).abs(), weights_nonzero_speech(target))


def mse_loss(mel_out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return _weighted_mean((mel_out - target) ** 2, weights_nonzero_speech(target))


def ssim_loss(mel_out: torch.Tensor, target: torch.Tensor,
              bias: float = 6.0) -> torch.Tensor:
    """1 - SSIM per frame, weighted by nonzero target frames."""
    smap = ssim_map(mel_out + bias, target + bias)
    return _weighted_mean(1.0 - smap, weights_nonzero_speech(target))


MEL_LOSS_FNS = {"l1": l1_loss, "mse": mse_loss, "ssim": ssim_loss}


def add_mel_loss(losses: dict, mel_out, target, mel_losses_spec: str,
                 postfix: str = "") -> None:
    mel_out, target = mel_out.float(), target.float()
    for name, lam in parse_mel_losses(mel_losses_spec).items():
        losses[f"{name}{postfix}"] = MEL_LOSS_FNS[name](mel_out, target) * lam


def dur_loss(losses: dict, dur_pred: torch.Tensor, mel2ph: torch.Tensor,
             txt_tokens: torch.Tensor, is_sil: torch.Tensor, hp) -> None:
    """Phoneme/word/sentence duration losses. dur_pred [B, S] linear-scale
    predictions; is_sil [B, S] float mask of silence tokens."""
    b, s = txt_tokens.shape
    nonpadding = (txt_tokens != 0).float()
    dur_gt = mel2token_to_dur(mel2ph, s).float() * nonpadding
    pdur = (torch.log1p(dur_pred) - torch.log1p(dur_gt)) ** 2
    losses["pdur"] = _weighted_mean(pdur, nonpadding) * hp["lambda_ph_dur"]
    if hp.get("lambda_word_dur", 0) > 0:
        # word id = running count of silences, zeroed on the silence itself;
        # segment 0 collects the silences and is dropped
        word_id = (torch.cumsum(is_sil, -1) * (1 - is_sil)).long()
        seg_sum = lambda v: segment_sum(v, word_id, s + 1)[:, 1:]

        word_dur_p, word_dur_g = seg_sum(dur_pred), seg_sum(dur_gt)
        wdur = (torch.log1p(word_dur_p) - torch.log1p(word_dur_g)) ** 2
        losses["wdur"] = (_weighted_mean(wdur, (word_dur_g > 0).float())
                          * hp["lambda_word_dur"])
    if hp.get("lambda_sent_dur", 0) > 0:
        sent_p, sent_g = dur_pred.sum(-1), dur_gt.sum(-1)
        losses["sdur"] = (global_mean((torch.log1p(sent_p) - torch.log1p(sent_g)) ** 2)
                          * hp["lambda_sent_dur"])


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy with logits (optax's form)."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def pitch_loss(losses: dict, pitch_pred: torch.Tensor, f0: torch.Tensor,
               uv: torch.Tensor, mel2ph: torch.Tensor, hp) -> None:
    """uv BCE-with-logits + voiced-frame f0 L1."""
    nonpadding = (mel2ph != 0).float()
    if hp.get("use_uv", True) and hp.get("pitch_type", "frame") == "frame":
        bce = sigmoid_bce(pitch_pred[:, :, 1], uv)
        losses["uv"] = _weighted_mean(bce, nonpadding) * hp["lambda_uv"]
        nonpadding = nonpadding * (uv == 0).float()
    f0_l1 = (pitch_pred[:, :, 0] - f0).abs()
    losses["f0"] = _weighted_mean(f0_l1, nonpadding) * hp["lambda_f0"]


def multi_focal_loss(logits: torch.Tensor, target: torch.Tensor,
                     alpha=(1e-3, 1.0, 0.0), gamma: float = 5.0,
                     smooth: float = 1e-6) -> torch.Tensor:
    """Class-weighted focal loss over [B, T, C] logits and [B, T] integer
    targets; ``alpha`` weighs the classes (fluent, stutter, pad)."""
    probs = torch.softmax(logits, dim=-1)
    log_probs = torch.log(probs.clamp(min=1e-12))
    tgt = target.long()[..., None]
    p_t = probs.gather(-1, tgt)[..., 0] + smooth
    logp_t = log_probs.gather(-1, tgt)[..., 0] + smooth
    a = torch.tensor(alpha, dtype=logits.dtype, device=logits.device)[target.long()]
    return global_mean(-a * (1.0 - p_t) ** gamma * logp_t)


def cross_entropy_loss(logits: torch.Tensor, target: torch.Tensor,
                       ignore_index: int = -1) -> torch.Tensor:
    """Mean cross entropy over [B, T, C] logits and [B, T] integer targets,
    positions at ``ignore_index`` left out."""
    tgt = target.long()
    ignored = tgt == ignore_index
    valid = (~ignored).float()   # float32 whatever the logits' dtype, as in JAX
    safe = tgt.masked_fill(ignored, 0)[..., None]
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, safe)[..., 0]
    return ratio((nll * valid).sum(), valid.sum())


def sil_token_mask(txt_tokens: torch.Tensor, sil_token_ids) -> torch.Tensor:
    """[B, S] float mask of tokens in the silence-phoneme id set."""
    is_sil = torch.zeros_like(txt_tokens, dtype=torch.bool)
    for tid in sil_token_ids:
        is_sil = is_sil | (txt_tokens == tid)
    return is_sil.float()
