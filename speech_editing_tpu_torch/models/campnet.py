"""CampNet: coarse-to-fine context-aware mask prediction, the port of the JAX
package's ``models/campnet.py``.

A 3-layer FFT text encoder; the masked mel frames replaced by a learned
``mask_emb``; a 6-layer cross-attending coarse decoder whose frame
self-attention is kernel K3 (``TransformerDecoder``); a residual
``ConvBlocks`` fine decoder over the coarse-composited mel. Parameter names
are the reference torch module's, as ``convert_campnet`` reads them.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from speech_editing_tpu_torch.modules.conv import ConvBlocks
from speech_editing_tpu_torch.modules.predictors import MelEncoder
from speech_editing_tpu_torch.modules.transformer import FastSpeechEncoder, TransformerDecoder


class CampNet(nn.Module):
    def __init__(self, vocab_size: int, hp: Any, out_dims: int = 80):
        super().__init__()
        self.hp = hp
        h = hp["hidden_size"]
        k = hp["dec_ffn_kernel_size"]
        self.encoder = FastSpeechEncoder(vocab_size, h, num_layers=3, kernel_size=k,
                                         num_heads=2)
        self.mel_encoder = MelEncoder(out_dims, h)
        self.decoder_coarse = TransformerDecoder(h, num_layers=6, ffn_kernel_size=k,
                                                 num_heads=2)
        self.decoder_fine = ConvBlocks(h, h, (1,) * 5, kernel_size=5,
                                       norm_type=hp.get("enc_dec_norm", "ln"),
                                       layers_in_block=2)
        self.mel_out_coarse = nn.Linear(h, out_dims, bias=False)
        self.mel_out_fine = nn.Linear(h, out_dims, bias=False)
        self.mask_emb = nn.Parameter(torch.zeros(1, 1, out_dims))

    def forward(self, txt_tokens, mels, time_mel_masks) -> dict:
        """txt_tokens [B, S]; mels [B, T, 80] (zero rows at padded frames);
        time_mel_masks [B, T, 1] -> ``mel_out_coarse``, ``mel_out_fine``
        [B, T, 80] and ``attn`` [B, T, S]."""
        src_nonpadding = (txt_tokens > 0).to(mels.dtype)[:, :, None]
        encoder_out = self.encoder(txt_tokens) * src_nonpadding
        mel_nonpadding = (mels.abs().sum(-1) > 0).to(mels.dtype)[:, :, None]
        tm = time_mel_masks
        coarse_in = self.mel_encoder(mels * (1 - tm) + self.mask_emb * tm) * mel_nonpadding
        # padded frames are masked at the self-attention keys too, unless
        # ref_pad_compat keeps the reference's value-only masking (see the
        # JAX package's models/campnet.py)
        frame_pad = mel_nonpadding[..., 0] == 0
        coarse_h, attn = self.decoder_coarse(
            coarse_in, encoder_out, encoder_padding_mask=txt_tokens == 0,
            self_attn_padding_mask=None if self.hp.get("ref_pad_compat") else frame_pad,
            padding_mask=frame_pad)
        mel_out_coarse = self.mel_out_coarse(coarse_h * mel_nonpadding) * mel_nonpadding

        mel_coarse = mels * (1 - tm) + mel_out_coarse * tm
        fine_in = self.mel_encoder(mel_coarse) * mel_nonpadding
        fine_nonpadding = (fine_in.abs().sum(-1, keepdim=True) > 0).to(fine_in.dtype)
        fine = self.decoder_fine(fine_in, fine_nonpadding) * mel_nonpadding
        mel_out_fine = mel_coarse + self.mel_out_fine(fine) * mel_nonpadding * tm
        return {"mel_out_coarse": mel_out_coarse, "mel_out_fine": mel_out_fine, "attn": attn}
