"""A3T: alignment-aware acoustic and text joint conformer, the port of the JAX
package's ``models/a3t.py``.

The masked mel's embedding and the phone embedding, each scaled by
sqrt(H) and tied by segment embeddings (mel2ph for the frames, the phone's
own index for the phones), run concatenated along time through a 4-layer
conformer encoder (k=9) and a 4-layer conformer decoder (k=31); the mel
part is projected to 80 bins, composited with the source, and refined by a
5-conv Postnet. Position rows restart at the mel/text boundary and are
zero at padding. ``serve_pad_safe_a3t`` moves each row's padding to the
end of the joint sequence (a stable sort), masks the conformer and Postnet
convs and evaluates the rel-shift at each row's true length, so bucket
padding is inert; at exact fit it changes nothing. ``espnet_bn_affine``
selects the reference's BatchNorm (eval mode) for the conv module's and
the Postnet's norms. Parameter names are the reference torch module's
(``encoder.{txt_embed, mel_embed, seg_embed, encoder_layers, layer_norm}``,
``a3t_decoder``, ``a3t_postnet.postnet.{i}.{0,1}``, ``mel_out_decoder``),
as ``convert_a3t`` reads them.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from speech_editing_tpu_torch.modules.conformer import (ConformerLayers, espnet_rel_pos_emb,
                                                        make_norm)
from speech_editing_tpu_torch.modules.conv import conv_same
from speech_editing_tpu_torch.modules.predictors import MelEncoder
from speech_editing_tpu_torch.modules.transformer import TokenEmbedding
from speech_editing_tpu_torch.utils.dtypes import weak


class Postnet(nn.Module):
    """Bias-free 5-wide convs, each followed by a norm, with tanh after all
    but the last; with ``nonpadding`` [B, T] each conv's input is masked."""

    def __init__(self, idim: int, odim: int = 80, n_layers: int = 5, n_chans: int = 256,
                 kernel_size: int = 5, norm_type: str = "ln"):
        super().__init__()
        dims = [idim] + [n_chans] * (n_layers - 1) + [odim]
        self.postnet = nn.ModuleList(
            nn.Sequential(nn.Conv1d(dims[i], dims[i + 1], kernel_size, bias=False),
                          make_norm(norm_type, dims[i + 1]))
            for i in range(n_layers))

    def forward(self, x, nonpadding=None):
        for i, (conv, norm) in enumerate(self.postnet):
            if nonpadding is not None:
                x = x * nonpadding[:, :, None]
            x = norm(conv_same(conv, x))
            if i < len(self.postnet) - 1:
                x = torch.tanh(x)
        return x


class _JointEncoder(ConformerLayers):
    """The reference's ``encoder``: the conformer stack with the three
    embeddings it owns."""

    def __init__(self, vocab_size: int, h: int, out_dims: int, norm_type: str, pad_safe: bool):
        super().__init__(h, num_layers=4, kernel_size=9, norm_type=norm_type, pad_safe=pad_safe)
        self.txt_embed = TokenEmbedding(vocab_size, h)
        self.mel_embed = MelEncoder(out_dims, h)
        self.seg_embed = TokenEmbedding(2000, h)


class A3T(nn.Module):
    def __init__(self, vocab_size: int, hp: Any, out_dims: int = 80):
        super().__init__()
        self.hp = hp
        h = self.hidden_size = hp["hidden_size"]
        norm_type = "affine" if hp.get("espnet_bn_affine") else "ln"
        self.pad_safe = bool(hp.get("serve_pad_safe_a3t", False))
        self.encoder = _JointEncoder(vocab_size, h, out_dims, norm_type, self.pad_safe)
        self.a3t_decoder = ConformerLayers(h, num_layers=4, kernel_size=31,
                                           norm_type=norm_type, pad_safe=self.pad_safe)
        self.a3t_postnet = Postnet(h, out_dims, norm_type=norm_type)
        self.mel_out_decoder = nn.Linear(h, out_dims)

    def forward(self, txt_tokens, mels, mel2ph, time_mel_masks) -> dict:
        """txt_tokens [B, S]; mels [B, T, 80]; mel2ph [B, T];
        time_mel_masks [B, T, 1] -> ``mel_out_decoder``, ``mel_out_postnet``
        [B, T, 80]."""
        enc = self.encoder
        h, dev = self.hidden_size, mels.device
        xscale = weak(math.sqrt(h), mels)
        txt_nonpadding = (txt_tokens > 0).to(mels.dtype)
        mel_nonpadding = (mel2ph > 0).to(mels.dtype)
        t_mel, s_txt = mels.shape[1], txt_tokens.shape[1]

        ph2ph = torch.arange(1, s_txt + 1, device=dev)[None, :].expand_as(txt_tokens)
        txt_feat = enc.txt_embed(txt_tokens) * txt_nonpadding[:, :, None]
        txt_feat = txt_feat * xscale + enc.seg_embed(ph2ph)
        mel_feat = enc.mel_embed(mels * (1 - time_mel_masks)) * mel_nonpadding[:, :, None]
        mel_feat = mel_feat * xscale + enc.seg_embed(mel2ph.long())

        nonpadding = torch.cat([mel_nonpadding, txt_nonpadding], dim=1)
        x = torch.cat([mel_feat, txt_feat], dim=1) * nonpadding[:, :, None]
        pos_emb = torch.cat([espnet_rel_pos_emb(t_mel, h, dev),
                             espnet_rel_pos_emb(s_txt, h, dev)])[None]
        pos_emb = pos_emb * nonpadding[:, :, None]
        if self.pad_safe:
            # each row's valid positions first: [mel | text | padding]
            order = torch.argsort((nonpadding <= 0).int(), dim=1, stable=True)
            take = order[:, :, None].expand(-1, -1, h)
            x = torch.gather(x, 1, take)
            pos_emb = torch.gather(pos_emb, 1, take)
            nonpadding = torch.gather(nonpadding, 1, order)

        x = enc(x, pos_emb, nonpadding)
        dec = self.a3t_decoder(x, pos_emb, nonpadding)
        dec = dec[:, :t_mel] * mel_nonpadding[:, :, None]
        mel_out_decoder = self.mel_out_decoder(dec) * mel_nonpadding[:, :, None]

        mel_decoder = mels * (1 - time_mel_masks) + mel_out_decoder * time_mel_masks
        post_in = enc.mel_embed(mel_decoder) * mel_nonpadding[:, :, None]
        post = self.a3t_postnet(post_in, mel_nonpadding if self.pad_safe else None)
        post = post * mel_nonpadding[:, :, None]
        return {"mel_out_decoder": mel_out_decoder,
                "mel_out_postnet": mel_decoder + post * time_mel_masks}
