"""Plain PyTorch reference of the ``fluentspeech`` configuration: the FluentSpeech
editor (Jiang et al., ACL 2023) as configured by ``configs/fluentspeech.json``
(a conv text encoder, speaker embeddings, the duration and pitch predictors
with masked ground-truth anchors, the masked-mel encoder and a 20 x 256
x0-predicting DiffNet under an 8-step VP-SDE schedule), float32, no kernels,
no batching beyond what a caller passes.

Parameter names are the ``state_dict`` names of the published torch modules,
so one state dict made by ``weights.py`` loads into this module and into the
program under test. The training loss draws its dropout masks, the diffusion
step and the noise from one ``torch.Generator`` in the order the published
training step draws them (the duration predictor's three dropout masks, the
pitch predictor's five, ``t``, the noise), so a generator seeded alike gives
both sides the same draws. This file imports no code of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# -- small pieces -----------------------------------------------------------------


def dropout(x, rate, generator):
    keep = 1.0 - rate
    mask = torch.bernoulli(torch.full(x.shape, keep, dtype=x.dtype, device=x.device),
                           generator=generator)
    return x * mask / keep


def grad_scale(x, scale):
    """Identity forward, ``scale`` times the gradient backward."""
    return x if scale == 1.0 else x.detach() + scale * (x - x.detach())


def conv_same(conv: nn.Conv1d, x):
    """``conv`` over [B, T, C] with SAME padding, the low half first."""
    total = conv.dilation[0] * (conv.kernel_size[0] - 1)
    y = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
    return conv(y).transpose(1, 2)


class Embedding(nn.Embedding):
    """An embedding whose id 0 gives a zero row."""

    def forward(self, ids):
        return super().forward(ids) * (ids != 0)[..., None]


def expand_states(h, mel2token):
    h = F.pad(h, (0, 0, 1, 0))
    ids = mel2token.long().clamp(0, h.shape[1] - 1)
    return torch.gather(h, 1, ids[:, :, None].expand(-1, -1, h.shape[2]))


def mel2token_to_dur(mel2token, n_tokens):
    ids = mel2token.long()
    dur = torch.zeros(ids.shape[0], n_tokens + 1, dtype=torch.long, device=ids.device)
    dur.scatter_add_(1, ids.clamp(0, n_tokens), ((ids >= 0) & (ids <= n_tokens)).long())
    return dur[:, 1:]


def f0_to_coarse(f0, f0_bin=256, f0_max=900.0, f0_min=50.0):
    mel_min = 1127 * math.log(1 + f0_min / 700)
    mel_max = 1127 * math.log(1 + f0_max / 700)
    f0_mel = 1127 * torch.log(1 + f0 / 700)
    scaled = (f0_mel - mel_min) * (f0_bin - 2) / (mel_max - mel_min) + 1
    f0_mel = torch.where(f0_mel > 0, scaled, f0_mel)
    return torch.round(f0_mel.clamp(1, f0_bin - 1)).long()


def denorm_f0(f0, uv, pitch_padding=None):
    f0 = (2.0 ** f0).clamp(50.0, 900.0)
    if uv is not None:
        f0 = torch.where(uv > 0, torch.zeros_like(f0), f0)
    if pitch_padding is not None:
        f0 = torch.where(pitch_padding, torch.zeros_like(f0), f0)
    return f0


# -- the conditioner --------------------------------------------------------------


class ResidualBlock(nn.Module):
    def __init__(self, c, kernel_size, dilation, n):
        super().__init__()
        self.kernel_size = kernel_size
        self.blocks = nn.ModuleList(
            nn.Sequential(nn.LayerNorm(c, eps=1e-5), nn.Conv1d(c, 2 * c, kernel_size,
                                                              dilation=dilation),
                          nn.Identity(), nn.GELU(), nn.Conv1d(2 * c, c, 1))
            for _ in range(n))

    def forward(self, x, nonpadding):
        for norm, conv, _, _, proj in self.blocks:
            h = conv_same(conv, norm(x) * nonpadding) * self.kernel_size ** -0.5
            x = (x + conv_same(proj, F.gelu(h))) * nonpadding
        return x


class TextConvEncoder(nn.Module):
    def __init__(self, vocab, hp):
        super().__init__()
        h = hp["hidden_size"]
        self.hidden = h
        self.res_blocks = nn.ModuleList(
            ResidualBlock(h, hp["enc_kernel_size"], d, hp["layers_in_block"])
            for d in hp["enc_dilations"])
        self.last_norm = nn.LayerNorm(h, eps=1e-5)
        self.post_net1 = nn.Conv1d(h, h, hp["enc_post_net_kernel"])
        self.embed_tokens = Embedding(vocab, h)

    def forward(self, tokens):
        x = self.embed_tokens(tokens) * math.sqrt(self.hidden)
        nonpad = (tokens != 0)[:, :, None].float()
        for block in self.res_blocks:
            x = block(x, nonpad)
        x = self.last_norm(x * nonpad) * nonpad
        return conv_same(self.post_net1, x) * nonpad


class ConvPredictor(nn.Module):
    """conv -> ReLU -> LayerNorm -> dropout per layer, re-masked; a linear head."""

    def __init__(self, h, n_layers, kernel_size, head, rate):
        super().__init__()
        self.kernel_size, self.rate = kernel_size, rate
        self.conv = nn.ModuleList(nn.Sequential(nn.Conv1d(h, h, kernel_size), nn.ReLU(),
                                                nn.LayerNorm(h, eps=1e-5))
                                  for _ in range(n_layers))
        self.linear = head

    def forward(self, x, padding, generator=None):
        k = self.kernel_size
        keep = (~padding)[:, :, None].float() if padding is not None else None
        for conv, _, ln in self.conv:
            x = ln(torch.relu(conv(F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))))
                   .transpose(1, 2))
            if generator is not None:
                x = dropout(x, self.rate, generator)
            if keep is not None:
                x = x * keep
        x = self.linear(x)
        return x if keep is None else x * keep


class Conditioner(nn.Module):
    """FastSpeech as FluentSpeech's masked conditioner (``fs.*``)."""

    def __init__(self, vocab, hp):
        super().__init__()
        h = hp["hidden_size"]
        self.hp = hp
        self.encoder = TextConvEncoder(vocab, hp)
        self.spk_embed_proj = nn.Linear(256, h)
        self.dur_embed = Embedding(2000, h)
        self.dur_predictor = ConvPredictor(h, hp["dur_predictor_layers"],
                                           hp["dur_predictor_kernel"],
                                           nn.Sequential(nn.Linear(h, 1), nn.Softplus()),
                                           hp["predictor_dropout"])
        self.pitch_embed = Embedding(300, h)
        self.pitch_predictor = ConvPredictor(h, 5, hp["predictor_kernel"], nn.Linear(h, 2), 0.2)

    def durations(self, dur_inp, tokens, masked_dur, generator=None):
        dur_inp = dur_inp + self.dur_embed(masked_dur.long())
        dur_inp = grad_scale(dur_inp, self.hp["predictor_grad"])
        return self.dur_predictor(dur_inp, tokens == 0, generator)[..., 0]

    def pitch(self, pitch_inp, tm, f0, uv, mel2ph, use_pred_pitch, generator=None):
        padding = mel2ph == 0
        keep = 1 - tm[..., 0]
        masked_gt = denorm_f0(f0 * keep, uv * keep, padding)
        pitch_inp = grad_scale(pitch_inp + self.pitch_embed(f0_to_coarse(masked_gt)),
                               self.hp["predictor_grad"])
        pred = self.pitch_predictor(pitch_inp, padding, generator)
        if use_pred_pitch:
            m = tm[..., 0]
            res_f0 = f0 * (1 - m) + pred[:, :, 0] * m
            res_uv = uv * (1 - m) + (pred[:, :, 1] > 0).float() * m
            f0_denorm = denorm_f0(res_f0, res_uv)
        else:
            f0_denorm = denorm_f0(f0, uv, padding)
        return self.pitch_embed(f0_to_coarse(f0_denorm)), pred

    def forward(self, tokens, tm, mel2ph, spk, f0, uv, use_pred_pitch=False, generator=None):
        out = {}
        enc = self.encoder(tokens)
        src_nonpad = (tokens > 0)[:, :, None].float()
        style = self.spk_embed_proj(spk)[:, None, :]
        masked = (mel2ph * (1 - tm[..., 0])).long()
        masked_dur = mel2token_to_dur(masked, tokens.shape[1]) * (tokens != 0)
        out["dur"] = self.durations((enc + style) * src_nonpad, tokens, masked_dur, generator)
        tgt_nonpad = (mel2ph > 0)[:, :, None].float()
        dec_inp = expand_states(enc, mel2ph)
        pitch_emb, out["pitch_pred"] = self.pitch(
            (dec_inp + style) * tgt_nonpad, tm, f0, uv, mel2ph, use_pred_pitch, generator)
        out["decoder_inp"] = (dec_inp + pitch_emb + style) * tgt_nonpad
        return out


class MelEncoder(nn.Module):
    def __init__(self, h):
        super().__init__()
        self.encoder = nn.Sequential(nn.Linear(80, h), nn.ReLU(), nn.Linear(h, h), nn.ReLU())
        self.fc_out = nn.Linear(h, h)

    def forward(self, mel):
        return self.fc_out(self.encoder(mel))


# -- DiffNet ----------------------------------------------------------------------


class ResidualLayer(nn.Module):
    """The gated residual block: y = (x + step) * mask, a dilated conv of y
    plus a 1x1 conv of the condition, tanh x sigmoid gate, a 1x1 conv to
    (residual, skip)."""

    def __init__(self, hidden, c, dilation):
        super().__init__()
        self.c, self.dilation = c, dilation
        self.dilated_conv = nn.Conv1d(c, 2 * c, 3, padding=dilation, dilation=dilation)
        self.diffusion_projection = nn.Linear(c, c)
        self.conditioner_projection = nn.Conv1d(hidden, 2 * c, 1)
        self.output_projection = nn.Conv1d(c, 2 * c, 1)

    def forward(self, x, cond, step, mask):
        """x [B, C, T]; cond [B, H, T]; step [B, C]; mask [B, 1, T]."""
        y = (x + self.diffusion_projection(step)[:, :, None]) * mask
        h = self.dilated_conv(y) + self.conditioner_projection(cond)
        g = torch.sigmoid(h[:, :self.c]) * torch.tanh(h[:, self.c:])
        o = self.output_projection(g)
        return (x + o[:, :self.c]) / math.sqrt(2.0), o[:, self.c:]


def step_embedding(t, dim):
    half = dim // 2
    freq = torch.exp(torch.arange(half, device=t.device) * -(math.log(10000) / (half - 1)))
    ang = t.float()[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class DiffNet(nn.Module):
    def __init__(self, hp):
        super().__init__()
        c, h = hp["residual_channels"], hp["hidden_size"]
        self.input_projection = nn.Conv1d(80, c, 1)
        self.mlp = nn.Sequential(nn.Linear(c, 4 * c), nn.Mish(), nn.Linear(4 * c, c))
        self.residual_layers = nn.ModuleList(
            ResidualLayer(h, c, 2 ** (i % hp["dilation_cycle_length"]))
            for i in range(hp["residual_layers"]))
        self.skip_projection = nn.Conv1d(c, c, 1)
        self.output_projection = nn.Conv1d(c, 80, 1)

    def forward(self, spec, t, cond, nonpad):
        """spec [B, T, 80]; t [B]; cond [B, T, H]; nonpad [B, T] -> [B, T, 80]."""
        x = F.relu(self.input_projection(spec.transpose(1, 2)))
        step = self.mlp(step_embedding(t, x.shape[1]))
        cond, mask = cond.transpose(1, 2), nonpad[:, None, :]
        skips = 0
        for layer in self.residual_layers:
            x, skip = layer(x, cond, step, mask)
            skips = skips + skip
        x = F.relu(self.skip_projection(skips / math.sqrt(len(self.residual_layers))))
        return self.output_projection(x).transpose(1, 2)


# -- the schedule ------------------------------------------------------------------


def vpsde_schedule(timesteps, device, min_beta=0.1, max_beta=40.0):
    """float32 buffers of the VP-SDE schedule (computed in float64) over
    ``timesteps + 1`` steps."""
    n = timesteps + 1
    betas = np.array([1.0 - np.exp(-min_beta / n - 0.5 * (max_beta - min_beta)
                                   * (2 * t - 1) / n ** 2) for t in range(1, n + 1)])
    ac = np.cumprod(1.0 - betas)
    ac_prev = np.append(1.0, ac[:-1])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return dict(sqrt_ac=f32(np.sqrt(ac)), sqrt_1mac=f32(np.sqrt(1.0 - ac)),
                coef1=f32(betas * np.sqrt(ac_prev) / (1.0 - ac)),
                coef2=f32((1.0 - ac_prev) * np.sqrt(1.0 - betas) / (1.0 - ac)),
                log_var=f32(np.log(np.maximum(post_var, 1e-20))))


def _at(buf, t):
    return buf[t][:, None, None]


class FluentSpeech(nn.Module):
    """``GaussianDiffusion``: the conditioner (``fs``), the masked-mel
    encoder and DiffNet (``denoise_fn``)."""

    def __init__(self, vocab, hp):
        super().__init__()
        self.hp = hp
        self.steps = hp["timesteps"]
        self.fs = Conditioner(vocab, hp)
        self.mel_encoder = MelEncoder(hp["hidden_size"])
        self.denoise_fn = DiffNet(hp)

    def cond(self, tokens, tm, mel2ph, spk, ref, f0, uv, use_pred_pitch, generator=None):
        out = self.fs(tokens, tm, mel2ph, spk, f0, uv, use_pred_pitch, generator)
        nonpad = (mel2ph > 0)[:, :, None].float()
        out["cond"] = out["decoder_inp"] + self.mel_encoder(ref * (1 - tm)) * nonpad
        return out

    def predict_durations(self, tokens, masked_dur, spk):
        """Durations [B, S] of the edited phones, anchored by ``masked_dur``."""
        enc = self.fs.encoder(tokens)
        style = self.fs.spk_embed_proj(spk)[:, None, :]
        return self.fs.durations((enc + style) * (tokens > 0)[:, :, None].float(), tokens,
                                 masked_dur)

    def sample(self, tokens, tm, mel2ph, spk, ref, f0, uv, noise):
        """The reverse diffusion with predicted pitch: ``noise`` [steps + 1,
        B, T, 80], the initial noise and then that of steps ``steps - 1`` ..
        0. Returns mel [B, T, 80] before the composite."""
        sched = vpsde_schedule(self.steps, tokens.device)
        cond = self.cond(tokens, tm, mel2ph, spk, ref, f0, uv, True)["cond"]
        nonpad = (mel2ph > 0).float()
        x = noise[0] * nonpad[..., None]
        for i in range(self.steps - 1, -1, -1):
            t = torch.full((tokens.shape[0],), i, dtype=torch.long, device=tokens.device)
            x0 = self.denoise_fn(x, t, cond, nonpad)
            mean = _at(sched["coef1"], t) * x0 + _at(sched["coef2"], t) * x
            x = mean + (i > 0) * torch.exp(0.5 * _at(sched["log_var"], t)) * noise[self.steps - i]
            x = x * nonpad[..., None]
        return x

    def train_forward(self, batch, generator):
        """The training branch: x0 predicted from the target diffused to a
        drawn step; the draws come from ``generator`` (see the module doc)."""
        tm = batch["time_mel_masks"][..., None]
        mels = batch["mels"]
        out = self.cond(batch["txt_tokens"], tm, batch["mel2ph"], batch["spk_embed"], mels,
                        batch["f0"], batch["uv"], False, generator)
        b = mels.shape[0]
        t = torch.randint(0, self.steps + 1, (b,), device=mels.device, generator=generator)
        noise = torch.randn(mels.shape, device=mels.device, dtype=mels.dtype,
                            generator=generator)
        sched = vpsde_schedule(self.steps, mels.device)
        nonpad = (batch["mel2ph"] > 0).float()
        x_t = (_at(sched["sqrt_ac"], t) * mels + _at(sched["sqrt_1mac"], t) * noise) \
            * nonpad[..., None]
        out["mel_out"] = self.denoise_fn(x_t, t, out["cond"], nonpad) * nonpad[..., None]
        return out


# -- the training loss -------------------------------------------------------------


def _wmean(values, weights):
    return (values * weights).sum() / weights.sum().clamp(min=1.0)


def _gauss_band(n, device):
    x = np.arange(11) - 5
    g = np.exp(-(x ** 2) / (2 * 1.5 ** 2))
    g = g / g.sum()
    m = np.zeros((n, n), np.float64)
    for k in range(11):
        m += np.diag(np.full(n - abs(k - 5), g[k]), k - 5)
    return torch.tensor(m, dtype=torch.float32, device=device)


def ssim_map(a, b):
    """SSIM of two [B, T, M] images: an 11-tap Gaussian (sigma 1.5), SAME
    zero padding, C1 = 1e-4, C2 = 9e-4."""
    wt, wm = _gauss_band(a.shape[1], a.device), _gauss_band(a.shape[2], a.device)
    blur = lambda x: torch.einsum("ts,bsm->btm", wt, x) @ wm
    mu1, mu2 = blur(a), blur(b)
    s1 = blur(a * a) - mu1 * mu1
    s2 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    c1, c2 = 1e-4, 9e-4
    return ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1)
                                                       * (s1 + s2 + c2))


def loss_terms(model: FluentSpeech, batch, generator, sil_ids, hp):
    """The published training loss of one batch: masked-region l1 and ssim
    (0.5 each), phone and word duration, uv and f0. Returns (total, terms)."""
    out = model.train_forward(batch, generator)
    tm = batch["time_mel_masks"][..., None]
    pred, tgt = out["mel_out"] * tm, batch["mels"] * tm
    w = (tgt.abs().sum(-1, keepdim=True) != 0).float().expand_as(tgt)
    terms = {"l1_coarse": _wmean((pred - tgt).abs(), w) * 0.5,
             "ssim_coarse": _wmean(1.0 - ssim_map(pred + 6.0, tgt + 6.0), w) * 0.5}
    tokens = batch["txt_tokens"]
    b, s = tokens.shape
    nonpad = (tokens != 0).float()
    dur_gt = mel2token_to_dur(batch["mel2ph"], s).float() * nonpad
    dur = out["dur"]
    terms["pdur"] = _wmean((torch.log1p(dur) - torch.log1p(dur_gt)) ** 2, nonpad) \
        * hp["lambda_ph_dur"]
    is_sil = torch.zeros_like(tokens, dtype=torch.bool)
    for i in sil_ids:
        is_sil = is_sil | (tokens == i)
    is_sil = is_sil.float()
    word = (torch.cumsum(is_sil, -1) * (1 - is_sil)).long()

    def word_sum(v):
        return torch.zeros(b, s + 1, device=v.device, dtype=v.dtype).scatter_add(1, word, v)[:, 1:]

    wp, wg = word_sum(dur), word_sum(dur_gt)
    terms["wdur"] = _wmean((torch.log1p(wp) - torch.log1p(wg)) ** 2, (wg > 0).float()) \
        * hp["lambda_word_dur"]
    pp, f0, uv = out["pitch_pred"], batch["f0"], batch["uv"]
    frames = (batch["mel2ph"] != 0).float()
    bce = torch.clamp(pp[:, :, 1], min=0) - pp[:, :, 1] * uv \
        + torch.log1p(torch.exp(-pp[:, :, 1].abs()))
    terms["uv"] = _wmean(bce, frames) * hp["lambda_uv"]
    terms["f0"] = _wmean((pp[:, :, 0] - f0).abs(), frames * (uv == 0).float()) * hp["lambda_f0"]
    return sum(terms.values()), terms
