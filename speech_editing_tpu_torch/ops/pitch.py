"""On-device f0 extraction and unvoiced-gap interpolation (plain torch).

A normalised-autocorrelation pitch tracker with static shapes: framing,
windowing and the DFT collapse into hop-sized chunked matrix products, the
autocorrelation is one cosine-transform product over the power spectrum,
and unvoiced gaps are filled linearly with cumulative-max index fills.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _tracker_constants(win: int, hop_size: int, lag_max: int, device: torch.device):
    """float32 constants of the tracker (computed in float64 on the host),
    made once per shape and device."""
    nfft = int(2 ** np.ceil(np.log2(2 * win)))
    kk = nfft // 2 + 1
    k = np.arange(kk)
    ang = 2.0 * np.pi * np.outer(np.arange(win), k) / nfft
    w_np = np.hanning(win)
    wcos = w_np[:, None] * np.cos(ang)                  # [win, K]
    wsin = w_np[:, None] * np.sin(ang)
    basis = np.concatenate([wcos, wsin, np.ones((win, 1))], axis=1)
    n_chunks = -(-win // hop_size)
    basis_p = np.zeros((n_chunks * hop_size, basis.shape[1]), np.float32)
    basis_p[:win] = basis
    lags = np.arange(lag_max + 2)
    coef = np.full(kk, 2.0)
    coef[0] = 1.0
    if nfft % 2 == 0:
        coef[-1] = 1.0
    inv = np.cos(2.0 * np.pi * np.outer(k, lags) / nfft) * coef[:, None] / nfft
    wac = np.fft.irfft(np.abs(np.fft.rfft(np.hanning(win), nfft)) ** 2,
                       nfft)[: lag_max + 2]
    arrays = dict(
        chunks=basis_p.reshape(n_chunks, hop_size, -1),
        ones_c=basis_p[:, -1].reshape(n_chunks, hop_size),
        wcos_sum=wcos.sum(0),
        wsin_sum=wsin.sum(0),
        inv=inv,
        wac=np.maximum(wac / wac[0], 1e-6))
    consts = {k: torch.tensor(np.asarray(a, np.float32), device=device)
              for k, a in arrays.items()}
    return dict(consts, n_chunks=n_chunks, kk=kk)


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median of a 1-D tensor, the mean of the middle pair for an even count."""
    s = torch.sort(x).values
    n = s.shape[0]
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def extract_pitch(wav: torch.Tensor, hop_size: int = 256,
                  sample_rate: int = 22050, f0_min: float = 80.0,
                  f0_max: float = 600.0,
                  voicing_threshold: float = 0.45) -> torch.Tensor:
    """1-D wav -> f0 per frame (``len(wav) // hop_size`` values, 0 = unvoiced)."""
    wav = wav.float()
    dev = wav.device
    n = wav.shape[-1]
    n_frames = n // hop_size
    if n_frames == 0:
        return torch.zeros(0, device=dev)
    win = min(int(round(3.0 / f0_min * sample_rate)), n)
    half = win // 2
    lag_min = max(2, int(sample_rate / f0_max))
    lag_max = min(win - 2, int(sample_rate / f0_min))
    if lag_max <= lag_min:
        return torch.zeros(n_frames, device=dev)
    c = _tracker_constants(win, hop_size, lag_max, dev)
    n_chunks, kk = c["n_chunks"], c["kk"]

    pad = half + 1
    wav_p = torch.nn.functional.pad(wav, (pad, pad + win))
    x = wav_p[hop_size // 2 + 1:]                        # frame t starts at t*hop
    s_rows = n_frames - 1 + n_chunks
    need = s_rows * hop_size
    x = x[:need]
    x = torch.nn.functional.pad(x, (0, need - x.shape[0]))
    xr = x.reshape(s_rows, hop_size)                     # [S, hop]
    y = torch.einsum("sj,cjo->cso", xr, c["chunks"])  # [C, S, 2K+1]
    q = torch.einsum("sj,cj->cs", xr * xr, c["ones_c"])
    dft = sum(y[i, i:i + n_frames] for i in range(n_chunks))
    sq = sum(q[i, i:i + n_frames] for i in range(n_chunks))[:, None] / win
    mean = dft[:, -1:] / win                             # [T, 1]
    re = dft[:, :kk] - mean * c["wcos_sum"][None, :]
    im = dft[:, kk:2 * kk] - mean * c["wsin_sum"][None, :]
    power = re * re + im * im                            # [T, K]
    ac = power @ c["inv"]                             # [T, lag_max + 2]
    ac0 = ac[:, :1].clamp(min=1e-12)
    r = (ac / ac0) / c["wac"][None, :]

    best = torch.argmax(r[:, lag_min: lag_max + 1], dim=1) + lag_min
    r_m1 = torch.gather(r, 1, (best - 1)[:, None])[:, 0]
    r_0 = torch.gather(r, 1, best[:, None])[:, 0]
    r_p1 = torch.gather(r, 1, (best + 1)[:, None])[:, 0]
    denom = r_m1 - 2 * r_0 + r_p1
    delta = torch.where(denom.abs() > 1e-9, 0.5 * (r_m1 - r_p1) / denom,
                        torch.zeros_like(denom)).clamp(-1, 1)
    f0 = sample_rate / (best + delta).clamp(min=1e-6)

    rms = torch.sqrt((sq - mean * mean).clamp(min=0.0))[:, 0]
    voiced = (r_0 > voicing_threshold) & (rms > 1e-4 + 0.02 * _median(rms))
    f0 = torch.where(voiced & (f0 >= f0_min) & (f0 <= f0_max), f0,
                     torch.zeros_like(f0))
    if n_frames >= 3:
        stacked = torch.stack([torch.roll(f0, -1), f0, torch.roll(f0, 1)], 1)
        f0_smooth = torch.median(stacked, dim=1).values
        f0 = torch.where(f0 > 0, torch.where(f0_smooth > 0, f0_smooth, f0),
                         torch.zeros_like(f0))
    return f0.float()


def interp_unvoiced(f0: torch.Tensor) -> torch.Tensor:
    """Linear interpolation through unvoiced (f0 == 0) gaps of a 1-D track;
    edges copy the nearest voiced value; an all-unvoiced track stays 0."""
    t = f0.shape[-1]
    pos = torch.arange(t, device=f0.device)
    voiced = f0 > 0
    neg = torch.full_like(pos, -1)
    left = torch.cummax(torch.where(voiced, pos, neg), 0).values
    right = t - 1 - torch.cummax(
        torch.where(voiced.flip(0), pos, neg), 0).values.flip(0)
    right_valid = torch.cummax(voiced.flip(0).long(), 0).values.flip(0) > 0
    left_valid = left >= 0
    f0_left = f0[left.clamp(0, t - 1)]
    f0_right = f0[right.clamp(0, t - 1)]
    wgt = (pos - left) / (right - left).clamp(min=1)
    interp = f0_left * (1 - wgt) + f0_right * wgt
    interp = torch.where(left_valid & ~right_valid, f0_left, interp)
    interp = torch.where(~left_valid & right_valid, f0_right, interp)
    interp = torch.where(left_valid | right_valid, interp,
                         torch.zeros_like(interp))
    return torch.where(voiced, f0, interp)


def norm_interp_f0(f0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(log2-normalised f0 interpolated through unvoiced gaps, uv mask)."""
    uv = (f0 == 0).float()
    log_f0 = torch.where(uv > 0, torch.zeros_like(f0), torch.log2(f0 + 1e-8))
    return interp_unvoiced(log_f0), uv
