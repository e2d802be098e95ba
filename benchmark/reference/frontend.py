"""Plain host reference of the edit front end and of the host stages around
the device programs, numpy only: the published toolkit's conventions as the
serve path states them, written here again and importing no code of the
program.

* text: lower-case words of letters, each through a rule-based
  letter-to-ARPAbet map (the g2p the program falls back on where ``g2p_en``
  is absent, as on the measured machine), wrapped ``<BOS> w | w | ... <EOS>``;
* alignment: an MFA-style TextGrid phone tier to a frame->phone map;
* audio: the log10 slaney mel (librosa's conventions) and the
  normalized-autocorrelation f0 of the source wav;
* the edit: the duration-inpainting inputs, length regulation of the
  predicted durations, the frame splice [head | edit | tail] and the
  request's noise generator (CRC-32 of the seed and the request's identity).
"""

from __future__ import annotations

import functools
import re
import zlib

import numpy as np
import torch
from scipy.io import wavfile
from scipy.signal import get_window

DIGRAPHS = [
    ("tch", ["CH"]), ("sch", ["S", "K"]), ("th", ["TH"]), ("ch", ["CH"]),
    ("sh", ["SH"]), ("ph", ["F"]), ("wh", ["W"]), ("ck", ["K"]),
    ("ng", ["NG"]), ("qu", ["K", "W"]), ("ee", ["IY1"]), ("oo", ["UW1"]),
    ("ea", ["IY1"]), ("ou", ["AW1"]), ("ai", ["EY1"]), ("ay", ["EY1"]),
    ("oi", ["OY1"]), ("oy", ["OY1"]), ("au", ["AO1"]), ("aw", ["AO1"]),
    ("ow", ["OW1"]), ("ar", ["AA1", "R"]), ("er", ["ER0"]),
    ("or", ["AO1", "R"]), ("igh", ["AY1"]),
]
SINGLE = {
    "a": ["AE1"], "b": ["B"], "c": ["K"], "d": ["D"], "e": ["EH1"], "f": ["F"], "g": ["G"],
    "h": ["HH"], "i": ["IH1"], "j": ["JH"], "k": ["K"], "l": ["L"], "m": ["M"], "n": ["N"],
    "o": ["AA1"], "p": ["P"], "q": ["K"], "r": ["R"], "s": ["S"], "t": ["T"], "u": ["AH1"],
    "v": ["V"], "w": ["W"], "x": ["K", "S"], "y": ["Y"], "z": ["Z"],
}
RESERVED = ["<pad>", "<EOS>", "<UNK>"]


def is_sil(p: str) -> bool:
    return p == "" or not p[0].isalpha()


@functools.lru_cache(maxsize=None)
def word_phones(word: str) -> tuple:
    out, i, w = [], 0, word.lower()
    while i < len(w):
        for pat, phs in DIGRAPHS:
            if w.startswith(pat, i):
                out.extend(phs)
                i += len(pat)
                break
        else:
            out.extend(SINGLE.get(w[i], []))
            i += 1
    return tuple(out or ["AH0"])


def text_to_phones(text: str):
    """(ph string, words list with separators, ph2word) of a text of
    lower-case words."""
    struct = [[w, list(word_phones(w))] for w in text.split(" ") if w]
    full = [["<BOS>", ["<BOS>"]]]
    for i, s in enumerate(struct):
        full.append(s)
        if i != len(struct) - 1:
            full.append(["|", ["|"]])
    full.append(["<EOS>", ["<EOS>"]])
    ph = [p for w in full for p in w[1]]
    ph2word = [i + 1 for i, w in enumerate(full) for _ in w[1]]
    return " ".join(ph), [w[0] for w in full], ph2word


def phone_set(words) -> list:
    """The sorted phone list of a word list, with the separators."""
    return sorted({p for w in words for p in word_phones(w)} | {"|", "<BOS>"})


def encode(ph: str, phones: list) -> np.ndarray:
    vocab = RESERVED + [p for p in phones if p not in RESERVED]
    ids = {p: i for i, p in enumerate(vocab)}
    return np.asarray([ids.get(p, 2) for p in ph.split(" ")], np.int64)


def words_region(words: list, region: str) -> list:
    regions = sorted([int(a), int(b)] for a, b in re.findall(r"\[([1-9]\d*),([1-9]\d*)\]",
                                                             region))
    out, wid, rid = [[0, 0] for _ in regions], 0, 0
    for i, w in enumerate(words):
        if is_sil(w) and w in ("|", "<BOS>", "<pad>"):
            continue
        wid += 1
        if wid == regions[rid][0]:
            out[rid][0] = i + 1
        if wid == regions[rid][1]:
            out[rid][1] = i + 1
            rid += 1
        if rid == len(regions):
            break
    return out


# -- alignment ----------------------------------------------------------------------


def textgrid_phones(path: str) -> list:
    """(start s, end s, mark) of the ``phones`` tier of a long-form TextGrid."""
    text = open(path, encoding="utf-8").read()
    for block in re.split(r"item\s*\[\d+\]\s*:", text)[1:]:
        if 'name = "phones"' not in block:
            continue
        return [(float(a), float(b), m.strip()) for a, b, m in re.findall(
            r"intervals\s*\[\d+\]\s*:\s*xmin\s*=\s*([\d.eE+-]+)\s*xmax\s*=\s*([\d.eE+-]+)\s*"
            r'text\s*=\s*"([^"]*)"', block)]
    raise ValueError(f"no phones tier in {path}")


def mel2ph_from_textgrid(path: str, ph: str, n_frames: int, hop: int, sr: int,
                         min_sil: float = 0.1) -> np.ndarray:
    """Frame -> 1-based phone id: TextGrid silences shorter than ``min_sil``
    join the interval before, a silence interval against a spoken phone
    goes to the phone before, a silence phone with no interval is skipped,
    the last frame copies the one before."""
    ph_list = ph.split(" ")
    merged = []
    for i, (a, b, m) in enumerate(textgrid_phones(path)):
        if b - a < min_sil and i > 0 and is_sil(m):
            merged[-1] = (merged[-1][0], b, merged[-1][2])
        else:
            merged.append((a, b, m))
    out = np.zeros(n_frames, np.int64)
    i_itv = i_ph = 0
    while i_itv < len(merged):
        a, b, m = merged[i_itv]
        start, end = int(a * sr / hop + 0.5), int(b * sr / hop + 0.5)
        if i_ph >= len(ph_list):
            out[start:end] = i_ph
            i_itv += 1
            continue
        if is_sil(m) and not is_sil(ph_list[i_ph]):
            out[start:end] = i_ph
            i_itv += 1
        elif not is_sil(m) and is_sil(ph_list[i_ph]):
            i_ph += 1
        else:
            out[start:end] = i_ph + 1
            i_ph += 1
            i_itv += 1
    if n_frames >= 2:
        out[-1] = out[-2]
    return out


# -- audio --------------------------------------------------------------------------


def load_wav(path: str) -> np.ndarray:
    sr, data = wavfile.read(path)
    return data.astype(np.float32) / 32768.0


def _hz_to_mel(f):
    f = np.asanyarray(f, np.float64)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0)
                    / (np.log(6.4) / 27.0), f / (200.0 / 3))


def _mel_to_hz(m):
    m = np.asanyarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                    200.0 / 3 * m)


def mel_basis(sr, n_fft, n_mels, fmin, fmax) -> np.ndarray:
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1][:, None],
                                   ramps[2:] / fdiff[1:][:, None]))
    return (w * (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]).astype(np.float32)


def log_mel(wav: np.ndarray, hp: dict):
    """(wav cut to T * hop, log10 mel [T, 80]) with a centred periodic-Hann
    STFT, zero padding, eps 1e-6."""
    n_fft, hop = hp["fft_size"], hp["hop_size"]
    w = get_window("hann", hp["win_size"], fftbins=True).astype(np.float64)
    y = np.pad(np.asarray(wav, np.float64), (n_fft // 2, n_fft // 2))
    n = 1 + (len(y) - n_fft) // hop
    frames = y[np.arange(n_fft)[None, :] + hop * np.arange(n)[:, None]]
    lin = np.abs(np.fft.rfft(frames * w[None, :], n=n_fft, axis=-1)).T
    basis = mel_basis(hp["audio_sample_rate"], n_fft, hp["audio_num_mel_bins"], hp["fmin"],
                      hp["fmax"])
    mel = np.log10(np.maximum(1e-6, basis @ lin))
    pad = (len(wav) // hop + 1) * hop - len(wav)
    wav = np.pad(wav, (0, pad))[: mel.shape[1] * hop]
    return wav.astype(np.float32), mel.T.astype(np.float32)


def autocorr_f0(wav, hop, sr, f0_min, f0_max, thr=0.45) -> np.ndarray:
    wav = np.asarray(wav, np.float64)
    n = len(wav) // hop
    win = min(int(round(3.0 / f0_min * sr)), len(wav))
    half = win // 2
    lag_min, lag_max = max(2, int(sr / f0_max)), min(win - 2, int(sr / f0_min))
    pad = half + 1
    wp = np.pad(wav, (pad, pad + win))
    centers = np.arange(n) * hop + hop // 2 + pad
    frames = wp[centers[:, None] + np.arange(-half, win - half)[None, :]]
    frames = frames - frames.mean(axis=1, keepdims=True)
    w = np.hanning(win)
    nfft = int(2 ** np.ceil(np.log2(2 * win)))
    spec = np.fft.rfft(frames * w[None, :], nfft, axis=1)
    ac = np.fft.irfft(spec * np.conj(spec), nfft, axis=1)[:, :lag_max + 2]
    ws = np.fft.rfft(w, nfft)
    wac = np.fft.irfft(ws * np.conj(ws), nfft)[:lag_max + 2]
    r = (ac / np.maximum(ac[:, :1], 1e-12)) / np.maximum(wac / wac[0], 1e-6)[None, :]
    best = np.argmax(r[:, lag_min:lag_max + 1], axis=1) + lag_min
    rows = np.arange(n)
    rm, r0, rp = r[rows, best - 1], r[rows, best], r[rows, best + 1]
    den = rm - 2 * r0 + rp
    delta = np.clip(np.where(np.abs(den) > 1e-9, 0.5 * (rm - rp) / den, 0.0), -1, 1)
    f0 = sr / np.maximum(best + delta, 1e-6)
    rms = np.sqrt((frames ** 2).mean(axis=1))
    voiced = (r0 > thr) & (rms > 1e-4 + 0.02 * np.median(rms))
    f0 = np.where(voiced & (f0 >= f0_min) & (f0 <= f0_max), f0, 0.0)
    if n >= 3:
        sm = np.median(np.stack([np.roll(f0, -1), f0, np.roll(f0, 1)]).T, axis=1)
        f0 = np.where(f0 > 0, np.where(sm > 0, sm, f0), 0.0)
    return f0.astype(np.float32)


def norm_interp_f0(f0):
    f0 = np.asarray(f0, np.float32)
    uv = (f0 == 0).astype(np.float32)
    f0 = np.where(uv > 0, 0.0, np.log2(f0 + 1e-8)).astype(np.float32)
    if 0 < int(uv.sum()) < len(f0):
        voiced = np.where(uv == 0)[0]
        f0 = np.where(uv > 0, np.interp(np.arange(len(f0)), voiced, f0[voiced])
                      .astype(np.float32), f0)
    return f0, uv


# -- one edit request ------------------------------------------------------------------


def prepare(row: dict, hp: dict, phones: list) -> dict:
    """What the host works out from a request before the device: phones,
    regions, mel, alignment, f0/uv."""
    ph, words, ph2word = text_to_phones(row["text"])
    eph, ewords, eph2word = text_to_phones(row["edited_text"])
    wav, mel = log_mel(load_wav(row["wav_fn_orig"]), hp)
    mel2ph = mel2ph_from_textgrid(row["mfa_textgrid"], ph, mel.shape[0], hp["hop_size"],
                                  hp["audio_sample_rate"])
    f0 = autocorr_f0(wav, hp["hop_size"], hp["audio_sample_rate"], hp["f0_min"], hp["f0_max"])
    f0 = np.pad(f0[:mel.shape[0]], (0, max(0, mel.shape[0] - len(f0))))
    f0, uv = norm_interp_f0(f0)
    ph2word = np.asarray(ph2word, np.int64)
    return dict(item_name=row["item_name"], ph=ph, ph2word=ph2word,
                edited_ph2word=np.asarray(eph2word, np.int64),
                edited_ph_token=encode(eph, phones),
                words_region=words_region(words, row["region"]),
                edited_words_region=words_region(ewords, row["edited_region"]),
                mel2ph=mel2ph, mel2word=np.where(mel2ph > 0, ph2word[mel2ph - 1], 0),
                dur=np.bincount(mel2ph, minlength=len(ph2word) + 1)[1:len(ph2word) + 1],
                f0=f0, uv=uv, mel=mel, wav=wav)


def dur_inputs(item: dict):
    """(masked durations [S_edit], edit frames [T] bool): the untouched
    words' durations anchor the edited phones; the tail block by the shorter
    of the two tails."""
    w0, w1 = item["words_region"][0]
    c1 = item["edited_words_region"][0][1]
    ph2word, eph2word, dur = item["ph2word"], item["edited_ph2word"], item["dur"]
    md = np.zeros(len(eph2word), np.int64)
    n_head = int(np.sum(ph2word < w0))
    md[:n_head] = dur[:n_head]
    n_tail = min(int(np.sum(ph2word > w1)), int(np.sum(eph2word > c1)))
    if n_tail > 0:
        md[-n_tail:] = dur[-n_tail:]
    return md, (item["mel2word"] >= w0) & (item["mel2word"] <= w1)


def regulate(item: dict, dur_int: np.ndarray):
    """(mel2ph [T_pred], mel2word [T_pred]) of integer durations."""
    dur_int = np.asarray(dur_int, np.int64) * (item["edited_ph_token"] > 0)
    cum = np.cumsum(dur_int)
    m2p = (np.searchsorted(cum, np.arange(int(cum[-1])), side="right") + 1).astype(np.int64)
    return m2p, item["edited_ph2word"][m2p - 1]


def splice(item: dict, m2p_pred, m2w_pred) -> dict:
    """[head | predicted edit | tail] of the alignment, reference mel, f0 and
    uv, and the edit's frame mask."""
    mel, mel2ph, mel2word = item["mel"], item["mel2ph"], item["mel2word"]
    w0, w1 = item["words_region"][0]
    c0, c1 = item["edited_words_region"][0]
    changed = (m2w_pred >= c0) & (m2w_pred <= c1)
    head = int(np.sum((mel2word >= 1) & (mel2word < w0)))
    tail = mel2word > w1
    mid = head + int(changed.sum())
    t_new = mid + int(tail.sum())
    m2p = np.zeros(t_new, np.int64)
    m2p[:head] = mel2ph[:head]
    m2p[head:mid] = m2p_pred[changed]
    ph2word, eph2word = item["ph2word"], item["edited_ph2word"]
    if tail.any():
        n_orig, n_edit = int(np.sum(ph2word > w1)), int(np.sum(eph2word > c1))
        if n_orig != n_edit:
            _, dense = np.unique(mel2ph[tail], return_inverse=True)
            m2p[mid:] = np.minimum(len(eph2word) - n_edit + 1 + dense, len(eph2word))
        else:
            m2p[mid:] = mel2ph[tail] + (int(np.sum(eph2word <= c1)) - int(np.sum(ph2word <= w1)))
    ref = np.zeros((t_new, mel.shape[1]), np.float32)
    f0, uv = np.zeros(t_new, np.float32), np.zeros(t_new, np.float32)
    ref[:head], f0[:head], uv[:head] = mel[:head], item["f0"][:head], item["uv"][:head]
    if tail.any():
        ref[mid:], f0[mid:], uv[mid:] = mel[tail], item["f0"][tail], item["uv"][tail]
    tm = np.zeros((t_new, 1), np.float32)
    tm[head:mid] = 1.0
    return dict(mel2ph=m2p, ref_mels=ref, f0=f0, uv=uv, time_mel_masks=tm, t_new=t_new)


def request_noise(seed: int, item: dict, steps: int, t: int, device) -> torch.Tensor:
    """[steps + 1, t, 80] from a device generator seeded by the CRC-32 of
    ``seed|name|phones|regions``."""
    ident = "|".join([str(seed), str(item["item_name"]), item["ph"], str(item["words_region"]),
                      str(item["edited_words_region"])])
    gen = torch.Generator(device=device).manual_seed(zlib.crc32(ident.encode()))
    return torch.randn(steps + 1, t, 80, generator=gen, device=device)
