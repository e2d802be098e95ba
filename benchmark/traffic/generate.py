"""The one generator of every traffic mix: it reads a mix's parameters (a
JSON file beside this one) and the run's seed, and writes what the program
receives into a directory: edit requests (wavs, MFA-style TextGrids, the
serve CLI's request schema) and their due times, or a binarized training
corpus.

Every seed gets the same set of sizes and gaps, in another order: lengths
sit at fixed quantiles of the mix's log-normal, inter-arrival gaps at fixed
quantiles of the exponential, and the seed permutes them and draws the
words, the edits, the pitch of each source and the corpus's contents. So two
seeds ask the same work of the program and differ in what they ask it of.
"""

from __future__ import annotations

import json
import os
import pickle
from pathlib import Path
from statistics import NormalDist

import numpy as np
from scipy.io import wavfile

from benchmark.reference.frontend import encode, phone_set, text_to_phones, word_phones

HERE = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    with open(HERE / f"{name}.json") as f:
        return json.load(f)


def words(mix: dict) -> list:
    return (HERE / mix.get("words", "words.txt")).read_text().split()


def lognormal_quantiles(n: int, median: float, sigma: float, lo: float, hi: float) -> np.ndarray:
    """``n`` values at the quantiles (k + 0.5) / n of a log-normal, clipped."""
    z = np.array([NormalDist().inv_cdf((k + 0.5) / n) for k in range(n)])
    return np.clip(median * np.exp(sigma * z), lo, hi)


def exponential_gaps(n: int, rate: float, rng: np.random.RandomState) -> np.ndarray:
    """``n`` gaps at the quantiles (k + 0.5) / n of Exp(rate), permuted."""
    q = (np.arange(n) + 0.5) / n
    return rng.permutation(-np.log1p(-q) / rate)


def source_wav(seconds: float, f0: float, sr: int, rng: np.random.RandomState) -> np.ndarray:
    """Six partials of ``f0`` with a vibrato and a syllable-rate envelope
    over a 0.01 rms noise floor (the partials as powers of one complex
    phasor)."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    z = np.exp(1j * 2 * np.pi * np.cumsum(f0 * (1 + 0.03 * np.sin(2 * np.pi * 5.0 * t))) / sr)
    tone, zk = np.zeros(n), np.ones(n, complex)
    for k in range(1, 7):
        zk = zk * z
        tone += 0.3 / k * zk.imag
    env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(3.0, 5.0) * t + rng.uniform(0, 6.3))
    return (tone * env + 0.01 * rng.randn(n)).astype(np.float32)


def write_textgrid(path: str, text: str, n_frames: int, hop: int, sr: int,
                   lead: int = 8, tail: int = 12) -> None:
    """A phone tier: ``text``'s phones evenly over the frames between a
    leading and a trailing silence."""
    phones = [p for w in text.split(" ") for p in word_phones(w)]
    bounds = lead + np.round(np.linspace(0, n_frames - lead - tail, len(phones) + 1)).astype(int)
    sec = lambda f: float(f * hop / sr)
    ivs = ([(0.0, sec(lead), "")] + [(sec(a), sec(b), p) for a, b, p in
                                     zip(bounds[:-1], bounds[1:], phones)]
           + [(sec(bounds[-1]), sec(n_frames), "")])
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "", "xmin = 0",
             f"xmax = {sec(n_frames)!r}", "tiers? <exists>", "size = 1", "item []:",
             "    item [1]:", '        class = "IntervalTier"', '        name = "phones"',
             "        xmin = 0", f"        xmax = {sec(n_frames)!r}",
             f"        intervals: size = {len(ivs)}"]
    for k, (a, b, m) in enumerate(ivs, 1):
        lines += [f"        intervals [{k}]:", f"            xmin = {a!r}",
                  f"            xmax = {b!r}", f'            text = "{m}"']
    Path(path).write_text("\n".join(lines) + "\n")


def edit_requests(mix: dict, hp: dict, seed: int, out_dir: str, n: int) -> list:
    """``n`` edit requests over ``mix["sources"]`` source recordings: each
    replaces 1-3 words in the first two thirds of its source's text with
    1-3 others. Returns rows of the serve CLI's schema."""
    rng = np.random.RandomState(seed % (2 ** 32))
    vocab = words(mix)
    sr, hop = hp["audio_sample_rate"], hp["hop_size"]
    src = mix["sources"]
    lengths = rng.permutation(lognormal_quantiles(src["count"], src["median_s"], src["sigma"],
                                                  src["min_s"], src["max_s"]))
    os.makedirs(out_dir, exist_ok=True)
    sources = []
    for k, secs in enumerate(lengths):
        n_words = max(4, round(secs * src["words_per_s"]))
        text = " ".join(vocab[i] for i in rng.randint(0, len(vocab), n_words))
        wav = source_wav(secs, rng.uniform(*src["f0_hz"]), sr, rng)
        wav_fn = os.path.join(out_dir, f"src{k:03d}.wav")
        wavfile.write(wav_fn, sr, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
        frames = len(wav) // hop + 1
        tg = os.path.join(out_dir, f"src{k:03d}.TextGrid")
        write_textgrid(tg, text, frames, hop, sr)
        sources.append((text.split(" "), wav_fn, tg, float(secs)))
    ed = mix["edit"]
    order = np.concatenate([rng.permutation(len(sources)) for _ in range(-(-n // len(sources)))])
    rows = []
    for i in range(n):
        text, wav_fn, tg, secs = sources[order[i]]
        w0 = rng.randint(1, max(1, int(len(text) * ed["first_fraction"])) + 1)
        w1 = min(len(text), w0 + rng.randint(ed["replace_min"], ed["replace_max"] + 1) - 1)
        new = [vocab[j] for j in rng.randint(0, len(vocab), rng.randint(ed["insert_min"],
                                                                       ed["insert_max"] + 1))]
        rows.append(dict(item_name=f"req{i:05d}", text=" ".join(text),
                         edited_text=" ".join(text[:w0 - 1] + new + text[w1:]),
                         region=f"[{w0},{w1}]", edited_region=f"[{w0},{w0 + len(new) - 1}]",
                         wav_fn_orig=wav_fn, mfa_textgrid=tg, source_s=secs))
    return rows


def due_times(mix: dict, seed: int, seconds: float) -> np.ndarray:
    """Open-loop due times from 0: the window's ``rate * seconds`` requests
    and as many again after it, so that load stays on while the window's
    last requests finish."""
    rate = float(mix["arrival"]["rate_per_s"])
    n = int(round(rate * seconds))
    rng = np.random.RandomState((seed + 7919) % (2 ** 32))
    gaps = exponential_gaps(n, rate, rng)
    window = np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) * (seconds / gaps.sum())
    return np.concatenate([window, seconds + window])


def lead_times(mix: dict, seed: int, lead_s: float) -> np.ndarray:
    """The lead-in's due times: ``rate * lead_s`` arrivals drawn as a
    window's are, in the ``lead_s`` seconds before the window (negative)."""
    if lead_s <= 0:
        return np.zeros(0)
    due = due_times(mix, seed + 1, lead_s)
    return due[due < lead_s] - lead_s


# -- the training corpus --------------------------------------------------------------


def write_corpus(mix: dict, hp: dict, seed: int, data_dir: str) -> dict:
    """A binarized corpus (``train`` split; ``<split>.data`` of pickled
    items, ``<split>.idx``, ``<split>_lengths.npy``, ``phone_set.json``):
    phone tokens of word texts (``|`` between words), a monotonic alignment
    of about ``frames_per_phone`` frames a phone, a log-mel-like mel, raw f0
    in Hz with ``unvoiced`` of the frames at 0, the coarse pitch and one of
    ``speakers`` speaker embeddings. Returns {item_name: item}."""
    c = mix["corpus"]
    rng = np.random.RandomState(seed % (2 ** 32))
    vocab = words(mix)
    phones = phone_set(vocab)
    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, "phone_set.json"), "w") as f:
        json.dump(phones, f)
    fps = hp["audio_sample_rate"] / hp["hop_size"]
    frames = np.round(rng.permutation(lognormal_quantiles(
        c["count"], c["median_s"], c["sigma"], c["min_s"], c["max_s"])) * fps).astype(int)
    speakers = rng.randn(c["speakers"], 256).astype(np.float32)
    items, offsets, blobs = {}, [0], []
    for i, t in enumerate(frames):
        text, n_ph = [], 1       # <BOS>, then each word's phones and a separator
        while len(text) < 2 or n_ph < t / c["frames_per_phone"]:
            text.append(vocab[rng.randint(len(vocab))])
            n_ph += len(word_phones(text[-1])) + 1
        ph, _, _ = text_to_phones(" ".join(text))
        tokens = encode(ph, phones)
        s = min(len(tokens), int(t))
        tokens = tokens[:s]
        bounds = np.sort(rng.choice(np.arange(1, t), s - 1, replace=False))
        mel2ph = (np.searchsorted(bounds, np.arange(t), side="right") + 1).astype(np.int64)
        f0 = (rng.uniform(80, 300, t) * (rng.rand(t) >= c["unvoiced"])).astype(np.float32)
        item = {"item_name": f"utt{i:05d}", "txt": " ".join(text), "wav_fn": f"utt{i:05d}.wav",
                "ph_token": tokens, "mel": (rng.randn(t, 80) * 0.5 - 1.0).astype(np.float32),
                "mel2ph": mel2ph, "f0": f0,
                "pitch": rng.randint(1, 256, t).astype(np.int64),
                "spk_embed": speakers[rng.randint(c["speakers"])]}
        items[item["item_name"]] = item
        blob = pickle.dumps(item)
        blobs.append(blob)
        offsets.append(offsets[-1] + len(blob))
    with open(os.path.join(data_dir, "train.data"), "wb") as f:
        f.write(b"".join(blobs))
    with open(os.path.join(data_dir, "train.idx"), "wb") as f:
        np.save(f, {"offsets": offsets})
    np.save(os.path.join(data_dir, "train_lengths.npy"), frames)
    return items
