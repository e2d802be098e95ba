"""Plain reference of the training batches: which items the published loader
puts into each batch of an epoch, and what it makes of them. Items sorted by
length after a permutation seeded by ``seed + epoch``, cut greedily into
batches under ``max_tokens`` (items x longest) and ``max_sentences``, the
batches shuffled by ``seed + epoch``; each item's normalised f0 (log2, the
unvoiced frames interpolated) and its time mask (alignment-aware: a random
``int((P + 1) * ratio)`` of its phones; ``random``: one span of ``ratio`` of
its frames), from a generator seeded by the seed, the epoch and the item's
index; the batch zero-padded. numpy only; imports
no code of the program."""

from __future__ import annotations

import numpy as np

from benchmark.reference.frontend import norm_interp_f0


def epoch_batches(sizes: np.ndarray, seed: int, epoch: int, max_tokens: int,
                  max_sentences: int) -> list:
    order = np.random.RandomState(seed + epoch).permutation(len(sizes))
    order = order[np.argsort(sizes[order], kind="mergesort")]
    batches, batch, longest = [], [], 0
    for i in order:
        n = int(sizes[i])
        longest = max(longest, n)
        if batch and (len(batch) == max_sentences or (len(batch) + 1) * longest > max_tokens):
            batches.append(batch)
            batch, longest = [], n
        batch.append(int(i))
    if batch:
        batches.append(batch)
    np.random.RandomState(seed + epoch).shuffle(batches)
    return batches


def span_mask(t: int, ratio: float, rng) -> np.ndarray:
    """One random contiguous span of ``ratio`` of the frames."""
    n = int(t * ratio)
    pos = rng.randint(0, max(1, t - n))
    mask = np.zeros(t, np.float32)
    mask[pos:pos + n] = 1.0
    return mask


def time_mask(mel2ph: np.ndarray, ratio: float, rng) -> np.ndarray:
    n_ph = int(mel2ph.max())
    ph = np.zeros(n_ph, np.float32)
    k = int((n_ph + 1) * ratio)
    if k > 0:
        ph[rng.choice(n_ph, size=min(k, n_ph), replace=False)] = 1.0
    return np.concatenate([[0.0], ph]).astype(np.float32)[mel2ph]


def _pad(arrays, value=0):
    n = max(len(a) for a in arrays)
    out = np.full((len(arrays), n) + arrays[0].shape[1:], value, dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, :len(a)] = a
    return out


def batch(items: list, indices: list, hp: dict, epoch: int) -> dict:
    """The collated batch of ``indices`` (positions in ``items``) in ``epoch``."""
    seed, t_max = int(hp["seed"]), int(hp["max_frames"])
    mels, toks, m2ps, f0s, uvs, masks, spks = [], [], [], [], [], [], []
    for i in indices:
        it = items[i]
        mel = np.asarray(it["mel"], np.float32)[:t_max]
        t = mel.shape[0]
        m2p = np.asarray(it["mel2ph"], np.int64)[:t]
        f0, uv = norm_interp_f0(np.asarray(it["f0"], np.float32)[:t])
        rng = np.random.RandomState((seed * 1000003 + epoch * 10007 + i) % (2 ** 31))
        masks.append(span_mask(t, hp["training_mask_ratio"], rng)
                     if hp.get("mask_type") == "random"
                     else time_mask(m2p, hp["training_mask_ratio"], rng))
        mels.append(mel)
        toks.append(np.asarray(it["ph_token"], np.int64)[:hp["max_input_tokens"]])
        m2ps.append(m2p)
        f0s.append(f0)
        uvs.append(uv)
        spks.append(np.asarray(it["spk_embed"], np.float32))
    return {"txt_tokens": _pad(toks), "mels": _pad(mels, 0.0), "mel2ph": _pad(m2ps),
            "f0": _pad(f0s, 0.0), "uv": _pad(uvs, 0.0), "time_mel_masks": _pad(masks, 0.0),
            "spk_embed": np.stack(spks)}
