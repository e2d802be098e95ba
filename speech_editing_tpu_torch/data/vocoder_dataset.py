"""HiFi-GAN's corpus: fixed-length random crops of mel and wav, the port of
the JAX package's ``data/vocoder_dataset.py``.

Items of at most ``max_samples // hop_size`` frames are left out of the
training and validation splits. Each item's wav is cut or zero-padded to
``len(mel) * hop_size`` samples, then a training or validation batch
takes a ``max_samples // hop_size``-frame crop of each item at a frame
offset drawn from the item's ``RandomState`` (``_item_rng``), the wav
cropped to match; the collater skips an item too short to crop. The
``test`` split takes each item from frame 0 but for its last frame, as the
JAX package does. Every training batch has one shape.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from speech_editing_tpu_torch.data.collate import collate_1d, collate_2d
from speech_editing_tpu_torch.data.datasets import BaseDataset
from speech_editing_tpu_torch.data.indexed_dataset import IndexedDataset


class VocoderDataset(BaseDataset):
    def __init__(self, prefix: str, hp: Any, shuffle: bool = False):
        super().__init__(hp, shuffle)
        self.prefix = prefix
        self.data_dir = hp["binary_data_dir"]
        self.hop_size = hp["hop_size"]
        self.batch_max_frames = 0 if prefix == "test" else hp["max_samples"] // self.hop_size
        self.indexed_ds = None
        sizes = np.load(f"{self.data_dir}/{prefix}_lengths.npy")
        self.avail_idxs = [i for i, s in enumerate(sizes) if s > self.batch_max_frames]
        if len(self.avail_idxs) < len(sizes):
            print(f"| {len(sizes) - len(self.avail_idxs)} short items skipped in "
                  f"{prefix} set.", flush=True)
        self.sizes = [sizes[i] for i in self.avail_idxs]

    def __getitem__(self, index: int) -> dict:
        real_idx = self.avail_idxs[index]
        if self.indexed_ds is None:
            self.indexed_ds = IndexedDataset(f"{self.data_dir}/{self.prefix}")
        item = self.indexed_ds[real_idx]
        n = len(item["mel"])
        return {"id": real_idx, "item_name": item["item_name"],
                "mel": np.asarray(item["mel"], np.float32),
                "wav": np.asarray(item["wav"], np.float32),
                "pitch": np.asarray(item.get("pitch", np.zeros(n)), np.int64),
                "f0": np.asarray(item.get("f0", np.zeros(n)), np.float32),
                "_rng": self._item_rng(index)}

    def collater(self, samples: list) -> dict:
        if len(samples) == 0:
            return {}
        hop = self.hop_size
        ys, cs, ps, f0s, names = [], [], [], [], []
        for s in samples:
            x, c, p, f0 = s["wav"], s["mel"], s["pitch"], s["f0"]
            x = x[:len(c) * hop]
            if len(x) < len(c) * hop:
                x = np.pad(x, (0, len(c) * hop - len(x)))
            max_frames = self.batch_max_frames or (len(c) - 1)
            if len(c) <= max_frames:
                continue
            start = int(s["_rng"].randint(0, len(c) - max_frames))
            c, p, f0 = (a[start:start + max_frames] for a in (c, p, f0))
            x = x[start * hop:(start + max_frames) * hop]
            names.append(s["item_name"])
            ys.append(x)
            cs.append(c)
            ps.append(p)
            f0s.append(f0)
        return {"wavs": collate_1d(ys, 0.0), "mels": collate_2d(cs, 0.0),
                "pitches": collate_1d(ps, 0), "f0": collate_1d(f0s, 0.0),
                "mel_lengths": np.asarray([len(c) for c in cs], np.int64),
                "item_name": names, "nsamples": len(names)}
