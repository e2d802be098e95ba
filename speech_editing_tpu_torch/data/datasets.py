"""The FluentSpeech corpus reader and its loader.

``EditingDataset`` reads one split of a binarized corpus (``<split>.data``
/ ``.idx`` and ``<split>_lengths.npy``): per item the mel, phone tokens,
mel2ph, normalised f0 and uv (under ``pitch_type: cwt`` also the CWT
targets ``cwt_spec``, ``f0_mean`` and ``f0_std``), the speaker embedding
and a time mask (train: ``random`` or ``alignment_aware`` at
``training_mask_ratio``; infer: one contiguous half of the phones);
``WordSpeechDataset`` adds PortaSpeech's word fields. The port's copy of the JAX package's
``data/datasets.py``: per-item masks draw from a ``RandomState`` seeded by
(seed, epoch, index), epochs order the items by length after a seeded
shuffle and shuffle the batches, so the port's batches and their order
equal the JAX ``DataLoader``'s for the same hp.

:class:`DataLoader` runs ``torch.utils.data.DataLoader`` over those
batches. Its batch sampler yields ``(epoch, index)`` keys, so worker
processes (``spawn``ed, kept for the loader's life) draw each item's mask
for the epoch the sampler was in.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

import numpy as np
import torch.utils.data

from speech_editing_tpu_torch.data.collate import batch_by_size, collate_1d_or_2d
from speech_editing_tpu_torch.data.indexed_dataset import IndexedDataset
from speech_editing_tpu_torch.data.masks import (generate_alignment_aware_time_mask,
                                                 generate_inference_mask,
                                                 generate_time_mask)
from speech_editing_tpu_torch.utils.audio.cwt import f0_to_cwt
from speech_editing_tpu_torch.utils.audio.pitch import norm_interp_f0



class BaseDataset:
    """Sizes, the epoch's order and per-item randomness. With
    ``use_weighted_sampler`` a shuffled dataset whose ``sample_weights``
    are not None draws each epoch's items with replacement in proportion
    to them (``set_epoch``): index ``i`` of the epoch is then a virtual
    index, mapped to a real item, and its mask randomness is keyed on the
    virtual index, so two draws of one item get their own masks."""

    _rng_salt = 0   # ConcatDataset threads the virtual index through here

    def __init__(self, hp: Any, shuffle: bool = False):
        if hp.get("train_sets"):
            raise NotImplementedError(
                "hp['train_sets']: the JAX package reads this key nowhere (its trainer "
                "builds one dataset from binary_data_dir), so the port does not either")
        self.hp = hp
        self.shuffle = shuffle
        self.sort_by_len = hp.get("sort_by_len", True)
        self.sizes: Any = None
        self.epoch = 0
        self._index_map: Optional[np.ndarray] = None   # virtual -> real index

    def set_epoch(self, epoch: int) -> None:
        """The epoch, and with the weighted sampler its draw:
        ``RandomState(seed + epoch).choice(n, n, p=w / w.sum())``."""
        self.epoch = epoch
        self._index_map = None
        if self.shuffle and self.hp.get("use_weighted_sampler", False):
            w = self.sample_weights()
            if w is not None:
                p = np.asarray(w, np.float64)
                rng = np.random.RandomState(int(self.hp.get("seed", 1234)) + epoch)
                self._index_map = rng.choice(len(p), len(p), replace=True, p=p / p.sum())

    def sample_weights(self) -> Optional[np.ndarray]:
        """Per-item sampling weights; None samples uniformly."""
        return None

    def _real_index(self, index: int) -> int:
        return int(self._index_map[index]) if self._index_map is not None else index

    def _item_rng(self, index: int) -> np.random.RandomState:
        seed = int(self.hp.get("seed", 1234))
        return np.random.RandomState((seed * 1000003 + self.epoch * 10007 + index
                                      + self._rng_salt * 97003) % (2 ** 31))

    def __len__(self) -> int:
        return len(self.sizes)

    def num_tokens(self, index: int) -> int:
        return self.size(index)

    def size(self, index: int) -> int:
        return min(self.sizes[self._real_index(index)], self.hp.get("max_frames", 1548))

    def ordered_indices(self) -> np.ndarray:
        """The epoch's item order: a permutation seeded by seed + epoch,
        stably sorted by (real) length when ``sort_by_len``; in order
        unshuffled."""
        if not self.shuffle:
            return np.arange(len(self))
        rng = np.random.RandomState(int(self.hp.get("seed", 1234)) + self.epoch)
        indices = rng.permutation(len(self))
        if self.sort_by_len:
            sizes = np.array(self.sizes)
            if self._index_map is not None:
                sizes = sizes[self._index_map]
            indices = indices[np.argsort(sizes[indices], kind="mergesort")]
        return indices


class BaseSpeechDataset(BaseDataset):
    """Mel, phone tokens and the speaker embedding or id of each item of
    the split ``<binary_data_dir>/<prefix>``."""

    def __init__(self, prefix: str, hp: Any, shuffle: bool = False):
        super().__init__(hp, shuffle)
        self.data_dir = hp["binary_data_dir"]
        self.prefix = prefix
        self.indexed_ds: Optional[IndexedDataset] = None
        sizes = np.load(f"{self.data_dir}/{prefix}_lengths.npy")
        if prefix == "test" and len(hp.get("test_ids", [])) > 0:
            self.avail_idxs = list(hp["test_ids"])
        else:
            self.avail_idxs = list(range(len(sizes)))
        if prefix == "train" and hp.get("min_frames", 0) > 0:
            self.avail_idxs = [i for i in self.avail_idxs if sizes[i] >= hp["min_frames"]]
        self.sizes = [sizes[i] for i in self.avail_idxs]

    def _get_item(self, index: int) -> dict:
        """The stored item at (virtual) ``index``."""
        if self.indexed_ds is None:
            self.indexed_ds = IndexedDataset(f"{self.data_dir}/{self.prefix}")
        return self.indexed_ds[self.avail_idxs[self._real_index(index)]]

    def __getitem__(self, index: int) -> dict:
        return self._sample(index, self._get_item(index))

    def _sample(self, index: int, item: dict) -> dict:
        hp = self.hp
        spec = np.asarray(item["mel"], np.float32)[:hp.get("max_frames", 1548)]
        fm = hp.get("frames_multiple", 1)
        spec = spec[:spec.shape[0] // fm * fm]
        sample = {
            "id": index,
            "item_name": item["item_name"],
            "text": item.get("txt", ""),
            "txt_token": np.asarray(item["ph_token"][:hp.get("max_input_tokens", 1550)],
                                    np.int64),
            "mel": spec,
        }
        if hp.get("use_spk_embed"):
            sample["spk_embed"] = np.asarray(item["spk_embed"], np.float32)
        if hp.get("use_spk_id"):
            sample["spk_id"] = int(item["spk_id"])
        return sample

    def collater(self, samples: list) -> dict:
        if len(samples) == 0:
            return {}
        hp = self.hp
        sm = int(hp.get("frame_size_multiple", 1))
        tok_m = int(hp.get("token_size_multiple", 1))
        batch = {
            "id": np.asarray([s["id"] for s in samples], np.int64),
            "item_name": [s["item_name"] for s in samples],
            "nsamples": len(samples),
            "text": [s["text"] for s in samples],
            "txt_tokens": collate_1d_or_2d([s["txt_token"] for s in samples], 0,
                                           size_multiple=tok_m),
            "txt_lengths": np.asarray([len(s["txt_token"]) for s in samples], np.int64),
            "mels": collate_1d_or_2d([s["mel"] for s in samples], 0.0, size_multiple=sm),
            "mel_lengths": np.asarray([s["mel"].shape[0] for s in samples], np.int64),
        }
        if hp.get("use_spk_embed"):
            batch["spk_embed"] = np.stack([s["spk_embed"] for s in samples])
        if hp.get("use_spk_id"):
            batch["spk_ids"] = np.asarray([s["spk_id"] for s in samples], np.int64)
        return batch


class EditingDataset(BaseSpeechDataset):
    """Adds mel2ph, f0/uv/pitch and the time mask ``time_mel_mask``; its
    sampling weights favour items with stutter frames."""

    def __init__(self, prefix: str, hp: Any, shuffle: bool = False):
        super().__init__(prefix, hp, shuffle)
        self._sample_weights: Optional[np.ndarray] = None

    def sample_weights(self) -> np.ndarray:
        """(10 + stutter frames) / frames of each item's
        ``stutter_mel_mask``, 1 for an item without one."""
        if self._sample_weights is None:
            ws = []
            for i in range(len(self)):   # set_epoch clears the map before it asks
                m = np.asarray(self._get_item(i).get("stutter_mel_mask", []))
                ws.append(1.0 if m.size == 0 else (10.0 + float((m > 0).sum())) / m.size)
            self._sample_weights = np.asarray(ws, np.float64)
        return self._sample_weights

    def _sample(self, index: int, item: dict) -> dict:
        sample = super()._sample(index, item)
        hp = self.hp
        sample["wav_fn"] = item.get("wav_fn")
        t = sample["mel"].shape[0]
        mel2ph = np.asarray(item["mel2ph"], np.int64)[:t]
        sample["mel2ph"] = mel2ph
        if hp.get("use_pitch_embed", True):
            f0, uv = norm_interp_f0(np.asarray(item["f0"], np.float32)[:t])
            sample["f0"], sample["uv"] = f0, uv
            sample["pitch"] = np.asarray(item.get("pitch", np.zeros(t)), np.int64)[:t]
            if hp.get("pitch_type") == "cwt":
                sample.update(self._cwt(item, t))
        if "stutter_mel_mask" in item:
            sample["stutter_mel_mask"] = np.asarray(item["stutter_mel_mask"], np.int64)[:t]
        rng = self._item_rng(index)
        if hp.get("infer", False):
            mask = generate_inference_mask(mel2ph, 0.5, rng)
        elif hp.get("mask_type", "alignment_aware") == "random":
            mask = generate_time_mask(t, hp.get("training_mask_ratio", 0.8), rng)
        else:
            mask = generate_alignment_aware_time_mask(
                mel2ph, hp.get("training_mask_ratio", 0.8), rng)
        sample["time_mel_mask"] = mask.astype(np.float32)
        return sample

    @staticmethod
    def _cwt(item: dict, t: int) -> dict:
        """FastSpeech2-orig's CWT targets: the binarizer's (``with_f0cwt``),
        else decomposed here from the raw f0."""
        if "cwt_spec" in item:
            spec = np.asarray(item["cwt_spec"], np.float32)
            mean = float(item.get("f0_mean", item.get("cwt_mean")))
            std = float(item.get("f0_std", item.get("cwt_std")))
        else:
            d = f0_to_cwt(np.asarray(item["f0"], np.float32)[:t])
            spec, mean, std = d["cwt_spec"], d["cwt_mean"], d["cwt_std"]
        return {"cwt_spec": spec[:t], "f0_mean": mean, "f0_std": std}

    def collater(self, samples: list) -> dict:
        if len(samples) == 0:
            return {}
        batch = super().collater(samples)
        hp = self.hp
        sm = int(hp.get("frame_size_multiple", 1))
        frames = lambda key, pad=0.0: collate_1d_or_2d([s[key] for s in samples], pad,
                                                       size_multiple=sm)
        batch["wav_fn"] = [s["wav_fn"] for s in samples]
        if hp.get("use_pitch_embed", True):
            batch["f0"], batch["uv"], batch["pitch"] = (frames("f0"), frames("uv"),
                                                        frames("pitch", 0))
        if "cwt_spec" in samples[0]:
            batch["cwt_spec"] = frames("cwt_spec")
            batch["f0_mean"], batch["f0_std"] = (
                np.asarray([s[k] for s in samples], np.float32) for k in ("f0_mean", "f0_std"))
        batch["mel2ph"] = frames("mel2ph", 0)
        if "stutter_mel_mask" in samples[0]:
            batch["stutter_mel_masks"] = frames("stutter_mel_mask",
                                                hp.get("stutter_pad_idx", -1))
        batch["time_mel_masks"] = frames("time_mel_mask", 0)
        return batch


class WordSpeechDataset(EditingDataset):
    """Adds PortaSpeech's word fields: ``word_token``, ``ph2word`` (cut to
    the phone tokens) and ``mel2word`` (cut to the mel), collated as
    ``word_tokens`` and ``ph2word`` to ``token_size_multiple`` and
    ``mel2word`` to ``frame_size_multiple``."""

    def _sample(self, index: int, item: dict) -> dict:
        sample = super()._sample(index, item)
        sample["word_token"] = np.asarray(item["word_token"], np.int64)
        sample["ph2word"] = np.asarray(item["ph2word"][:len(sample["txt_token"])], np.int64)
        if "mel2word" in item:
            sample["mel2word"] = np.asarray(item["mel2word"], np.int64)[:sample["mel"].shape[0]]
        return sample

    def collater(self, samples: list) -> dict:
        batch = super().collater(samples)
        if not samples:
            return batch
        sm = int(self.hp.get("frame_size_multiple", 1))
        tok_m = int(self.hp.get("token_size_multiple", 1))
        for key, name, multiple in (("word_token", "word_tokens", tok_m),
                                    ("ph2word", "ph2word", tok_m), ("mel2word", "mel2word", sm)):
            if key in samples[0]:
                batch[name] = collate_1d_or_2d([s[key] for s in samples], 0,
                                               size_multiple=multiple)
        return batch


class ConcatDataset(BaseDataset):
    """Datasets one after the other, sharing the first one's collater. The
    weighted sampler runs at this level: the children keep no map of their
    own (token-budget batching reads this level's sizes), and each child's
    item randomness is salted with the virtual index, so repeated draws of
    one item get their own masks."""

    def __init__(self, datasets: list):
        if not datasets:
            raise ValueError("ConcatDataset of no datasets")
        super().__init__(datasets[0].hp, datasets[0].shuffle)
        self.datasets = datasets
        self.sizes = [s for d in datasets for s in d.sizes]
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])

    def set_epoch(self, epoch: int) -> None:
        super().set_epoch(epoch)
        for d in self.datasets:
            d.set_epoch(epoch)
            d._index_map = None

    def sample_weights(self) -> Optional[np.ndarray]:
        ws = [d.sample_weights() for d in self.datasets]
        if all(w is None for w in ws):
            return None
        return np.concatenate([np.ones(len(d), np.float64) if w is None else np.asarray(w)
                               for d, w in zip(self.datasets, ws)])

    def __getitem__(self, index: int) -> dict:
        real = self._real_index(index)
        k = int(np.searchsorted(self._offsets, real, side="right") - 1)
        d = self.datasets[k]
        d._rng_salt = index - real
        try:
            return d[real - self._offsets[k]]
        finally:
            d._rng_salt = 0

    def collater(self, samples: list) -> dict:
        return self.datasets[0].collater(samples)


class EpochBatchSampler:
    """The batches of epoch after epoch from epoch 0 (one epoch unless
    ``endless``), each a list of ``(epoch, index)`` keys: per epoch
    ``batch_by_size`` over the dataset's ordered indices, the batches
    shuffled by seed + epoch when the dataset shuffles."""

    def __init__(self, dataset: BaseDataset, max_tokens: Optional[int] = None,
                 max_sentences: Optional[int] = None,
                 required_batch_size_multiple: int = 1, endless: bool = False):
        self.dataset = dataset
        self.max_tokens, self.max_sentences = max_tokens, max_sentences
        self.bsz_mult = required_batch_size_multiple
        self.endless = endless

    def batches(self, epoch: int) -> list[list[int]]:
        ds = self.dataset
        ds.set_epoch(epoch)
        batches = batch_by_size(ds.ordered_indices(), ds.num_tokens,
                                max_tokens=self.max_tokens,
                                max_sentences=self.max_sentences,
                                required_batch_size_multiple=self.bsz_mult)
        if ds.shuffle:
            np.random.RandomState(int(ds.hp.get("seed", 1234)) + epoch).shuffle(batches)
        return batches

    def __iter__(self) -> Iterator[list]:
        epoch = 0
        while True:
            for batch in self.batches(epoch):
                yield [(epoch, i) for i in batch]
            epoch += 1
            if not self.endless:
                return


class _EpochItems(torch.utils.data.Dataset):
    """``dataset[(epoch, index)]``: the item as the dataset gives it in that
    epoch. Each copy (a worker's is taken when the loader starts, maybe
    before the sampler has drawn epoch 0's map) sets the dataset's epoch
    itself on its first key and on every change of epoch."""

    def __init__(self, dataset: BaseDataset):
        self.dataset = dataset
        self._epoch: Optional[int] = None

    def __getitem__(self, key):
        epoch, index = key
        if self._epoch != epoch:
            self.dataset.set_epoch(epoch)
            self._epoch = epoch
        return self.dataset[index]


class _Tensors:
    """A collater whose arrays come back as tensors (sharing their memory),
    which the loader can pin."""

    def __init__(self, collater):
        self.collater = collater

    def __call__(self, samples: list) -> dict:
        return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in self.collater(samples).items()}


class DataLoader:
    """Collated host batches of ``dataset`` from
    :class:`EpochBatchSampler`, in ``num_workers`` spawned processes (0: in
    this one), each two batches ahead; ``close`` stops the workers. The
    batches hold numpy arrays, or with ``pin_memory`` tensors that the
    loader's pin thread copies into pinned memory (on a host with a GPU)
    for non-blocking copies to it."""

    def __init__(self, dataset: BaseDataset, max_tokens: Optional[int] = None,
                 max_sentences: Optional[int] = None,
                 required_batch_size_multiple: int = 1, endless: bool = False,
                 num_workers: int = 0, pin_memory: bool = False):
        self.dataset = dataset
        self.sampler = EpochBatchSampler(dataset, max_tokens, max_sentences,
                                         required_batch_size_multiple, endless)
        workers = dict(num_workers=num_workers, prefetch_factor=2,
                       multiprocessing_context="spawn") if num_workers > 0 else {}
        self.loader = torch.utils.data.DataLoader(
            _EpochItems(dataset), batch_sampler=self.sampler,
            collate_fn=_Tensors(dataset.collater) if pin_memory else dataset.collater,
            pin_memory=pin_memory and torch.cuda.is_available(), **workers)
        self._iters: list = []

    def __iter__(self) -> Iterator[dict]:
        it = iter(self.loader)
        self._iters.append(it)
        return it

    def close(self) -> None:
        for it in self._iters:
            shutdown = getattr(it, "_shutdown_workers", None)
            if shutdown is not None:
                shutdown()
        self._iters.clear()

    def __enter__(self) -> "DataLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
