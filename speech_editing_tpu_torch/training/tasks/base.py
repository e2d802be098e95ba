"""What a model family gives the trainer: its dataset, the batch keys its
step reads, its model, its loss, its inference forward and the converter
of its JAX checkpoints. The port of the JAX package's
``training/tasks/base.py``.

The vocabulary comes from the corpus's ``phone_set.json``
(``binary_data_dir``): ``vocab_size`` counts it with the three reserved
ids, and ``sil_token_ids`` are the ids of its silence phones. Without one,
``hp["vocab_size"]`` (default 100) and no silence ids.
"""

from __future__ import annotations

import os
from typing import Any, Sequence

import torch

from speech_editing_tpu_torch.data.datasets import EditingDataset
from speech_editing_tpu_torch.utils.text.text_encoder import (TokenTextEncoder,
                                                              build_token_encoder)


class BaseTask:
    dataset_cls = EditingDataset
    # the collated batch's keys that go to the device for a step
    array_batch_keys: Sequence[str] = (
        "txt_tokens", "mels", "mel2ph", "f0", "uv", "time_mel_masks")

    def __init__(self, hp: Any):
        self.hp = hp
        data_dir = hp.get("binary_data_dir", "")
        fn = os.path.join(data_dir, "phone_set.json") if data_dir else ""
        self.token_encoder: TokenTextEncoder | None = (
            build_token_encoder(fn) if fn and os.path.exists(fn) else None)
        if self.token_encoder is None:
            self.vocab_size = int(hp.get("vocab_size", 100))
            self.sil_token_ids: tuple = ()
        else:
            enc = self.token_encoder
            self.vocab_size = enc.vocab_size
            self.sil_token_ids = tuple(sorted({i for p in enc.sil_phonemes()
                                               for i in enc.encode(p)}))

    def effective_batch_keys(self) -> tuple:
        keys = list(self.array_batch_keys)
        if self.hp.get("use_spk_embed"):
            keys.append("spk_embed")
        if self.hp.get("use_spk_id"):
            keys.append("spk_ids")
        return tuple(keys)

    def build_model(self):
        raise NotImplementedError

    def make_loss_fn(self, model, train: bool = True):
        """``loss_fn(batch, generator=None, t=None, noise=None) -> (total,
        losses)``; ``train=False`` is the validation loss (no dropout)."""
        raise NotImplementedError

    def params_from_jax(self, params, hp: Any) -> dict:
        """A JAX checkpoint's parameter tree (numpy) -> the model's
        ``state_dict``."""
        raise NotImplementedError

    def meta_columns(self, out: dict, b: int, t_len: int) -> dict:
        """Columns of ``meta.csv`` for row ``b`` of an inference output
        (``t_len`` real frames); none by default."""
        return {}

    def build_infer_fn(self, model):
        """``infer_fn(batch, generator=None, noise=None) -> out``: the
        model's inference forward on a device batch (the dataset's
        ``mel2ph`` and ``time_mel_masks``), with ``mel_out`` composited as
        ``mel_out * mask + mels * (1 - mask)``. ``generator`` / ``noise``:
        see ``GaussianDiffusion.forward``."""

        @torch.inference_mode()
        def infer_fn(batch, generator=None, noise=None):
            tm = batch["time_mel_masks"][..., None].float()
            out = model(batch["txt_tokens"], tm, batch["mel2ph"], batch.get("spk_embed"),
                        batch["mels"], batch["f0"], batch["uv"], generator=generator,
                        noise=noise)
            out["mel_out"] = out["mel_out"] * tm + batch["mels"] * (1 - tm)
            return out

        return infer_fn
