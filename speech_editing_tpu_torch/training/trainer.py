"""A minimal FluentSpeech trainer: collated batches in, steps, logged
metrics out.

The core of the JAX package's ``Trainer._train_loop``: each batch (a dict
of numpy arrays, the keys of ``make_loss_fn``) goes to the device, one
:class:`TrainStep` runs on it, and every ``hp["tb_log_interval"]`` steps
the metrics are printed; ``hp["max_nan_intervals"]`` logged intervals in a
row with skipped (non-finite) updates abort the run. Checkpoints, validation and the
binarized-dataset reader are not ported yet.
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import torch

from speech_editing_tpu_torch.training.tasks.spec_denoiser import build_model
from speech_editing_tpu_torch.training.train_state import TrainStep

_INT_KEYS = ("txt_tokens", "mel2ph")


class Trainer:
    """Seeded random weights (``seed``) until loaded through
    ``train_step.load_state_dict``. ``device`` defaults to ``"cuda"`` and
    raises when no GPU is present; ``device="cpu"`` runs every kernel's
    plain version. ``dropout=False`` turns predictor dropout off."""

    def __init__(self, hp: Any, device="cuda", seed: int = 0, vocab_size: int = 80,
                 sil_token_ids: Sequence[int] = (), dropout: bool = True):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; pass device='cpu' "
                               "to run the plain versions")
        self.hp = hp
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = build_model(vocab_size, hp)
        self.model.to(self.device).train()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.train_step = TrainStep(self.model, hp, sil_token_ids, train=dropout)
        self.log_interval = int(hp.get("tb_log_interval", 100))
        self.max_nan_intervals = int(hp.get("max_nan_intervals", 5))
        self._nan_intervals = 0

    @property
    def global_step(self) -> int:
        return self.train_step.step

    def to_device(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v)
            out[k] = (v.long() if k in _INT_KEYS else v.float()).to(self.device)
        return out

    def step(self, batch: dict) -> dict:
        """One training step on a host (or device) batch; returns its metrics
        as 0-d device tensors."""
        metrics = self.train_step(self.to_device(batch), self.generator)
        if self.global_step % self.log_interval == 0:
            self._log(metrics)
        return metrics

    def fit(self, batches: Iterable[dict], max_updates: int) -> list[dict]:
        """Step through ``batches`` until ``max_updates`` steps have run;
        returns every step's metrics as floats."""
        history = []
        for batch in batches:
            if self.global_step >= max_updates:
                break
            history.append({k: float(v) for k, v in self.step(batch).items()})
        return history

    def _log(self, metrics: dict) -> None:
        m = {k: float(v) for k, v in metrics.items()}
        print(f"| step {self.global_step} | "
              + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())), flush=True)
        if m["nan_grads"] > 0:
            self._nan_intervals += 1
            print(f"| WARNING: non-finite gradients at step {self.global_step}; "
                  f"update skipped ({self._nan_intervals} intervals in a row)",
                  flush=True)
            if self._nan_intervals >= self.max_nan_intervals:
                raise RuntimeError(f"gradients non-finite for {self._nan_intervals} "
                                   "logged intervals in a row; aborting")
        else:
            self._nan_intervals = 0
