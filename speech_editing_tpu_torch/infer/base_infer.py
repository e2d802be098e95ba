"""The inference base class: phone encoder, model, vocoder and speaker
embedder. The port of the JAX package's ``infer/base_infer.py``.

The model's weights come from the last checkpoint of ``hp["work_dir"]``
(the port's or the JAX package's), the vocoder from the registry
(``hp["vocoder"]``), the phone encoder from ``phone_set.json`` under
``binary_data_dir`` (or ``processed_data_dir``). ``device`` defaults to
``"cuda"``, which raises without a GPU; ``"cpu"`` runs every kernel's
plain version. ``infer_once = forward_model(preprocess_input(inp))``.
``serve_quant_int8`` keeps the model's weights in int8 (``quant``).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from speech_editing_tpu_torch.infer.quant import maybe_quantized, weights
from speech_editing_tpu_torch.training.trainer import cuda_or_cpu


class BaseInfer:
    quant = None    # the model's int8 weights under serve_quant_int8 (build_model)

    def __init__(self, hp: Any, device: Any = "cuda"):
        self.device = cuda_or_cpu(device, type(self).__name__)
        self.hp = hp
        self.data_dir = hp["binary_data_dir"]
        self.ph_encoder = self._load_encoder()
        self.model = self.build_model()
        self.vocoder = self.build_vocoder()
        self.spk_embedder = self._build_spk_embedder()

    def _load_encoder(self):
        from speech_editing_tpu_torch.utils.text.text_encoder import build_token_encoder

        for d in (self.data_dir, self.hp.get("processed_data_dir", "")):
            fn = os.path.join(d, "phone_set.json") if d else ""
            if fn and os.path.exists(fn):
                return build_token_encoder(fn)
        raise FileNotFoundError(f"phone_set.json not found under {self.data_dir}")

    def build_model(self):
        raise NotImplementedError

    def load_variables(self) -> dict:
        """The last checkpoint of ``work_dir`` as the model's ``state_dict``."""
        from speech_editing_tpu_torch.training.checkpoint import (get_last_checkpoint,
                                                                  load_checkpoint)

        ckpt_path, _ = get_last_checkpoint(self.hp["work_dir"])
        if ckpt_path is None:
            raise FileNotFoundError(f"no checkpoint in {self.hp['work_dir']}")
        payload = load_checkpoint(ckpt_path)
        if "jax_params" in payload:
            sd = self.params_from_jax(payload["jax_params"])
        else:
            sd = payload["state"]["model"]
        print(f"| loaded {ckpt_path} (step {payload['steps']})", flush=True)
        return sd

    def params_from_jax(self, params) -> dict:
        """A JAX package checkpoint's parameter tree as the model's
        ``state_dict`` (``utils/convert_jax_params.py``); FluentSpeech's
        ``GaussianDiffusion`` here, each family's in its driver."""
        from speech_editing_tpu_torch.utils.convert_jax_params import params_from_jax

        return params_from_jax(params, self.hp)

    def maybe_quantize(self, model):
        """``serve_quant_int8``: ``model``'s weights in int8 on the device
        (``infer/quant.py``), which the device programs dequantize once a
        call through :meth:`weights`; None without it."""
        return maybe_quantized(self.hp, model, self.device, "acoustic model")

    def weights(self):
        """The context the device programs run the model in: its float32
        weights dequantized for the call under ``serve_quant_int8``."""
        return weights(self.quant)

    def build_vocoder(self):
        from speech_editing_tpu_torch.infer.vocoder import get_vocoder_cls

        return get_vocoder_cls(self.hp.get("vocoder", "GriffinLim"))(self.hp, self.device)

    def _build_spk_embedder(self):
        """resemblyzer's speaker encoder when it imports, else a zero
        256-vector, as in the JAX package; prints which."""
        try:
            from resemblyzer import VoiceEncoder  # type: ignore

            enc = VoiceEncoder(device="cpu")
        except Exception:
            print("| speaker embedding: zeros (resemblyzer is not installed)", flush=True)
            return lambda wav: np.zeros(256, np.float32)
        print("| speaker embedding: resemblyzer VoiceEncoder", flush=True)
        return lambda wav: np.asarray(enc.embed_utterance(wav.astype(np.float64)), np.float32)

    def run_vocoder(self, mel: np.ndarray) -> np.ndarray:
        return self.vocoder.spec2wav(np.asarray(mel))

    def preprocess_input(self, inp: dict) -> dict:
        raise NotImplementedError

    def forward_model(self, item: dict):
        raise NotImplementedError

    def infer_once(self, inp: dict):
        return self.forward_model(self.preprocess_input(inp))
