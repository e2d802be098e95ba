"""Region-edit drivers for the in-place editing families (CampNet, A3T,
EditSpeech): the port of the JAX package's ``infer/editors.py``.

    python -m speech_editing_tpu_torch.infer.editors --config egs/<family>.yaml \
        --exp_name NAME [-hp k=v,...] [--device cpu]

The CSV edit API of ``infer/spec_denoiser.py`` (same schema, MFA step and
outputs), with the driver picked from the config's ``task_cls``
(``infer_cls_for_hp``). These models keep the source's frame grid and
regenerate only the edited span: the frame mask is the frames of the
region's words (``mel2word``), one deterministic device program predicts
the mel, which is composited with the source and vocoded (the edit and the
source, two vocoder calls). CampNet conditions on the edited phones,
A3T and EditSpeech on the source's; EditSpeech splices its two decoders
(``bidirectional_fusion``). CampNet's frame self-attention is kernel K3.
Runs on the GPU unless ``--device cpu`` is given; ``serve_batched`` routes
the CSV through ``infer/serving.py::BatchedInPlaceEditServer``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from speech_editing_tpu_torch.infer.spec_denoiser import SpecDenoiserInfer
from speech_editing_tpu_torch.models.a3t import A3T
from speech_editing_tpu_torch.models.campnet import CampNet
from speech_editing_tpu_torch.models.editspeech import EditSpeech, bidirectional_fusion
from speech_editing_tpu_torch.utils import convert_jax_params as cjp


class _InPlaceEditInfer(SpecDenoiserInfer):
    """Shared flow: the frame mask over the edit region, a same-length
    regeneration. A family sets ``model_cls`` and ``converter`` (its
    ``utils/convert_jax_params.py`` function, for a JAX checkpoint) and
    implements
    ``_model_mel_out_batch(txt, mels, mel2ph, tm, spk, f0, uv)``: one
    device program over ``[B, ...]`` inputs (numpy or device tensors)
    returning the predicted mel [B, T, 80] on the device, which the
    per-item path (B=1) and the batch server share."""

    #: the token sequence the model reads
    _token_field = "ph_token"
    model_cls: type
    converter: Callable[[Any, Any], dict]

    @classmethod
    def make_server(cls, infer_ins, **kw):
        """The in-place families' batch server."""
        from speech_editing_tpu_torch.infer.serving import BatchedInPlaceEditServer

        return BatchedInPlaceEditServer(infer_ins, **kw)

    def build_model(self):
        model = self.model_cls(self.ph_encoder.vocab_size, self.hp,
                               self.hp.get("audio_num_mel_bins", 80))
        model.load_state_dict(self.load_variables())
        model.to(self.device).eval()
        self.quant = self.maybe_quantize(model)
        return model

    def params_from_jax(self, params) -> dict:
        return self.converter(params, self.hp)

    def _frame_mask(self, item) -> np.ndarray:
        w0, w1 = item["words_region"][0]
        mel2word = item["mel2word"]
        return ((mel2word >= w0) & (mel2word <= w1)).astype(np.float32)

    def _model_mel_out_batch(self, txt, mels, mel2ph, tm, spk, f0, uv) -> torch.Tensor:
        raise NotImplementedError

    def _model_mel_out(self, item, tm, spk_embed) -> np.ndarray:
        return self._model_mel_out_batch(
            item[self._token_field][None], item["mel"][None], item["mel2ph"][None],
            tm[None], spk_embed, item["f0"][None], item["uv"][None])[0].cpu().numpy()

    def forward_model(self, item):
        """One edit. Returns (wav_out, wav_gt, mel_out, mel, mel_out * mask,
        mel * mask)."""
        tm = self._frame_mask(item)[:, None]
        spk_embed = self.spk_embedder(item["wav"])[None]
        mel_out = self._model_mel_out(item, tm, spk_embed)
        mel_out = mel_out * tm + item["mel"] * (1 - tm)
        wav_out = self.run_vocoder(mel_out)
        wav_gt = self.run_vocoder(item["mel"])
        return wav_out, wav_gt, mel_out, item["mel"], mel_out * tm, item["mel"] * tm


class CampNetInfer(_InPlaceEditInfer):
    _token_field = "edited_ph_token"
    model_cls = CampNet
    converter = staticmethod(cjp.campnet_params_from_jax)

    @torch.inference_mode()
    def _model_mel_out_batch(self, txt, mels, mel2ph, tm, spk, f0, uv):
        with self.weights():
            out = self.model(self._tensor(txt), self._tensor(mels), self._tensor(tm))
        return out["mel_out_fine"]


class A3TInfer(_InPlaceEditInfer):
    model_cls = A3T
    converter = staticmethod(cjp.a3t_params_from_jax)

    @torch.inference_mode()
    def _model_mel_out_batch(self, txt, mels, mel2ph, tm, spk, f0, uv):
        with self.weights():
            out = self.model(self._tensor(txt), self._tensor(mels), self._tensor(mel2ph),
                             self._tensor(tm))
        return out["mel_out_postnet"]


class EditSpeechInfer(_InPlaceEditInfer):
    model_cls = EditSpeech
    converter = staticmethod(cjp.editspeech_params_from_jax)

    @torch.inference_mode()
    def _model_mel_out_batch(self, txt, mels, mel2ph, tm, spk, f0, uv):
        mels, tm = self._tensor(mels), self._tensor(tm)
        with self.weights():
            out = self.model(self._tensor(txt), tm, self._tensor(mel2ph),
                             self._tensor(spk, torch.float32), mels, self._tensor(f0),
                             self._tensor(uv))
        return bidirectional_fusion(out["forward_outputs"], out["backward_outputs"], mels, tm)


INFER_BY_TASK = {
    "campnet": CampNetInfer,
    "a3t": A3TInfer,
    "editspeech": EditSpeechInfer,
}


def infer_cls_for_hp(hp) -> type:
    """The editor driver of the config's ``task_cls``."""
    task_cls = str(hp.get("task_cls", "")).lower()
    for key, cls in INFER_BY_TASK.items():
        if key in task_cls:
            return cls
    raise SystemExit(f"cannot infer editor from task_cls={hp.get('task_cls')!r}; "
                     f"expected one of {sorted(INFER_BY_TASK)}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    """The in-place families' CSV edit API (see the module doc)."""
    from speech_editing_tpu_torch.infer.spec_denoiser import main as csv_main

    csv_main(argv, infer_cls_for_hp)


if __name__ == "__main__":
    main()
