"""One sentence from text with a TTS baseline: text -> phones -> mel -> wav,
with no source utterance. The port of the JAX package's
``infer/tts_infer.py``.

    python -m speech_editing_tpu_torch.infer.tts_infer --config egs/fs.yaml \
        --exp_name NAME --text "hello world" [--out out.wav] [--device cpu]

The driver comes from the config's ``task_cls`` (``infer_cls_for``; the
PortaSpeech tasks are refused: ``run --infer`` is their inference entry
point):
FastSpeech and FastSpeech2-orig predict the durations and the pitch (the
latter from its CWT coefficients) and the energy; DiffSpeech runs its
reverse process from a ``torch.Generator`` seeded by ``seed``. As in the
JAX package the mel is regulated to the static ``max_frames`` budget and
cut to the predicted length before the vocoder. The phones come from the
port's text front end (its fallback g2p when ``g2p_en`` is absent), the
weights from the last checkpoint of the work dir (the port's or the JAX
package's), the vocoder from ``hp["vocoder"]``. Runs on the GPU unless
``--device cpu`` is given.
"""

from __future__ import annotations

import re
from typing import Any, Optional, Sequence

import numpy as np
import torch

from speech_editing_tpu_torch.infer.base_infer import BaseInfer
from speech_editing_tpu_torch.models.diffspeech import DiffSpeech
from speech_editing_tpu_torch.models.fs import FastSpeech
from speech_editing_tpu_torch.models.fs2_orig import FastSpeech2Orig
from speech_editing_tpu_torch.utils import convert_jax_params as cjp
from speech_editing_tpu_torch.utils.text.processors import get_txt_processor_cls, txt_to_ph


class FastSpeechInfer(BaseInfer):
    """FastSpeech free-running synthesis."""

    converter = staticmethod(cjp.fastspeech_params_from_jax)

    def make_model(self):
        return FastSpeech(self.ph_encoder.vocab_size, self.hp, decoder=True, masked=False)

    def build_model(self):
        model = self.make_model()
        model.load_state_dict(self.load_variables())
        return model.to(self.device).eval()

    def params_from_jax(self, params) -> dict:
        return self.converter(params, self.hp)

    def preprocess_input(self, inp: dict) -> dict:
        txt_processor = get_txt_processor_cls(self.hp.get("language", "en"))
        ph, txt, *_ = txt_to_ph(txt_processor, inp["text"])
        item = {"item_name": inp.get("item_name", "<tts>"), "text": txt, "ph": ph,
                "ph_token": np.asarray(self.ph_encoder.encode(ph), np.int64)}
        if self.hp.get("use_spk_embed") and inp.get("ref_wav") is not None:
            item["spk_embed"] = self.spk_embedder(np.asarray(inp["ref_wav"], np.float32))
        return item

    def _spk(self, item: dict) -> Optional[torch.Tensor]:
        if "spk_embed" in item:
            return torch.as_tensor(item["spk_embed"], device=self.device)[None]
        if self.hp.get("use_spk_embed"):
            return torch.zeros(1, 256, device=self.device)
        return None

    def run_model(self, txt: torch.Tensor, spk: Optional[torch.Tensor]) -> dict:
        return self.model(txt, None, None, spk, use_pred_mel2ph=True, use_pred_pitch=True)

    @torch.inference_mode()
    def forward_model(self, item: dict):
        """(wav, mel [frames, M]): the mel cut to its predicted length."""
        txt = torch.as_tensor(item["ph_token"], device=self.device)[None]
        out = self.run_model(txt, self._spk(item))
        n = int((out["mel2ph"][0] > 0).sum())
        mel = out["mel_out"][0, :max(n, 1)].float().cpu().numpy()
        return self.run_vocoder(mel), mel


class FS2OrigInfer(FastSpeechInfer):
    """FastSpeech2-orig: ``infer`` predicts durations, pitch and energy."""

    converter = staticmethod(cjp.fs2_orig_params_from_jax)

    def make_model(self):
        return FastSpeech2Orig(self.ph_encoder.vocab_size, self.hp)

    def run_model(self, txt, spk):
        return self.model(txt, None, spk, infer=True)


class DiffSpeechInfer(FastSpeechInfer):
    """DiffSpeech: the reverse process over the FastSpeech conditioner, its
    noise from a device generator seeded by ``seed`` at each call."""

    converter = staticmethod(cjp.diffspeech_params_from_jax)

    def make_model(self):
        return DiffSpeech(self.ph_encoder.vocab_size, self.hp,
                          self.hp.get("audio_num_mel_bins", 80))

    def run_model(self, txt, spk):
        gen = torch.Generator(device=self.device).manual_seed(int(self.hp.get("seed", 1234)))
        return self.model(txt, None, spk, generator=gen)


def infer_cls_for(hp: Any):
    """The driver of the config's ``task_cls``. ``FastSpeech2OrigTask`` (the
    class ``egs/fs2_orig.yaml`` names) takes FastSpeech2-orig's driver: the
    JAX package's pattern (``fs2orig|fs2_orig``) misses that name and gives
    it FastSpeech's, which cannot load its weights."""
    task = hp.get("task_cls", "")
    if re.search(r"portaspeech", task, re.IGNORECASE):
        # the JAX package gives these FastSpeech's driver, whose model cannot
        # load PortaSpeech's weights
        raise ValueError(f"task_cls {task!r}: tts_infer has no PortaSpeech driver; generate "
                         "with `python -m speech_editing_tpu_torch.run --config ... --infer`")
    if re.search(r"diffspeech", task, re.IGNORECASE):
        return DiffSpeechInfer
    if re.search(r"fastspeech2orig|fs2_?orig", task, re.IGNORECASE):
        return FS2OrigInfer
    return FastSpeechInfer


def main(argv: Optional[Sequence[str]] = None) -> str:
    """The command line (see the module doc); returns the wav's path."""
    import sys

    from speech_editing_tpu_torch.config.hparams import arg_parser, set_hparams
    from speech_editing_tpu_torch.training.trainer import cuda_or_cpu, float32_on_card
    from speech_editing_tpu_torch.utils.audio.io import save_wav

    parser = arg_parser()
    parser.add_argument("--text", required=True)
    parser.add_argument("--out", default="tts_out.wav")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(sys.argv[1:] if argv is None else list(argv))
    device = cuda_or_cpu(args.device, "tts_infer")
    float32_on_card()
    hp = set_hparams(args)
    wav, mel = infer_cls_for(hp)(hp, device).infer_once({"text": args.text})
    save_wav(np.asarray(wav, np.float32), args.out, int(hp["audio_sample_rate"]))
    print(f"| wrote {args.out} ({len(wav)} samples, {mel.shape[0]} frames)", flush=True)
    return args.out


if __name__ == "__main__":
    main()
