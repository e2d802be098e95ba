"""Gradio web demo for region editing (needs the ``gradio`` package).

A form that takes source audio, the original and the edited transcript and
the two word regions, and runs the FluentSpeech region editor
(``SpecDenoiserInfer``) on the GPU:

    python -m speech_editing_tpu_torch.infer.gradio_app --config CONFIG \
        --exp_name NAME [-hp k=v,...] [--device cpu]

The upload is aligned with MFA when the binary and its models are there
(``mfa_dict``/``mfa_model``), else uniformly over the phones of the
original text.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Any, Optional, Sequence

import numpy as np


def _align_textgrid(hp: Any, wav: np.ndarray, text: str) -> Optional[str]:
    """Force-align one uploaded clip with MFA if the binary and models are
    on this host (``mfa_dict``/``mfa_model`` hparams); else None."""
    dict_path, model_path = hp.get("mfa_dict", ""), hp.get("mfa_model", "")
    if not (shutil.which("mfa") and dict_path and model_path):
        return None
    from speech_editing_tpu_torch.utils.audio.io import save_wav
    from speech_editing_tpu_torch.utils.text.processors import get_txt_processor_cls, txt_to_ph
    from speech_editing_tpu_torch.utils.text.text_encoder import is_sil_phoneme

    tmp = tempfile.mkdtemp(prefix="gradio_mfa_")
    corpus, out_dir = f"{tmp}/corpus", f"{tmp}/out"
    os.makedirs(corpus, exist_ok=True)
    save_wav(wav, f"{corpus}/item.wav", int(hp["audio_sample_rate"]))
    *_, ph_gb_word = txt_to_ph(get_txt_processor_cls(hp.get("language", "en")), text)
    words_nosil = ["_".join(p for p in w.split("_") if not is_sil_phoneme(p))
                   for w in ph_gb_word.split(" ") if not is_sil_phoneme(w)]
    with open(f"{corpus}/item.lab", "w") as f:
        f.write(" ".join(words_nosil))
    try:
        subprocess.run(["mfa", "align", "-j", "1", "--clean", corpus, dict_path, model_path,
                        out_dir], check=True, capture_output=True, timeout=600)
    except (subprocess.SubprocessError, OSError):
        return None
    tg = f"{out_dir}/item.TextGrid"
    return tg if os.path.exists(tg) else None


def build_app(hp: Any, device: Any = "cuda"):
    """The gradio ``Interface`` whose ``fn`` edits one upload; ``device``
    as ``SpecDenoiserInfer`` takes it."""
    try:
        import gradio as gr  # type: ignore
    except ImportError as e:
        raise ImportError("the gradio demo needs `pip install gradio`") from e

    from speech_editing_tpu_torch.infer.spec_denoiser import SpecDenoiserInfer
    from speech_editing_tpu_torch.utils.audio.dsp import wav2spec

    infer_ins = SpecDenoiserInfer(hp, device=device)
    sr = int(hp["audio_sample_rate"])

    def edit(audio, text, edited_text, region, edited_region):
        in_sr, wav = audio
        wav = np.asarray(wav)
        if wav.dtype.kind == "i":       # gradio's numpy audio arrives int16
            wav = wav.astype(np.float32) / 32768.0
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 2:               # stereo -> mono
            wav = wav.mean(axis=1)
        if int(in_sr) != sr:
            from scipy.signal import resample_poly

            g = np.gcd(int(in_sr), sr)
            wav = resample_poly(wav, sr // g, int(in_sr) // g).astype(np.float32)
        res = wav2spec(wav, sample_rate=sr, fft_size=hp["fft_size"], hop_size=hp["hop_size"],
                       win_length=hp["win_size"], num_mels=hp["audio_num_mel_bins"],
                       fmin=hp["fmin"], fmax=hp["fmax"])
        inp = {"item_name": "gradio", "text": text, "edited_text": edited_text,
               "region": region, "edited_region": edited_region, "mel": res["mel"],
               "wav": res["wav"]}
        tg = _align_textgrid(hp, res["wav"], text)
        if tg is not None:
            inp["mfa_textgrid"] = tg
        else:
            # no MFA on this host: a uniform alignment over the original
            # phones (the edit region's boundaries are then coarse)
            from speech_editing_tpu_torch.utils.text.processors import (get_txt_processor_cls,
                                                                        txt_to_ph)

            ph, *_ = txt_to_ph(get_txt_processor_cls(hp.get("language", "en")), text)
            s, t = len(ph.split(" ")), res["mel"].shape[0]
            inp["mel2ph"] = np.minimum(np.arange(t) * s // t + 1, s)
        wav_out, *_ = infer_ins.infer_once(inp)
        return sr, (np.clip(wav_out, -1, 1) * 32767).astype(np.int16)

    return gr.Interface(
        fn=edit,
        inputs=[gr.Audio(label="source audio"), gr.Textbox(label="original text"),
                gr.Textbox(label="edited text"), gr.Textbox(label="region e.g. [4,6]"),
                gr.Textbox(label="edited region e.g. [4,6]")],
        outputs=gr.Audio(label="edited audio"),
        title=hp.get("gradio_title", "speech_editing_tpu — text-based speech editing"),
        description=hp.get("gradio_description", ""))


def main(argv: Optional[Sequence[str]] = None) -> None:
    from speech_editing_tpu_torch.config.hparams import arg_parser, set_hparams
    from speech_editing_tpu_torch.training.trainer import cuda_or_cpu

    parser = arg_parser()
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = cuda_or_cpu(args.device, "gradio_app")
    build_app(set_hparams(args), device).launch()


if __name__ == "__main__":
    main()
