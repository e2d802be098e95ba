"""Copy synthesis: wav -> mel -> vocoder -> wav.

Exercises the mel front end and the vocoder end to end on one utterance.
With ``--vocoder_ckpt`` pointing at a HiFi-GAN work dir (the port's, a JAX
one, or a released checkpoint converted by ``utils/convert_torch_ckpt.py``)
it vocodes on the GPU (``--device cpu`` on the CPU); ``--vocoder
griffinlim``, or a directory without a checkpoint, runs Griffin-Lim on the
host.

    python -m speech_editing_tpu_torch.scripts.copy_synthesis IN.wav OUT.wav \
        [--vocoder_ckpt DIR] [--vocoder hifigan|griffinlim] [--sample_rate 22050] \
        [--device cpu]

Prints one JSON line (the JAX package's ``scripts/copy_synthesis.py``
keys): the frames, the vocoder's seconds after a warm-up call, its
real-time factor and a mel-consistency L1 (the output's mel against the
input's: low means the vocoder keeps the content).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("in_wav")
    ap.add_argument("out_wav")
    ap.add_argument("--vocoder_ckpt", default="")
    ap.add_argument("--sample_rate", type=int, default=22050)
    ap.add_argument("--vocoder", default="hifigan")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from speech_editing_tpu_torch.infer.vocoder import get_vocoder_cls
    from speech_editing_tpu_torch.training.trainer import cuda_or_cpu, float32_on_card
    from speech_editing_tpu_torch.utils.audio.dsp import wav2spec
    from speech_editing_tpu_torch.utils.audio.io import save_wav

    device = cuda_or_cpu(args.device, "copy_synthesis")
    float32_on_card()
    hp = {"vocoder_ckpt": args.vocoder_ckpt, "audio_sample_rate": args.sample_rate,
          "fft_size": 1024, "hop_size": 256, "win_size": 1024, "audio_num_mel_bins": 80,
          "fmin": 55, "fmax": 7600}

    def mel_of(wav_or_path):
        return wav2spec(wav_or_path, fft_size=hp["fft_size"], hop_size=hp["hop_size"],
                        win_length=hp["win_size"], num_mels=hp["audio_num_mel_bins"],
                        fmin=hp["fmin"], fmax=hp["fmax"], sample_rate=args.sample_rate)

    res = mel_of(args.in_wav)
    mel = res["mel"]
    vocoder = get_vocoder_cls(args.vocoder)(hp, device)
    vocoder.spec2wav(mel)           # warm-up: first-call costs out of the timing
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    wav_out = np.asarray(vocoder.spec2wav(mel), np.float32)
    dt = time.perf_counter() - t0
    save_wav(wav_out, args.out_wav, args.sample_rate)
    mel_round = mel_of(wav_out)["mel"]
    t = min(len(mel), len(mel_round))
    dur = len(res["wav"]) / args.sample_rate
    line = {"out": args.out_wav, "frames": int(len(mel)), "vocode_s": round(dt, 3),
            "rtf": round(dt / max(dur, 1e-9), 5),
            "mel_consistency_l1": round(float(np.abs(mel[:t] - mel_round[:t]).mean()), 4)}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
