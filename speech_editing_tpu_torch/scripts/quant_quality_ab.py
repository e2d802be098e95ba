"""Quantized-serving quality A/B: the acceptance metrics with float32 against
int8 weights.

Trains the acceptance FluentSpeech model on the structured synthetic corpus
(``e2e_acceptance.py``'s recipe: mel frames a deterministic function of the
aligned phoneme), then regenerates each test item's masked middle span
twice with the same per-item diffusion noise, once with float32 weights and
once with weight-only int8 (``infer/quant.py``), and scores both against
the ground truth: the masked-region mel MCD (``evals.mcd.get_metrics_mels``
over the span) and the STOI of Griffin-Lim wavs (the ground-truth mel
against the composited mel, one vocoder for both). The result is the
difference between the two columns: the quality cost of int8 weight-only
serving at trained weights.

    python -m speech_editing_tpu_torch.scripts.quant_quality_ab [--steps 4000] \
        [--reuse-workdir] [--workdir DIR] [--device cpu]

Prints one JSON line with the JAX package's ``scripts/quant_quality_ab.py``
keys and the ``widths``, ``device`` and ``wall_s`` of this run.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

from speech_editing_tpu_torch.scripts import e2e_acceptance as e2e


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "quant_quality_ab"))
    ap.add_argument("--reuse-workdir", action="store_true",
                    help="skip training if a checkpoint already exists")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from speech_editing_tpu_torch.config.hparams import dump_yaml, read_yaml
    from speech_editing_tpu_torch.data.indexed_dataset import IndexedDataset
    from speech_editing_tpu_torch.evals.mcd import get_metrics_mels
    from speech_editing_tpu_torch.evals.stoi import stoi
    from speech_editing_tpu_torch.infer.quant import QuantizedWeights
    from speech_editing_tpu_torch.training.checkpoint import get_last_checkpoint, load_checkpoint
    from speech_editing_tpu_torch.training.tasks.spec_denoiser import build_model
    from speech_editing_tpu_torch.training.trainer import cuda_or_cpu, float32_on_card
    from speech_editing_tpu_torch.utils.audio.griffin_lim import mel2wav_griffin_lim

    device = cuda_or_cpu(args.device, "quant_quality_ab")
    t_start = time.perf_counter()
    wd = os.path.abspath(args.workdir)
    ckpt_dir = os.path.join(wd, "checkpoints", "quant_ab_spec_denoiser")
    cfg = os.path.join(wd, "cfg.yaml")
    if not (args.reuse_workdir and glob.glob(os.path.join(ckpt_dir, "model_ckpt_steps_*.ckpt"))):
        shutil.rmtree(wd, ignore_errors=True)
        os.makedirs(wd, exist_ok=True)
        data_dir = os.path.join(wd, "binary")
        e2e.write_structured_corpus(data_dir)
        hp = e2e.acceptance_hp("spec_denoiser", data_dir, args.steps, device.type)
        with open(cfg, "w") as f:
            f.write(dump_yaml(hp))
        e2e.run_cli(cfg, ckpt_dir, "--reset", "--device", device.type)
    else:
        hp = read_yaml(cfg)

    float32_on_card()
    # the structured corpus has no phone_set.json: the task's vocabulary is
    # hp['vocab_size'] (default 100), which the checkpoint was built with
    vocab = int(hp.get("vocab_size", 100))
    ckpt_path, steps = get_last_checkpoint(ckpt_dir)
    sd = load_checkpoint(ckpt_path)["state"]["model"]
    model = build_model(vocab, hp)
    model.load_state_dict(sd)
    model.to(device).eval()
    qmodel = build_model(vocab, hp)
    qmodel.load_state_dict(sd)
    qmodel.to(device).eval()
    q = QuantizedWeights(qmodel, 1024, device)

    def infer(m, args_dev, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.inference_mode():
            return m(*args_dev, generator=gen)["mel_out"][0].float().cpu().numpy()

    ds = IndexedDataset(os.path.join(hp["binary_data_dir"], "test"))
    sr = int(hp["audio_sample_rate"])
    rows = {"fp32": {"mcd": [], "stoi": []}, "int8": {"mcd": [], "stoi": []}}
    for i in range(len(ds)):
        it = ds[i]
        mel = np.asarray(it["mel"], np.float32)
        t = len(mel)
        m0, m1 = t // 4, t // 4 + t // 2
        tm = np.zeros((t, 1), np.float32)
        tm[m0:m1] = 1.0
        ref = mel * (1 - tm)
        f0 = np.asarray(it["f0"], np.float32)
        args_dev = [torch.as_tensor(a)[None].to(device) for a in
                    (np.asarray(it["ph_token"]), tm, np.asarray(it["mel2ph"]))]
        args_dev += [None] + [torch.as_tensor(a)[None].to(device) for a in
                              (ref, f0, (f0 == 0).astype(np.float32))]
        wav_gt = mel2wav_griffin_lim(mel, sample_rate=sr, n_fft=hp["fft_size"],
                                     hop_size=hp["hop_size"])
        for name in ("fp32", "int8"):
            if name == "fp32":
                out = infer(model, args_dev, 7000 + i)
            else:
                with q.dequantized() as qm:
                    out = infer(qm, args_dev, 7000 + i)
            comp = out * tm + ref * (1 - tm)
            mcd, _, _ = get_metrics_mels(mel[m0:m1], comp[m0:m1])
            rows[name]["mcd"].append(mcd)
            wav_p = mel2wav_griffin_lim(comp, sample_rate=sr, n_fft=hp["fft_size"],
                                        hop_size=hp["hop_size"])
            n = min(len(wav_gt), len(wav_p))
            rows[name]["stoi"].append(stoi(wav_gt[:n], wav_p[:n], sr))
        print(f"| item {i}: mcd fp32 {rows['fp32']['mcd'][-1]:.3f} "
              f"int8 {rows['int8']['mcd'][-1]:.3f}", flush=True)

    mcd_fp, mcd_q = (float(np.mean(rows[k]["mcd"])) for k in ("fp32", "int8"))
    stoi_fp, stoi_q = (float(np.mean(rows[k]["stoi"])) for k in ("fp32", "int8"))
    line = {
        "metric": "quant_int8_mcd_delta_db",
        "value": round(mcd_q - mcd_fp, 4),
        "unit": (f"masked-region mel-MCD delta int8-fp32 (trained {steps}-step acceptance "
                 f"model, {len(ds)} test items, identical diffusion noise)"),
        "mcd_fp32": round(mcd_fp, 4), "mcd_int8": round(mcd_q, 4),
        "stoi_fp32": round(stoi_fp, 4), "stoi_int8": round(stoi_q, 4),
        "stoi_delta": round(stoi_q - stoi_fp, 4),
        "max_weight_quant_err": round(float(q.max_err), 6),
        "widths": {k: hp[k] for k in ("hidden_size", "residual_channels", "residual_layers")},
        "device": str(device), "wall_s": round(time.perf_counter() - t_start, 1),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
