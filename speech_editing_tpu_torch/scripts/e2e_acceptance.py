"""End-to-end acceptance run: train a family on a structured synthetic corpus
until its masked-region reconstruction measurably beats an untrained model,
then score the generated segments with the metric pipeline.

The corpus's mel frames are a deterministic function of the aligned phoneme
(plus noise), so a working model provably learns (the masked-region MCD
drops against the untrained baseline) rather than just executing. Each run
is the port's training entry in a process of its own, on the GPU unless
``--device cpu``:

    python -m speech_editing_tpu_torch.scripts.e2e_acceptance [--steps 600] \
        [--model spec_denoiser|campnet|a3t|editspeech|stutter_speech|...] \
        [--workdir DIR] [--seed 0] [--device cpu]

Prints one JSON line: the untrained and trained metric, ``improvement_x``,
``metric``, ``threshold``, ``model``, ``steps`` and ``pass`` (the JAX
package's ``scripts/e2e_acceptance.py``'s keys), and the ``widths``,
``seed``, ``device`` and ``wall_s`` of this run. ``--seed`` is the training
seed (JAX's tool fixes it at 0); the corpus is always JAX's, of seed 0. On the GPU the families whose model
runs DiffNet (DIFFNET_FAMILIES) run at the smallest widths the DiffNet
block kernel is compiled for (``ops/cuda/diffnet_block.py::WIDTHS``: hidden
192, residual 128); the others keep the acceptance's own widths.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Optional, Sequence

import numpy as np

# the tools' copy of the tiny CPU configuration the JAX package's tests use
TINY_HP = {
    "hidden_size": 32, "audio_num_mel_bins": 80, "audio_sample_rate": 22050,
    "hop_size": 256, "fft_size": 1024, "win_size": 1024, "fmin": 55, "fmax": 7600,
    "encoder_type": "conv", "decoder_type": "conv", "enc_layers": 2, "dec_layers": 2,
    "enc_ffn_kernel_size": 5, "dec_ffn_kernel_size": 9, "enc_dilations": [1, 1],
    "dec_dilations": [1, 1], "enc_kernel_size": 5, "dec_kernel_size": 5,
    "enc_post_net_kernel": 3, "dec_post_net_kernel": 3, "layers_in_block": 2,
    "enc_dec_norm": "ln", "num_heads": 2, "dropout": 0.0,
    "predictor_hidden": -1, "dur_predictor_layers": 2, "dur_predictor_kernel": 3,
    "predictor_kernel": 5, "predictor_dropout": 0.0, "predictor_grad": 0.1,
    "use_pitch_embed": True, "use_spk_embed": True, "use_spk_id": False, "use_uv": True,
    "pitch_type": "frame", "frames_multiple": 1,
    "timesteps": 4, "timescale": 1, "schedule_type": "vpsde", "residual_layers": 2,
    "residual_channels": 16, "dilation_cycle_length": 1, "diff_loss_type": "l1",
    "keep_bins": 80,
    "mel_losses": "l1:0.5|ssim:0.5", "lambda_ph_dur": 0.1, "lambda_word_dur": 1.0,
    "lambda_sent_dur": 0.0, "lambda_f0": 1.0, "lambda_uv": 1.0, "dur_level": "word",
    "lr": 2e-4, "optimizer_adam_beta1": 0.9, "optimizer_adam_beta2": 0.98,
    "weight_decay": 0, "warmup_updates": 10, "scheduler": "warmup", "clip_grad_norm": 1.0,
    "accumulate_grad_batches": 1, "max_frames": 96, "max_input_tokens": 20,
    "lstm_hidden": 64,
}

# the acceptance model's widths and schedule, over TINY_HP
ACCEPTANCE_HP = {
    "max_tokens": 4000, "max_sentences": 8, "num_sanity_val_steps": 1, "num_ckpt_keep": 1,
    "tb_log_interval": 100, "seed": 0, "vocoder": "griffinlim", "training_mask_ratio": 0.6,
    "infer_mask_ratio": 0.5, "mask_type": "random", "hidden_size": 64,
    "residual_layers": 4, "residual_channels": 32, "timesteps": 8, "lr": 4e-4,
    "warmup_updates": 100,
    # the port's loader and result writers in process (the runs are small)
    "ds_workers": 0, "test_save_workers": 1, "num_valid_plots": 0,
}


def _stutter_mask(rs, t_len: int, i: int):
    """One or two block-aligned stutter spans per item (16-frame label
    blocks), so that the validation stream always holds stutter blocks and
    no held-out block is half stutter."""
    m = np.zeros(t_len, np.int64)
    bs = 16
    n_blocks = t_len // bs
    if n_blocks >= 2:
        n_spans = 2 if n_blocks >= 5 else 1
        for _ in range(n_spans):
            blk = int(rs.randint(0, n_blocks))
            m[blk * bs: (blk + 1) * bs] = 1
    return m


# stuttered frames carry a detectable spectral signature (otherwise the
# stutter label would be independent of every model input)
_STUTTER_SIG = np.zeros(80, np.float32)
_STUTTER_SIG[16:48] = 1.2


def write_structured_corpus(data_dir: str, n_items: int = 24, vocab: int = 12,
                            seed: int = 0) -> None:
    """Binarized corpus where mel[t] = signature(phoneme at t) + noise."""
    from speech_editing_tpu_torch.data.indexed_dataset import IndexedDatasetBuilder

    rs = np.random.RandomState(seed)
    base = rs.randn(vocab, 80) * 0.8      # a smooth 80-bin signature per token
    for v in range(vocab):
        base[v] = np.convolve(base[v], np.ones(9) / 9, mode="same") - 1.5
    os.makedirs(data_dir, exist_ok=True)
    for prefix, n in (("train", n_items), ("valid", 4), ("test", 6)):
        builder = IndexedDatasetBuilder(f"{data_dir}/{prefix}")
        lengths = []
        for i in range(n):
            s = int(rs.randint(6, 11))
            ph_token = rs.randint(3, vocab, s).astype(np.int64)
            durs = rs.randint(4, 12, s)
            mel2ph = np.repeat(np.arange(1, s + 1), durs).astype(np.int64)
            t_len = len(mel2ph)
            stutter = _stutter_mask(rs, t_len, i)
            mel = (base[ph_token[mel2ph - 1]] + 0.05 * rs.randn(t_len, 80)
                   + stutter[:, None] * _STUTTER_SIG)
            f0 = 150.0 + 8.0 * ph_token[mel2ph - 1] + rs.randn(t_len)
            ph2word = (np.arange(s) // 2 + 1).astype(np.int64)
            builder.add_item({
                "item_name": f"item_{prefix}_{i}", "txt": "synthetic",
                "ph_token": ph_token, "mel": mel.astype(np.float32),
                "mel2ph": mel2ph, "ph2word": ph2word,
                "word_token": rs.randint(3, vocab, int(ph2word.max())).astype(np.int64),
                "mel2word": np.where(mel2ph > 0, (mel2ph - 1) // 2 + 1, 0).astype(np.int64),
                "f0": f0.astype(np.float32),
                "pitch": np.clip(f0, 1, 255).astype(np.int64),
                "spk_embed": np.zeros(256, np.float32), "spk_id": 0,
                "wav_fn": "",
                "stutter_mel_mask": stutter,
            })
            lengths.append(t_len)
        builder.finalize()
        np.save(f"{data_dir}/{prefix}_lengths.npy", np.asarray(lengths))


def seg_mcd(gen_dir: str) -> float:
    """Mean MCD over the [G_SEG]/[P_SEG] wav pairs of a test run."""
    from speech_editing_tpu_torch.evals.mcd import cal_mcd_with_wave_batch

    return cal_mcd_with_wave_batch(os.path.join(gen_dir, "wavs", "*"), use_dtw=True)


def full_mcd(gen_dir: str) -> float:
    """Mean MCD over the whole-utterance [G]/[P] pairs (the TTS baselines
    generate the whole mel; there is no edit region)."""
    from speech_editing_tpu_torch.evals.mcd import cal_mcd

    pairs = [(item, item.replace("[G]", "[P]"))
             for item in sorted(glob.glob(os.path.join(gen_dir, "wavs", "*.wav")))
             if os.path.basename(item).startswith("[G]")]
    assert pairs, f"no [G] wavs under {gen_dir}"
    return float(np.mean([cal_mcd(p, use_dtw=True) for p in pairs]))


def diffspeech_denoise_mae(hp: dict, ckpt_dir: str, device: Any = "cpu") -> float:
    """Mel-domain MAE of DiffSpeech's x0 estimates against the ground truth
    at a fixed mid-schedule step t = T/2 for every row, with the same noise
    draws for the trained and the untrained checkpoint: the quantity the
    eps objective directly optimises (full-chain synthesis does not form
    recognisable mel at this size)."""
    import torch

    from speech_editing_tpu_torch.ops.diffusion import q_sample
    from speech_editing_tpu_torch.run import task_class
    from speech_editing_tpu_torch.training.checkpoint import (get_last_checkpoint,
                                                              load_checkpoint)

    task = task_class(hp["task_cls"])(hp)
    model = task.build_model()
    model.load_state_dict(load_checkpoint(get_last_checkpoint(ckpt_dir)[0])["state"]["model"])
    model.to(device).eval()
    ds = task.dataset_cls("test", hp, shuffle=False)
    batch = ds.collater([ds[i] for i in range(min(6, len(ds)))])
    bt = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()
          if k in task.effective_batch_keys()}
    with torch.inference_mode():
        cond = model.compute_cond(bt["txt_tokens"], bt["mel2ph"], bt.get("spk_embed"),
                                  bt["f0"], bt["uv"])["decoder_inp"]
        x0n = model.norm_spec(bt["mels"])
        t_mid = int(hp["timesteps"]) // 2
        t = torch.full((x0n.shape[0],), t_mid, dtype=torch.long, device=device)
        noise = torch.randn(x0n.shape, generator=torch.Generator().manual_seed(7)).to(device)
        sched = model.schedule(device)
        x_t = q_sample(sched, x0n, t, noise)
        eps = model.denoise(x_t, t, cond)
        x0_est = ((x_t - sched.sqrt_one_minus_alphas_cumprod[t_mid] * eps)
                  / sched.sqrt_alphas_cumprod[t_mid]).clamp(-1, 1)
        mel_pred = model.denorm_spec(x0_est).cpu().numpy()
    mel_gt = np.asarray(batch["mels"])
    mask = (np.asarray(batch["mel2ph"]) > 0)[:, :, None]
    return float(np.abs((mel_pred - mel_gt) * mask).sum() / (mask.sum() * mel_gt.shape[-1]))


def run_cli(cfg: str, exp: str, *extra: str) -> str:
    """The port's training entry on ``cfg`` in a process of its own; its
    standard output (the tail echoed). A phase is cut at
    ``E2E_PHASE_TIMEOUT`` seconds (default 1500)."""
    cmd = [sys.executable, "-m", "speech_editing_tpu_torch.run", "--config", cfg,
           "--exp_name", exp, *extra]
    try:
        p = subprocess.run(cmd, check=False, capture_output=True, text=True,
                           timeout=int(os.environ.get("E2E_PHASE_TIMEOUT", 1500)))
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"run {extra} for {exp} timed out (E2E_PHASE_TIMEOUT)") from e
    sys.stdout.write(p.stdout[-4000:])
    if p.returncode != 0:
        sys.stderr.write((p.stderr or "")[-8000:])
        raise RuntimeError(f"run {extra} for {exp} failed (rc={p.returncode})")
    return p.stdout


_TASKS = "speech_editing_tpu_torch.training.tasks."
TASKS = {
    "spec_denoiser": _TASKS + "spec_denoiser.SpecDenoiserTask",
    "campnet": _TASKS + "campnet.CampNetTask",
    "a3t": _TASKS + "a3t.A3TTask",
    "editspeech": _TASKS + "editspeech.EditSpeechTask",
    "stutter_speech": _TASKS + "stutter_speech.StutterSpeechTask",
    "fs": _TASKS + "tts.FastSpeechTask",
    "fs2_orig": _TASKS + "tts.FastSpeech2OrigTask",
    "diffspeech": _TASKS + "tts.DiffSpeechTask",
    "ps": _TASKS + "portaspeech.PortaSpeechTask",
    "ps_flow": _TASKS + "portaspeech.PortaSpeechFlowTask",
    "ps_adv": _TASKS + "ps_adv.PortaSpeechAdvTask",
    "stutter_predictor": _TASKS + "stutter_speech.StutterPredictorTask",
}

# whole-utterance TTS baselines: score full [P]/[G] wavs (no edit region)
TTS_FAMILIES = {"fs", "fs2_orig", "diffspeech", "ps", "ps_flow", "ps_adv"}

PS_EXTRA = {  # the PortaSpeech stack at the acceptance's size
    "use_word_encoder": True, "word_enc_layers": 1, "dur_level": "word",
    "word_encoder_type": "fft", "text_encoder_postnet": True,
    "add_word_pos": True, "use_fvae": True, "fvae_enc_dec_hidden": 32,
    "latent_size": 8, "fvae_kernel_size": 5, "fvae_enc_n_layers": 2,
    "fvae_dec_n_layers": 2, "fvae_strides": 4, "use_prior_flow": True,
    "prior_flow_hidden": 16, "prior_flow_kernel_size": 3,
    "prior_flow_n_blocks": 2, "lambda_kl": 1.0, "kl_min": 0.0,
    "kl_start_steps": 100, "noise_scale": 0.8, "post_glow_hidden": 16,
    "post_glow_n_blocks": 2, "sigmoid_scale": False, "word_dict_size": 30,
    "frames_multiple": 4, "frame_size_multiple": 4, "encoder_type": "fft",
    "use_spk_embed": True, "use_pitch_embed": False,
}

FAMILY_EXTRA = {
    "fs2_orig": {"pitch_type": "cwt", "predictor_layers": 2, "cwt_std_scale": 0.8},
    # eps-prediction needs residual_channels >= the 80 mel bins, and lr 1e-3
    # roughly doubles the loss slope at this size; pass --steps >= 4000
    "diffspeech": {"schedule_type": "cosine", "timesteps": 16, "max_beta": 0.06, "lr": 1e-3,
                   "residual_channels": 96},
    "ps": PS_EXTRA,
    "ps_flow": PS_EXTRA,
    "ps_adv": dict(PS_EXTRA, lambda_mel_adv=0.05, disc_win_num=1, mel_disc_hidden_size=32,
                   disc_start_steps=0),
    "stutter_predictor": {"frames_multiple": 16, "frame_size_multiple": 16,
                          "stutter_block_size": 16, "stutter_pad_idx": -1},
}


# the families whose model runs DiffNet, and so the DiffNet block kernel
DIFFNET_FAMILIES = {"spec_denoiser", "stutter_speech", "diffspeech"}


def card_widths(hp: dict) -> dict:
    """``hidden_size`` and ``residual_channels`` raised to the smallest
    widths the DiffNet block kernel is compiled for (at least the asked
    ones), so that the GPU runs it."""
    from speech_editing_tpu_torch.ops.cuda.diffnet_block import WIDTHS, diffnet_block_takes
    from speech_editing_tpu_torch.ops.flash_attention import flash_mha_takes

    import torch

    for c, h in sorted(WIDTHS):
        if c >= hp["residual_channels"] and h >= hp["hidden_size"]:
            assert diffnet_block_takes(c, h, 1, torch.float32)
            assert flash_mha_takes(h // hp["num_heads"], torch.float32)
            return {"hidden_size": h, "residual_channels": c}
    raise ValueError(f"no compiled DiffNet width holds {hp['residual_channels']} x "
                     f"{hp['hidden_size']} (WIDTHS {WIDTHS})")


def acceptance_hp(model: str, data_dir: str, steps: int, device: str) -> dict:
    hp = dict(TINY_HP, **ACCEPTANCE_HP, task_cls=TASKS[model], binary_data_dir=data_dir,
              max_updates=steps, val_check_interval=steps)
    hp.update(FAMILY_EXTRA.get(model, {}))
    if device != "cpu" and model in DIFFNET_FAMILIES:
        hp.update(card_widths(hp))
    return hp


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--model", default="spec_denoiser", choices=sorted(TASKS))
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "e2e_acceptance"))
    ap.add_argument("--n-items", dest="n_items", type=int, default=24,
                    help="corpus size (a bigger corpus for the diffspeech full-chain probe)")
    ap.add_argument("--diffspeech-full", dest="diffspeech_full", action="store_true",
                    help="score diffspeech with full-chain synthesis MCD ([G]/[P] wavs) "
                         "instead of the denoise-MAE proxy")
    ap.add_argument("--seed", type=int, default=0,
                    help="the training seed (initialisation, batches, masks, draws)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from speech_editing_tpu_torch.config.hparams import dump_yaml
    from speech_editing_tpu_torch.training.trainer import cuda_or_cpu

    device = cuda_or_cpu(args.device, "e2e_acceptance")
    t_start = time.perf_counter()
    wd = os.path.abspath(args.workdir)
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd, exist_ok=True)
    data_dir = os.path.join(wd, "binary")
    write_structured_corpus(data_dir, n_items=args.n_items)
    hp = acceptance_hp(args.model, data_dir, args.steps, device.type)
    hp["seed"] = args.seed
    cfg = os.path.join(wd, "cfg.yaml")

    is_predictor = args.model == "stutter_predictor"
    metric_name = ("val_focal" if is_predictor
                   else "denoise_mae" if (args.model == "diffspeech" and not args.diffspeech_full)
                   else "mcd_full" if args.model in TTS_FAMILIES else "mcd")
    # editing regenerates a masked span of a known utterance (large gains
    # expected); TTS synthesises the whole mel from text (smaller but
    # reliable gains); the predictor is scored on its focal loss
    threshold = 0.7 if metric_name == "mcd" else 0.9 if \
        metric_name in ("mcd_full", "denoise_mae") else 0.8

    results = {}
    for tag, steps in (("untrained", 1), ("trained", args.steps)):
        hp["max_updates"] = steps
        hp["val_check_interval"] = steps
        with open(cfg, "w") as f:
            f.write(dump_yaml(hp))
        ckpt_dir = os.path.join(wd, "checkpoints", f"e2e_{args.model}_{tag}")
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        dev = ["--device", device.type]
        out_train = run_cli(cfg, ckpt_dir, "--reset", *dev)
        if is_predictor:
            val_lines = [ln for ln in out_train.splitlines() if ln.startswith("| validation")]
            m = re.search(r"focal=([0-9.eE+-]+)", val_lines[-1])
            results[f"{metric_name}_{tag}"] = round(float(m.group(1)), 5)
        elif metric_name == "denoise_mae":
            score = diffspeech_denoise_mae(hp, ckpt_dir, device)
            results[f"{metric_name}_{tag}"] = round(score, 4)
        else:
            run_cli(cfg, ckpt_dir, "--infer", *dev)
            gens = sorted(glob.glob(os.path.join(ckpt_dir, "generated_*")))
            if not gens:
                raise RuntimeError(f"the infer run for {ckpt_dir} produced no generated_* dir")
            score = full_mcd(gens[-1]) if args.model in TTS_FAMILIES else seg_mcd(gens[-1])
            results[f"{metric_name}_{tag}"] = round(score, 4)
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    untrained = results[f"{metric_name}_untrained"]
    trained = results[f"{metric_name}_trained"]
    ok = trained < untrained * threshold
    line = {**results, "improvement_x": round(untrained / max(trained, 1e-9), 2),
            "metric": metric_name, "threshold": threshold, "model": args.model,
            "steps": args.steps, "pass": bool(ok),
            "widths": {k: hp[k] for k in ("hidden_size", "residual_channels", "residual_layers",
                                          "num_heads")},
            "seed": args.seed, "device": str(device), "wall_s": round(time.perf_counter() - t_start, 1)}
    print(json.dumps(line), flush=True)
    if not ok:
        sys.exit(1)
    return line


if __name__ == "__main__":
    main()
