#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``speech_editing_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA GPU

Phases, each of which exits non-zero on a failed check:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` builds every kernel from ``speech_editing_tpu_torch/csrc``
   for ``sm_90a``, one compiler per source, in parallel;
3. kernels: each CUDA kernel against its plain PyTorch version at the
   shapes of the edit path, with the error against the stated tolerance,
   the kernel's, the plain version's and (for attention) SDPA's time;
4. main path: ``EditPipeline`` at the flagship width (seeded random
   weights) answers edit requests of 512 (``bench.py``'s utterance), 300
   and 700 frames; every launch counter must move by exactly its expected
   amount per request; outputs are finite, frames outside the edit equal
   the source mel, and one request re-run on the CPU (plain versions, same
   weights and noise) agrees; the edit's real-time factor is timed.

Float32 throughout, with TF32 off for matrix products and cuDNN
convolutions, so the card and the CPU compute the same function. The
second-to-last line is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from speech_editing_tpu_torch.config.flagship import FLAGSHIP_HP, HIFIGAN_V1_HP
from speech_editing_tpu_torch.infer.edit import EditPipeline
from speech_editing_tpu_torch.ops.cuda import build
from speech_editing_tpu_torch.ops.cuda.diffnet_block import (diffnet_block,
                                                             diffnet_block_plain)
from speech_editing_tpu_torch.ops.cuda.mel_kernel import mel_spectrogram
from speech_editing_tpu_torch.ops.flash_attention import attention_plain, flash_mha
from speech_editing_tpu_torch.ops.mel import MelConfig
from speech_editing_tpu_torch.ops.mel import mel_spectrogram as mel_plain

PEAK_FP32_FLOPS = 67e12     # H100 SXM, float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12    # H100 SXM, bytes/s
SR, HOP = 22050, 256
REQUEST_FRAMES = (512, 300, 700)
EXPECTED_PER_REQUEST = {"diffnet_block": FLAGSHIP_HP["residual_layers"] * FLAGSHIP_HP["timesteps"],
                        "mel_spectrogram": 1,
                        "flash_mha": FLAGSHIP_HP["enc_layers"]}
CPU_MEL_TOL = 2e-2


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, n_bytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, n_bytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# -- kernel phases ---------------------------------------------------------------

def phase_diffnet_block(gen) -> dict:
    c, h, t = FLAGSHIP_HP["residual_channels"], FLAGSHIP_HP["hidden_size"], 512
    tol, out = 1e-4, {}
    for b in (1, 4):
        r = lambda *s, scale=1.0: torch.randn(*s, device="cuda", generator=gen) * scale
        x, cond, step = r(b, t, c), r(b, t, h, scale=0.5), r(b, c, scale=0.3)
        mask = torch.ones(b, t, device="cuda")
        mask[-1, t - 37:] = 0.0      # a padded tail
        w = (r(3 * c, 2 * c, scale=0.05), r(2 * c, scale=0.1), r(h, 2 * c, scale=0.05),
             r(2 * c, scale=0.1), r(c, 2 * c, scale=0.05), r(2 * c, scale=0.1))
        got = diffnet_block(x, cond, step, mask, *w)
        ref = diffnet_block_plain(x, cond, step, mask, *w)
        torch.cuda.synchronize()
        err = max(float((g - e).abs().max()) for g, e in zip(got, ref))
        ms = time_ms(lambda: diffnet_block(x, cond, step, mask, *w))
        plain_ms = time_ms(lambda: diffnet_block_plain(x, cond, step, mask, *w))
        flops = 2 * b * t * 2 * c * (3 * c + h + c)
        bound_ms, bound_by = bound(flops, nbytes(x, cond, step, mask, *w) + 2 * nbytes(x))
        print(f"[kernel] diffnet_block B={b} T={t} C={c} H={h}: max_abs_err={err:.3e} "
              f"(tol {tol}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        check(err <= tol, f"diffnet_block B={b}: error {err} > {tol}")
        out.setdefault("max_abs_err", 0.0)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if b == 1:   # the edit path's shape
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    return dict(out, name="diffnet_block", route="cuda",
                source="speech_editing_tpu_torch/csrc/diffnet_block.cu",
                replaces="speech_editing_tpu/ops/pallas/diffnet_block.py:139",
                tol=tol, library_ms=None)


def phase_mel() -> dict:
    cfg, n = MelConfig(), 512 * HOP          # bench.py's 131072-sample utterance
    tol, mean_tol = 2e-2, 2e-3               # log10 units, the Pallas kernel's test bars
    wav = torch.tensor(utterance(n, seed=0), device="cuda")[None]
    got, ref = mel_spectrogram(wav, cfg), mel_plain(wav, cfg)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    mean_err = float((got - ref).abs().mean())
    ms = time_ms(lambda: mel_spectrogram(wav, cfg))
    plain_ms = time_ms(lambda: mel_plain(wav, cfg))
    n_frames, n_bins = got.shape[1], cfg.fft_size // 2 + 1
    flops = n_frames * (2 * 2 * cfg.fft_size * n_bins + 2 * n_bins * cfg.num_mels)
    basis_bytes = 4 * (2 * cfg.fft_size * n_bins + n_bins * cfg.num_mels)
    bound_ms, bound_by = bound(flops, nbytes(wav, got) + basis_bytes)
    print(f"[kernel] mel_spectrogram N={n}: max_abs_err={err:.3e} (tol {tol}), "
          f"mean_abs_err={mean_err:.3e} (tol {mean_tol}) kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    check(err <= tol, f"mel_spectrogram: error {err} > {tol}")
    check(mean_err <= mean_tol, f"mel_spectrogram: mean error {mean_err} > {mean_tol}")
    return dict(name="mel_spectrogram", route="cuda",
                source="speech_editing_tpu_torch/csrc/mel_kernel.cu",
                replaces="speech_editing_tpu/ops/pallas/mel_kernel.py:53",
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def phase_attention(gen) -> dict:
    h = FLAGSHIP_HP["num_heads"]
    d = FLAGSHIP_HP["hidden_size"] // h
    tol, out = 1e-4, {}
    for b, s in ((1, 48), (3, 130)):
        q = torch.randn(b, s, h, d, device="cuda", generator=gen) * d ** -0.5
        k = torch.randn(b, s, h, d, device="cuda", generator=gen)
        v = torch.randn(b, s, h, d, device="cuda", generator=gen)
        lengths = [s] + [s - 1 - 29 * i for i in range(1, b)]
        pad = torch.arange(s, device="cuda")[None, :] >= torch.tensor(lengths, device="cuda")[:, None]
        got, ref = flash_mha(q, k, v, pad), attention_plain(q, k, v, pad)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())     # every row has a valid key
        ms = time_ms(lambda: flash_mha(q, k, v, pad))
        plain_ms = time_ms(lambda: attention_plain(q, k, v, pad))
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        allowed = (~pad)[:, None, None, :]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=allowed, scale=1.0))
        flops = 4 * h * s * d * sum(lengths)    # q k^T and p v over valid keys
        bound_ms, bound_by = bound(flops, nbytes(q, k, v, pad, got))
        print(f"[kernel] flash_mha B={b} S={s} h={h} d={d} valid keys {lengths}: "
              f"max_abs_err={err:.3e} (tol {tol}) kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.6f} ms "
              f"({bound_by})", flush=True)
        check(err <= tol, f"flash_mha S={s}: error {err} > {tol}")
        out["max_abs_err"] = max(out.get("max_abs_err", 0.0), err)
        if s == 48:  # the edit path's shape
            out.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
    return dict(out, name="flash_mha", route="cuda",
                source="speech_editing_tpu_torch/csrc/flash_attention.cu",
                replaces="speech_editing_tpu/ops/flash_attention.py:85", tol=tol)


# -- main path -------------------------------------------------------------------

COUNTERS = {"diffnet_block": diffnet_block, "mel_spectrogram": mel_spectrogram,
            "flash_mha": flash_mha}


def reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def utterance(n: int, seed: int) -> np.ndarray:
    """bench.py's source wav, a 180 Hz tone with a 3 Hz tremolo, over a
    0.02 rms noise floor. A recording has one; without it the mel bins far
    from the tone sit at the eps floor, where two float32 summation orders
    differ by up to 4e-2 in log10 and the comparison measures rounding."""
    t_ax = np.arange(n) / SR
    tone = 0.3 * np.sin(2 * np.pi * 180 * t_ax) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t_ax))
    return (tone + 0.02 * np.random.RandomState(seed).randn(n)).astype(np.float32)


def edit_request(t: int, seed: int, device: str):
    """bench.py's edit at ``t`` frames: its utterance, 48 tokens, the middle
    third regenerated."""
    rs = np.random.RandomState(seed)
    wav = utterance(t * HOP, seed)
    s = 48
    txt = rs.randint(1, 80, (1, s))
    mel2ph = np.clip(np.sort(rs.randint(1, s + 1, (1, t))), 1, s)
    mask = np.zeros((1, t, 1), np.float32)
    mask[:, t // 3: 2 * t // 3] = 1.0
    return tuple(torch.tensor(a, device=device) for a in (wav[None], txt, mel2ph, mask))


def main_path(gen) -> tuple[dict, dict]:
    pipe = EditPipeline(FLAGSHIP_HP, HIFIGAN_V1_HP, device="cuda", vocab_size=80, seed=0)
    big_t = FLAGSHIP_HP["timesteps"]
    requests = {t: edit_request(t, seed=i, device="cuda")
                for i, t in enumerate(REQUEST_FRAMES)}
    noise_512 = [torch.randn(1, 512, 80, device="cuda", generator=gen)
                 for _ in range(big_t + 1)]
    results, per_request = {}, {}
    reset_counts()
    for t, req in requests.items():
        before = counts()
        if t == 512:   # explicit noise, re-used by the CPU run below
            results[t] = pipe(*req, noise=noise_512)
        else:
            results[t] = pipe(*req, generator=gen)
        torch.cuda.synchronize()
        per_request[t] = {k: counts()[k] - before[k] for k in COUNTERS}
    totals = counts()
    print(f"[main] launches per request {per_request}; totals {totals}", flush=True)
    for t, moved in per_request.items():
        check(moved == EXPECTED_PER_REQUEST,
              f"request {t}: launches {moved} != expected {EXPECTED_PER_REQUEST}")

    cfg = pipe.mel_cfg
    for t, (wav_out, mel_out) in results.items():
        wav, _, _, mask = requests[t]
        check(tuple(wav_out.shape) == (1, t * HOP), f"wav shape {tuple(wav_out.shape)}")
        check(tuple(mel_out.shape) == (1, t, 80), f"mel shape {tuple(mel_out.shape)}")
        check(bool(torch.isfinite(wav_out).all() and torch.isfinite(mel_out).all()),
              f"request {t}: non-finite output")
        keep = mask[0, :, 0] == 0
        source = mel_spectrogram(wav, cfg)[:, :t]
        check(torch.equal(mel_out[0, keep], source[0, keep]),
              f"request {t}: frames outside the edit differ from the source mel")
        edited = (mel_out[0, ~keep] - source[0, ~keep]).abs().mean()
        print(f"[main] request T={t}: finite, outside-edit frames exact, "
              f"mean |edit - source| {float(edited):.4f}", flush=True)

    # the 512-frame request again on the CPU: plain versions, same weights and noise
    cpu = EditPipeline(FLAGSHIP_HP, HIFIGAN_V1_HP, device="cpu", vocab_size=80, seed=1)
    cpu.model.load_state_dict({k: v.cpu() for k, v in pipe.model.state_dict().items()})
    cpu.vocoder.load_state_dict({k: v.cpu() for k, v in pipe.vocoder.state_dict().items()})
    t0 = time.perf_counter()
    wav_cpu, mel_cpu = cpu(*(a.cpu() for a in requests[512]),
                           noise=[n.cpu() for n in noise_512])
    cpu_s = time.perf_counter() - t0
    mel_err = float((results[512][1].cpu() - mel_cpu).abs().max())
    wav_err = float((results[512][0].cpu() - wav_cpu).abs().max())
    print(f"[main] CPU re-run of T=512 ({cpu_s:.1f} s): mel_out max_abs_err "
          f"{mel_err:.3e} (tol {CPU_MEL_TOL}), wav max_abs_err {wav_err:.3e}", flush=True)
    check(mel_err <= CPU_MEL_TOL, f"GPU vs CPU mel_out error {mel_err} > {CPU_MEL_TOL}")

    # real-time factor of the 512-frame edit (bench.py's utterance)
    rtf = time_edits(pipe, requests[512], gen)
    profile_edit(pipe, requests[512], gen, rtf["host_ms_p50"])
    return totals, rtf


def time_edits(pipe, req, gen, n: int = 40, warmup: int = 3) -> dict:
    """One edit at a time, ``n`` times: CUDA events around each edit (the
    device timeline from its first launch to its last kernel's end) and the
    host clock to the synchronise after it. Median and p75 (ten samples
    above it at n=40)."""
    audio_s = req[0].shape[1] / SR
    for _ in range(warmup):
        pipe(*req, generator=gen)
    torch.cuda.synchronize()
    ev_ms, host_ms = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        pipe(*req, generator=gen)
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ev_ms.append(start.elapsed_time(end))
    q = lambda xs, p: float(np.percentile(xs, p))
    rtf = {"edits": n, "audio_s": audio_s,
           "event_ms_p50": q(ev_ms, 50), "event_ms_p75": q(ev_ms, 75),
           "host_ms_p50": q(host_ms, 50), "host_ms_p75": q(host_ms, 75)}
    rtf["rtf_p50"] = rtf["event_ms_p50"] / 1e3 / audio_s
    print(f"[main] edit T=512 ({audio_s:.3f} s audio), {n} edits one at a time: "
          f"CUDA events p50 {rtf['event_ms_p50']:.3f} ms, p75 {rtf['event_ms_p75']:.3f} ms; "
          f"host clock p50 {rtf['host_ms_p50']:.3f} ms, p75 {rtf['host_ms_p75']:.3f} ms; "
          f"RTF p50 {rtf['rtf_p50']:.6f}", flush=True)
    return rtf


def profile_edit(pipe, req, gen, edit_ms: float, top: int = 12) -> None:
    """Device time by kernel over one 512-frame edit (``torch.profiler``,
    after one profiled warm-up edit), and its share of ``edit_ms``, the
    edit's host-clock time without the profiler."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1), acc_events=True) as prof:
        for _ in range(2):
            pipe(*req, generator=gen)
            torch.cuda.synchronize()
            prof.step()
    kernels = [e for e in prof.key_averages()   # the step's own span is no kernel
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print("[profile] the profiler saw no device time: not measured", flush=True)
        return
    n_ops = sum(e.count for e in kernels)
    print(f"[profile] edit T=512: {n_ops} device operations, busy {busy_ms:.3f} ms, "
          f"{busy_ms / edit_ms:.3f} of the unprofiled edit's {edit_ms:.3f} ms "
          f"host clock", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
              f"{e.key[:90]}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU")
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"[device] {kind} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[device] float32 everywhere; TF32 off for matmul and cuDNN", flush=True)

    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"[build] {len(build.SOURCES)} kernels ({', '.join(build.SOURCES)}) in "
          f"{time.perf_counter() - t0:.1f} s; built now: {sorted(reports)}", flush=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [phase_diffnet_block(gen), phase_mel(), phase_attention(gen)]
    launches, rtf = main_path(gen)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["kernel_ms"] = k["ms"]
        check(k["launches"] > 0, f"{k['name']} was not launched on the main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "tol",
            "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"edit_rtf": rtf, "card": smi}))
    print(smi)
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
