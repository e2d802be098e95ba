#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``speech_editing_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA GPU

Phases, each of which exits non-zero on a failed check:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` builds every kernel from ``speech_editing_tpu_torch/csrc``
   for ``sm_90a``, one compiler per source, in parallel;
3. kernels: each CUDA kernel against its plain PyTorch version at the
   shapes of the edit and train paths, with the error against the stated
   tolerance, the kernel's, the plain version's and (for attention) SDPA's
   time, its achieved TFLOP/s and its share of the bound; K1 at the edit's
   three request lengths, at dilations 1-3 and at the train shape, and
   timed L2-cold at the edit shape (20 weight sets cycled, as the edit's 20
   blocks find them); the backward kernels K5 and K4 also against autograd
   of the plain forward, through the autograd Functions that pair them with
   K1 and K3; K3 and K4 at each timed shape also with their device time
   (``torch.profiler``), device operations (which must be 1) and host time
   a call, beside SDPA's, and on a batch with a row of only pad keys and at
   a head width of 36;
4. edit path: ``EditPipeline`` at the flagship width (seeded random
   weights) answers edit requests of 512 (``bench.py``'s utterance), 300
   and 700 frames; every launch counter must move by exactly its expected
   amount per request; outputs are finite, frames outside the edit equal
   the source mel, and one request re-run on the CPU (plain versions, same
   weights and noise) agrees; the edit's real-time factor is timed;
5. train path: ``Trainer`` at the flagship width takes 3 warm-up and 10
   timed steps on a seeded synthetic batch at the flagship token budget
   (78 utterances x 512 frames); every loss term and the gradient norm are
   finite and every launch counter moves by exactly its expected amount
   per step; one step on a 2-utterance slice, re-run on the CPU (plain
   versions, same weights, optimizer state, diffusion draw, dropout off),
   agrees in losses, gradients, parameters and Adam moments; step time,
   frames per second, peak memory and a profiled step are printed.

``python3 chip_smoke.py --time-attention`` builds K3 and K4 only and times
them and SDPA at those shapes, with no checks: run from a copy of another
commit, it times that commit's kernels in the same call.

Float32 throughout, with TF32 off for matrix products and cuDNN
convolutions, so the card and the CPU compute the same function. The
second-to-last line is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import itertools
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
from speech_editing_tpu_torch.ops.cuda.diffnet_block import (_fits64, _tile_plan,
                                                             diffnet_block,
                                                             diffnet_block_bwd,
                                                             diffnet_block_bwd_plain,
                                                             diffnet_block_plain,
                                                             diffnet_block_train)
from speech_editing_tpu_torch.ops.cuda.mel_kernel import mel_spectrogram
from speech_editing_tpu_torch.ops.flash_attention import (attention_bwd_plain,
                                                          attention_lse_plain,
                                                          attention_plain, flash_mha,
                                                          flash_mha_bwd,
                                                          flash_mha_train)
from speech_editing_tpu_torch.ops.mel import MelConfig
from speech_editing_tpu_torch.ops.mel import mel_spectrogram as mel_plain
from speech_editing_tpu_torch.training.trainer import Trainer

PEAK_FP32_FLOPS = 67e12     # H100 SXM, float32 outside the tensor cores
# H100 SXM, float32-accurate products on the tensor cores: three TF32
# products each (3xTF32, as K1 and K5 run them) at 495 TFLOP/s dense
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_HBM_BYTES = 3.35e12    # H100 SXM, bytes/s
SR, HOP = 22050, 256
REQUEST_FRAMES = (512, 300, 700)
EXPECTED_PER_REQUEST = {"diffnet_block": FLAGSHIP_HP["residual_layers"] * FLAGSHIP_HP["timesteps"],
                        "diffnet_block_bwd": 0, "mel_spectrogram": 1,
                        "flash_mha": FLAGSHIP_HP["enc_layers"], "flash_mha_bwd": 0}
EXPECTED_PER_STEP = {"diffnet_block": FLAGSHIP_HP["residual_layers"],
                     "diffnet_block_bwd": FLAGSHIP_HP["residual_layers"],
                     "mel_spectrogram": 0, "flash_mha": FLAGSHIP_HP["enc_layers"],
                     "flash_mha_bwd": FLAGSHIP_HP["enc_layers"]}
CPU_MEL_TOL = 2e-2
# the train path: 78 x 512 = 39,936 frames, under the flagship's
# max_tokens of 40,000 frames per step; 48 text tokens
TRAIN_B, TRAIN_T, TRAIN_S = 78, 512, 48
TRAIN_MIN_T, TRAIN_MIN_S = 300, 24     # utterance lengths drawn from these up
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
SIL_IDS = (1, 2)          # the synthetic batch's silence tokens
BWD_TOL = 1e-4            # backward kernels, relative to the reference's max
STEP_LOSS_RTOL, STEP_GRAD_TOL = 1e-4, 1e-3
STEP_PARAM_TOL, STEP_MOMENT_TOL = 1e-4, 1e-3


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


def host_us(fn, iters: int = 200, warmup: int = 3) -> float:
    """Host time of one call in us: the host clock around ``iters`` calls
    issued back to back, read before the synchronise after them, so it
    counts the Python and the launch, not the device's work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / iters
    torch.cuda.synchronize()
    return us


def bound(flops: float, n_bytes: float) -> tuple[float, str]:
    """The least time for the work: its float32 FLOP at the 3xTF32 tensor-core
    rate (the fastest float32-accurate rate of the card) or its bytes at the
    HBM rate, whichever is longer, in ms."""
    t_ops, t_bytes = flops / PEAK_3XTF32_FLOPS, n_bytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def rate(flops: float, ms: float, bound_ms: float) -> str:
    """Achieved TFLOP/s, as a share of the 3xTF32 and the fp32 CUDA-core
    rates, and the share of the bound."""
    if ms <= 0:
        return "no device time measured"
    tflops = flops / ms / 1e9
    return (f"{tflops:.1f} TFLOP/s ({tflops * 1e12 / PEAK_3XTF32_FLOPS:.3f} of 3xTF32, "
            f"{tflops * 1e12 / PEAK_FP32_FLOPS:.3f} of fp32 CUDA cores), "
            f"{bound_ms / ms:.3f} of the bound")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def rel_err(got, ref) -> float:
    """Largest |got - ref| over the pairs, each relative to the largest
    magnitude of its reference."""
    return max(float((g - e).abs().max() / e.abs().max().clamp(min=1e-30))
               for g, e in zip(got, ref))


# -- kernel phases ---------------------------------------------------------------

def block_inputs(gen, b: int, t: int = 512):
    """A DiffNet block's inputs at the flagship width, the last row with a
    37-frame padded tail: (x, cond, step, mask, weights)."""
    c, h = FLAGSHIP_HP["residual_channels"], FLAGSHIP_HP["hidden_size"]
    r = lambda *s, scale=1.0: torch.randn(*s, device="cuda", generator=gen) * scale
    x, cond, step = r(b, t, c), r(b, t, h, scale=0.5), r(b, c, scale=0.3)
    mask = torch.ones(b, t, device="cuda")
    mask[-1, t - 37:] = 0.0
    w = (r(3 * c, 2 * c, scale=0.05), r(2 * c, scale=0.1), r(h, 2 * c, scale=0.05),
         r(2 * c, scale=0.1), r(c, 2 * c, scale=0.05), r(2 * c, scale=0.1))
    return x, cond, step, mask, w


def check_wide_dilation(name: str, b: int, t: int, dilation: int) -> None:
    """At [b, t] 64-row tiles fill the card; at ``dilation`` their halo must
    not fit in shared memory, so the plan takes 16-row tiles there."""
    wide = _tile_plan(b, t, _fits64(name, dilation))[0]
    check(_tile_plan(b, t, _fits64(name, 1))[0] == 64 and wide == 16,
          f"{name}: 64-row tiles expected at dilation 1 and 16-row tiles at {dilation}")


def phase_diffnet_block(gen) -> dict:
    """K1 against its plain version at the edit's requests (B=1, T = 512,
    300, 700), at B=4 with dilation 1, 2 and 3 (3 at T=509, a ragged last
    tile), at B=16 with dilation 8 (whose 64-row tiles do not fit) and at
    the train shape with h; timed at the edit shape warm and L2-cold, and at
    the train shape, with the host time of one call at the edit shape."""
    c, h = FLAGSHIP_HP["residual_channels"], FLAGSHIP_HP["hidden_size"]
    tol, out = 1e-4, {"max_abs_err": 0.0}
    flops = lambda b, t: 2 * b * t * 2 * c * (3 * c + h + c)
    check_wide_dilation("diffnet_block", 16, 512, 8)
    for b, t, dilation in ((1, 512, 1), (1, 300, 1), (1, 700, 1), (4, 512, 1), (4, 512, 2),
                           (4, 509, 3), (16, 512, 8), (TRAIN_B, 512, 1)):
        x, cond, step, mask, w = block_inputs(gen, b, t)
        train = b == TRAIN_B      # the train path's form: h written too
        call = lambda fn: fn(x, cond, step, mask, *w, dilation=dilation, return_h=train)
        got, ref = call(diffnet_block), call(diffnet_block_plain)
        torch.cuda.synchronize()
        err = max(float((g - e).abs().max()) for g, e in zip(got, ref))
        msg = (f"[kernel] diffnet_block B={b} T={t} C={c} H={h} dilation={dilation}"
               f"{' (with h)' if train else ''}: max_abs_err={err:.3e} (tol {tol})")
        check(err <= tol, f"diffnet_block B={b} T={t} d={dilation}: error {err} > {tol}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if (b, t) in ((1, 512), (TRAIN_B, 512)):
            ms = time_ms(lambda: call(diffnet_block))
            plain_ms = time_ms(lambda: call(diffnet_block_plain))
            bound_ms, bound_by = bound(flops(b, t), nbytes(x, cond, step, mask, *w, *got))
            msg += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                    f"({bound_by}); {rate(flops(b, t), ms, bound_ms)}")
            if train:
                out.update(train_ms=ms, train_plain_ms=plain_ms, train_bound_ms=bound_ms)
            else:
                us = host_us(lambda: call(diffnet_block))
                msg += f"; host {us:.1f} us a call"
                out.update(warm_ms=ms, warm_plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, host_us=us)
        print(msg, flush=True)
    # the edit shape as the edit finds it: its 20 blocks' weights (50 MB)
    # do not stay in the 50 MB L2, so cycle through 20 weight sets
    x, cond, step, mask, _ = block_inputs(gen, 1, 512)
    sets = [block_inputs(gen, 1, 512)[4] for _ in range(FLAGSHIP_HP["residual_layers"])]
    turn = itertools.count()
    cold = lambda fn: fn(x, cond, step, mask, *sets[next(turn) % len(sets)])
    ms = time_ms(lambda: cold(diffnet_block), iters=2 * len(sets))
    plain_ms = time_ms(lambda: cold(diffnet_block_plain), iters=2 * len(sets))
    print(f"[kernel] diffnet_block B=1 T=512 L2-cold ({len(sets)} weight sets, "
          f"{nbytes(*(t for ws in sets for t in ws)) / 2 ** 20:.0f} MiB): kernel {ms:.4f} ms "
          f"(warm {out['warm_ms']:.4f}), plain {plain_ms:.4f} ms (warm "
          f"{out['warm_plain_ms']:.4f}), bound {out['bound_ms']:.4f} ms; "
          f"{rate(flops(1, 512), ms, out['bound_ms'])}", flush=True)
    out.update(ms=ms, plain_ms=plain_ms)
    return dict(out, name="diffnet_block", route="cuda",
                source="speech_editing_tpu_torch/csrc/diffnet_block.cu",
                replaces="speech_editing_tpu/ops/pallas/diffnet_block.py:139",
                tol=tol, library_ms=None)


def phase_diffnet_block_bwd(gen) -> dict:
    """K5 against its plain version, and K1 + K5 (the autograd Function)
    against autograd of the plain forward, at B=4 with dilation 1 and 2
    (and 3 at T=509, a ragged last tile); timed at B=4 and at the train
    path's B=78; against its plain version also at B=16 with dilation 8,
    whose 64-row tiles do not fit."""
    c, out = FLAGSHIP_HP["residual_channels"], {"max_abs_err": 0.0}
    check_wide_dilation("diffnet_block_bwd", 16, 512, 8)
    for b, t, dilation in ((4, 512, 1), (4, 512, 2), (4, 509, 3), (16, 512, 8),
                           (TRAIN_B, 512, 1)):
        x, cond, step, mask, w = block_inputs(gen, b, t)
        dxo, dsk = (torch.randn(b, t, c, device="cuda", generator=gen) for _ in range(2))
        _, _, h = diffnet_block(x, cond, step, mask, *w, dilation=dilation,
                                return_h=True)
        args = (h, dxo, dsk, mask, w[0], w[4], dilation)
        got, ref = diffnet_block_bwd(*args), diffnet_block_bwd_plain(*args)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        msg = f"[kernel] diffnet_block_bwd B={b} T={t} C={c} dilation={dilation}: " \
              f"max err vs plain {err:.3e}"
        if b == 4:
            leaves = [a.detach().requires_grad_() for a in (x, cond, step, *w)]

            def grads(block):
                lx, lc, ls, *lw = leaves
                outs = block(lx, lc, ls, mask, *lw, dilation=dilation)
                return torch.autograd.grad(outs, leaves, (dxo, dsk))
            err_ag = rel_err(grads(diffnet_block_train), grads(diffnet_block_plain))
            msg += f", vs autograd of the plain forward {err_ag:.3e}"
            check(err_ag <= BWD_TOL, f"diffnet_block_bwd autograd d={dilation}: "
                                     f"error {err_ag} > {BWD_TOL}")
            err = max(err, err_ag)
        check(err <= BWD_TOL, f"diffnet_block_bwd B={b} d={dilation}: error {err}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if dilation == 1:
            ms = time_ms(lambda: diffnet_block_bwd(*args))
            plain_ms = time_ms(lambda: diffnet_block_bwd_plain(*args))
            flops = 16 * b * t * c * c
            bound_ms, bound_by = bound(flops, nbytes(h, dxo, dsk, mask, w[0], w[4], *got))
            msg += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {bound_ms:.4f} ms ({bound_by}); {rate(flops, ms, bound_ms)}")
            if b == TRAIN_B:
                out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        print(msg + f" (tol {BWD_TOL}, relative to the reference's max)", flush=True)
    return dict(out, name="diffnet_block_bwd", route="cuda",
                source="speech_editing_tpu_torch/csrc/diffnet_block_bwd.cu",
                replaces="speech_editing_tpu/ops/pallas/diffnet_block.py:231",
                tol=BWD_TOL, library_ms=None)


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
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"{rate(flops, ms, bound_ms)}", flush=True)
    check(err <= tol, f"mel_spectrogram: error {err} > {tol}")
    check(mean_err <= mean_tol, f"mel_spectrogram: mean error {mean_err} > {mean_tol}")
    return dict(name="mel_spectrogram", route="cuda",
                source="speech_editing_tpu_torch/csrc/mel_kernel.cu",
                replaces="speech_editing_tpu/ops/pallas/mel_kernel.py:53",
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


PROFILE_EDGE_S = 0.05
MARKER = "bitwise_not"     # the marker kernel's name holds this; no measured call's does


def profiled(run) -> list:
    """``torch.profiler``'s device operations (``device_ops``) over one call
    of ``run``, after one profiled warm-up call. The profiler keeps a device
    event only if its timestamp falls inside its window, and the device's
    timestamps can read behind the host clock (a kernel seen to start before
    its own launch), which dropped the first events of a short window; so
    the window opens and closes PROFILE_EDGE_S of host sleep away from the
    work."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1), acc_events=True) as prof:
        for _ in range(2):
            time.sleep(PROFILE_EDGE_S)
            run()
            torch.cuda.synchronize()
            time.sleep(PROFILE_EDGE_S)
            prof.step()
    return device_ops(prof)


def profile_calls(fn, iters: int = 50, tries: int = 3) -> tuple[float, int]:
    """The device time of one call in ms and the device operations a call
    issues, from ``torch.profiler`` over ``iters`` calls, each followed by
    a marker of one kernel (``bitwise_not_`` of one int16). Should the
    profiler still lose events, each operation counts round(its events /
    the marker's events) times a call, at its mean time an event; a window
    that kept under half the marker's events is profiled again, up to
    ``tries`` windows."""
    marker = torch.zeros(1, dtype=torch.int16, device="cuda")

    def run():
        for _ in range(iters):
            fn()
            marker.bitwise_not_()
    for _ in range(tries):
        ops = profiled(run)
        marks = sum(e.count for e in ops if MARKER in e.key)
        if marks >= iters / 2:
            break
    check(marks >= iters / 2, f"the profiler kept {marks} of {iters} marker events "
                              f"in each of {tries} windows: device operations not measured")
    per_call = [(round(e.count / marks), e.self_device_time_total / e.count)
                for e in ops if e.count and MARKER not in e.key]
    return sum(n * us for n, us in per_call) / 1e3, sum(n for n, _ in per_call)


def call_times(fn, library) -> dict:
    """A kernel's wrapper call and one PyTorch call computing the same
    function: event time, device time and device operations a call, host
    time of the wrapper call."""
    device_ms, ops = profile_calls(fn)
    lib_device_ms, lib_ops = profile_calls(library)
    return dict(ms=time_ms(fn), device_ms=device_ms, ops_per_call=ops, host_us=host_us(fn),
                library_ms=time_ms(library), library_device_ms=lib_device_ms,
                library_ops_per_call=lib_ops)


def times_text(t: dict, library: str) -> str:
    return (f"kernel {t['ms']:.4f} ms events, {t['device_ms']:.4f} ms device, "
            f"{t['ops_per_call']} device ops a call, host {t['host_us']:.1f} us a call; "
            f"{library} {t['library_ms']:.4f} ms events, {t['library_device_ms']:.4f} ms "
            f"device ({t['library_ops_per_call']} ops)")


def sdpa_fwd(q, k, v, pad):
    """SDPA on the same inputs (the yardstick; the port never calls it)."""
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    allowed = (~pad)[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed, scale=1.0)


def sdpa_bwd(q, k, v, do, pad):
    """SDPA's backward on the same inputs and output gradient."""
    qt, kt, vt = (a.detach().transpose(1, 2).requires_grad_() for a in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, scale=1.0,
                                         attn_mask=(~pad)[:, None, None, :])
    do_t = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), do_t, retain_graph=True)


# the timed attention shapes: (B, S, valid keys of each row, K3 with lse);
# None stands for the train batch's lengths
FWD_SHAPES = ((1, 48, [48], False), (3, 130, [130, 100, 71], False),
              (TRAIN_B, TRAIN_S, None, True))
BWD_SHAPES = ((1, 48, [43]), (3, 130, [130, 100, 71]), (TRAIN_B, TRAIN_S, None))
PAD_ROW_LENGTHS = [48, 0, 31]          # batch row 1 has only pad keys
NARROW_D, NARROW_LENGTHS = 36, [48, 40, 24]


def check_one_op(name: str, t: dict) -> None:
    check(t["ops_per_call"] == 1, f"{name}: {t['ops_per_call']} device operations a call, "
                                  f"expected 1")


def phase_attention(gen) -> dict:
    """K3 against its plain version (and its logsumexp) at the edit's,
    a long and the train path's shapes, timed at each with its device
    time, device operations and host time a call; then a batch with a
    row of only pad keys and a head width of 36."""
    h = FLAGSHIP_HP["num_heads"]
    d = FLAGSHIP_HP["hidden_size"] // h
    tol, out, shapes = 1e-4, {"max_abs_err": 0.0}, []
    for b, s, lengths, with_lse in FWD_SHAPES:
        lengths = lengths or train_lengths()
        q, k, v, pad = attention_inputs(gen, b, s, lengths)
        got = flash_mha(q, k, v, pad, return_lse=with_lse)   # the edit's form: no lse
        got, lse = got if with_lse else (got, None)
        ref = attention_plain(q, k, v, pad)
        torch.cuda.synchronize()       # every row has a valid key
        err = rel_err([got, lse], [ref, attention_lse_plain(q, k, pad)]) if with_lse \
            else float((got - ref).abs().max())
        t = call_times(lambda: flash_mha(q, k, v, pad, return_lse=with_lse),
                       sdpa_fwd(q, k, v, pad))
        plain_ms = time_ms(lambda: (attention_plain(q, k, v, pad), attention_lse_plain(q, k, pad))
                           if with_lse else attention_plain(q, k, v, pad))
        flops = 4 * h * s * d * sum(lengths)    # q k^T and p v over valid keys
        bound_ms, bound_by = bound(flops, nbytes(q, k, v, pad, got, lse))
        shown = lengths if b <= 3 else f"{min(lengths)}..{max(lengths)}"
        print(f"[kernel] flash_mha B={b} S={s} h={h} d={d}{' with logsumexp' if with_lse else ''}"
              f", valid keys {shown}: max err {err:.3e} "
              f"({'relative to the reference max' if with_lse else 'absolute'}, tol {tol}); "
              f"{times_text(t, 'sdpa')}; plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
              f"({bound_by}); device {rate(flops, t['device_ms'], bound_ms)}", flush=True)
        check(err <= tol, f"flash_mha B={b} S={s}: error {err} > {tol}")
        check_one_op(f"flash_mha B={b} S={s}", t)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        shapes.append(dict(t, b=b, s=s, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           max_err=err))
    out.update(shapes[0], shapes=shapes)   # the table's row: the edit path's shape

    # a row whose keys are all padding: zeros and lse -inf by design, where
    # the plain version's -1e9 bias gives uniform weights; the other rows match
    q, k, v, pad = attention_inputs(gen, 3, 48, PAD_ROW_LENGTHS)
    got, lse = flash_mha(q, k, v, pad, return_lse=True)
    rows = [i for i, n in enumerate(PAD_ROW_LENGTHS) if n > 0]
    empty = [i for i, n in enumerate(PAD_ROW_LENGTHS) if n == 0]
    err = rel_err([got[rows], lse[rows]], [attention_plain(q, k, v, pad)[rows],
                                           attention_lse_plain(q, k, pad)[rows]])
    zero_row = bool((got[empty] == 0).all() and (lse[empty] == float("-inf")).all())
    print(f"[kernel] flash_mha B=3 S=48 d={d}, valid keys {PAD_ROW_LENGTHS}: the row with "
          f"none gives out 0 and lse -inf: {zero_row}; other rows max err {err:.3e} "
          f"relative to the reference max (tol {tol})", flush=True)
    check(zero_row, "flash_mha: a row with no valid key must give out 0 and lse -inf")
    check(err <= tol, f"flash_mha with a padded row: error {err} > {tol}")

    # a head width that is not a multiple of 8: d zero-filled to the k8 step
    q, k, v, pad = attention_inputs(gen, 3, 48, NARROW_LENGTHS, d=NARROW_D)
    got, lse = flash_mha(q, k, v, pad, return_lse=True)
    err = rel_err([got, lse], [attention_plain(q, k, v, pad), attention_lse_plain(q, k, pad)])
    print(f"[kernel] flash_mha B=3 S=48 d={NARROW_D}, valid keys {NARROW_LENGTHS}: max err "
          f"{err:.3e} relative to the reference max (tol {tol})", flush=True)
    check(err <= tol, f"flash_mha d={NARROW_D}: error {err} > {tol}")
    out["max_abs_err"] = max(out["max_abs_err"], err)
    return dict(out, name="flash_mha", route="cuda",
                source="speech_editing_tpu_torch/csrc/flash_attention.cu",
                replaces="speech_editing_tpu/ops/flash_attention.py:85", tol=tol)


def attention_inputs(gen, b: int, s: int, lengths, d: int | None = None):
    h = FLAGSHIP_HP["num_heads"]
    d = d or FLAGSHIP_HP["hidden_size"] // h
    q = torch.randn(b, s, h, d, device="cuda", generator=gen) * d ** -0.5
    k = torch.randn(b, s, h, d, device="cuda", generator=gen)
    v = torch.randn(b, s, h, d, device="cuda", generator=gen)
    pad = (torch.arange(s, device="cuda")[None, :]
           >= torch.tensor(lengths, device="cuda")[:, None])
    return q, k, v, pad


def train_lengths() -> list[int]:
    """The token counts of the train path's batch."""
    tokens = train_batch(TRAIN_B, TRAIN_T, TRAIN_S, seed=0)["txt_tokens"]
    return [int(n) for n in (tokens > 0).sum(1)]


def bwd_errors(q, k, v, pad, do, rows=None) -> tuple:
    """K4 (fed K3's output and logsumexp) against its plain version over the
    whole batch, and K3 + K4 against autograd of the plain forward over the
    batch rows ``rows`` (all by default): (errors, K4's grads, K4's args)."""
    o, lse = flash_mha(q, k, v, pad, return_lse=True)
    args = (q, k, v, o, lse, do, pad)
    got, ref = flash_mha_bwd(*args), attention_bwd_plain(*args)
    torch.cuda.synchronize()
    leaves = [a.detach().requires_grad_() for a in (q, k, v)]
    grads = lambda attend: torch.autograd.grad(attend(*leaves, pad), leaves, do)
    pick = (lambda gs: [g[rows] for g in gs]) if rows is not None else (lambda gs: gs)
    err_ag = rel_err(pick(grads(flash_mha_train)), pick(grads(attention_plain)))
    return rel_err(got, ref), err_ag, got, args


def phase_attention_bwd(gen) -> dict:
    """K3's logsumexp and K4 against their plain versions, and K3 + K4 (the
    autograd Function) against autograd of the plain forward, with key
    padding; timed beside SDPA's backward at each shape, with the device
    time, device operations and host time a call; then a batch with a row
    of only pad keys and a head width of 36."""
    out, shapes = {"max_abs_err": 0.0}, []
    for b, s, lengths in BWD_SHAPES:
        lengths = lengths or train_lengths()
        q, k, v, pad = attention_inputs(gen, b, s, lengths)
        do = torch.randn_like(q)
        err, err_ag, got, args = bwd_errors(q, k, v, pad, do)
        err_lse = rel_err([args[4]], [attention_lse_plain(q, k, pad)])
        pad_zero = bool((got[1][pad] == 0).all() and (got[2][pad] == 0).all())
        t = call_times(lambda: flash_mha_bwd(*args), sdpa_bwd(q, k, v, do, pad))
        plain_ms = time_ms(lambda: attention_bwd_plain(*args))
        h, d = q.shape[2], q.shape[3]
        flops = 10 * h * s * d * sum(lengths)   # five products over valid keys
        bound_ms, bound_by = bound(flops, nbytes(*args, *got))
        print(f"[kernel] flash_mha_bwd B={b} S={s} valid keys "
              f"{lengths if b <= 3 else f'{min(lengths)}..{max(lengths)}'}: "
              f"max err vs plain {err:.3e}, vs autograd of the plain forward "
              f"{err_ag:.3e}, logsumexp {err_lse:.3e} (tol {BWD_TOL}, relative to the "
              f"reference's max); pad keys' dk, dv exactly 0: {pad_zero}; "
              f"{times_text(t, 'sdpa backward')}; plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by}); device {rate(flops, t['device_ms'], bound_ms)}",
              flush=True)
        worst = max(err, err_ag, err_lse)
        check(worst <= BWD_TOL, f"flash_mha_bwd B={b} S={s}: error {worst} > {BWD_TOL}")
        check(pad_zero, f"flash_mha_bwd B={b} S={s}: pad keys got nonzero dk or dv")
        check_one_op(f"flash_mha_bwd B={b} S={s}", t)
        out["max_abs_err"] = max(out["max_abs_err"], worst)
        shapes.append(dict(t, b=b, s=s, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           max_err=worst))
    out.update(shapes[-1], shapes=shapes)  # the table's row: the train path's shape

    # a row whose keys are all padding: dq = dk = dv = 0 there, K4 against
    # its plain version over the whole batch, autograd only on the other rows
    q, k, v, pad = attention_inputs(gen, 3, 48, PAD_ROW_LENGTHS)
    do = torch.randn_like(q)
    rows = [i for i, n in enumerate(PAD_ROW_LENGTHS) if n > 0]
    empty = [i for i, n in enumerate(PAD_ROW_LENGTHS) if n == 0]
    err, err_ag, got, _ = bwd_errors(q, k, v, pad, do, rows)
    zero_row = all(bool((g[empty] == 0).all()) for g in got)
    pad_zero = bool((got[1][pad] == 0).all() and (got[2][pad] == 0).all())
    print(f"[kernel] flash_mha_bwd B=3 S=48 valid keys {PAD_ROW_LENGTHS}: the row with none "
          f"gives dq = dk = dv = 0: {zero_row}; pad keys' dk, dv exactly 0: {pad_zero}; max err "
          f"vs plain {err:.3e} (whole batch), vs autograd of the plain forward {err_ag:.3e} "
          f"(other rows) (tol {BWD_TOL})", flush=True)
    check(zero_row and pad_zero, "flash_mha_bwd: a row with no valid key must get zero grads")
    check(max(err, err_ag) <= BWD_TOL, f"flash_mha_bwd with a padded row: {err}, {err_ag}")

    q, k, v, pad = attention_inputs(gen, 3, 48, NARROW_LENGTHS, d=NARROW_D)
    err, err_ag, got, _ = bwd_errors(q, k, v, pad, torch.randn_like(q))
    pad_zero = bool((got[1][pad] == 0).all() and (got[2][pad] == 0).all())
    print(f"[kernel] flash_mha_bwd B=3 S=48 d={NARROW_D} valid keys {NARROW_LENGTHS}: max err "
          f"vs plain {err:.3e}, vs autograd of the plain forward {err_ag:.3e} (tol {BWD_TOL}); "
          f"pad keys' dk, dv exactly 0: {pad_zero}", flush=True)
    check(max(err, err_ag) <= BWD_TOL and pad_zero, f"flash_mha_bwd d={NARROW_D}: {err}, {err_ag}")
    out["max_abs_err"] = max(out["max_abs_err"], err, err_ag)
    return dict(out, name="flash_mha_bwd", route="cuda",
                source="speech_editing_tpu_torch/csrc/flash_attention_bwd.cu",
                replaces="speech_editing_tpu/ops/flash_attention.py:85 (the bundled "
                         "kernel's _flash_attention_bwd_dkv :941 and _bwd_dq :1287)",
                tol=BWD_TOL)


def time_attention(gen) -> None:
    """``--time-attention``: K3 and K4 as the installed package builds them,
    timed at the phases' shapes with no checks, so that two versions of the
    package can be timed in one call; one JSON line."""
    rows = []
    for (b, s, lengths, with_lse), (_, _, bwd_lengths) in zip(FWD_SHAPES, BWD_SHAPES):
        q, k, v, pad = attention_inputs(gen, b, s, lengths or train_lengths())
        fwd = call_times(lambda: flash_mha(q, k, v, pad, return_lse=with_lse),
                         sdpa_fwd(q, k, v, pad))
        q, k, v, pad = attention_inputs(gen, b, s, bwd_lengths or train_lengths())
        do = torch.randn_like(q)
        o, lse = flash_mha(q, k, v, pad, return_lse=True)
        bwd = call_times(lambda: flash_mha_bwd(q, k, v, o, lse, do, pad),
                         sdpa_bwd(q, k, v, do, pad))
        print(f"[time] B={b} S={s}: flash_mha{' with logsumexp' if with_lse else ''} "
              f"{times_text(fwd, 'sdpa')}; flash_mha_bwd {times_text(bwd, 'sdpa backward')}",
              flush=True)
        rows.append({"b": b, "s": s, "flash_mha": fwd, "flash_mha_bwd": bwd})
    print(json.dumps({"attention_times": rows}))


# -- edit path -------------------------------------------------------------------

COUNTERS = {"diffnet_block": diffnet_block, "diffnet_block_bwd": diffnet_block_bwd,
            "mel_spectrogram": mel_spectrogram, "flash_mha": flash_mha,
            "flash_mha_bwd": flash_mha_bwd}


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


def edit_path(gen) -> tuple[dict, dict]:
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
    print(f"[edit] launches per request {per_request}; totals {totals}", flush=True)
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
        print(f"[edit] request T={t}: finite, outside-edit frames exact, "
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
    print(f"[edit] CPU re-run of T=512 ({cpu_s:.1f} s): mel_out max_abs_err "
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
    print(f"[edit] edit T=512 ({audio_s:.3f} s audio), {n} edits one at a time: "
          f"CUDA events p50 {rtf['event_ms_p50']:.3f} ms, p75 {rtf['event_ms_p75']:.3f} ms; "
          f"host clock p50 {rtf['host_ms_p50']:.3f} ms, p75 {rtf['host_ms_p75']:.3f} ms; "
          f"RTF p50 {rtf['rtf_p50']:.6f}", flush=True)
    return rtf


def device_ops(prof) -> list:
    """The profile's device operations by name, without the spans of
    annotations (the profiler step, the optimizer step), whose device time
    is that of the kernels inside them."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("ProfilerStep", "Optimizer."))]


def profile_edit(pipe, req, gen, edit_ms: float, top: int = 12) -> None:
    """Device time by kernel over one 512-frame edit (``torch.profiler``,
    after one profiled warm-up edit), and its share of ``edit_ms``, the
    edit's host-clock time without the profiler."""
    kernels = profiled(lambda: pipe(*req, generator=gen))
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


# -- train path ------------------------------------------------------------------

def train_batch(b: int, t: int, s: int, seed: int) -> dict:
    """A collated FluentSpeech batch (numpy, the keys of ``make_loss_fn``):
    frame lengths 300..t and token counts 24..s (TRAIN_MIN_T, TRAIN_MIN_S;
    the first row full), a silence token (id 1) at about one token in four
    as a word boundary, each utterance's tokens spread monotonically over
    its frames, log-mel-like values on real frames and zeros on padding,
    log2 f0 with 20 % unvoiced frames, and the middle third of each
    utterance masked."""
    rs = np.random.RandomState(seed)
    frames = rs.randint(TRAIN_MIN_T, t + 1, b)
    n_tok = rs.randint(TRAIN_MIN_S, s + 1, b)
    frames[0], n_tok[0] = t, s
    batch = dict(txt_tokens=np.zeros((b, s), np.int64), mel2ph=np.zeros((b, t), np.int64),
                 mels=np.zeros((b, t, 80), np.float32), f0=np.zeros((b, t), np.float32),
                 uv=np.zeros((b, t), np.float32), time_mel_masks=np.zeros((b, t), np.float32))
    for i, (f, n) in enumerate(zip(frames, n_tok)):
        tokens = rs.randint(3, 80, n)
        tokens[rs.rand(n) < 0.25] = SIL_IDS[0]
        batch["txt_tokens"][i, :n] = tokens
        bounds = np.sort(rs.choice(np.arange(1, f), n - 1, replace=False))
        batch["mel2ph"][i, :f] = np.searchsorted(bounds, np.arange(f), side="right") + 1
        batch["mels"][i, :f] = rs.randn(f, 80) * 0.5 - 1.0
        uv = (rs.rand(f) < 0.2).astype(np.float32)
        batch["uv"][i, :f] = uv
        batch["f0"][i, :f] = (rs.rand(f) * 2 + 6.5) * (1 - uv)
        batch["time_mel_masks"][i, f // 3: 2 * f // 3] = 1.0
    return batch


def train_path() -> tuple[dict, dict]:
    batch = train_batch(TRAIN_B, TRAIN_T, TRAIN_S, seed=0)
    real_frames = int((batch["mel2ph"] > 0).sum())
    trainer = Trainer(dict(FLAGSHIP_HP, tb_log_interval=TRAIN_WARMUP + TRAIN_TIMED),
                      device="cuda", seed=0, vocab_size=80, sil_token_ids=SIL_IDS)
    reset_counts()
    per_step, ev_ms, host_ms = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        before = counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        metrics = trainer.step(batch)
        end.record()
        end.synchronize()
        if i >= TRAIN_WARMUP:
            host_ms.append((time.perf_counter() - t0) * 1e3)
            ev_ms.append(start.elapsed_time(end))
        per_step.append({k: counts()[k] - before[k] for k in COUNTERS})
        m = {k: float(v) for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in m.values()) and m["nan_grads"] == 0,
              f"train step {i}: non-finite metrics {m}")
    totals = counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[train] launches per step {per_step[-1]}; totals {totals}", flush=True)
    for i, moved in enumerate(per_step):
        check(moved == EXPECTED_PER_STEP,
              f"train step {i}: launches {moved} != expected {EXPECTED_PER_STEP}")
    print("[train] last step: " + " ".join(f"{k}={v:.5f}" for k, v in sorted(m.items())),
          flush=True)
    q = lambda xs, p: float(np.percentile(xs, p))
    stats = {"batch": [TRAIN_B, TRAIN_T], "frames": TRAIN_B * TRAIN_T,
             "real_frames": real_frames, "timed_steps": TRAIN_TIMED,
             "event_ms_p50": q(ev_ms, 50), "event_ms_p75": q(ev_ms, 75),
             "host_ms_p50": q(host_ms, 50), "host_ms_p75": q(host_ms, 75),
             "peak_gib": peak_gib}
    stats["frames_per_s"] = stats["frames"] / (stats["event_ms_p50"] / 1e3)
    stats["real_frames_per_s"] = real_frames / (stats["event_ms_p50"] / 1e3)
    print(f"[train] B={TRAIN_B} x T={TRAIN_T} ({real_frames} real frames), "
          f"{TRAIN_TIMED} steps after {TRAIN_WARMUP} warm-up: CUDA events p50 "
          f"{stats['event_ms_p50']:.3f} ms, p75 {stats['event_ms_p75']:.3f} ms; host "
          f"clock p50 {stats['host_ms_p50']:.3f} ms, p75 {stats['host_ms_p75']:.3f} ms; "
          f"{stats['frames_per_s']:.0f} frames/s ({stats['real_frames_per_s']:.0f} real); "
          f"peak memory {peak_gib:.3f} GiB", flush=True)
    profile_step(trainer, batch, stats["host_ms_p50"])
    compare_step_with_cpu(trainer, batch)
    return totals, stats


def profile_step(trainer, batch, step_ms: float, top: int = 15) -> None:
    """Device time by kernel over one train step (``torch.profiler``, after
    one profiled warm-up step), and its share of ``step_ms``, the step's
    host-clock time without the profiler."""
    kernels = profiled(lambda: trainer.step(batch))
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print("[profile] the profiler saw no device time: not measured", flush=True)
        return
    print(f"[profile] train step: {sum(e.count for e in kernels)} device operations, "
          f"busy {busy_ms:.3f} ms, {busy_ms / step_ms:.3f} of the unprofiled step's "
          f"{step_ms:.3f} ms host clock", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
              f"{e.key[:90]}", flush=True)


def compare_step_with_cpu(trainer, batch) -> None:
    """One step on a 2-utterance slice of the batch, on the card and on the
    CPU (plain versions), from the trained state with the same diffusion
    draw and dropout off: losses, gradients, updated parameters and Adam
    moments must agree."""
    import copy
    sub = {k: v[:2] for k, v in batch.items()}
    gen = torch.Generator().manual_seed(7)
    t_draw = torch.randint(0, FLAGSHIP_HP["timesteps"] + 1, (2,), generator=gen)
    noise = torch.randn(2, TRAIN_T, 80, generator=gen)
    state = trainer.train_step.state_dict()

    def run(dev: str) -> dict:
        twin = Trainer(FLAGSHIP_HP, device=dev, seed=1, vocab_size=80,
                       sil_token_ids=SIL_IDS, dropout=False)
        twin.train_step.load_state_dict(copy.deepcopy(state))
        t0 = time.perf_counter()
        metrics = twin.train_step(twin.to_device(sub), t=t_draw.to(dev),
                                  noise=noise.to(dev))
        secs = time.perf_counter() - t0
        step = twin.train_step
        named = dict(step.model.named_parameters())
        moment = lambda key: {n: step.optimizer.state[p][key].cpu()
                              for n, p in named.items()}
        return dict(secs=secs, metrics={k: float(v) for k, v in metrics.items()},
                    grads={n: p.grad.cpu() for n, p in named.items()},
                    params={n: p.detach().cpu() for n, p in named.items()},
                    exp_avg=moment("exp_avg"), exp_avg_sq=moment("exp_avg_sq"))

    gpu, cpu = (run(dev) for dev in ("cuda", "cpu"))
    loss_err = max(abs(gpu["metrics"][k] - v) / max(abs(v), 1e-12)
                   for k, v in cpu["metrics"].items() if k != "nan_grads")
    worst = {key: max((rel_err([gpu[key][n]], [cpu[key][n]]), n) for n in cpu[key])
             for key in ("grads", "params", "exp_avg", "exp_avg_sq")}
    print(f"[train] B=2 step on the card vs the CPU ({cpu['secs']:.1f} s): loss terms "
          f"max rel err {loss_err:.3e} (tol {STEP_LOSS_RTOL}); gradients "
          f"{worst['grads'][0]:.3e} of each tensor's max (tol {STEP_GRAD_TOL}, worst "
          f"{worst['grads'][1]}); updated params {worst['params'][0]:.3e} (tol "
          f"{STEP_PARAM_TOL}); Adam moments {worst['exp_avg'][0]:.3e} / "
          f"{worst['exp_avg_sq'][0]:.3e} (tol {STEP_MOMENT_TOL}); loss "
          f"{gpu['metrics']['total_loss']:.6f} vs {cpu['metrics']['total_loss']:.6f}",
          flush=True)
    check(loss_err <= STEP_LOSS_RTOL, f"B=2 step: loss error {loss_err}")
    check(worst["grads"][0] <= STEP_GRAD_TOL, f"B=2 step: gradient error {worst['grads']}")
    check(worst["params"][0] <= STEP_PARAM_TOL, f"B=2 step: param error {worst['params']}")
    for key in ("exp_avg", "exp_avg_sq"):
        check(worst[key][0] <= STEP_MOMENT_TOL, f"B=2 step: {key} error {worst[key]}")


def main() -> None:
    only_times = sys.argv[1:] == ["--time-attention"]
    if sys.argv[1:] and not only_times:
        fail(f"usage: python3 chip_smoke.py [--time-attention]; got {sys.argv[1:]}")
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
    if only_times:
        build.build_all(("flash_attention", "flash_attention_bwd"))
        print(smi, flush=True)
        time_attention(torch.Generator(device="cuda").manual_seed(0))
        return
    reports = build.build_all()
    print(f"[build] {len(build.SOURCES)} kernels ({', '.join(build.SOURCES)}) in "
          f"{time.perf_counter() - t0:.1f} s; built now: {sorted(reports)}", flush=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [phase_diffnet_block(gen), phase_diffnet_block_bwd(gen), phase_mel(),
               phase_attention(gen), phase_attention_bwd(gen)]
    edit_launches, rtf = edit_path(gen)
    train_launches, train = train_path()
    for k in kernels:
        k["launches_by_path"] = {"edit": edit_launches[k["name"]],
                                 "train": train_launches[k["name"]]}
        k["launches"] = sum(k["launches_by_path"].values())
        k["kernel_ms"] = k["ms"]
        check(k["launches"] > 0, f"{k['name']} was not launched on a main path")
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "tol", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"edit_rtf": rtf, "train_step": train, "card": smi}))
    print(smi)
    extra = ("warm_ms", "warm_plain_ms", "host_us", "train_ms", "train_plain_ms",
             "train_bound_ms", "device_ms", "ops_per_call", "library_device_ms", "shapes")
    print(json.dumps({"kernels": [{key: k[key] for key in keys + extra if key in k}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
