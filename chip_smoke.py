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
   K1 and K3; at each timed shape the device time (``torch.profiler``),
   device operations and host time a call, the operations checked == 1 for
   K2, K3 and K4; K3 and K4 beside SDPA's, and on a batch with a row of only
   pad keys and at a head width of 36; K2 at the edit's three requests, at
   B=4 with a ragged last tile and at hop 128, timed beside a cuFFT
   composite, its bound counted as the least work of the function (a real
   FFT on the fp32 CUDA cores); the bf16 forms of K1 (at the edit's three
   lengths, at B=4 with dilations 1-3 and T=509 ragged, at the bf16 run
   step's median batch B=16 x T=446 and the bf16 flagship step's B=78 x
   T=512, both with h) and K5 (B=4 at dilations 2 and 3, B=16 x T=446,
   there also K1 + K5 against autograd of the bf16 plain forward, and B=78
   x T=512) against their bf16 plain versions (BF16_TOL,
   BF16_AUTOGRAD_TOL), timed at B=16 x T=446 and B=78 x T=512 with the
   device time, operations and host time a call beside a cuBLAS composite
   of the same function, their bound counted at the bf16 tensor-core
   rate; K1 and K5, float32 and bf16, at the other widths
   they are compiled for (``WIDTHS``: C=128, H=256) against their plain
   versions (``check_block_widths``); the bf16 forms of K3 (with its float32
   logsumexp) and K4 against their bf16 plain versions (BF16_TOL), K3 + K4
   against autograd of the bf16 plain forward (BF16_AUTOGRAD_TOL), at the
   bf16 flagship step's shape (B=78 x S=48) and CampNet's decoder shapes
   (B=16, T 256-1536), timed beside SDPA in bf16 and the float32 forms,
   their bound at the bf16 tensor-core rate; and on a row of only pad keys,
   a head width of 36 and a key mask with holes (pad keys inside CampNet's
   T=1024 rows, a whole 64-key tile of one row, a row of only pad keys; the
   bf16 kernels skip all-pad tiles), K4's bf16 form run twice on the same
   inputs and required bit-identical; the build phase counts each
   attention and DiffNet library's HGMMA (wgmma) and HMMA (mma.sync)
   instructions in its SASS and requires the bf16 kernels to run on wgmma
   alone;
4. edit path: ``EditPipeline`` at the flagship width (seeded random
   weights, DiffNet's output projection drawn non-zero) answers edit
   requests of 512 (``bench.py``'s utterance), 300 and 700 frames; every
   launch counter must move by exactly its expected amount per request;
   outputs are finite, frames outside the edit equal the source mel, and
   one request re-run on the CPU (plain versions, same weights and noise)
   agrees; the edit's real-time factor is timed;
5. train path: ``Trainer`` at the flagship width takes 3 warm-up and 10
   timed steps on a seeded synthetic batch at the flagship token budget
   (78 utterances x 512 frames); every loss term and the gradient norm are
   finite and every launch counter moves by exactly its expected amount
   per step; one step on a 2-utterance slice, re-run on the CPU (plain
   versions, same weights, optimizer state, diffusion draw, dropout off),
   agrees in losses, gradients, parameters and Adam moments; step time,
   frames per second, peak memory and a profiled step are printed;
5b. bf16 train path: the same steps under ``use_bf16``, each launching
   the bf16 forms of K1 and K5 20 times and of K3 and K4 4 times (the fft
   text encoder), nothing else; timed and profiled the same way;
6. run path: the training entry ``speech_editing_tpu_torch.run`` on
   ``egs/spec_denoiser.yaml`` as shipped (conv text encoder, speaker
   embeddings, ``max_sentences`` 16, ``max_tokens`` 40,000, two loader
   workers, alignment-aware masks; float32 through ``use_bf16=False``) over
   a synthetic binarized corpus of 512/32/8 utterances of 150-700 frames,
   in a temporary directory: 30 steps with sanity validation, validation
   and a checkpoint every 15 steps, then a second run resumes to 35. Every
   step launches K1 and K5 20 times each and nothing else, every
   validation batch K1 20 times; metrics are finite; the checkpoints at 15
   and 30 exist; the resume starts at step 30 with the saved parameters and
   Adam moments bit for bit; a 2-utterance slice of a corpus batch, stepped
   on the card and on the CPU, agrees. Steps/s, real frames/s, the loader
   wait a step, a profiled step, peak memory, validation time and the
   checkpoint's size, save and load times are printed.
6b. bf16 run path: the same entry on ``egs/spec_denoiser.yaml`` as shipped
   (``use_bf16: true``, no override) over the same corpus, the loader in
   process: 30 steps, a
   validation of 4 batches and a checkpoint, then a resume to 35. Every
   step launches the bf16 K1 and K5 20 times each and nothing else, every
   validation batch the float32 K1 20 times; metrics are finite; the
   checkpoint holds float32 parameters and moments, which the resume
   restores bit for bit; a 2-utterance bf16 step on the card and on the
   CPU agree at the BF16_* bars. Steps/s, host p50/p75, a profiled median
   step and peak memory are printed.
7. infer path, on the run path's checkpoint and corpus with a HiFi-GAN V1
   checkpoint of seeded weights at ``egs/hifigan.yaml``'s widths (the
   vocoder must load as HiFi-GAN on the card): ``run --infer`` over the 8
   test utterances writes [P]/[G]/[P_SEG]/[G_SEG] wavs and ``meta.csv``,
   each item launches K1 160 times and no other kernel, and every mel_out
   frame outside the dataset's mask is the ground truth's; then the CSV
   region-edit API (``SpecDenoiserInfer.example_run``) edits four
   requests of 2.5-5 s (a lengthening, a shortening, a same-length edit
   and a tail that re-phonemizes differently; fallback g2p, TextGrids
   written here): an output and a ``_ref`` wav each, 160 K1 launches an
   edit, head and tail frames equal to the source's, the edited span as
   long as its predicted durations, the same request twice bit-identical;
   each edit's host latency and its parts over 20 edits, one profiled
   edit, and one request re-run on the CPU with the card's noise (a
   duration or pitch bin that rounds the other way is replayed and
   counted). K1 is then held against its plain version at every length
   this phase ran it at.
8. serve path, on the same checkpoint, corpus and HiFi-GAN: the batch
   server (``BatchedEditServer``, 16 rows a chunk, the default 128-1536
   frame and 32-256 token buckets), warmed, edits 32 requests of 1.3-15.5 s
   (TextGrids written here): each dur chunk launches no kernel and each
   diff chunk K1 160 times and nothing else; results finite with the
   source's head and tail frames; no program shape after warmup; one
   request gives the same mel bit for bit alone, in its 16-row chunk and at
   another row, and at its exact-fit bucket agrees with the per-item driver
   (SERVE_FIT_TOL); a 128-frame diff chunk runs again bit-identical and on
   the CPU with the card's noise (pitch bins replayed, CSV_TOL); a B=16 x
   T=512 diff chunk is profiled (host, busy, K1's and HiFi-GAN's shares).
   Then the serve CLI in a subprocess over the same requests as JSONL, with
   ``--warmup --workers 2 --max-wait-ms 100`` and again with ``--fast-io``
   (unwarmed, every other request): all served, 16-bit wavs bit-identical
   across the two runs and batch
   mode, no shape added after warmup; latency p50/p99 and chunk fill. Then
   the same requests on int8 weights (``serve_quant_int8``): bytes against
   float32 and the largest mel_out difference. K1 is held against its plain
   version at B=16 and T 256-1536 with ragged masks.
9. in-place path: CampNet, A3T and EditSpeech (``infer/editors.py``) in
   turn at their shipped widths (``egs/{campnet,a3t,editspeech}.yaml``),
   each from a port checkpoint of seeded weights written here, on the run
   path's phone set and the infer path's HiFi-GAN: the CSV edit API over
   the infer path's four requests (wavs, launches an edit, the same request
   twice bit-identical, frames outside the mask the source's); the batch
   server (``BatchedInPlaceEditServer``, 16 rows a chunk, default buckets),
   warmed, over the serve path's 32 requests (each CampNet chunk launches
   K3 9 times, the other families nothing; results finite with the
   source's frames outside the mask; requests/s, audio s/s, fill, peak
   memory); one request alone, in its chunk and at another row
   bit-identical, and at its exact-fit bucket with max_batch 1 the
   per-item driver's mel and wav bit for bit; a profiled B=16 x T=512
   chunk (host, busy, K3's and HiFi-GAN's shares); a 128-frame chunk run
   again bit-identical and on the CPU (EditSpeech's splice frames
   replayed and counted, INPLACE_CPU_TOL). CampNet also online through the
   serve CLI (``--warmup``, every other request; wavs bit-identical to
   batch mode's) and
   EditSpeech on int8 weights. K3 is held against its plain version and
   timed beside SDPA at CampNet's decoder shapes (B=16, T 256-1536, h=2,
   d=96, ragged key padding) in the kernels phase.
10. family train path: StutterSpeech, its stutter predictor, CampNet,
   A3T and EditSpeech in turn through the training entry at their shipped
   widths (``egs/<family>.yaml``) over one synthetic corpus of 128/16/2
   utterances of 150-700 frames with per-frame stutter labels (spans on
   about 10 % of the frames), with the infer path's HiFi-GAN: 12 steps, a
   validation of 2 batches and a checkpoint, then ``--infer`` of the 2
   test items from that checkpoint (loaded bit for bit). Every step,
   validation batch and item moves each launch counter by its expected
   amount (StutterSpeech K1 and K5 20 a step, CampNet K3 and K4 9, the
   others nothing); metrics are finite; the predictor's text encoder
   starts as StutterSpeech's checkpoint's ``fs.encoder`` bit for bit and
   its ``meta.csv`` holds the block labels; a StutterSpeech and a CampNet
   step re-run on the CPU agree. Step host p50/p75, steps/s, peak memory
   and a profiled median step are printed. K4 is held against its plain
   version and timed beside SDPA's backward at CampNet's decoder shapes in
   the kernels phase. Then the same five under ``-hp use_bf16=true``:
   10 steps, a validation batch (float32, as JAX validates) and a
   checkpoint of float32 masters each; every step launches the bf16 forms
   (StutterSpeech K1 and K5 20 times, CampNet K3 and K4 9), every
   validation batch the float32 ones; a CampNet step re-run on the CPU
   agrees at the BF16_* bars; EditSpeech's profiled step runs its LSTMs
   through cuDNN's recurrence (``aten::_cudnn_rnn``), not a per-step cell.
11. width override: one bf16 step of ``egs/spec_denoiser.yaml`` at ``-hp
   residual_channels=128``, a width K1 and K5 are compiled for beside the
   shipped 256, DiffNet's output projection drawn non-zero so that the
   blocks get a gradient: the bf16 K1 and K5 launch 20 times each, and the
   step agrees with the CPU's (BF16_* bars). A DiffNet block, attentions
   (160-wide heads; float16) and a mel outside their kernels' envelopes
   raise on the card (no caller gives way to a plain version there).
12. switches: ``egs/spec_denoiser.yaml`` as shipped through the training
   entry on the run path's corpus under each of the editing configs'
   remaining switches: ``ref_pad_compat``, ``no_diffusion`` and
   ``use_masked_cond=false`` in float32, ``accumulate_grad_batches=2`` in
   bf16 as the yaml ships it; 4 updates each, a validation batch and a
   checkpoint. Every update moves the counters by K1 and K5 20 times (the
   bf16 forms 40 under accumulation, two microbatches an update), the
   DiffNet blocks run without a mask under ``ref_pad_compat`` alone; a
   2-utterance update (two microbatches under accumulation) of each on the
   card and on the CPU agrees (STEP_* or BF16_* bars); one ``--infer`` item
   under ``no_diffusion`` launches K1 20 times (one DiffNet call). K1 (with
   h) and K5 without a mask, float32 and bf16, against their plain versions
   at the ``ref_pad_compat`` run's median batch, and timed there without the
   mask beside with it.
13. GAN train: HiFi-GAN V1 through the training entry on
   ``egs/hifigan.yaml`` as shipped (the full MPD and MSD, 16 crops of 8192
   samples a batch) over a synthetic mel + wav corpus of 64/4/2 utterances:
   10 steps, a validation batch and a checkpoint, a resume to 12 (both nets
   and both Adam states bit for bit), ``--infer`` (copy synthesis) of the 2
   test items; the trained work dir loads through ``infer/vocoder.py``'s
   HiFi-GAN and vocodes a mel bit for bit as the generator does; one B=2 GAN
   step on the card and on the CPU agrees; step times, peak memory and a
   profiled step. No kernel of the port runs on this path (cuDNN's
   convolutions and cuBLAS's DFT products).
14. data: the offline pipeline on a raw vctk-layout corpus of 24 synthetic
   utterances of 1.5-6 s at 22,050 Hz over 3 speakers, with TextGrids
   written here in place of the aligner's and a resemblyzer-format
   checkpoint of seeded weights in ``VOICE_ENCODER_CKPT``: ``python -m
   speech_editing_tpu_torch.data.align_and_binarize --skip-align`` on
   ``egs/spec_denoiser.yaml`` (in process, ``N_PROC=1``): the speaker
   encoder runs on the card once for every item and no kernel of the port
   runs; every stored embedding is the encoder's, and each utterance
   re-embedded on the CPU agrees within DATA_TOL; then one step of the
   shipped config (``use_spk_embed: true``, bf16, the loader in process)
   on the new corpus launches the bf16 K1 and K5 20 times each; each
   stage's seconds and the encoder's device time an utterance (CUDA
   events around its forward).
15. evals: ``evals.get_metrics`` and the ``evals.batch_tools`` command
   lines (mcd, pitch, pitch --dtw, stats, separate) over the infer path's
   ``generated_*_test``: every number finite.

``python3 chip_smoke.py --time-attention`` builds K3 and K4 only and times
them, float32 and bf16 (the flagship step's, CampNet's and the holes
shapes), beside SDPA at those shapes, with each kernel's TFLOP/s and share
of its bound and the SASS counts, with no checks; ``--time-mel`` does the same
for K2 at the edit shape beside the cuFFT composite, and ``--time-diffnet``
for the bf16 K1 (with h) and K5 at the bf16 run step's B=16 x T=446 and
the bf16 flagship step's B=78 x T=512 beside their cuBLAS composites. Run
from a copy of another commit, each times that commit's kernels in the
same call.

Float32 but for the bf16 phases, with TF32 off for matrix products and
cuDNN convolutions and bf16 products reduced in float32, so the card and
the CPU compute the same function. The second-to-last line is
``{"kernels": [...]}``, the last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import glob
import io
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F
from scipy.io import wavfile

import speech_editing_tpu_torch.models.editspeech as editspeech_module
import speech_editing_tpu_torch.models.fs as fs_module
import speech_editing_tpu_torch.modules.wavenet as wavenet_module
from speech_editing_tpu_torch.config.flagship import FLAGSHIP_HP, HIFIGAN_V1_HP
from speech_editing_tpu_torch.config.hparams import (arg_parser, dump_yaml, load_config,
                                                     set_hparams)
from speech_editing_tpu_torch.data.align_and_binarize import main as align_and_binarize_main
from speech_editing_tpu_torch.data.binarizer import BaseBinarizer
from speech_editing_tpu_torch.data.indexed_dataset import IndexedDataset, IndexedDatasetBuilder
from speech_editing_tpu_torch.data.preprocess import BasePreprocessor
from speech_editing_tpu_torch.evals import batch_tools
from speech_editing_tpu_torch.evals import get_metrics
from speech_editing_tpu_torch.infer.edit import EditPipeline
from speech_editing_tpu_torch.infer.editors import A3TInfer, CampNetInfer, EditSpeechInfer
from speech_editing_tpu_torch.infer.serve import _load_request as load_request
from speech_editing_tpu_torch.infer.serving import BatchedEditServer, BatchedInPlaceEditServer
from speech_editing_tpu_torch.infer.spec_denoiser import (SpecDenoiserInfer, request_generator,
                                                          request_noise)
from speech_editing_tpu_torch.infer.vocoder import HifiGAN, get_vocoder_cls
from speech_editing_tpu_torch.models.vocoder.hifigan import HifiGanGenerator
from speech_editing_tpu_torch.models.voice_encoder import (VoiceEncoder, VoiceEncoderCtx,
                                                           load_voice_encoder, seeded_state_dict)
from speech_editing_tpu_torch.ops.cuda import build
from speech_editing_tpu_torch.ops.cuda.diffnet_block import (RSQRT2, WIDTHS, _conv_input,
                                                             _fits64, _shift, _tile_plan,
                                                             _tile_plan_bf16, diffnet_block,
                                                             diffnet_block_bwd,
                                                             diffnet_block_bwd_plain,
                                                             diffnet_block_plain,
                                                             diffnet_block_train)
from speech_editing_tpu_torch.modules.transformer import MultiheadAttention
from speech_editing_tpu_torch.modules.wavenet import DiffNetResidualBlock
from speech_editing_tpu_torch.ops.cuda.mel_kernel import mel_spectrogram
from speech_editing_tpu_torch.ops.flash_attention import (attention_bwd_plain,
                                                          attention_lse_plain,
                                                          attention_plain, flash_mha,
                                                          flash_mha_bwd,
                                                          flash_mha_train)
from speech_editing_tpu_torch.ops.mel import MelConfig, mel_bases
from speech_editing_tpu_torch.ops.mel import mel_spectrogram as mel_plain
from speech_editing_tpu_torch.run import run as run_entry
from speech_editing_tpu_torch.run import task_class
from speech_editing_tpu_torch.training.checkpoint import save_checkpoint
from speech_editing_tpu_torch.training.tasks.spec_denoiser import SpecDenoiserTask
from speech_editing_tpu_torch.training.tasks.stutter_speech import StutterPredictorTask
from speech_editing_tpu_torch.training.trainer import Trainer, float32_on_card
from speech_editing_tpu_torch.utils.audio.dsp import stft_window, wav2spec
from speech_editing_tpu_torch.utils.audio.io import save_wav
from speech_editing_tpu_torch.utils.init import init_like_flax
from speech_editing_tpu_torch.utils.multiprocess import ResultSaverPool
from speech_editing_tpu_torch.utils.text.processors import (_FallbackG2p,
                                                            get_txt_processor_cls, txt_to_ph)
from speech_editing_tpu_torch.utils.text.text_encoder import build_token_encoder, is_sil_phoneme

PEAK_FP32_FLOPS = 67e12     # H100 SXM, float32 outside the tensor cores
# H100 SXM, float32-accurate products on the tensor cores: three TF32
# products each (3xTF32, as K1 and K5 run them) at 495 TFLOP/s dense
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_HBM_BYTES = 3.35e12    # H100 SXM, bytes/s
PEAK_BF16_FLOPS = 989e12    # H100 SXM, bf16 products on the tensor cores, dense
SR, HOP = 22050, 256
REQUEST_FRAMES = (512, 300, 700)
# each kernel's launch counter: its wrapper and the attribute it counts in
# (K1, K3, K4 and K5 count their float32 and bf16 forms apart)
COUNTERS = {"diffnet_block": (diffnet_block, "launches"),
            "diffnet_block_bf16": (diffnet_block, "launches_bf16"),
            "diffnet_block_bwd": (diffnet_block_bwd, "launches"),
            "diffnet_block_bwd_bf16": (diffnet_block_bwd, "launches_bf16"),
            "mel_spectrogram": (mel_spectrogram, "launches"),
            "flash_mha": (flash_mha, "launches"), "flash_mha_bf16": (flash_mha, "launches_bf16"),
            "flash_mha_bwd": (flash_mha_bwd, "launches"),
            "flash_mha_bwd_bf16": (flash_mha_bwd, "launches_bf16")}
NO_LAUNCH = {k: 0 for k in COUNTERS}
EXPECTED_PER_REQUEST = dict(
    NO_LAUNCH, diffnet_block=FLAGSHIP_HP["residual_layers"] * FLAGSHIP_HP["timesteps"],
    mel_spectrogram=1, flash_mha=FLAGSHIP_HP["enc_layers"])
EXPECTED_PER_STEP = dict(
    NO_LAUNCH, diffnet_block=FLAGSHIP_HP["residual_layers"],
    diffnet_block_bwd=FLAGSHIP_HP["residual_layers"], flash_mha=FLAGSHIP_HP["enc_layers"],
    flash_mha_bwd=FLAGSHIP_HP["enc_layers"])
# the flagship's step under use_bf16: the bf16 forms of all four
EXPECTED_PER_BF16_TRAIN_STEP = dict(
    NO_LAUNCH, diffnet_block_bf16=FLAGSHIP_HP["residual_layers"],
    diffnet_block_bwd_bf16=FLAGSHIP_HP["residual_layers"],
    flash_mha_bf16=FLAGSHIP_HP["enc_layers"], flash_mha_bwd_bf16=FLAGSHIP_HP["enc_layers"])
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
# the bf16 kernels against their bf16 plain versions: two bf16 ulps of the
# largest element (an f32 sum in another order flips a rounding; measured
# up to 4.9e-3 on the card); K1 + K5 against autograd of the bf16 plain
# forward, which rounds its backward at other places: four ulps (9.1e-3 on
# the CPU)
BF16_TOL, BF16_AUTOGRAD_TOL = 2.0 ** -6, 2.0 ** -5
# a bf16 step on the card against the CPU's: the same bf16 arithmetic, the
# f32 sums in another order, so the bars come from this comparison's own
# readings (on the H100, after 1 to 35 steps: loss terms 7.6e-4-4.3e-3
# relative; the worst gradient 2.8e-2-4.1e-2 and the median 4.7e-3-6.4e-3 in
# relative L2; Adam moments 1.8e-3-3.3e-2; Adam directions 7.8e-3-2.6e-2 at
# worst, median 5.8e-5-8.7e-4), 2.3-4 times over. An Adam step moves an
# element by lr times u = m^ / (sqrt(v^) + eps), which rounding can flip only
# where m is near 0. At the warmup's lr (under 1e-6) the float32 parameter's
# own rounding hides the step, so u is compared, from each side's moments:
# on the elements whose first moment is at least half its tensor's largest
# on the CPU (away from a flip), within BF16_STEP_RTOL of the CPU's. At most
# BF16_FLIPS of all elements moved apart by half their move (0.0007-0.0036
# measured)
BF16_LOSS_RTOL, BF16_GRAD_L2, BF16_GRAD_L2_MEDIAN = 1e-2, 0.1, 0.02
BF16_STEP_RTOL, BF16_FLIPS = 0.1, 0.01


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


def bound(flops: float, n_bytes: float, peak: float = PEAK_3XTF32_FLOPS) -> tuple[float, str]:
    """The least time for the work: its float32 FLOP at ``peak`` (by default
    the 3xTF32 tensor-core rate, the fastest float32-accurate rate of the
    card, for products) or its bytes at the HBM rate, whichever is longer,
    in ms."""
    t_ops, t_bytes = flops / peak, n_bytes / PEAK_HBM_BYTES
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

def block_inputs(gen, b: int, t: int = 512, ragged: bool = False, widths=None):
    """A DiffNet block's inputs at the flagship width (or ``widths``, (C,
    H)), the last row with a 37-frame padded tail, or with ``ragged`` each
    row but the first padded from a length drawn in [t/5, t], as a collated
    batch of utterances is: (x, cond, step, mask, weights)."""
    c, h = widths or (FLAGSHIP_HP["residual_channels"], FLAGSHIP_HP["hidden_size"])
    r = lambda *s, scale=1.0: torch.randn(*s, device="cuda", generator=gen) * scale
    x, cond, step = r(b, t, c), r(b, t, h, scale=0.5), r(b, c, scale=0.3)
    mask = torch.ones(b, t, device="cuda")
    if ragged:
        lengths = torch.randint(t // 5, t + 1, (b,), device="cuda", generator=gen)
        lengths[0] = t
        mask = (torch.arange(t, device="cuda")[None] < lengths[:, None]).float()
    else:
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


def run_block_shapes():
    """The run path's block shapes, [max_sentences, T] at dilation 1 with
    every row padded to its own length: T = 700 (the corpus's longest;
    64-row tiles with a ragged last tile), 500 (64-row tiles, ragged) and
    300 (16-row tiles, ragged)."""
    return [(RUN_B, t, 1) for t in (RUN_MAX_T, 500, 300)]


def plan_text(name: str, b: int, t: int, dilation: int, form: str = "f32",
              c: int = FLAGSHIP_HP["residual_channels"],
              h: int = FLAGSHIP_HP["hidden_size"]) -> str:
    """The tile plan the wrapper of K1 or K5 picks for its ``form`` ("f32":
    rows and K1's split; "bf16": 64-row tiles, K1's split or the cluster
    that shares the weights) at C=``c``, H=``h``."""
    if form == "bf16":
        split, share = _tile_plan_bf16(b, t, c, name == "diffnet_block")
        return (f"64-row tiles x cluster {split} splitting the gate columns" if split > 1
                else f"64-row tiles x cluster {share} sharing the weights")
    rows, cluster = _tile_plan(b, t, _fits64(name, dilation, form, c, h), c)
    split = cluster > 1 and name == "diffnet_block"
    return f"{rows}-row tiles{f' x cluster {cluster}' if split else ''}"


def check_block_widths(gen) -> dict:
    """K1 and K5, float32 and bf16, against their plain versions at the
    widths they are compiled for beside the flagship's (``WIDTHS``): at B=1
    x T=300 (16-row tiles, the largest cluster C allows), at B=4 x T=509
    with dilation 2 and at B=16 x T=512 (64-row tiles), rows padded to
    their own lengths (B=4, 16), K1 with h. The float32
    forms at 1e-4 (K1, absolute) and BWD_TOL (K5, of the largest), the
    bf16 forms at BF16_TOL; returns the worst error of each kernel."""
    worst = dict.fromkeys(("diffnet_block", "diffnet_block_bf16", "diffnet_block_bwd",
                           "diffnet_block_bwd_bf16"), 0.0)
    flagship = (FLAGSHIP_HP["residual_channels"], FLAGSHIP_HP["hidden_size"])
    for (c, h), dtype, (b, t, dilation, ragged) in itertools.product(
            [w for w in WIDTHS if w != flagship], (torch.float32, torch.bfloat16),
            ((1, 300, 1, False), (4, 509, 2, True), (16, 512, 1, True))):
        bf = dtype == torch.bfloat16
        x, cond, step, mask, w = block_inputs(gen, b, t, ragged, (c, h))
        x, cond, step, mask = (v.to(dtype) for v in (x, cond, step, mask))
        w = tuple(v.to(dtype) for v in w)
        got = diffnet_block(x, cond, step, mask, *w, dilation=dilation, return_h=True)
        ref = diffnet_block_plain(x, cond, step, mask, *w, dilation=dilation, return_h=True)
        dxo, dsk = (torch.randn(b, t, c, device="cuda", generator=gen).to(dtype)
                    for _ in range(2))
        args = (got[2], dxo, dsk, mask, w[0], w[4], dilation)
        got_b, ref_b = diffnet_block_bwd(*args), diffnet_block_bwd_plain(*args)
        torch.cuda.synchronize()
        f = lambda ts: [v.float() for v in ts]
        err = (rel_err(f(got), f(ref)) if bf
               else max(float((g - e).abs().max()) for g, e in zip(got, ref)))
        err_b = rel_err(f(got_b), f(ref_b))
        tol, tol_b = (BF16_TOL, BF16_TOL) if bf else (1e-4, BWD_TOL)
        suffix, form = ("_bf16", "bf16") if bf else ("", "f32")
        plan = plan_text("diffnet_block", b, t, dilation, form, c, h)
        print(f"[kernel] C={c} H={h} {form} B={b} T={t} dilation={dilation}"
              f"{', rows padded to their own lengths' if ragged else ''}: diffnet_block "
              f"({plan}) err {err:.3e} (tol {tol:.3e}), diffnet_block_bwd err {err_b:.3e} "
              f"(tol {tol_b:.3e})", flush=True)
        check(err <= tol and err_b <= tol_b,
              f"C={c} H={h} {dtype} B={b}: errors {err}, {err_b}")
        worst["diffnet_block" + suffix] = max(worst["diffnet_block" + suffix], err)
        worst["diffnet_block_bwd" + suffix] = max(worst["diffnet_block_bwd" + suffix], err_b)
    return worst


def phase_diffnet_block(gen) -> dict:
    """K1 against its plain version at the edit's requests (B=1, T = 512,
    300, 700), at B=4 with dilation 1, 2 and 3 (3 at T=509, a ragged last
    tile), at B=16 with dilation 8 (whose 64-row tiles do not fit), at the
    train shape with h and at the run path's shapes (every row padded to
    its own length) with h and without; timed at the edit shape warm and
    L2-cold, and at the train shape, with the device time, device
    operations and host time of one call at both."""
    c, h = FLAGSHIP_HP["residual_channels"], FLAGSHIP_HP["hidden_size"]
    tol, out = 1e-4, {"max_abs_err": 0.0}
    flops = lambda b, t: 2 * b * t * 2 * c * (3 * c + h + c)
    check_wide_dilation("diffnet_block", 16, 512, 8)
    shapes = [(b, t, d, False, b == TRAIN_B)   # the train path's form: h written too
              for b, t, d in ((1, 512, 1), (1, 300, 1), (1, 700, 1), (4, 512, 1), (4, 512, 2),
                              (4, 509, 3), (16, 512, 8), (TRAIN_B, 512, 1))]
    shapes += [(b, t, d, True, train) for b, t, d in run_block_shapes() for train in (True, False)]
    for b, t, dilation, ragged, train in shapes:
        x, cond, step, mask, w = block_inputs(gen, b, t, ragged)
        call = lambda fn: fn(x, cond, step, mask, *w, dilation=dilation, return_h=train)
        got, ref = call(diffnet_block), call(diffnet_block_plain)
        torch.cuda.synchronize()
        err = max(float((g - e).abs().max()) for g, e in zip(got, ref))
        msg = (f"[kernel] diffnet_block B={b} T={t} C={c} H={h} dilation={dilation}"
               f"{' (with h)' if train else ''}"
               f"{', rows padded to their own lengths' if ragged else ''}, "
               f"{plan_text('diffnet_block', b, t, dilation)}: max_abs_err={err:.3e} "
               f"(tol {tol})")
        check(err <= tol, f"diffnet_block B={b} T={t} d={dilation}: error {err} > {tol}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if (b, t) in ((1, 512), (TRAIN_B, 512)):
            ms = time_ms(lambda: call(diffnet_block))
            plain_ms = time_ms(lambda: call(diffnet_block_plain))
            bound_ms, bound_by = bound(flops(b, t), nbytes(x, cond, step, mask, *w, *got))
            device_ms, ops = profile_calls(lambda: call(diffnet_block))
            us = host_us(lambda: call(diffnet_block))
            msg += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                    f"({bound_by}); {rate(flops(b, t), ms, bound_ms)}; {device_ms:.4f} ms "
                    f"device, {ops} device ops a call, host {us:.1f} us a call")
            if train:
                out.update(train_ms=ms, train_plain_ms=plain_ms, train_bound_ms=bound_ms,
                           train_device_ms=device_ms, train_ops_per_call=ops, train_host_us=us)
            else:
                out.update(warm_ms=ms, warm_plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, host_us=us, device_ms=device_ms, ops_per_call=ops)
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
    path's B=78, there also with the device time, device operations and
    host time of one call; against its plain version also at B=16 with
    dilation 8, whose 64-row tiles do not fit, and at the run path's
    shapes (every row padded to its own length)."""
    c, out = FLAGSHIP_HP["residual_channels"], {"max_abs_err": 0.0}
    check_wide_dilation("diffnet_block_bwd", 16, 512, 8)
    shapes = [(b, t, d, False) for b, t, d in ((4, 512, 1), (4, 512, 2), (4, 509, 3),
                                               (16, 512, 8), (TRAIN_B, 512, 1))]
    shapes += [(b, t, d, True) for b, t, d in run_block_shapes()]
    for b, t, dilation, ragged in shapes:
        x, cond, step, mask, w = block_inputs(gen, b, t, ragged)
        dxo, dsk = (torch.randn(b, t, c, device="cuda", generator=gen) for _ in range(2))
        _, _, h = diffnet_block(x, cond, step, mask, *w, dilation=dilation,
                                return_h=True)
        args = (h, dxo, dsk, mask, w[0], w[4], dilation)
        got, ref = diffnet_block_bwd(*args), diffnet_block_bwd_plain(*args)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        msg = (f"[kernel] diffnet_block_bwd B={b} T={t} C={c} dilation={dilation}"
               f"{', rows padded to their own lengths' if ragged else ''}, "
               f"{plan_text('diffnet_block_bwd', b, t, dilation)}: max err vs plain {err:.3e}")
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
        if (b, t) in ((4, 512), (TRAIN_B, 512)) and dilation == 1:
            ms = time_ms(lambda: diffnet_block_bwd(*args))
            plain_ms = time_ms(lambda: diffnet_block_bwd_plain(*args))
            flops = 16 * b * t * c * c
            bound_ms, bound_by = bound(flops, nbytes(h, dxo, dsk, mask, w[0], w[4], *got))
            msg += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {bound_ms:.4f} ms ({bound_by}); {rate(flops, ms, bound_ms)}")
            if b == TRAIN_B:
                device_ms, ops = profile_calls(lambda: diffnet_block_bwd(*args))
                us = host_us(lambda: diffnet_block_bwd(*args))
                msg += (f"; {device_ms:.4f} ms device, {ops} device ops a call, "
                        f"host {us:.1f} us a call")
                out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           device_ms=device_ms, ops_per_call=ops, host_us=us)
        print(msg + f" (tol {BWD_TOL}, relative to the reference's max)", flush=True)
    return dict(out, name="diffnet_block_bwd", route="cuda",
                source="speech_editing_tpu_torch/csrc/diffnet_block_bwd.cu",
                replaces="speech_editing_tpu/ops/pallas/diffnet_block.py:231",
                tol=BWD_TOL, library_ms=None)


# the bf16 run step's median batch (PERF.md section 5): B=16 x T=446, each
# row padded to its own length
BF16_B, BF16_T = 16, 446


def bf16_block_inputs(gen, b: int, t: int, ragged: bool = False):
    """:func:`block_inputs` in bf16, the mask too, as the bf16 step feeds K1."""
    x, cond, step, mask, w = block_inputs(gen, b, t, ragged)
    bf = torch.bfloat16
    return x.to(bf), cond.to(bf), step.to(bf), mask.to(bf), tuple(v.to(bf) for v in w)


def bf16_rate(flops: float, ms: float, bound_ms: float) -> str:
    if ms <= 0:
        return "no device time measured"
    tflops = flops / ms / 1e9
    return (f"{tflops:.1f} TFLOP/s ({tflops * 1e12 / PEAK_BF16_FLOPS:.3f} of the bf16 "
            f"tensor-core rate), {bound_ms / ms:.3f} of the bound")


def time_bf16_call(out: dict, call, plain, composite, flops: float, n_bytes: int,
                   prefix: str = "") -> str:
    """Event time, the plain version's, the bound (bf16 FLOP at 989 TFLOP/s
    or bytes at the HBM rate), device ms and operations a call and host us
    a call of ``call``, and the event and device times of its cuBLAS
    ``composite`` (the yardstick: no one PyTorch call computes the
    function), into ``out`` under ``prefix``; returns their text."""
    t = call_times(call, composite)
    plain_ms = time_ms(plain)
    bound_ms, bound_by = bound(flops, n_bytes, PEAK_BF16_FLOPS)
    out.update({prefix + k: v for k, v in dict(
        ms=t["ms"], plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        device_ms=t["device_ms"], ops_per_call=t["ops_per_call"], host_us=t["host_us"],
        gflop=flops / 1e9, mbytes=n_bytes / 1e6, cublas_ms=t["library_ms"],
        cublas_device_ms=t["library_device_ms"],
        cublas_ops_per_call=t["library_ops_per_call"]).items()})
    return (f"; plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
            f"{flops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f} MB); {times_text(t, CUBLAS)}; device "
            f"{bf16_rate(flops, t['device_ms'], bound_ms)}")


CUBLAS = "cublas composite (bf16 products, elementwise gate: several calls)"


def cublas_block(x, cond, step, mask, w, dilation: int):
    """K1's yardstick in bf16: the im2col product [B T, 3C + H] @ [3C + H,
    2C] (cuBLAS), the gate, g @ Wo and the residual, as PyTorch calls; the
    stacked weight made once, outside the timed call."""
    wd, bd, wc, bc, wo, bo = w
    c = x.shape[-1]
    w1, b1 = torch.cat([wd, wc]), bd + bc

    def run():
        a = torch.cat([_conv_input(x, step, mask, dilation), cond], -1).flatten(0, 1)
        h = torch.addmm(b1, a, w1)
        g = torch.sigmoid(h[:, :c]) * torch.tanh(h[:, c:])
        o = torch.addmm(bo, g, wo)
        return (x.flatten(0, 1) + o[:, :c]) * RSQRT2, o[:, c:], h
    return run


def cublas_block_bwd(h, dxo, dsk, mask, wd, wo, dilation: int):
    """K5's yardstick in bf16: do @ Wo^T, the gate backward, dh @ Wd^T
    (cuBLAS) and the shift-scatter, as PyTorch calls."""
    b, t, c = dxo.shape

    def run():
        do = torch.cat([dxo * RSQRT2, dsk], -1).flatten(0, 1)
        dg = do @ wo.t()
        hf = h.flatten(0, 1)
        s, th = torch.sigmoid(hf[:, :c]), torch.tanh(hf[:, c:])
        dh = torch.cat([dg * th * s * (1 - s), dg * s * (1 - th * th)], -1)
        dy3 = (dh @ wd.t()).view(b, t, 3 * c)
        dy = (_shift(dy3[..., :c], dilation) + dy3[..., c:2 * c]
              + _shift(dy3[..., 2 * c:], -dilation))
        return dy * mask[..., None] + dxo * RSQRT2, dh, s * th
    return run


def phase_diffnet_block_bf16(gen) -> dict:
    """K1's bf16 form against its bf16 plain version at the edit's lengths
    (B=1, T = 512, 300, 700), at B=4 with dilation 1, 2 and 3 (T=509, rows
    padded to their own lengths), at the bf16 run step's median batch (B=16
    x T=446, ragged, with h) and at the bf16 flagship step's (B=78 x
    T=512, ragged, with h); timed at the last two beside its cuBLAS
    composite (the run step's also beside the float32 form)."""
    c, h = FLAGSHIP_HP["residual_channels"], FLAGSHIP_HP["hidden_size"]
    out = {"max_abs_err": 0.0}
    flops = lambda b, t: 2 * b * t * 2 * c * (3 * c + h + c)
    shapes = [(1, 512, 1, False, False), (1, 300, 1, False, False), (1, 700, 1, False, False),
              (4, 509, 1, True, False), (4, 509, 2, True, False), (4, 509, 3, True, False),
              (BF16_B, BF16_T, 1, True, True), (TRAIN_B, TRAIN_T, 1, True, True)]
    for b, t, dilation, ragged, train in shapes:
        x, cond, step, mask, w = bf16_block_inputs(gen, b, t, ragged)
        call = lambda fn: fn(x, cond, step, mask, *w, dilation=dilation, return_h=train)
        got, ref = call(diffnet_block), call(diffnet_block_plain)
        torch.cuda.synchronize()
        check(all(g.dtype == torch.bfloat16 for g in got), "diffnet_block bf16: not bf16")
        err = rel_err([g.float() for g in got], [e.float() for e in ref])
        msg = (f"[kernel] diffnet_block bf16 B={b} T={t} dilation={dilation}"
               f"{' (with h)' if train else ''}"
               f"{', rows padded to their own lengths' if ragged else ''}, "
               f"{plan_text('diffnet_block', b, t, dilation, 'bf16')}: max err {err:.3e} of "
               f"the plain version's largest (tol {BF16_TOL:.3e})")
        check(err <= BF16_TOL, f"diffnet_block bf16 B={b} T={t} d={dilation}: error {err}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if train:
            msg += time_bf16_call(out, lambda: call(diffnet_block),
                                  lambda: call(diffnet_block_plain),
                                  cublas_block(x, cond, step, mask, w, dilation), flops(b, t),
                                  nbytes(x, cond, step, mask, *w, *got),
                                  "train_" if b == TRAIN_B else "")
        if train and b == BF16_B:
            f32 = [v.float() for v in (x, cond, step, mask, *w)]
            f32_ms = time_ms(lambda: diffnet_block(*f32, dilation=1, return_h=True))
            out["f32_ms"] = f32_ms
            msg += f"; the float32 form at this shape {f32_ms:.4f} ms"
        print(msg, flush=True)
    return dict(out, name="diffnet_block_bf16", route="cuda",
                source="speech_editing_tpu_torch/csrc/diffnet_block.cu",
                replaces="speech_editing_tpu/ops/pallas/diffnet_block.py:139",
                tol=BF16_TOL, library_ms=None)


def phase_diffnet_block_bwd_bf16(gen) -> dict:
    """K5's bf16 form against its bf16 plain version at B=4 with dilation 2
    and 3 (T=509), at the bf16 run step's median batch (B=16 x T=446) and
    at the bf16 flagship step's (B=78 x T=512), rows padded to their own
    lengths; at the run step's also K1 + K5 (the autograd Function) against
    autograd of the bf16 plain forward; timed at the last two beside its
    cuBLAS composite."""
    c, out = FLAGSHIP_HP["residual_channels"], {"max_abs_err": 0.0}
    for b, t, dilation in ((4, 509, 2), (4, 509, 3), (BF16_B, BF16_T, 1), (TRAIN_B, TRAIN_T, 1)):
        x, cond, step, mask, w = bf16_block_inputs(gen, b, t, ragged=True)
        dxo, dsk = (torch.randn(b, t, c, device="cuda", generator=gen).to(torch.bfloat16)
                    for _ in range(2))
        h = diffnet_block(x, cond, step, mask, *w, dilation=dilation, return_h=True)[2]
        args = (h, dxo, dsk, mask, w[0], w[4], dilation)
        got, ref = diffnet_block_bwd(*args), diffnet_block_bwd_plain(*args)
        torch.cuda.synchronize()
        err = rel_err([g.float() for g in got], [e.float() for e in ref])
        check(err <= BF16_TOL, f"diffnet_block_bwd bf16 B={b} d={dilation}: error {err}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        msg = (f"[kernel] diffnet_block_bwd bf16 B={b} T={t} dilation={dilation}, rows padded "
               f"to their own lengths, {plan_text('diffnet_block_bwd', b, t, dilation, 'bf16')}"
               f": max err vs plain {err:.3e} (tol {BF16_TOL:.3e})")
        if b == BF16_B:
            leaves = [a.detach().requires_grad_() for a in (x, cond, step, *w)]

            def grads(block):
                lx, lc, ls, *lw = leaves
                outs = block(lx, lc, ls, mask, *lw, dilation=dilation)
                return [g.float() for g in torch.autograd.grad(outs, leaves, (dxo, dsk))]
            err_ag = rel_err(grads(diffnet_block_train), grads(diffnet_block_plain))
            check(err_ag <= BF16_AUTOGRAD_TOL, f"diffnet_block_bwd bf16 autograd: {err_ag}")
            out["autograd_err"] = err_ag
            msg += (f", K1 + K5 vs autograd of the plain forward {err_ag:.3e} (tol "
                    f"{BF16_AUTOGRAD_TOL:.3e})")
        if b in (BF16_B, TRAIN_B):
            msg += time_bf16_call(out, lambda: diffnet_block_bwd(*args),
                                  lambda: diffnet_block_bwd_plain(*args),
                                  cublas_block_bwd(*args), 16 * b * t * c * c,
                                  nbytes(h, dxo, dsk, mask, w[0], w[4], *got),
                                  "train_" if b == TRAIN_B else "")
        print(msg, flush=True)
    return dict(out, name="diffnet_block_bwd_bf16", route="cuda",
                source="speech_editing_tpu_torch/csrc/diffnet_block_bwd.cu",
                replaces="speech_editing_tpu/ops/pallas/diffnet_block.py:231",
                tol=BF16_TOL, library_ms=None)


# K2's shapes (batch, samples, hop): the edit's three requests, a ragged
# last tile at B=4, and hop 128
MEL_SHAPES = ((1, 512 * HOP, HOP), (1, 300 * HOP, HOP), (1, 700 * HOP, HOP),
              (4, 256 * 130 + 17, HOP), (1, 512 * HOP, 128))
MEL_TOL, MEL_MEAN_TOL = 2e-2, 2e-3   # log10 units, the Pallas kernel's test bars
CUFFT = "cufft composite (stft, abs, mel product, log10: several calls)"


def cufft_mel(wav, cfg):
    """K2's yardstick on the same inputs: ``torch.stft`` (cuFFT), magnitude,
    mel product and log10, a composite of several PyTorch calls; the port
    never calls it."""
    window = torch.tensor(stft_window(cfg.window, cfg.win_length, cfg.fft_size),
                          dtype=torch.float32, device=wav.device)
    fb_t = torch.from_numpy(mel_bases(cfg)[2]).to(wav.device)

    def run():
        spec = torch.stft(wav, cfg.fft_size, cfg.hop_size, window=window, center=True,
                          pad_mode="constant", return_complex=True)
        return torch.log10(torch.clamp(spec.abs().transpose(1, 2) @ fb_t, min=cfg.eps))
    return run


def mel_work(cfg, frames: int) -> tuple[float, float]:
    """K2's least work over ``frames`` frames in FLOP: a real FFT at 2.5 n
    log2 n a frame, 4 a bin for the magnitude, 2 a non-zero filterbank
    weight. Beside it the TPU formulation's count, by which K2 was bounded
    while it computed dense DFT products: two such products and a dense mel
    product."""
    n, n_bins = cfg.fft_size, cfg.fft_size // 2 + 1
    nnz = np.count_nonzero(mel_bases(cfg)[2])
    fft = frames * (2.5 * n * np.log2(n) + 4 * n_bins + 2 * nnz)
    dense = frames * (2 * 2 * n * n_bins + 2 * n_bins * cfg.num_mels)
    return float(fft), float(dense)


def edit_wav():
    """bench.py's 131072-sample utterance, the edit path's K2 input."""
    return torch.tensor(utterance(512 * HOP, seed=0), device="cuda")[None]


def phase_mel() -> dict:
    """K2 against its plain version at MEL_SHAPES (max and mean error in
    log10); at the edit shape its event time, device time, device operations
    (which must be 1) and host time a call, beside the plain version and the
    cuFFT composite, and its share of the bound, counted as the function's
    least work at the fp32 CUDA-core rate (the old DFT-product count once
    beside it)."""
    out = {"max_abs_err": 0.0, "shapes": []}
    for b, n, hop in MEL_SHAPES:
        cfg = MelConfig(hop_size=hop)
        wav = torch.tensor(np.stack([utterance(n, seed=i) for i in range(b)]), device="cuda")
        got, ref = mel_spectrogram(wav, cfg), mel_plain(wav, cfg)
        torch.cuda.synchronize()
        err, mean_err = float((got - ref).abs().max()), float((got - ref).abs().mean())
        print(f"[kernel] mel_spectrogram B={b} N={n} hop={hop} ({got.shape[1]} frames): "
              f"max_abs_err={err:.3e} (tol {MEL_TOL}), mean_abs_err={mean_err:.3e} "
              f"(tol {MEL_MEAN_TOL})", flush=True)
        check(err <= MEL_TOL, f"mel_spectrogram B={b} N={n} hop={hop}: error {err} > {MEL_TOL}")
        check(mean_err <= MEL_MEAN_TOL, f"mel_spectrogram B={b} N={n} hop={hop}: mean error "
                                        f"{mean_err} > {MEL_MEAN_TOL}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["shapes"].append(dict(b=b, n=n, hop=hop, max_err=err, mean_err=mean_err))

    cfg, wav = MelConfig(), edit_wav()
    got, cufft = mel_spectrogram(wav, cfg), cufft_mel(wav, cfg)
    cufft_err = float((cufft() - got).abs().max())
    t = call_times(lambda: mel_spectrogram(wav, cfg), cufft)
    check_one_op("mel_spectrogram", t)
    plain_ms = time_ms(lambda: mel_plain(wav, cfg))
    n_bins = cfg.fft_size // 2 + 1
    fft_flops, dense_flops = mel_work(cfg, got.shape[1])
    io = nbytes(wav, got)
    bound_ms, bound_by = bound(fft_flops, io, PEAK_FP32_FLOPS)
    basis_bytes = 4 * (2 * cfg.fft_size * n_bins + n_bins * cfg.num_mels)
    old_ms, old_by = bound(dense_flops, io + basis_bytes)
    print(f"[kernel] mel_spectrogram B=1 N={wav.shape[1]}: {times_text(t, CUFFT)}; plain "
          f"{plain_ms:.4f} ms; the composite's max |diff| from the kernel {cufft_err:.3e}; "
          f"bound {bound_ms:.6f} ms ({bound_by}: {fft_flops / 1e6:.2f} MFLOP at the fp32 "
          f"CUDA-core rate, {io / 1e6:.3f} MB), {bound_ms / t['device_ms']:.3f} of the device "
          f"time, {bound_ms / t['ms']:.3f} of the event time; the old DFT-product count "
          f"{old_ms:.6f} ms ({old_by}: {dense_flops / 1e9:.3f} GFLOP at 3xTF32, "
          f"{(io + basis_bytes) / 1e6:.2f} MB with the bases), {old_ms / t['device_ms']:.3f} "
          f"of the device time", flush=True)
    return dict(out, name="mel_spectrogram", route="cuda",
                source="speech_editing_tpu_torch/csrc/mel_kernel.cu",
                replaces="speech_editing_tpu/ops/pallas/mel_kernel.py:53", tol=MEL_TOL,
                ms=t["ms"], device_ms=t["device_ms"], ops_per_call=t["ops_per_call"],
                host_us=t["host_us"], plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                old_bound_ms=old_ms, library_ms=None, cufft_ms=t["library_ms"],
                cufft_device_ms=t["library_device_ms"],
                cufft_ops_per_call=t["library_ops_per_call"])


def time_mel(gen=None) -> None:
    """``--time-mel``: K2 as the installed package builds it, timed at the
    edit shape beside the cuFFT composite with no checks, so that two
    versions of the package can be timed in one call; one JSON line."""
    cfg, wav = MelConfig(), edit_wav()
    t = call_times(lambda: mel_spectrogram(wav, cfg), cufft_mel(wav, cfg))
    print(f"[time] mel_spectrogram B=1 N={wav.shape[1]}: {times_text(t, CUFFT)}", flush=True)
    print(json.dumps({"mel_times": t}))


PROFILE_EDGE_S = 0.05
MARKER = "bitwise_not"     # the marker kernel's name holds this; no measured call's does


def profiled(run) -> tuple[list, float]:
    """``torch.profiler``'s events by name (``key_averages``) over one call
    of ``run``, after one profiled warm-up call, and the ms the device was
    busy in that call (``device_busy_ms``). The profiler keeps a device
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
    return list(prof.key_averages()), device_busy_ms(prof.events())


def device_busy_ms(events) -> float:
    """The union of the device operations' intervals in ms: kernels on
    different streams (cuDNN runs some convolutions on its own) overlap,
    so their summed time can exceed the time the device was busy."""
    total, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in device_ops(events)):
        if b > end:
            total, end = total + b - max(a, end), b
    return total / 1e3


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
        ops = device_ops(profiled(run)[0])
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
# CampNet's coarse decoder self-attention in a serving chunk: B=16 frame rows
# at the serving buckets, h=2, d=96 (egs/campnet.yaml's hidden 192), each
# row but the first padded from its own length
CAMPNET_B, CAMPNET_T, CAMPNET_H = 16, (256, 512, 1024, 1536), 2
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
    out["campnet_shapes"] = [check_attention_at(gen, CAMPNET_B, t, tol) for t in CAMPNET_T]
    out["max_abs_err"] = max([out["max_abs_err"]] + [r["max_err"] for r in out["campnet_shapes"]])

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


def campnet_lengths(b: int, t: int) -> list[int]:
    """A serving chunk's frame counts: the first row fills the bucket, the
    others fall evenly to 40% of it."""
    return [t] + [int(t * (1 - 0.6 * i / (b - 1))) for i in range(1, b)]


def check_attention_at(gen, b: int, t: int, tol: float) -> dict:
    """K3 at a CampNet decoder shape (ragged key padding) against its plain
    version, timed beside SDPA with the same padding, with its bound."""
    h, d = CAMPNET_H, 192 // CAMPNET_H
    lengths = campnet_lengths(b, t)
    q, k, v, pad = attention_inputs(gen, b, t, lengths, d=d, h=h)
    got = flash_mha(q, k, v, pad)
    err = float((got - attention_plain(q, k, v, pad)).abs().max())
    torch.cuda.synchronize()
    times = call_times(lambda: flash_mha(q, k, v, pad), sdpa_fwd(q, k, v, pad))
    plain_ms = time_ms(lambda: attention_plain(q, k, v, pad), iters=5)
    flops = 4 * h * t * d * sum(lengths)       # q k^T and p v over valid keys
    bound_ms, bound_by = bound(flops, nbytes(q, k, v, pad, got))
    print(f"[kernel] flash_mha B={b} T={t} h={h} d={d} (CampNet's decoder self-attention), "
          f"valid keys {min(lengths)}..{max(lengths)}: max err {err:.3e} (absolute, tol {tol}); "
          f"{times_text(times, 'sdpa')}; plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by}, {flops / 1e9:.2f} GFLOP); device "
          f"{rate(flops, times['device_ms'], bound_ms)}", flush=True)
    check(err <= tol, f"flash_mha B={b} T={t} d={d}: error {err} > {tol}")
    check_one_op(f"flash_mha B={b} T={t}", times)
    return dict(times, b=b, s=t, h=h, d=d, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, gflop=flops / 1e9, max_err=err)


def attention_inputs(gen, b: int, s: int, lengths, d: int | None = None, h: int | None = None):
    h = h or FLAGSHIP_HP["num_heads"]
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


def check_attention_bwd_at(gen, b: int, t: int) -> dict:
    """K4 at a CampNet decoder shape (ragged key padding; 64-key tiles and
    dQ CTAs) against its plain version, K3 + K4 against autograd of the
    plain forward, pad keys' dk and dv zero; timed beside SDPA's backward,
    with its bound: 10 h T d sum(len) FLOP (five products over the valid
    keys) at the 3xTF32 rate against its bytes at the HBM rate."""
    h, d = CAMPNET_H, 192 // CAMPNET_H
    lengths = campnet_lengths(b, t)
    q, k, v, pad = attention_inputs(gen, b, t, lengths, d=d, h=h)
    do = torch.randn_like(q)
    err, err_ag, got, args = bwd_errors(q, k, v, pad, do)
    pad_zero = bool((got[1][pad] == 0).all() and (got[2][pad] == 0).all())
    times = call_times(lambda: flash_mha_bwd(*args), sdpa_bwd(q, k, v, do, pad))
    plain_ms = time_ms(lambda: attention_bwd_plain(*args), iters=5)
    flops = 10 * h * t * d * sum(lengths)
    bound_ms, bound_by = bound(flops, nbytes(*args, *got))
    worst = max(err, err_ag)
    print(f"[kernel] flash_mha_bwd B={b} T={t} h={h} d={d} (CampNet's decoder self-attention "
          f"in training), valid keys {min(lengths)}..{max(lengths)}: max err vs plain "
          f"{err:.3e}, vs autograd of the plain forward {err_ag:.3e} (tol {BWD_TOL}, relative "
          f"to the reference's max); pad keys' dk, dv exactly 0: {pad_zero}; "
          f"{times_text(times, 'sdpa backward')}; plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}, {flops / 1e9:.2f} GFLOP); device "
          f"{rate(flops, times['device_ms'], bound_ms)}", flush=True)
    check(worst <= BWD_TOL, f"flash_mha_bwd B={b} T={t} d={d}: error {worst} > {BWD_TOL}")
    check(pad_zero, f"flash_mha_bwd B={b} T={t}: pad keys got nonzero dk or dv")
    check_one_op(f"flash_mha_bwd B={b} T={t}", times)
    return dict(times, b=b, s=t, h=h, d=d, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, gflop=flops / 1e9, max_err=worst)


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
    out["campnet_shapes"] = [check_attention_bwd_at(gen, CAMPNET_B, t) for t in CAMPNET_T]
    out["max_abs_err"] = max([out["max_abs_err"]] + [r["max_err"] for r in out["campnet_shapes"]])

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


def bf16_attention_shapes() -> list:
    """The bf16 attention phases' shapes, (B, T, valid keys, h, d): the bf16
    flagship step's (B=78 x S=48, the train batch's token counts) first,
    then CampNet's decoder at B=16 and T 256-1536 (ragged key padding)."""
    h = FLAGSHIP_HP["num_heads"]
    return ([(TRAIN_B, TRAIN_S, train_lengths(), h, FLAGSHIP_HP["hidden_size"] // h)]
            + [(CAMPNET_B, t, campnet_lengths(CAMPNET_B, t), CAMPNET_H, 192 // CAMPNET_H)
               for t in CAMPNET_T])


def bf16_attention_inputs(gen, b: int, s: int, lengths, d: int, h: int):
    q, k, v, pad = attention_inputs(gen, b, s, lengths, d=d, h=h)
    return q.bfloat16(), k.bfloat16(), v.bfloat16(), pad


# a key mask with holes at CampNet's T=1024: about one key in five padded
# inside each ragged row, keys 448-511 of row 0 (a whole 64-key tile in its
# middle) padded, row 1 only pad keys
HOLES_T, HOLES_TILE = 1024, (448, 512)


def holes_inputs(gen):
    h, d = CAMPNET_H, 192 // CAMPNET_H
    q, k, v, pad = bf16_attention_inputs(gen, CAMPNET_B, HOLES_T,
                                         campnet_lengths(CAMPNET_B, HOLES_T), d, h)
    pad = pad | (torch.rand(pad.shape, device="cuda", generator=gen) < 0.2)
    pad[0, HOLES_TILE[0]:HOLES_TILE[1]] = True
    pad[1] = True
    return q, k, v, pad


def bf16_attention_cases(gen) -> list:
    """The bf16 attention phases' cases, (label, q, k, v, pad, timed): the
    shapes of bf16_attention_shapes, a row of only pad keys and a head
    width that is not a multiple of 16 (untimed), and the key mask with
    holes."""
    cases = [(f"B={b} T={s} h={h} d={d}, valid keys {min(lengths)}..{max(lengths)}",
              *bf16_attention_inputs(gen, b, s, lengths, d, h), True)
             for b, s, lengths, h, d in bf16_attention_shapes()]
    cases += [(f"B=3 S=48 d={d}, valid keys {lengths}",
               *bf16_attention_inputs(gen, 3, 48, lengths, d, 2), False)
              for lengths, d in ((PAD_ROW_LENGTHS, FLAGSHIP_HP["hidden_size"] // 2),
                                 (NARROW_LENGTHS, NARROW_D))]
    q, k, v, pad = holes_inputs(gen)
    return cases + [(f"B={CAMPNET_B} T={HOLES_T} d={q.shape[3]} with holes (keys "
                     f"{HOLES_TILE[0]}-{HOLES_TILE[1] - 1} of row 0 and all of row 1 "
                     f"padded; {int((~pad).sum())} valid keys of {pad.numel()})",
                     q, k, v, pad, True)]


def live_rows(pad) -> list:
    """The batch rows with a valid key."""
    return [i for i in range(pad.shape[0]) if not bool(pad[i].all())]


def attention_work(q, pad, backward: bool = False) -> float:
    """The FLOP of K3 (q k^T and p v, 4 h T d a valid key) or K4 (five
    products, 10 h T d) over the valid keys of this mask."""
    _, t, h, d = q.shape
    return (10 if backward else 4) * h * t * d * int((~pad).sum())


def phase_attention_bf16(gen) -> dict:
    """K3's bf16 form (with its float32 logsumexp, as the bf16 training
    steps call it) against its bf16 plain version at the bf16 flagship
    step's shape and at CampNet's decoder shapes, timed beside SDPA in bf16
    and the float32 form; then a row of only pad keys, a head width of 36
    and a key mask with holes (timed too). The row of the kernel table is
    the flagship step's shape."""
    out, shapes = {"max_abs_err": 0.0}, []
    for label, q, k, v, pad, timed in bf16_attention_cases(gen):
        got, lse = flash_mha(q, k, v, pad, return_lse=True)
        ref, ref_lse = attention_plain(q, k, v, pad), attention_lse_plain(q, k, pad)
        torch.cuda.synchronize()
        check(got.dtype == torch.bfloat16 and lse.dtype == torch.float32,
              f"flash_mha bf16: out {got.dtype}, lse {lse.dtype}")
        rows = live_rows(pad)
        err = rel_err([got[rows].float(), lse[rows]], [ref[rows].float(), ref_lse[rows]])
        zero = all(bool((got[i] == 0).all() and (lse[i] == float("-inf")).all())
                   for i in range(q.shape[0]) if i not in rows)
        msg = (f"[kernel] flash_mha bf16 {label} with logsumexp: max err {err:.3e} of the bf16 "
               f"plain version's largest (tol {BF16_TOL:.3e}); rows with no valid key give out 0 "
               f"and lse -inf: {zero}")
        check(err <= BF16_TOL and zero, f"flash_mha bf16 {label}: error {err}, zero rows {zero}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if timed:
            t = call_times(lambda: flash_mha(q, k, v, pad, return_lse=True), sdpa_fwd(q, k, v, pad))
            plain_ms = time_ms(lambda: (attention_plain(q, k, v, pad),
                                        attention_lse_plain(q, k, pad)), iters=5)
            f32 = [a.float() for a in (q, k, v)]
            f32_ms = time_ms(lambda: flash_mha(*f32, pad, return_lse=True))
            flops = attention_work(q, pad)
            bound_ms, bound_by = bound(flops, nbytes(q, k, v, pad, got, lse), PEAK_BF16_FLOPS)
            msg += (f"; {times_text(t, 'sdpa bf16')}; float32 form {f32_ms:.4f} ms; plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}, {flops / 1e9:.2f} "
                    f"GFLOP at the bf16 rate); device {bf16_rate(flops, t['device_ms'], bound_ms)}")
            check_one_op(f"flash_mha bf16 {label}", t)
            b, s, h, d = q.shape[0], q.shape[1], q.shape[2], q.shape[3]
            shapes.append(dict(t, b=b, s=s, h=h, d=d, plain_ms=plain_ms, f32_ms=f32_ms,
                               bound_ms=bound_ms, bound_by=bound_by, gflop=flops / 1e9,
                               max_err=err))
        print(msg, flush=True)
    out.update(shapes[0], shapes=shapes)
    return dict(out, name="flash_mha_bf16", route="cuda",
                source="speech_editing_tpu_torch/csrc/flash_attention.cu",
                replaces="speech_editing_tpu/ops/flash_attention.py:85 (in bf16)",
                tol=BF16_TOL)


def phase_attention_bwd_bf16(gen) -> dict:
    """K4's bf16 form (fed K3's bf16 output and logsumexp) against its bf16
    plain version, K3 + K4 against autograd of the bf16 plain forward (which
    rounds its backward at other places), pad keys' dk and dv zero, the
    same inputs twice bit-identical, at the bf16 flagship step's shape and
    CampNet's decoder shapes; timed beside SDPA's backward in bf16 and the
    float32 form; then a row of only pad keys, a head width of 36 and a key
    mask with holes (timed too)."""
    out, shapes = {"max_abs_err": 0.0}, []
    for label, q, k, v, pad, timed in bf16_attention_cases(gen):
        do = torch.randn_like(q)
        rows = live_rows(pad)
        o, lse = flash_mha(q, k, v, pad, return_lse=True)
        args = (q, k, v, o, lse, do, pad)
        got, again, ref = flash_mha_bwd(*args), flash_mha_bwd(*args), attention_bwd_plain(*args)
        torch.cuda.synchronize()
        check(all(g.dtype == torch.bfloat16 for g in got), "flash_mha_bwd bf16: not bf16")
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        err = rel_err([g.float() for g in got], [r.float() for r in ref])
        leaves = [a.detach().requires_grad_() for a in (q, k, v)]
        grads = lambda attend: [g[rows].float() for g in
                                torch.autograd.grad(attend(*leaves, pad), leaves, do)]
        err_ag = rel_err(grads(flash_mha_train), grads(attention_plain))
        zero = bool((got[1][pad] == 0).all() and (got[2][pad] == 0).all()) and all(
            bool((g[i] == 0).all()) for g in got for i in range(q.shape[0]) if i not in rows)
        msg = (f"[kernel] flash_mha_bwd bf16 {label}: max err vs the bf16 plain version "
               f"{err:.3e} (tol {BF16_TOL:.3e}), K3 + K4 vs autograd of the plain forward "
               f"{err_ag:.3e} (tol {BF16_AUTOGRAD_TOL:.3e}); pad keys' dk, dv and rows with no "
               f"valid key exactly 0: {zero}; two runs bit-identical: {same}")
        check(err <= BF16_TOL and err_ag <= BF16_AUTOGRAD_TOL and zero and same,
              f"flash_mha_bwd bf16 {label}: {err}, {err_ag}, zero {zero}, bit-identical {same}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["autograd_err"] = max(out.get("autograd_err", 0.0), err_ag)
        if timed:
            t = call_times(lambda: flash_mha_bwd(*args), sdpa_bwd(q, k, v, do, pad))
            plain_ms = time_ms(lambda: attention_bwd_plain(*args), iters=5)
            f32 = [a.float() for a in (q, k, v)]
            o32, lse32 = flash_mha(*f32, pad, return_lse=True)
            f32_ms = time_ms(lambda: flash_mha_bwd(*f32, o32, lse32, do.float(), pad))
            flops = attention_work(q, pad, backward=True)
            bound_ms, bound_by = bound(flops, nbytes(*args, *got), PEAK_BF16_FLOPS)
            msg += (f"; {times_text(t, 'sdpa backward bf16')}; float32 form {f32_ms:.4f} ms; "
                    f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}, "
                    f"{flops / 1e9:.2f} GFLOP at the bf16 rate); device "
                    f"{bf16_rate(flops, t['device_ms'], bound_ms)}")
            check_one_op(f"flash_mha_bwd bf16 {label}", t)
            b, s, h, d = q.shape[0], q.shape[1], q.shape[2], q.shape[3]
            shapes.append(dict(t, b=b, s=s, h=h, d=d, plain_ms=plain_ms, f32_ms=f32_ms,
                               bound_ms=bound_ms, bound_by=bound_by, gflop=flops / 1e9,
                               max_err=err, autograd_err=err_ag))
        print(msg, flush=True)
    worst_ag = out["autograd_err"]
    out.update(shapes[0], shapes=shapes, autograd_err=worst_ag)
    return dict(out, name="flash_mha_bwd_bf16", route="cuda",
                source="speech_editing_tpu_torch/csrc/flash_attention_bwd.cu",
                replaces="speech_editing_tpu/ops/flash_attention.py:85 (the bundled "
                         "kernel's _flash_attention_bwd_dkv :941 and _bwd_dq :1287, in bf16)",
                tol=BF16_TOL)


def sass_counts(name: str) -> dict:
    """Tensor-core instructions in the SASS of ``csrc/<name>.cu``'s library
    (``cuobjdump --dump-sass``), summed over its bf16 kernels (namespace
    ``bf16_form``) and its float32 ones: HGMMA (wgmma) and HMMA
    (mma.sync)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts = {form: {"HGMMA": 0, "HMMA": 0} for form in ("bf16", "float32")}
    for function in sass.split("Function : ")[1:]:
        form = counts["bf16" if "bf16_form" in function.splitlines()[0] else "float32"]
        for op in form:
            form[op] += function.count(op)
    return counts


def print_sass(names=("flash_attention", "flash_attention_bwd", "diffnet_block",
                      "diffnet_block_bwd")) -> dict:
    counts = {name: sass_counts(name) for name in names}
    for name, c in counts.items():
        print(f"[build] {name} SASS: bf16 kernels {c['bf16']['HGMMA']} HGMMA (wgmma), "
              f"{c['bf16']['HMMA']} HMMA (mma.sync); float32 kernels {c['float32']['HMMA']} HMMA",
              flush=True)
    return counts


def time_attention(gen) -> None:
    """``--time-attention``: K3 and K4 as the installed package builds them,
    float32 and bf16, timed at the phases' shapes (bf16: the flagship step's,
    CampNet's T 256-1536 and the key mask with holes) with no checks, each
    beside SDPA with its achieved TFLOP/s and share of the bound, so that
    two versions of the package can be timed in one call; one JSON line."""
    rows = []
    for (b, s, lengths, with_lse), (_, _, bwd_lengths) in zip(FWD_SHAPES, BWD_SHAPES):
        q, k, v, pad = attention_inputs(gen, b, s, lengths or train_lengths())
        fwd = call_times(lambda: flash_mha(q, k, v, pad, return_lse=with_lse),
                         sdpa_fwd(q, k, v, pad))
        out = flash_mha(q, k, v, pad, return_lse=with_lse)
        fwd_flops = attention_work(q, pad)
        fwd_bound, _ = bound(fwd_flops, nbytes(q, k, v, pad, *(out if with_lse else (out,))))
        q, k, v, pad = attention_inputs(gen, b, s, bwd_lengths or train_lengths())
        do = torch.randn_like(q)
        o, lse = flash_mha(q, k, v, pad, return_lse=True)
        bwd = call_times(lambda: flash_mha_bwd(q, k, v, o, lse, do, pad),
                         sdpa_bwd(q, k, v, do, pad))
        bwd_flops = attention_work(q, pad, True)
        bwd_bound, _ = bound(bwd_flops, nbytes(q, k, v, o, lse, do, pad, q, k, v))   # + dq, dk, dv
        print(f"[time] B={b} S={s}: flash_mha{' with logsumexp' if with_lse else ''} "
              f"{times_text(fwd, 'sdpa')}; device {rate(fwd_flops, fwd['device_ms'], fwd_bound)}; "
              f"flash_mha_bwd {times_text(bwd, 'sdpa backward')}; device "
              f"{rate(bwd_flops, bwd['device_ms'], bwd_bound)}", flush=True)
        rows.append({"b": b, "s": s, "flash_mha": fwd, "flash_mha_bwd": bwd})
    bf16_cases = [(f"B={b} T={s}", *bf16_attention_inputs(gen, b, s, lengths, d, h))
                  for b, s, lengths, h, d in bf16_attention_shapes()]
    bf16_cases.append((f"B={CAMPNET_B} T={HOLES_T} with holes", *holes_inputs(gen)))
    for label, q, k, v, pad in bf16_cases:
        fwd = call_times(lambda: flash_mha(q, k, v, pad, return_lse=True), sdpa_fwd(q, k, v, pad))
        o, lse = flash_mha(q, k, v, pad, return_lse=True)
        do = torch.randn_like(q)
        bwd = call_times(lambda: flash_mha_bwd(q, k, v, o, lse, do, pad),
                         sdpa_bwd(q, k, v, do, pad))
        fwd_flops, bwd_flops = attention_work(q, pad), attention_work(q, pad, True)
        fwd["bound_ms"], _ = bound(fwd_flops, nbytes(q, k, v, pad, o, lse), PEAK_BF16_FLOPS)
        # the outputs dq, dk, dv are the sizes of q, k, v
        bwd["bound_ms"], _ = bound(bwd_flops, nbytes(q, k, v, o, lse, do, pad, q, k, v),
                                   PEAK_BF16_FLOPS)
        print(f"[time] bf16 {label}: flash_mha {times_text(fwd, 'sdpa bf16')}; device "
              f"{bf16_rate(fwd_flops, fwd['device_ms'], fwd['bound_ms'])}; flash_mha_bwd "
              f"{times_text(bwd, 'sdpa backward bf16')}; device "
              f"{bf16_rate(bwd_flops, bwd['device_ms'], bwd['bound_ms'])}", flush=True)
        rows.append({"bf16": label, "flash_mha": fwd, "flash_mha_bwd": bwd})
    print(json.dumps({"attention_times": rows,
                      "sass": print_sass(("flash_attention", "flash_attention_bwd"))}))


def time_diffnet(gen) -> None:
    """``--time-diffnet``: the bf16 K1 (with h) and K5 as the installed
    package builds them, timed at the bf16 run step's median batch (B=16 x
    T=446) and the bf16 flagship step's (B=78 x T=512), rows padded to
    their own lengths, with no checks, each beside its cuBLAS composite
    with its achieved TFLOP/s and share of the bound, so that two versions
    of the package can be timed in one call; one JSON line."""
    c, h_n = FLAGSHIP_HP["residual_channels"], FLAGSHIP_HP["hidden_size"]
    rows = []
    for b, t in ((BF16_B, BF16_T), (TRAIN_B, TRAIN_T)):
        x, cond, step, mask, w = bf16_block_inputs(gen, b, t, ragged=True)
        k1 = lambda: diffnet_block(x, cond, step, mask, *w, dilation=1, return_h=True)
        got = k1()
        fwd = call_times(k1, cublas_block(x, cond, step, mask, w, 1))
        dxo, dsk = (torch.randn(b, t, c, device="cuda", generator=gen).to(torch.bfloat16)
                    for _ in range(2))
        args = (got[2], dxo, dsk, mask, w[0], w[4], 1)
        k5 = lambda: diffnet_block_bwd(*args)
        bwd = call_times(k5, cublas_block_bwd(*args))
        fwd_flops, bwd_flops = 2 * b * t * 2 * c * (3 * c + h_n + c), 16 * b * t * c * c
        fwd["bound_ms"], _ = bound(fwd_flops, nbytes(x, cond, step, mask, *w, *got),
                                   PEAK_BF16_FLOPS)
        bwd["bound_ms"], _ = bound(bwd_flops, nbytes(*args[:5], w[4], *k5()), PEAK_BF16_FLOPS)
        print(f"[time] bf16 B={b} T={t}: diffnet_block {times_text(fwd, CUBLAS)}; device "
              f"{bf16_rate(fwd_flops, fwd['device_ms'], fwd['bound_ms'])}; diffnet_block_bwd "
              f"{times_text(bwd, CUBLAS)}; device "
              f"{bf16_rate(bwd_flops, bwd['device_ms'], bwd['bound_ms'])}", flush=True)
        rows.append({"b": b, "t": t, "diffnet_block_bf16": fwd, "diffnet_block_bwd_bf16": bwd})
    print(json.dumps({"diffnet_times": rows,
                      "sass": print_sass(("diffnet_block", "diffnet_block_bwd"))}))


# -- edit path -------------------------------------------------------------------

def reset_counts() -> None:
    """Launch counts to 0."""
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


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
    # flax zero-initializes DiffNet's output projection, which would hide the
    # blocks' output from the comparisons below; a trained model's is not zero
    out = pipe.model.denoise_fn.output_projection.weight
    out.data.copy_(torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
                   * (2 / out.shape[1]) ** 0.5)
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


def device_ops(events: list) -> list:
    """The profile's device operations by name, without the spans of
    annotations (the profiler step, the optimizer step), whose device time
    is that of the kernels inside them."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("ProfilerStep", "Optimizer."))]


def host_ops(events: list) -> list:
    """The profile's host operations by name (the CPU side: operators,
    CUDA runtime calls), without the annotation spans."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("ProfilerStep", "Optimizer."))]


def profile_edit(pipe, req, gen, edit_ms: float, top: int = 12) -> None:
    """Device time by kernel over one 512-frame edit (``torch.profiler``,
    after one profiled warm-up edit), and its share of ``edit_ms``, the
    edit's host-clock time without the profiler."""
    events, busy = profiled(lambda: pipe(*req, generator=gen))
    kernels = device_ops(events)
    if busy == 0:
        print("[profile] the profiler saw no device time: not measured", flush=True)
        return
    n_ops = sum(e.count for e in kernels)
    print(f"[profile] edit T=512: {n_ops} device operations, busy {busy:.3f} ms, "
          f"{busy / edit_ms:.3f} of the unprofiled edit's {edit_ms:.3f} ms "
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


def train_path(bf16: bool = False) -> tuple[dict, dict]:
    """The flagship's train step at B=78 x T=512, float32 or (``bf16``)
    under ``use_bf16``: TRAIN_WARMUP + TRAIN_TIMED steps, each launching
    its kernels' forms as expected; timed, profiled, and in float32 a B=2
    step re-run on the CPU."""
    label, expected = ("train bf16", EXPECTED_PER_BF16_TRAIN_STEP) if bf16 else \
        ("train", EXPECTED_PER_STEP)
    batch = train_batch(TRAIN_B, TRAIN_T, TRAIN_S, seed=0)
    real_frames = int((batch["mel2ph"] > 0).sum())
    trainer = Trainer.from_hp(dict(FLAGSHIP_HP, use_bf16=bf16), device="cuda", seed=0,
                              vocab_size=80, sil_token_ids=SIL_IDS)
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
              f"{label} step {i}: non-finite metrics {m}")
    totals = counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[{label}] launches per step {per_step[-1]}; totals {totals}", flush=True)
    for i, moved in enumerate(per_step):
        check(moved == expected, f"{label} step {i}: launches {moved} != expected {expected}")
    print(f"[{label}] last step: " + " ".join(f"{k}={v:.5f}" for k, v in sorted(m.items())),
          flush=True)
    q = lambda xs, p: float(np.percentile(xs, p))
    stats = {"batch": [TRAIN_B, TRAIN_T], "frames": TRAIN_B * TRAIN_T,
             "real_frames": real_frames, "timed_steps": TRAIN_TIMED,
             "event_ms_p50": q(ev_ms, 50), "event_ms_p75": q(ev_ms, 75),
             "host_ms_p50": q(host_ms, 50), "host_ms_p75": q(host_ms, 75),
             "peak_gib": peak_gib}
    stats["frames_per_s"] = stats["frames"] / (stats["event_ms_p50"] / 1e3)
    stats["real_frames_per_s"] = real_frames / (stats["event_ms_p50"] / 1e3)
    print(f"[{label}] B={TRAIN_B} x T={TRAIN_T} ({real_frames} real frames), "
          f"{TRAIN_TIMED} steps after {TRAIN_WARMUP} warm-up: CUDA events p50 "
          f"{stats['event_ms_p50']:.3f} ms, p75 {stats['event_ms_p75']:.3f} ms; host "
          f"clock p50 {stats['host_ms_p50']:.3f} ms, p75 {stats['host_ms_p75']:.3f} ms; "
          f"{stats['frames_per_s']:.0f} frames/s ({stats['real_frames_per_s']:.0f} real); "
          f"peak memory {peak_gib:.3f} GiB", flush=True)
    busy_ms = profile_step(trainer, batch, stats["host_ms_p50"], label=label)
    stats.update(launches_per_step=expected, profiled_busy_ms=busy_ms,
                 profiled_busy_share=None if busy_ms is None else busy_ms / stats["host_ms_p50"])
    if bf16:
        return totals, stats
    compare_step_with_cpu("train", lambda dev: Trainer.from_hp(
        FLAGSHIP_HP, device=dev, seed=1, vocab_size=80, sil_token_ids=SIL_IDS,
        dropout=False), trainer.train_step.state_dict(), {k: v[:2] for k, v in batch.items()})
    return totals, stats


# the kernels of csrc/ by their function names, with their template arguments
PORT_KERNEL = (r"(diffnet_block\w*|gate_bwd\w*|shift_scatter\w*|attention_(fwd|bwd)_kernel|"
               r"mel_kernel)(<[^>]*>)?")


def profile_step(trainer, batch, step_ms: float, top: int = 15,
                 label: str = "train", keep: list | None = None) -> float | None:
    """Device time by kernel over one train step (``torch.profiler``, after
    one profiled warm-up step), and its share of ``step_ms``, the step's
    host-clock time without the profiler; then the host's own time by
    operation (under the profiler, which adds to it). Returns the device's
    busy ms, None if the profiler saw none; the events go into ``keep``."""
    events, busy = profiled(lambda: trainer.step(batch))
    if keep is not None:
        keep.extend(events)
    kernels = device_ops(events)
    if busy == 0:
        print("[profile] the profiler saw no device time: not measured", flush=True)
        return None
    summed = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[profile] {label} step: {sum(e.count for e in kernels)} device operations, "
          f"{summed:.3f} ms of device time, busy {busy:.3f} ms, "
          f"{busy / step_ms:.3f} of the unprofiled step's "
          f"{step_ms:.3f} ms host clock", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
              f"{e.key[:90]}", flush=True)
    ours = [(re.search(PORT_KERNEL, e.key), e) for e in kernels]
    print(f"[profile] {label} step, the port's kernels: " + ("; ".join(
        f"{m.group(0)} {e.self_device_time_total / 1e3:.3f} ms {e.count}x"
        for m, e in ours if m) or "none"), flush=True)
    host = host_ops(events)
    print(f"[profile] {label} step, host: {sum(e.count for e in host)} operations and "
          f"runtime calls, {sum(e.self_cpu_time_total for e in host) / 1e3:.3f} ms of "
          f"their own host time under the profiler; the largest:", flush=True)
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:top]:
        print(f"[profile] {e.self_cpu_time_total / 1e3:9.3f} ms {e.count:5d}x "
              f"{e.key[:90]}", flush=True)
    return busy


@contextlib.contextmanager
def relu_branches(masks: list, replay: bool):
    """Within the block every ReLU (``torch.relu``, which ``F.relu`` and
    ``nn.ReLU`` call) records its branch, ``x > 0``, into ``masks`` in call
    order; with ``replay`` it takes the recorded branch instead of its own,
    ``x * mask``, and counts the inputs where the two differ. A gradient
    jumps where a ReLU's input crosses 0: two steps whose pre-activations
    differ by rounding can take different branches at an input within
    rounding of 0 and then differ there by far more than rounding. Yields
    ``[flips, calls]``."""
    orig, tally = torch.relu, [0, 0]

    def relu(x):
        if not replay:
            masks.append(x.detach() > 0)
            return orig(x)
        mask = masks[tally[1]].to(x.device)
        tally[0] += int(((x > 0) != mask).sum())
        tally[1] += 1
        return x * mask.to(x.dtype)

    torch.relu = relu
    try:
        yield tally
    finally:
        torch.relu = orig
    check(not replay or tally[1] == len(masks),
          f"relu_branches: {tally[1]} ReLU calls replayed {len(masks)} recorded ones")


def compare_step_with_cpu(label: str, make_twin, state: dict, sub,
                          diffusion: bool = True, bf16: bool = False) -> None:
    """One step on ``sub``, a 2-utterance batch (host arrays of the step's
    keys; a list of them: one accumulated update of those microbatches), on
    the card and on the CPU (plain versions): twins from
    ``make_twin(device)`` with dropout off load ``state`` and, with
    ``diffusion``, take the same diffusion draws, and the CPU's ReLUs take
    the card's branches (``relu_branches``), so both differentiate the same
    function; losses, gradients, updated parameters and Adam moments must
    agree: at the float32 tolerances (STEP_*), or with ``bf16`` (a bf16
    step, whose roundings an f32 sum in another order can flip) at the
    BF16_* bars, gradients and moments in relative L2."""
    gen = torch.Generator().manual_seed(7)
    micro = sub if isinstance(sub, list) else [sub]
    draws = []
    for batch in micro:
        b, t = batch["mels"].shape[:2]
        draws.append(dict(t=torch.randint(0, FLAGSHIP_HP["timesteps"] + 1, (b,), generator=gen),
                          noise=torch.randn(b, t, 80, generator=gen)) if diffusion else {})
    masks: list = []

    def run(dev: str, replay: bool) -> dict:
        twin = make_twin(dev)
        twin.train_step.load_state_dict(copy.deepcopy(state))
        on = [{k: v.to(dev) for k, v in d.items()} for d in draws]
        t0 = time.perf_counter()
        with relu_branches(masks, replay) as tally:
            if isinstance(sub, list):
                metrics = twin.train_step.accumulate([twin.to_device(m) for m in micro],
                                                     draws=on)
            else:
                metrics = twin.train_step(twin.to_device(sub), **on[0])
        secs = time.perf_counter() - t0
        step = twin.train_step
        named = dict(step.model.named_parameters())
        moment = lambda key: {n: step.optimizer.state[p][key].cpu()
                              for n, p in named.items()}
        group = step.optimizer.param_groups[0]
        adam = dict(count=float(step.optimizer.state[next(iter(named.values()))]["step"]),
                    betas=group["betas"], eps=group["eps"])
        return dict(secs=secs, metrics={k: float(v) for k, v in metrics.items()},
                    flips=tally[0], grads={n: p.grad.cpu() for n, p in named.items()},
                    params={n: p.detach().cpu() for n, p in named.items()},
                    exp_avg=moment("exp_avg"), exp_avg_sq=moment("exp_avg_sq"), adam=adam)

    gpu, cpu = (run(dev, replay=i == 1) for i, dev in enumerate(("cuda", "cpu")))
    if bf16:
        compare_bf16_step(label, gpu, cpu, state["model"], sum(m.numel() for m in masks))
        return
    n_relu = sum(m.numel() for m in masks)
    loss_err = max(abs(gpu["metrics"][k] - v) / max(abs(v), 1e-12)
                   for k, v in cpu["metrics"].items() if k != "nan_grads")
    worst = {key: max((rel_err([gpu[key][n]], [cpu[key][n]]), n) for n in cpu[key])
             for key in ("grads", "params", "exp_avg", "exp_avg_sq")}
    print(f"[{label}] B=2 step on the card vs the CPU ({cpu['secs']:.1f} s): loss terms "
          f"max rel err {loss_err:.3e} (tol {STEP_LOSS_RTOL}); gradients "
          f"{worst['grads'][0]:.3e} of each tensor's max (tol {STEP_GRAD_TOL}, worst "
          f"{worst['grads'][1]}); updated params {worst['params'][0]:.3e} (tol "
          f"{STEP_PARAM_TOL}); Adam moments {worst['exp_avg'][0]:.3e} / "
          f"{worst['exp_avg_sq'][0]:.3e} (tol {STEP_MOMENT_TOL}); loss "
          f"{gpu['metrics']['total_loss']:.6f} vs {cpu['metrics']['total_loss']:.6f}; ReLU "
          f"inputs on the other side of 0 on the CPU, given the card's branch: "
          f"{cpu['flips']} of {n_relu}", flush=True)
    check(loss_err <= STEP_LOSS_RTOL, f"[{label}] B=2 step: loss error {loss_err}")
    check(worst["grads"][0] <= STEP_GRAD_TOL, f"[{label}] B=2 step: gradient error {worst['grads']}")
    check(worst["params"][0] <= STEP_PARAM_TOL, f"[{label}] B=2 step: param error {worst['params']}")
    for key in ("exp_avg", "exp_avg_sq"):
        check(worst[key][0] <= STEP_MOMENT_TOL, f"[{label}] B=2 step: {key} error {worst[key]}")


def compare_bf16_step(label: str, gpu: dict, cpu: dict, before: dict, n_relu: int) -> None:
    """The BF16_* bars over one bf16 step's results on the card and the CPU
    (``compare_step_with_cpu``'s ``run``), from the parameters ``before``."""
    loss_err = max(abs(gpu["metrics"][k] - v) / max(abs(v), 1e-12)
                   for k, v in cpu["metrics"].items() if k != "nan_grads")
    l2 = lambda key: sorted((float((gpu[key][n] - cpu[key][n]).norm()
                                   / cpu[key][n].norm().clamp(min=1e-30)), n) for n in cpu[key])
    grads, m1, m2 = l2("grads"), l2("exp_avg"), l2("exp_avg_sq")
    median = grads[len(grads) // 2][0]
    adam = cpu["adam"]
    check(gpu["adam"] == adam, f"[{label}] bf16 step: Adam {gpu['adam']} != {adam}")
    (b1, b2), eps, k = adam["betas"], adam["eps"], adam["count"]
    direction = lambda side, n: (side["exp_avg"][n] / (1 - b1 ** k)) / (
        (side["exp_avg_sq"][n] / (1 - b2 ** k)).sqrt() + eps)
    worst_step, settled, rels, apart, total = (0.0, ""), 0, [], 0, 0
    for n, p_cpu in cpu["params"].items():
        m = cpu["exp_avg"][n].abs()
        big = m >= 0.5 * float(m.max())
        if float(m.max()) > 0:
            u_cpu = direction(cpu, n)[big]
            rel = (direction(gpu, n)[big] - u_cpu).abs() / u_cpu.abs()
            settled += rel.numel()
            rels.append(rel)
            worst_step = max(worst_step, (float(rel.max()), n))
        step_gpu = gpu["params"][n] - before[n].cpu()
        step_cpu = p_cpu - before[n].cpu()
        diff = (step_gpu - step_cpu).abs()
        apart += int((diff > 0.5 * torch.maximum(step_gpu.abs(), step_cpu.abs())).sum())
        total += diff.numel()
    median_step = float(torch.cat(rels).median())
    print(f"[{label}] B=2 bf16 step on the card vs the CPU ({cpu['secs']:.1f} s): loss terms "
          f"max rel err {loss_err:.3e} (tol {BF16_LOSS_RTOL}); gradients in relative L2 max "
          f"{grads[-1][0]:.3e} ({grads[-1][1]}), median {median:.3e} (tol {BF16_GRAD_L2}, "
          f"{BF16_GRAD_L2_MEDIAN}); Adam moments {m1[-1][0]:.3e} / {m2[-1][0]:.3e} (tol "
          f"{BF16_GRAD_L2}); Adam's direction m^ / (sqrt(v^) + eps) on the {settled} elements "
          f"whose first moment is at least half their tensor's largest: relative error median "
          f"{median_step:.3e}, worst {worst_step[0]:.3e} ({worst_step[1]}; tol "
          f"{BF16_STEP_RTOL}); updated params moved apart at {apart} of {total} elements "
          f"(tol {BF16_FLIPS}); loss {gpu['metrics']['total_loss']:.6f} vs "
          f"{cpu['metrics']['total_loss']:.6f}; ReLU inputs on the other side of 0 on the "
          f"CPU, given the card's branch: {cpu['flips']} of {n_relu}", flush=True)
    check(loss_err <= BF16_LOSS_RTOL, f"[{label}] bf16 step: loss error {loss_err}")
    check(grads[-1][0] <= BF16_GRAD_L2 and median <= BF16_GRAD_L2_MEDIAN,
          f"[{label}] bf16 step: gradient error {grads[-1]}, median {median}")
    check(max(m1[-1][0], m2[-1][0]) <= BF16_GRAD_L2,
          f"[{label}] bf16 step: moments {m1[-1]}, {m2[-1]}")
    check(settled > 0 and worst_step[0] <= BF16_STEP_RTOL,
          f"[{label}] bf16 step: Adam direction error {worst_step} on the settled elements")
    check(apart <= BF16_FLIPS * total, f"[{label}] bf16 step: {apart} of {total} apart")


# -- run path --------------------------------------------------------------------

# the synthetic corpus: VCTK-like utterances (150-700 frames, about 2-8 s at
# 22,050 Hz and hop 256), one phone per about 7 frames, 80 phones
RUN_SPLITS = {"train": 512, "valid": 32, "test": 8}
RUN_MIN_T, RUN_MAX_T, RUN_FRAMES_PER_PHONE = 150, 700, 7
RUN_SIL_PHONES = ["|", ",", ".", "?", "!", ";", "<BOS>"]
# every phone the fallback g2p writes, so the CSV edit API's phones are in the vocabulary
G2P_PHONES = sorted({p for _, phs in _FallbackG2p.DIGRAPHS for p in phs}
                    | {p for phs in _FallbackG2p.SINGLE.values() for p in phs} | {"AH0"})
RUN_PHONES = RUN_SIL_PHONES + G2P_PHONES + [
    f"P{i}" for i in range(80 - len(RUN_SIL_PHONES) - len(G2P_PHONES))]
RUN_SPEAKERS = 24
RUN_STEPS, RUN_RESUME_TO = 30, 35   # a validation and a checkpoint every RUN_STEPS / 2
RUN_HP = (f"use_bf16=False,max_updates={RUN_STEPS},val_check_interval={RUN_STEPS // 2},"
          "num_sanity_val_steps=2,eval_max_batches=8,tb_log_interval=10")
RUN_B = 16              # egs/base.yaml's max_sentences: 16 x 700 frames is under max_tokens
RUN_WARMUP = 5          # steps of the first run left out of its timings
RUN_LAYERS = FLAGSHIP_HP["residual_layers"]   # egs/spec_denoiser.yaml's, as the flagship's
EXPECTED_PER_RUN_STEP = dict(NO_LAUNCH, diffnet_block=RUN_LAYERS, diffnet_block_bwd=RUN_LAYERS)
EXPECTED_PER_VALID_BATCH = dict(EXPECTED_PER_RUN_STEP, diffnet_block_bwd=0)


def stutter_labels(rs, t: int) -> np.ndarray:
    """Per-frame stutter labels as the binarizer writes them (0 fluent, 1
    stutter): spans of 4-23 frames covering about 10 % of the frames."""
    lab = np.zeros(t, np.int64)
    for _ in range(max(1, round(0.1 * t / 13.5))):
        n = rs.randint(4, 24)
        start = rs.randint(0, t - n)
        lab[start:start + n] = 1
    return lab


def write_run_corpus(data_dir: str, seed: int = 0, splits: dict | None = None,
                     stutter: bool = False) -> int:
    """A binarized corpus with every key ``EditingDataset`` reads, written
    by the port's ``IndexedDatasetBuilder``: log-mel-like mels, phone
    tokens with a silence phone about one in four, monotonic mel2ph, raw
    f0 in Hz with 20 % unvoiced frames, coarse pitch, a 256-d speaker
    embedding per speaker, and with ``stutter`` per-frame stutter labels
    (``stutter_labels``); ``splits`` items a split (default RUN_SPLITS).
    Returns the bytes of mel written."""
    rs = np.random.RandomState(seed)
    os.makedirs(data_dir)
    with open(os.path.join(data_dir, "phone_set.json"), "w") as f:
        json.dump(RUN_PHONES, f)
    speakers = rs.randn(RUN_SPEAKERS, 256).astype(np.float32)
    n_sil = len(RUN_SIL_PHONES)
    mel_bytes = 0
    for split, n_items in (splits or RUN_SPLITS).items():
        builder = IndexedDatasetBuilder(os.path.join(data_dir, split))
        lengths = rs.randint(RUN_MIN_T, RUN_MAX_T + 1, n_items)
        for i, t in enumerate(lengths):
            s = max(2, int(t) // RUN_FRAMES_PER_PHONE)
            tokens = rs.randint(3 + n_sil, 3 + len(RUN_PHONES), s)
            sil = rs.rand(s) < 0.25
            tokens[sil] = rs.randint(3, 3 + n_sil, int(sil.sum()))
            bounds = np.sort(rs.choice(np.arange(1, t), s - 1, replace=False))
            mel2ph = np.searchsorted(bounds, np.arange(t), side="right") + 1
            f0 = rs.uniform(80, 300, t) * (rs.rand(t) >= 0.2)
            mel = (rs.randn(t, 80) * 0.5 - 1.0).astype(np.float32)
            mel_bytes += mel.nbytes
            item = {
                "item_name": f"{split}_{i}", "txt": "synthetic", "wav_fn": f"{split}_{i}.wav",
                "ph_token": tokens.astype(np.int64), "mel": mel,
                "mel2ph": mel2ph.astype(np.int64), "f0": f0.astype(np.float32),
                "pitch": rs.randint(1, 256, t).astype(np.int64),
                "spk_embed": speakers[rs.randint(RUN_SPEAKERS)]}
            if stutter:
                item["stutter_mel_mask"] = stutter_labels(rs, int(t))
            builder.add_item(item)
        builder.finalize()
        np.save(os.path.join(data_dir, f"{split}_lengths.npy"), lengths)
    return mel_bytes


class _TimedLoader:
    """A training loader whose every batch records the host's wait for it."""

    def __init__(self, loader, waits: list):
        self.loader, self.sampler, self.waits = loader, loader.sampler, waits

    def __iter__(self):
        return self._timed(iter(self.loader))   # starts the workers now, as the loader does

    def _timed(self, it):
        while True:
            t0 = time.perf_counter()
            try:
                raw = next(it)
            except StopIteration:
                return
            self.waits.append((time.perf_counter() - t0) * 1e3)
            yield raw

    def close(self) -> None:
        self.loader.close()


class RunRecorder:
    """Wraps ``Trainer``'s methods while the run entry trains, to record each
    step's CUDA-event and host-clock time, real frames, launches and
    metrics, each validation batch's launches, the loader waits, the
    validations', saves' and the resume's host time, and the state the
    resume loaded."""

    def __init__(self):
        self.steps, self.valid, self.waits = [], [], []
        self.validate_s, self.save_s, self.load_s = [], [], []
        self.loaded = None

    @contextlib.contextmanager
    def instrumented(self):
        names = ("step", "_eval_batch", "_loader", "validate", "save", "_build_state")
        orig = {name: getattr(Trainer, name) for name in names}
        rec = self

        def step(trainer, raw, *more):
            before = counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            metrics = orig["step"](trainer, raw, *more)
            end.record()
            end.synchronize()
            # copies, so the loader's pinned buffers go back to its cache
            raws = [{k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in r.items()}
                    for r in (raw, *more)]
            rec.steps.append(dict(
                host_ms=(time.perf_counter() - t0) * 1e3, event_ms=start.elapsed_time(end),
                frames=sum(int(r["mel_lengths"].sum()) for r in raws),
                shape=tuple(raw["mels"].shape[:2]),
                launches={k: counts()[k] - before[k] for k in COUNTERS},
                step=trainer.global_step, metrics=metrics, raw=raws[0], raws=raws))
            return metrics

        def eval_batch(trainer, raw):
            before = counts()
            metrics = orig["_eval_batch"](trainer, raw)
            torch.cuda.synchronize()
            rec.valid.append({k: counts()[k] - before[k] for k in COUNTERS})
            return metrics

        def loader(trainer, prefix, *args, **kwargs):
            made = orig["_loader"](trainer, prefix, *args, **kwargs)
            return _TimedLoader(made, rec.waits) if prefix == "train" else made

        def timed(name, into):
            def wrapper(trainer, *args, **kwargs):
                t0 = time.perf_counter()
                out = orig[name](trainer, *args, **kwargs)
                torch.cuda.synchronize()
                into.append(time.perf_counter() - t0)
                return out
            return wrapper

        def build_state(trainer):
            timed("_build_state", rec.load_s)(trainer)
            rec.loaded = copy.deepcopy(trainer.train_step.state_dict())

        patches = dict(step=step, _eval_batch=eval_batch, _loader=loader,
                       validate=timed("validate", self.validate_s),
                       save=timed("save", self.save_s), _build_state=build_state)
        for name, fn in patches.items():
            setattr(Trainer, name, fn)
        try:
            yield self
        finally:
            for name, fn in orig.items():
                setattr(Trainer, name, fn)


def states_equal(a: dict, b: dict) -> bool:
    """Bit for bit: parameters, Adam's moments and both counts."""
    if (a["step"], a["updates"]) != (b["step"], b["updates"]):
        return False
    if any(not torch.equal(v, b["model"][k].to(v.device)) for k, v in a["model"].items()):
        return False
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    return sorted(sa) == sorted(sb) and all(
        torch.equal(torch.as_tensor(v), torch.as_tensor(sb[i][k]).to(torch.as_tensor(v).device))
        for i in sa for k, v in sa[i].items())


def run_path(smi: str, tmp: str) -> tuple[dict, dict]:
    """The training entry (``speech_editing_tpu_torch.run``) on
    ``egs/spec_denoiser.yaml`` at its shipped widths and batch budget, float32,
    over a synthetic corpus in ``tmp/data``: RUN_STEPS steps with sanity
    and interval validation and checkpoints into ``tmp/checkpoints/run``,
    then a resume to RUN_RESUME_TO."""
    q = lambda xs, p: float(np.percentile(xs, p))
    t0 = time.perf_counter()
    mel_bytes = write_run_corpus(os.path.join(tmp, "data"))
    corpus_s = time.perf_counter() - t0
    work = os.path.join(tmp, "checkpoints", "run")
    argv = ["--config", "egs/spec_denoiser.yaml", "--exp_name", work, "-hp",
            f"binary_data_dir={os.path.join(tmp, 'data')},{RUN_HP}"]
    first, second = RunRecorder(), RunRecorder()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with first.instrumented():
        trainer = run_entry(argv)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    with second.instrumented():
        resumed = run_entry(argv[:-1] + [argv[-1] + f",max_updates={RUN_RESUME_TO}"])
    totals = counts()

    print(f"[run] launches per step {first.steps[-1]['launches']}, per validation batch "
          f"{first.valid[-1]}; totals {totals}", flush=True)
    for rec in (first, second):
        for st in rec.steps:
            check(st["launches"] == EXPECTED_PER_RUN_STEP,
                  f"run step {st['step']}: launches {st['launches']} != "
                  f"{EXPECTED_PER_RUN_STEP}")
            m = {k: float(v) for k, v in st["metrics"].items()}
            check(all(np.isfinite(v) for v in m.values()) and m["nan_grads"] == 0,
                  f"run step {st['step']}: non-finite metrics {m}")
        for moved in rec.valid:
            check(moved == EXPECTED_PER_VALID_BATCH,
                  f"validation batch: launches {moved} != {EXPECTED_PER_VALID_BATCH}")
    check(len(first.steps) == RUN_STEPS and len(first.valid) == 2 + 8 + 8,
          f"run: {len(first.steps)} steps, {len(first.valid)} validation batches")
    ckpts = {n: os.path.join(work, f"model_ckpt_steps_{n}.ckpt")
             for n in (RUN_STEPS // 2, RUN_STEPS, RUN_RESUME_TO)}
    check(all(os.path.exists(p) for p in ckpts.values()),
          f"run: checkpoints {sorted(os.listdir(work))}")
    saved = torch.load(ckpts[RUN_STEPS], map_location="cpu", weights_only=True)["state"]
    check(second.steps[0]["step"] == RUN_STEPS + 1
          and len(second.steps) == RUN_RESUME_TO - RUN_STEPS
          and states_equal(second.loaded, saved),
          f"resume: the second run did not start from step {RUN_STEPS} with the saved "
          "parameters and Adam moments, bit for bit")
    print(f"[run] resume: started at step {RUN_STEPS} with the checkpoint's parameters, Adam "
          f"moments and counts bit for bit; ran to {resumed.global_step}", flush=True)

    timed = first.steps[RUN_WARMUP:]
    ev = [st["event_ms"] for st in timed]
    host = [st["host_ms"] for st in timed]
    frames = sum(st["frames"] for st in timed)
    waits = first.waits[RUN_WARMUP:]
    stats = {"steps": len(first.steps) + len(second.steps), "timed_steps": len(timed),
             "batch_sizes": sorted({st["shape"][0] for st in first.steps}),
             "padded_frames_range": [min(st["shape"][1] for st in first.steps),
                                     max(st["shape"][1] for st in first.steps)],
             "padded_frames_p50": q([st["shape"][1] for st in timed], 50),
             "real_frames_per_step_mean": frames / len(timed),
             "event_ms_p50": q(ev, 50), "event_ms_p75": q(ev, 75),
             "host_ms_p50": q(host, 50), "host_ms_p75": q(host, 75),
             "steps_per_s_events": 1e3 / q(ev, 50), "steps_per_s_host": 1e3 / q(host, 50),
             "real_frames_per_s_events": frames / (sum(ev) / 1e3),
             "real_frames_per_s_host": frames / (sum(host) / 1e3),
             "loader_wait_ms_p50": q(waits, 50), "loader_wait_ms_p75": q(waits, 75),
             "loader_wait_ms_max": max(waits), "first_batch_wait_ms": first.waits[0],
             "validation_s": first.validate_s, "peak_gib": peak_gib,
             "ckpt_mb": os.path.getsize(ckpts[RUN_STEPS]) / 1e6,
             "ckpt_save_s": first.save_s, "ckpt_load_s": second.load_s[0],
             "corpus_mel_mb": mel_bytes / 1e6, "corpus_write_s": corpus_s, "card": smi}
    print(f"[run] egs/spec_denoiser.yaml, float32, {stats['timed_steps']} timed steps "
          f"(of {RUN_STEPS}, after {RUN_WARMUP}), batches of {stats['batch_sizes']} utterances "
          f"padded to {stats['padded_frames_range']} frames (p50 "
          f"{stats['padded_frames_p50']:.0f}), "
          f"{stats['real_frames_per_step_mean']:.0f} real frames a step: CUDA "
          f"events p50 {stats['event_ms_p50']:.3f} ms, p75 {stats['event_ms_p75']:.3f} "
          f"ms; host clock p50 {stats['host_ms_p50']:.3f} ms, p75 "
          f"{stats['host_ms_p75']:.3f} ms; {stats['steps_per_s_host']:.2f} steps/s "
          f"(host p50), {stats['real_frames_per_s_host']:.0f} real frames/s (host), "
          f"{stats['real_frames_per_s_events']:.0f} (events); {smi}", flush=True)
    print(f"[run] loader wait a step (ds_workers 2): p50 {stats['loader_wait_ms_p50']:.3f} "
          f"ms, p75 {stats['loader_wait_ms_p75']:.3f} ms, max "
          f"{stats['loader_wait_ms_max']:.3f} ms, first batch "
          f"{stats['first_batch_wait_ms']:.1f} ms; peak memory {peak_gib:.3f} GiB; "
          f"validations {[round(v, 3) for v in first.validate_s]} s (8 batches; the "
          f"first is the 2-batch sanity run); checkpoint {stats['ckpt_mb']:.1f} MB, "
          f"saves {[round(v, 3) for v in first.save_s]} s, resume load "
          f"{stats['ckpt_load_s']:.3f} s; corpus {stats['corpus_mel_mb']:.1f} MB of mel "
          f"written in {corpus_s:.1f} s; {smi}", flush=True)
    # the profiled step: the timed batch at the median padded length,
    # against its own host-clock time in the run
    mid = sorted(timed, key=lambda st: st["shape"][1])[len(timed) // 2]
    raw = {k: v.pin_memory() if isinstance(v, torch.Tensor) else v
           for k, v in mid["raw"].items()}
    b, t = mid["shape"]
    print(f"[run] profiled batch: the timed step at the median padded length, B={b} x "
          f"T={t} ({mid['frames']} real frames; {plan_text('diffnet_block', b, t, 1)} "
          f"for K1, {plan_text('diffnet_block_bwd', b, t, 1)} for K5), "
          f"{mid['host_ms']:.3f} ms host clock and {mid['event_ms']:.3f} ms CUDA events "
          f"in the run", flush=True)
    busy_ms = profile_step(trainer, raw, mid["host_ms"], label=f"run B={b} x T={t}")
    stats.update(profiled_batch=[b, t], profiled_real_frames=mid["frames"],
                 profiled_host_ms=mid["host_ms"], profiled_busy_ms=busy_ms,
                 profiled_busy_share=None if busy_ms is None else busy_ms / mid["host_ms"])
    keys = resumed.task.effective_batch_keys()
    check("spk_embed" in keys, f"run: the step's keys {keys} lack spk_embed")
    compare_step_with_cpu("run", lambda dev: Trainer(resumed.task, resumed.hp, dev,
                                                     dropout=False),
                          resumed.train_step.state_dict(),
                          {k: raw[k][:2] for k in keys})
    return totals, stats


# -- bf16 run path ---------------------------------------------------------------

# the loader in process (ds_workers=0), as the family paths load: the run
# path drives the spawned workers
RUN_BF16_HP = ("max_updates=30,val_check_interval=30,num_sanity_val_steps=0,"
               "eval_max_batches=4,tb_log_interval=10,ds_workers=0")
RUN_BF16_STEPS, RUN_BF16_RESUME_TO, RUN_BF16_VALID = 30, 35, 4
EXPECTED_PER_BF16_STEP = dict(NO_LAUNCH, diffnet_block_bf16=RUN_LAYERS,
                              diffnet_block_bwd_bf16=RUN_LAYERS)


def float_dtypes(state: dict) -> set:
    """The dtypes of a saved state's floating parameters and Adam moments."""
    tensors = list(state["model"].values()) + [
        v for s in state["optimizer"]["state"].values() for k, v in s.items()
        if k.startswith("exp_avg")]
    return {t.dtype for t in tensors if t.is_floating_point()}


def run_bf16_path(smi: str, tmp: str, data_dir: str) -> tuple[dict, dict]:
    """``egs/spec_denoiser.yaml`` as shipped (``use_bf16: true``, no override)
    through the training entry over the run path's corpus: 30 steps, a
    validation of 4 batches and a checkpoint into ``tmp/checkpoints/run_bf16``,
    then a resume to 35. Every step launches the bf16 K1 and K5 20 times each
    and nothing else; every validation batch the float32 K1 20 times (JAX
    validates in float32); the checkpoint holds float32
    parameters and moments, which the resume restores bit for bit; a
    2-utterance step on the card agrees with the CPU's at the BF16_* bars."""
    q = lambda xs, p: float(np.percentile(xs, p))
    work = os.path.join(tmp, "checkpoints", "run_bf16")
    argv = ["--config", "egs/spec_denoiser.yaml", "--exp_name", work, "-hp",
            f"binary_data_dir={data_dir},{RUN_BF16_HP}"]
    first, second = RunRecorder(), RunRecorder()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with first.instrumented():
        trainer = run_entry(argv)
    train_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(trainer.hp["use_bf16"] is True, "run bf16: the shipped config is not use_bf16")
    with second.instrumented():
        resumed = run_entry(argv[:-1] + [argv[-1] + f",max_updates={RUN_BF16_RESUME_TO}"])
    totals = counts()
    print(f"[run bf16] launches per step {first.steps[-1]['launches']}, per validation "
          f"batch {first.valid[-1]}; totals {totals}", flush=True)
    for rec in (first, second):
        for st in rec.steps:
            check(st["launches"] == EXPECTED_PER_BF16_STEP,
                  f"run bf16 step {st['step']}: launches {st['launches']} != "
                  f"{EXPECTED_PER_BF16_STEP}")
            m = {k: float(v) for k, v in st["metrics"].items()}
            check(all(np.isfinite(v) for v in m.values()) and m["nan_grads"] == 0,
                  f"run bf16 step {st['step']}: non-finite metrics {m}")
        for moved in rec.valid:
            check(moved == EXPECTED_PER_VALID_BATCH,
                  f"run bf16 validation batch: launches {moved} != {EXPECTED_PER_VALID_BATCH}")
    check(len(first.steps) == RUN_BF16_STEPS and len(first.valid) == RUN_BF16_VALID,
          f"run bf16: {len(first.steps)} steps, {len(first.valid)} validation batches")
    ckpt = os.path.join(work, f"model_ckpt_steps_{RUN_BF16_STEPS}.ckpt")
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)["state"]
    check(float_dtypes(saved) == {torch.float32},
          f"run bf16: the checkpoint holds {float_dtypes(saved)}, not float32 only")
    check(all(torch.isfinite(v).all() for v in saved["model"].values()),
          "run bf16: non-finite parameters in the checkpoint")
    check(second.steps[0]["step"] == RUN_BF16_STEPS + 1
          and len(second.steps) == RUN_BF16_RESUME_TO - RUN_BF16_STEPS
          and states_equal(second.loaded, saved),
          "run bf16 resume: not from the checkpoint's float32 state bit for bit")
    print(f"[run bf16] the checkpoint at {RUN_BF16_STEPS} holds float32 parameters and Adam "
          f"moments; the resume started from them bit for bit and ran to "
          f"{resumed.global_step}", flush=True)
    timed = first.steps[RUN_WARMUP:]
    ev = [st["event_ms"] for st in timed]
    host = [st["host_ms"] for st in timed]
    frames = sum(st["frames"] for st in timed)
    stats = {"steps": len(first.steps) + len(second.steps), "timed_steps": len(timed),
             "padded_frames_p50": q([st["shape"][1] for st in timed], 50),
             "real_frames_per_step_mean": frames / len(timed),
             "event_ms_p50": q(ev, 50), "event_ms_p75": q(ev, 75),
             "host_ms_p50": q(host, 50), "host_ms_p75": q(host, 75),
             "steps_per_s_host": 1e3 / q(host, 50),
             "real_frames_per_s_host": frames / (sum(host) / 1e3),
             "validation_s": first.validate_s, "peak_gib": peak_gib,
             "train_s": train_s, "card": smi}
    print(f"[run bf16] egs/spec_denoiser.yaml as shipped (bf16 steps, float32 masters and "
          f"validation), {len(timed)} timed steps (of {RUN_BF16_STEPS}, after "
          f"{RUN_WARMUP}), padded frames p50 {stats['padded_frames_p50']:.0f}, "
          f"{stats['real_frames_per_step_mean']:.0f} real frames a step: host clock p50 "
          f"{stats['host_ms_p50']:.3f} ms, p75 {stats['host_ms_p75']:.3f} ms "
          f"({stats['steps_per_s_host']:.2f} steps/s, {stats['real_frames_per_s_host']:.0f} "
          f"real frames/s); CUDA events p50 {stats['event_ms_p50']:.3f} ms; peak memory "
          f"{peak_gib:.3f} GiB; validation {[round(v, 3) for v in first.validate_s]} s; "
          f"{train_s:.1f} s for the first run; {smi}", flush=True)
    mid = sorted(timed, key=lambda st: st["shape"][1])[len(timed) // 2]
    raw = {k: v.pin_memory() if isinstance(v, torch.Tensor) else v
           for k, v in mid["raw"].items()}
    b, t = mid["shape"]
    print(f"[run bf16] profiled batch: B={b} x T={t} ({mid['frames']} real frames; "
          f"{plan_text('diffnet_block', b, t, 1, 'bf16')} for K1, "
          f"{plan_text('diffnet_block_bwd', b, t, 1, 'bf16')} for K5), {mid['host_ms']:.3f} "
          f"ms host clock in the run", flush=True)
    busy_ms = profile_step(trainer, raw, mid["host_ms"], label=f"run bf16 B={b} x T={t}")
    stats.update(profiled_batch=[b, t], profiled_host_ms=mid["host_ms"],
                 profiled_busy_ms=busy_ms,
                 profiled_busy_share=None if busy_ms is None else busy_ms / mid["host_ms"])
    keys = resumed.task.effective_batch_keys()
    compare_step_with_cpu("run bf16", lambda dev: Trainer(resumed.task, resumed.hp, dev,
                                                          dropout=False),
                          resumed.train_step.state_dict(), {k: raw[k][:2] for k in keys},
                          bf16=True)
    return totals, stats


WIDTH_OVERRIDE = 128      # -hp residual_channels: compiled beside the shipped 256
EXPECTED_WIDTH_STEP = dict(NO_LAUNCH, diffnet_block_bf16=RUN_LAYERS,
                           diffnet_block_bwd_bf16=RUN_LAYERS)


def check_outside_raises() -> list:
    """On the card, a call outside a kernel's envelope raises, through the
    module that calls it: a DiffNet block of 96 channels, an attention with
    160-wide heads (past the 128 K3 and K4 are compiled for), a float16
    attention (they take float32 and bf16) and a mel with hop 250. Returns
    the messages."""
    gen = torch.Generator().manual_seed(3)
    block = DiffNetResidualBlock(FLAGSHIP_HP["hidden_size"], 96, dilation=1).cuda()
    wide = MultiheadAttention(320, 2).cuda()
    half = MultiheadAttention(64, 2).cuda().to(torch.float16)
    x = torch.randn(2, 9, 96, generator=gen).cuda()
    cases = [("diffnet_block", lambda: block(x, torch.randn(2, 9, FLAGSHIP_HP["hidden_size"],
                                                            generator=gen).cuda(),
                                            torch.randn(2, 96, generator=gen).cuda(), None)),
             ("flash_mha", lambda: wide(torch.randn(2, 7, 320, generator=gen).cuda())),
             ("flash_mha", lambda: half(torch.randn(2, 7, 64, generator=gen).cuda()
                                        .to(torch.float16))),
             ("mel_spectrogram", lambda: mel_spectrogram(
                 torch.randn(1, 4000, generator=gen).cuda(), MelConfig(hop_size=250)))]
    messages = []
    for name, call in cases:
        before = counts()
        try:
            call()
        except ValueError as e:
            messages.append(str(e))
            check(str(e).startswith(f"{name}: ") and "envelope" in str(e),
                  f"outside the envelope: {name} raised {e}")
        else:
            fail(f"outside the envelope: {name} ran on the card")
        check(counts() == before, f"outside the envelope: {name} launched a kernel")
    print(f"[width] outside the envelopes the card raises: {messages}", flush=True)
    return messages


def width_override_path(smi: str, data_dir: str) -> dict:
    """One step of ``egs/spec_denoiser.yaml`` (bf16, as shipped) at ``-hp
    residual_channels=128`` on a batch of the run path's corpus: the bf16
    K1 and K5 at C=128 launch 20 times each and nothing else, and the step
    agrees with the CPU's (BF16_* bars); then :func:`check_outside_raises`."""
    hp = load_config("egs/spec_denoiser.yaml")
    hp.update(binary_data_dir=data_dir, residual_channels=WIDTH_OVERRIDE, ds_workers=0)
    task = SpecDenoiserTask(hp)
    trainer = Trainer(task, task.hp, "cuda")
    # DiffNet's output projection drawn non-zero: at flax's zero init (and
    # the warmup's lr of 0 at the first step) no gradient reaches the blocks
    out = trainer.model.denoise_fn.output_projection.weight
    with torch.no_grad():
        out.copy_(0.02 * torch.randn(out.shape, generator=torch.Generator().manual_seed(5)))
    with trainer._loader("train", shuffle=False) as loader:
        raw = next(iter(loader))
    reset_counts()
    metrics = {k: float(v) for k, v in trainer.step(raw).items()}
    torch.cuda.synchronize()
    launches = counts()
    b, t = raw["mels"].shape[:2]
    print(f"[width] residual_channels={WIDTH_OVERRIDE}, bf16, B={b} x T={t} "
          f"({plan_text('diffnet_block', b, t, 1, 'bf16', WIDTH_OVERRIDE)} for K1): launches "
          f"{launches}; metrics finite {all(np.isfinite(v) for v in metrics.values())}",
          flush=True)
    check(launches == EXPECTED_WIDTH_STEP,
          f"width override: launches {launches} != {EXPECTED_WIDTH_STEP}")
    check(all(np.isfinite(v) for v in metrics.values()) and metrics["nan_grads"] == 0,
          f"width override: metrics {metrics}")
    compare_step_with_cpu("width", lambda dev: Trainer(task, task.hp, dev, dropout=False),
                          trainer.train_step.state_dict(),
                          {k: raw[k][:2] for k in task.effective_batch_keys()}, bf16=True)
    return dict(batch=[b, t], launches=launches, raises=check_outside_raises(), card=smi)


# -- infer path ------------------------------------------------------------------

# the CSV edit API's requests: (seconds of source audio, f0, text, edited text,
# region, edited region): a lengthening, a shortening and a same-length
# edit, and an edit whose tail after the stated region differs ("mat" ->
# "mats"), which the splice meets as a tail that re-phonemized differently
# (the fallback g2p is context-free and re-phonemizes no unchanged word)
CSV_ROWS = [
    (3.0, 130.0, "we walked along the quiet river bank at dawn",
     "we walked along the very long and quiet river bank at dawn", "[4,5]", "[4,8]"),
    (5.0, 180.0, "she sold seven bright sea shells by the sandy shore last summer",
     "she sold shells by the sandy shore last summer", "[2,5]", "[2,2]"),
    (4.0, 110.0, "the old man read the morning paper in his garden",
     "the old man read the evening paper in his garden", "[6,6]", "[6,6]"),
    (2.5, 210.0, "the cat sat on the mat", "the dog sat on the mats", "[2,2]", "[2,2]"),
]
CSV_ROUNDS = 10           # timed passes over the four requests
CSV_TOL = 1e-3            # card vs CPU mel_out of one CSV request
DUR_TOL = 1e-4            # card vs CPU predicted durations
EXPECTED_PER_EDIT = dict(NO_LAUNCH, diffnet_block=RUN_LAYERS * FLAGSHIP_HP["timesteps"])


def csv_wav(seconds: float, f0: float, seed: int) -> np.ndarray:
    """A harmonic source: six partials of ``f0`` with a 3 Hz tremolo over a
    0.01 rms noise floor."""
    n = int(seconds * SR)
    t_ax = np.arange(n) / SR
    tone = sum(0.3 / k * np.sin(2 * np.pi * f0 * k * t_ax) for k in range(1, 7))
    tone = tone * (1 + 0.3 * np.sin(2 * np.pi * 3 * t_ax))
    return (tone + 0.01 * np.random.RandomState(seed).randn(n)).astype(np.float32)


def write_textgrid(path: str, text: str, n_frames: int, lead: int = 8, tail: int = 12) -> None:
    """An MFA-style phone tier: ``text``'s g2p phones spread evenly over
    ``n_frames`` between a leading and a trailing silence."""
    ph, *_ = txt_to_ph(get_txt_processor_cls("en"), text)
    phones = [p for p in ph.split(" ") if not is_sil_phoneme(p)]
    bounds = lead + np.round(np.linspace(0, n_frames - lead - tail, len(phones) + 1)).astype(int)
    sec = lambda f: float(f * HOP / SR)
    ivs = ([(0.0, sec(lead), "")]
           + [(sec(a), sec(b), p) for a, b, p in zip(bounds[:-1], bounds[1:], phones)]
           + [(sec(bounds[-1]), sec(n_frames), "")])
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "", "xmin = 0",
             f"xmax = {sec(n_frames)!r}", "tiers? <exists>", "size = 1", "item []:",
             "    item [1]:", '        class = "IntervalTier"', '        name = "phones"',
             "        xmin = 0", f"        xmax = {sec(n_frames)!r}",
             f"        intervals: size = {len(ivs)}"]
    for k, (a, b, m) in enumerate(ivs, 1):
        lines += [f"        intervals [{k}]:", f"            xmin = {a!r}",
                  f"            xmax = {b!r}", f'            text = "{m}"']
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_vocoder(voc_dir: str) -> dict:
    """A HiFi-GAN V1 checkpoint of seeded weights (flax's initializers) at
    ``egs/hifigan.yaml``'s widths, with its ``config.yaml``; returns the
    generator's config."""
    vhp = {k: load_config("egs/hifigan.yaml")[k] for k in HIFIGAN_V1_HP}
    check(vhp == HIFIGAN_V1_HP, f"egs/hifigan.yaml's generator {vhp} != {HIFIGAN_V1_HP}")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        sd = init_like_flax(HifiGanGenerator(vhp)).state_dict()
    save_checkpoint(voc_dir, {"model": sd}, 1)
    with open(os.path.join(voc_dir, "config.yaml"), "w") as f:
        f.write(dump_yaml(vhp))
    return vhp


class InferRecorder:
    """Wraps ``Trainer._infer_batch``, ``SpecDenoiserInfer``'s methods, the
    HiFi-GAN vocoder and the result writers' ``drain`` while an entry point
    runs, to record each test batch's and each edit's launches, inputs and
    outputs, the predicted durations, and the host time of the inference
    forwards, the vocoder calls and the wait for the writers."""

    def __init__(self):
        self.batches, self.edits, self.durs = [], [], []
        self.seconds = {"forward": 0.0, "vocoder": 0.0, "writers": 0.0}

    @contextlib.contextmanager
    def instrumented(self):
        rec = self
        orig = {"batch": Trainer._infer_batch, "forward": SpecDenoiserInfer.forward_model,
                "durs": SpecDenoiserInfer.predict_durations, "voc": HifiGAN.spec2wav,
                "drain": ResultSaverPool.drain}

        def timed(name, key):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                out = orig[name](*args, **kwargs)
                rec.seconds[key] += time.perf_counter() - t0
                return out
            return wrapper

        def infer_batch(trainer, raw, *args, **kwargs):
            before = counts()
            t0 = time.perf_counter()
            out = orig["batch"](trainer, raw, *args, **kwargs)
            torch.cuda.synchronize()
            rec.seconds["forward"] += time.perf_counter() - t0
            rec.batches.append(dict(launches={k: counts()[k] - before[k] for k in COUNTERS},
                                    names=list(raw["item_name"]),
                                    lengths=[int(n) for n in raw["mel_lengths"]],
                                    shape=tuple(raw["mels"].shape[:2]),
                                    mels=torch.as_tensor(raw["mels"]).clone(),
                                    masks=torch.as_tensor(raw["time_mel_masks"]).clone(),
                                    mel_out=out["mel_out"].cpu()))
            return out

        def forward_model(inf, item, *args, **kwargs):
            before = counts()
            out = orig["forward"](inf, item, *args, **kwargs)
            torch.cuda.synchronize()
            rec.edits.append(dict(launches={k: counts()[k] - before[k] for k in COUNTERS},
                                  item=item, out=out))
            return out

        def predict_durations(inf, item, spk_embed):
            dur = orig["durs"](inf, item, spk_embed)
            rec.durs.append(dur)
            return dur

        Trainer._infer_batch = infer_batch
        SpecDenoiserInfer.forward_model = forward_model
        SpecDenoiserInfer.predict_durations = predict_durations
        HifiGAN.spec2wav = timed("voc", "vocoder")
        ResultSaverPool.drain = timed("drain", "writers")
        try:
            yield self
        finally:
            Trainer._infer_batch = orig["batch"]
            SpecDenoiserInfer.forward_model = orig["forward"]
            SpecDenoiserInfer.predict_durations = orig["durs"]
            HifiGAN.spec2wav = orig["voc"]
            ResultSaverPool.drain = orig["drain"]


def check_test_set(gen_dir: str, rec: InferRecorder, n_items: int = RUN_SPLITS["test"],
                   expected: dict = EXPECTED_PER_EDIT) -> list:
    """``--infer``'s outputs: a [P] and a [G] wav and a [P] mel per item,
    segment wavs per masked item, ``meta.csv``; ``expected`` launches an
    item (by default K1 only, 160); mel_out finite and equal to the ground
    truth outside the mask. Returns the rows of ``meta.csv``."""
    names = [n for b in rec.batches for n in b["names"]]
    check(len(names) == n_items and len(set(names)) == len(names),
          f"--infer generated {names}")
    wavs = set(os.listdir(os.path.join(gen_dir, "wavs")))
    with open(os.path.join(gen_dir, "meta.csv")) as f:
        meta = list(csv.reader(f))[1:]
    check(sorted(r[0] for r in meta) == sorted(names), f"meta.csv rows {meta}")
    for b in rec.batches:
        check(b["launches"] == expected,
              f"--infer batch {b['names']}: launches {b['launches']} != {expected}")
        for i, name in enumerate(b["names"]):
            t = b["lengths"][i]
            seg = b["masks"][i, :t] == 1
            want = {f"[P]{name}.wav", f"[G]{name}.wav", f"[P]{name}_mel.npy"}
            if bool(seg.any()):
                want |= {f"[P_SEG]{name}.wav", f"[G_SEG]{name}.wav"}
            check(want <= wavs, f"--infer {name}: missing {sorted(want - wavs)}")
            mel_out, mels = b["mel_out"][i, :t], b["mels"][i, :t]
            saved = torch.from_numpy(np.load(os.path.join(gen_dir, "wavs", f"[P]{name}_mel.npy")))
            check(bool(torch.isfinite(mel_out).all()) and torch.equal(saved, mel_out),
                  f"--infer {name}: mel_out not finite or not the saved [P] mel")
            check(torch.equal(mel_out[~seg], mels[~seg]),
                  f"--infer {name}: frames outside the mask differ from the ground truth")
    return meta


def check_edit(rec_edit: dict, dur: np.ndarray, out_dir: str) -> dict:
    """One CSV edit: its wavs, K1 only with 160 launches, the composite's
    head and tail equal to the source mel's spliced frames, the edited span
    as long as the predicted durations of the edited words, all finite."""
    item, (wav_out, wav_gt, mel_out, mel, ref_mels, _) = rec_edit["item"], rec_edit["out"]
    name = item["item_name"]
    check(all(os.path.exists(os.path.join(out_dir, f"{name}{s}.wav")) for s in ("", "_ref")),
          f"CSV edit {name}: missing wavs in {sorted(os.listdir(out_dir))}")
    check(rec_edit["launches"] == EXPECTED_PER_EDIT,
          f"CSV edit {name}: launches {rec_edit['launches']} != {EXPECTED_PER_EDIT}")
    check(all(np.isfinite(a).all() for a in (wav_out, wav_gt, mel_out)),
          f"CSV edit {name}: non-finite output")
    (w0, w1), (c0, c1) = item["words_region"][0], item["edited_words_region"][0]
    head = int(np.sum((item["mel2word"] >= 1) & (item["mel2word"] < w0)))
    tail_src = mel[item["mel2word"] > w1]
    dur_int = np.round(dur).astype(np.int64) * (item["edited_ph_token"] > 0)
    changed = (item["edited_ph2word"] >= c0) & (item["edited_ph2word"] <= c1)
    span = int(dur_int[changed].sum())
    check(mel_out.shape[0] == head + span + len(tail_src),
          f"CSV edit {name}: {mel_out.shape[0]} frames != head {head} + predicted span "
          f"{span} + tail {len(tail_src)}")
    check(np.array_equal(mel_out[:head], mel[:head])
          and np.array_equal(mel_out[head + span:], tail_src),
          f"CSV edit {name}: head or tail frames differ from the source mel")
    n_tail_orig = int(np.sum(item["ph2word"] > w1))
    n_tail_edit = int(np.sum(item["edited_ph2word"] > c1))
    return dict(name=name, source_frames=int(mel.shape[0]), frames=int(mel_out.shape[0]),
                head=head, span=span, tail=len(tail_src),
                tail_phones=(n_tail_orig, n_tail_edit), wav_s=len(wav_out) / SR)


@contextlib.contextmanager
def coarse_pitch_bins(bins: list, replay: bool):
    """Within the block every pitch quantisation (``f0_to_coarse``, as the
    conditioner calls it) records its bins into ``bins``; with ``replay`` it
    takes the recorded bins instead of its own and counts those that
    differ, each by one bin (an f0 within rounding of a bin edge). A bin
    picks a pitch embedding, so such a frame's conditioning would differ by
    far more than rounding. Yields ``[flips, calls]``."""
    orig, tally = fs_module.f0_to_coarse, [0, 0]

    def f0_to_coarse(f0, *args, **kwargs):
        got = orig(f0, *args, **kwargs)
        if not replay:
            bins.append(got.detach().clone())
            return got
        want = bins[tally[1]].to(got.device)
        differ = got != want
        check(bool(((got - want).abs()[differ] == 1).all()),
              "coarse pitch: the card's and the CPU's bins differ by more than one")
        tally[0] += int(differ.sum())
        tally[1] += 1
        return want

    fs_module.f0_to_coarse = f0_to_coarse
    try:
        yield tally
    finally:
        fs_module.f0_to_coarse = orig
    check(not replay or tally[1] == len(bins),
          f"coarse_pitch_bins: {tally[1]} calls replayed {len(bins)} recorded ones")


def compare_edit_with_cpu(hp: dict, inf, inp: dict) -> dict:
    """One CSV request on the card and again on the CPU (plain versions),
    with the card's noise and, where a predicted duration or a pitch bin
    lies within rounding of a rounding edge, the card's rounding replayed
    and counted; the float durations within DUR_TOL and mel_out within
    CSV_TOL."""
    item = inf.preprocess_input(inp)
    spk = inf.spk_embedder(item["wav"])[None]
    bins: list = []
    with coarse_pitch_bins(bins, replay=False):
        dur_gpu = inf.predict_durations(item, spk)
        mel_gpu = inf.forward_model(item)[2]
    gen = request_generator(int(hp.get("seed", 1234)), item, "cuda")
    noise = request_noise(gen, FLAGSHIP_HP["timesteps"], mel_gpu.shape[0], 80)[:, None].cpu()
    cpu = SpecDenoiserInfer(hp, "cpu")
    t0 = time.perf_counter()
    with coarse_pitch_bins(bins, replay=True) as tally:
        dur_cpu = cpu.predict_durations(item, spk)
        flipped = np.round(dur_cpu) != np.round(dur_gpu)
        mel_cpu = cpu.forward_model(item, noise=noise, dur_int=np.round(dur_gpu))[2]
    cpu_s = time.perf_counter() - t0
    dur_err = float(np.abs(dur_cpu - dur_gpu).max())
    edge = np.abs(np.abs(dur_gpu - np.floor(dur_gpu)) - 0.5)
    mel_err = float(np.abs(mel_cpu - mel_gpu).max()) if mel_cpu.shape == mel_gpu.shape else np.inf
    out = dict(name=item["item_name"], frames=int(mel_gpu.shape[0]), cpu_s=cpu_s,
               dur_max_abs_err=dur_err, dur_replayed=int(flipped.sum()), durations=len(dur_gpu),
               bins_replayed=tally[0], bins=int(sum(b.numel() for b in bins)),
               mel_max_abs_err=mel_err)
    print(f"[infer] CSV request {out['name']} on the card vs the CPU ({cpu_s:.1f} s): "
          f"durations max_abs_err {dur_err:.3e} (tol {DUR_TOL}), {out['dur_replayed']} of "
          f"{out['durations']} rounded the other way on the CPU and replayed; pitch bins "
          f"replayed {out['bins_replayed']} of {out['bins']}; mel_out ({out['frames']} "
          f"frames) max_abs_err {mel_err:.3e} (tol {CSV_TOL})", flush=True)
    check(dur_err <= DUR_TOL, f"CSV request: durations differ by {dur_err} > {DUR_TOL}")
    check(bool((edge[flipped] <= DUR_TOL).all()),
          "CSV request: a duration rounded the other way away from a .5 edge")
    check(mel_err <= CSV_TOL, f"CSV request: card vs CPU mel_out error {mel_err} > {CSV_TOL}")
    return out


def time_csv_edits(inf, inputs: list) -> dict:
    """Host-clock latency of each CSV edit, one at a time, CSV_ROUNDS passes
    over the requests after one untimed pass: the whole edit (``wav2spec``
    of the wav file, then ``infer_once``) and its parts: the host front end
    (``wav2spec``, g2p, TextGrid, ``autocorr_pitch``), the duration program
    (with the host's length regulation), the diffusion program and the two
    vocoder calls. Every part ends in a copy to the host, so the host
    clock holds its device work."""
    parts = {"front_end": [], "durations": [], "diffusion": [], "vocoder": []}
    names = {"preprocess_input": "front_end", "inpaint_durations": "durations",
             "diffuse": "diffusion", "run_vocoder": "vocoder"}
    spent: dict = {}

    def timed(name):
        fn = getattr(inf, name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[names[name]] = spent.get(names[name], 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    for name in names:
        setattr(inf, name, timed(name))
    total = []
    try:
        for rnd in range(CSV_ROUNDS + 1):
            for row in inputs:
                spent.clear()
                t0 = time.perf_counter()
                spec = wav2spec(row["wav_fn_orig"], **row["spec_kw"])
                t1 = time.perf_counter()
                inf.infer_once(dict(row["info"], mel=spec["mel"], wav=spec["wav"]))
                t2 = time.perf_counter()
                if rnd == 0:
                    continue
                spent["front_end"] += t1 - t0
                total.append((t2 - t0) * 1e3)
                for k in parts:
                    parts[k].append(spent[k] * 1e3)
    finally:
        for name in names:
            delattr(inf, name)
    q = lambda xs, p: float(np.percentile(xs, p))
    stats = {"edits": len(total), "host_ms_p50": q(total, 50), "host_ms_p75": q(total, 75)}
    for k, xs in parts.items():
        stats[f"{k}_ms_p50"], stats[f"{k}_ms_p75"] = q(xs, 50), q(xs, 75)
    return stats


def infer_path(smi: str, tmp: str, work: str, data_dir: str) -> tuple[dict, dict, dict, list]:
    """The two inference entry points on the run path's checkpoint and
    corpus, with a HiFi-GAN V1 vocoder checkpoint of seeded weights: ``run
    --infer`` over the 8 test utterances, then the CSV region-edit API
    over CSV_ROWS, timed, profiled and one request re-run on the CPU.
    Returns the launches of each and the statistics, and the frame counts
    K1 ran at."""
    voc_dir = os.path.join(tmp, "hifigan")
    write_vocoder(voc_dir)
    argv = ["--config", "egs/spec_denoiser.yaml", "--exp_name", work, "-hp",
            f"binary_data_dir={data_dir},{RUN_HP},vocoder_ckpt={voc_dir}", "--infer"]
    hp = set_hparams(arg_parser().parse_args(argv), print_hparams=False)
    voc = get_vocoder_cls(hp["vocoder"])(hp, "cuda")
    check(voc.kind == "hifigan" and next(voc.generator.parameters()).is_cuda,
          f"vocoder: {voc.kind} on {voc.device}, expected HiFi-GAN on cuda")
    del voc

    # run --infer over the test split
    rec = InferRecorder()
    reset_counts()
    t0 = time.perf_counter()
    with rec.instrumented():
        trainer = run_entry(argv)
    infer_s = time.perf_counter() - t0
    infer_launches = counts()
    gen_dir = os.path.join(work, f"generated_{trainer.global_step}_test")
    check_test_set(gen_dir, rec)
    lengths = sorted(b["shape"][1] for b in rec.batches)
    sec = rec.seconds
    stats = {"infer_items": len(rec.batches), "infer_s": infer_s,
             "infer_items_per_s": len(rec.batches) / infer_s, "infer_frames": lengths,
             "infer_forward_s": sec["forward"], "infer_vocoder_s": sec["vocoder"],
             "infer_writers_wait_s": sec["writers"],
             "infer_other_s": infer_s - sec["forward"] - sec["vocoder"] - sec["writers"]}
    print(f"[infer] run --infer: {len(rec.batches)} test items ({lengths} frames) in "
          f"{infer_s:.2f} s, {stats['infer_items_per_s']:.2f} items/s (host clock, model "
          f"and vocoder load and the writes included): inference forwards "
          f"{sec['forward']:.2f} s, vocoder calls {sec['vocoder']:.2f} s, waiting for the "
          f"{os.getenv('N_PROC', (os.cpu_count() or 2) - 1)} spawned writers "
          f"{sec['writers']:.2f} s, the rest (config, model and checkpoint load, loader) "
          f"{stats['infer_other_s']:.2f} s; launches per item "
          f"{rec.batches[0]['launches']}, totals {infer_launches}; every mel_out frame "
          f"outside the mask is the ground truth's; {smi}", flush=True)
    del trainer

    # the CSV edit API
    csv_dir = os.path.join(tmp, "csv")
    os.makedirs(csv_dir)
    spec_kw = dict(sample_rate=hp["audio_sample_rate"], fft_size=hp["fft_size"],
                   hop_size=hp["hop_size"], win_length=hp.get("win_size", hp["fft_size"]),
                   num_mels=hp["audio_num_mel_bins"], fmin=hp["fmin"], fmax=hp["fmax"])
    rows = []
    for i, (seconds, f0, text, edited, region, edited_region) in enumerate(CSV_ROWS):
        wav_fn = os.path.join(csv_dir, f"edit{i}.wav")
        save_wav(csv_wav(seconds, f0, i), wav_fn, SR)
        tg = os.path.join(csv_dir, f"edit{i}.TextGrid")
        write_textgrid(tg, text, wav2spec(wav_fn, **spec_kw)["mel"].shape[0])
        rows.append(dict(item_name=f"edit{i}", text=text, edited_text=edited,
                         wav_fn_orig=wav_fn, edited_region=edited_region, region=region,
                         mfa_textgrid=tg))
    out_dir = os.path.join(csv_dir, "out")
    rec = InferRecorder()
    reset_counts()
    with rec.instrumented():
        SpecDenoiserInfer.example_run(rows, hp, out_dir=out_dir, device="cuda")
    csv_launches = counts()
    check(len(rec.edits) == len(rows) == len(rec.durs), f"CSV edit API: {len(rec.edits)} edits")
    edits = [check_edit(e, d, out_dir) for e, d in zip(rec.edits, rec.durs)]
    check(edits[-1]["tail_phones"][0] != edits[-1]["tail_phones"][1],
          f"CSV edit {edits[-1]['name']}: the tail rank remap was not reached")
    for e in edits:
        print(f"[infer] CSV edit {e['name']}: {e['source_frames']} source frames -> "
              f"{e['frames']} (head {e['head']}, predicted span {e['span']}, tail "
              f"{e['tail']}; tail phones {e['tail_phones'][0]} -> {e['tail_phones'][1]}), "
              f"{e['wav_s']:.3f} s of audio; head and tail frames are the source's",
              flush=True)
    print(f"[infer] CSV edit API: {len(rows)} edits; launches per edit "
          f"{rec.edits[0]['launches']}, totals {csv_launches}", flush=True)

    inf = SpecDenoiserInfer(hp, "cuda")
    inputs = [dict(info=r, wav_fn_orig=r["wav_fn_orig"], spec_kw=spec_kw) for r in rows]
    again = []
    for r in inputs[:2]:
        spec = wav2spec(r["wav_fn_orig"], **spec_kw)
        inp = dict(r["info"], mel=spec["mel"], wav=spec["wav"])
        again.append(inf.infer_once(inp)[2])
    check(np.array_equal(again[0], rec.edits[0]["out"][2])
          and np.array_equal(again[1], rec.edits[1]["out"][2]),
          "CSV edit API: the same request twice gave different mels")
    print("[infer] the same requests again (a new SpecDenoiserInfer): bit-identical mels",
          flush=True)
    timing = time_csv_edits(inf, inputs)
    print(f"[infer] CSV edit latency, {timing['edits']} edits one at a time over "
          f"{len(rows)} requests ({[e['frames'] for e in edits]} frames), host clock: p50 "
          f"{timing['host_ms_p50']:.3f} ms, p75 {timing['host_ms_p75']:.3f} ms; host front "
          f"end p50 {timing['front_end_ms_p50']:.3f} (p75 {timing['front_end_ms_p75']:.3f}), "
          f"duration program {timing['durations_ms_p50']:.3f} "
          f"({timing['durations_ms_p75']:.3f}), diffusion program "
          f"{timing['diffusion_ms_p50']:.3f} ({timing['diffusion_ms_p75']:.3f}), two vocoder "
          f"calls {timing['vocoder_ms_p50']:.3f} ({timing['vocoder_ms_p75']:.3f}) ms; {smi}",
          flush=True)
    spec = wav2spec(rows[0]["wav_fn_orig"], **spec_kw)
    inp = dict(rows[0], mel=spec["mel"], wav=spec["wav"])
    events, busy_ms = profiled(lambda: inf.infer_once(inp))
    kernels = device_ops(events)
    n_ops = sum(e.count for e in kernels)
    print(f"[profile] CSV edit {rows[0]['item_name']} ({edits[0]['frames']} frames): "
          f"{n_ops} device operations, busy {busy_ms:.3f} ms", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
              f"{e.key[:90]}", flush=True)
    cpu = compare_edit_with_cpu(hp, inf, inp)
    stats.update(csv_edits=edits, csv_timing=timing, csv_profile_busy_ms=busy_ms,
                 csv_profile_device_ops=n_ops, csv_cpu=cpu, card=smi)
    frames = lengths + [e["frames"] for e in edits]
    return infer_launches, csv_launches, stats, frames


def check_block_at(gen, frames: list) -> float:
    """K1 against its plain version at B=1 and each frame count the infer
    path ran it at, no padding, as the edits give it; returns the error."""
    worst = 0.0
    for t in sorted(set(frames)):
        x, cond, step, _, w = block_inputs(gen, 1, t)
        mask = torch.ones(1, t, device="cuda")
        got = diffnet_block(x, cond, step, mask, *w)
        ref = diffnet_block_plain(x, cond, step, mask, *w)
        err = max(float((g - e).abs().max()) for g, e in zip(got, ref))
        check(err <= 1e-4, f"diffnet_block B=1 T={t}: error {err} > 1e-4")
        worst = max(worst, err)
    print(f"[kernel] diffnet_block B=1 at the infer path's {len(set(frames))} lengths "
          f"{sorted(set(frames))}, {plan_text('diffnet_block', 1, max(frames), 1)} at the "
          f"longest: max_abs_err={worst:.3e} (tol 1e-4)", flush=True)
    return worst


# -- serve path ------------------------------------------------------------------

SERVE_BATCH = 16
# the serve phase's 32 requests, seconds of source audio each: the edited
# lengths fall in the 128, 256, 512, 1024 and 1536-frame buckets and the
# 32- to 256-token buckets; 17 share one (token, frame) bucket, a full
# chunk and a tail
SERVE_SECONDS = [1.3] * 3 + [2.6] * 4 + [4.5] * 17 + [9.0] * 4 + [15.5] * 4
SERVE_WORDS = ("we walked along the quiet river bank at dawn while she sold seven bright sea "
               "shells by the sandy shore and the old man read his morning paper in the "
               "garden").split()
SERVE_NEW = [["very", "long"], ["green"], ["small", "and", "old"], ["evening"]]
SERVE_ALONE = 7           # the first 4.5 s request: served alone, at another row, exact fit
SERVE_CPU_T = 128         # the frame bucket of the diff chunk re-run on the CPU
SERVE_FIT_TOL = 1e-4      # exact-fit server vs the per-item driver, on the card
SERVE_K1_T = (256, 512, 1024, 1536)    # K1 at B=16 and the serving buckets
EXPECTED_PER_DUR_CHUNK = {k: 0 for k in EXPECTED_PER_EDIT}


def serve_row_specs(d: str) -> list:
    """The serve phase's requests (the serve CLI's JSONL schema with an
    ``mfa_textgrid``), their wav and TextGrid paths under ``d``: harmonic
    wavs of SERVE_SECONDS, about 2.6 words a second from SERVE_WORDS, one
    or two words in the first third replaced by one to three others."""
    rows = []
    for i, secs in enumerate(SERVE_SECONDS):
        n = max(5, round(secs * 2.6))
        words = [SERVE_WORDS[(5 * i + k) % len(SERVE_WORDS)] for k in range(n)]
        w0, new = n // 3 + 1, SERVE_NEW[i % len(SERVE_NEW)]
        w1 = w0 + i % 2
        rows.append(dict(item_name=f"serve{i:02d}", text=" ".join(words),
                         edited_text=" ".join(words[:w0 - 1] + new + words[w1:]),
                         region=f"[{w0},{w1}]", edited_region=f"[{w0},{w0 + len(new) - 1}]",
                         wav_fn_orig=os.path.join(d, f"serve{i:02d}.wav"),
                         mfa_textgrid=os.path.join(d, f"serve{i:02d}.TextGrid")))
    return rows


def serve_rows(d: str, spec_kw: dict) -> list:
    """``serve_row_specs`` with their wavs and TextGrids (as the infer
    path's) written."""
    rows = serve_row_specs(d)
    for i, (secs, row) in enumerate(zip(SERVE_SECONDS, rows)):
        save_wav(csv_wav(secs, 100.0 + 7 * i, 100 + i), row["wav_fn_orig"], SR)
        write_textgrid(row["mfa_textgrid"], row["text"],
                       wav2spec(row["wav_fn_orig"], **spec_kw)["mel"].shape[0])
    return rows


class ChunkRecorder:
    """Wraps a server's chunk stages to record each chunk: its stage,
    buckets, real rows, batch, launches, host seconds (its results' fetch
    included) and requests."""

    def __init__(self, server):
        self.chunks = []
        for stage in type(server).STAGES:
            name = f"run_{stage}_chunk"
            setattr(server, name, self._wrap(stage, getattr(server, name)))

    def _wrap(self, stage, run):
        def wrapped(reqs, s_b, t_b, b_eff):
            before = counts()
            t0 = time.perf_counter()
            run(reqs, s_b, t_b, b_eff)
            self.chunks.append(dict(stage=stage, s_b=s_b, t_b=t_b, n=len(reqs), b=b_eff,
                                    s=time.perf_counter() - t0, reqs=list(reqs),
                                    launches={k: counts()[k] - before[k] for k in COUNTERS}))
        return wrapped

    def of(self, stage: str) -> list:
        return [c for c in self.chunks if c["stage"] == stage]


def check_served(inputs: list, results: list, rec: ChunkRecorder) -> None:
    """Each dur chunk launches no kernel, each diff chunk K1 160 times and
    nothing else; every result finite, of its spliced length, its head and
    tail frames the source's and every frame outside the edit the spliced
    reference's."""
    for c in rec.of("dur"):
        check(c["launches"] == EXPECTED_PER_DUR_CHUNK,
              f"serve: dur chunk {c['s_b']}x{c['t_b']} launched {c['launches']}")
    for c in rec.of("diff"):
        check(c["launches"] == EXPECTED_PER_EDIT,
              f"serve: diff chunk {c['s_b']}x{c['t_b']} launched {c['launches']}")
    reqs = {r.item["item_name"]: r for c in rec.of("diff") for r in c["reqs"]}
    check(sorted(reqs) == sorted(i["item_name"] for i in inputs),
          f"serve: diff chunks served {sorted(reqs)}")
    for inp, res in zip(inputs, results):
        r = reqs[inp["item_name"]]
        mel_out, item, sp = res["mel_out"], r.item, r.splice
        check(mel_out.shape == (sp["t_new"], 80) and np.isfinite(mel_out).all()
              and np.isfinite(res["wav_out"]).all()
              and len(res["wav_out"]) == sp["t_new"] * HOP,
              f"serve {inp['item_name']}: result shape or values")
        (w0, w1) = item["words_region"][0]
        head = int(np.sum((item["mel2word"] >= 1) & (item["mel2word"] < w0)))
        tail = item["mel"][item["mel2word"] > w1]
        keep = sp["time_mel_masks"][:, 0] == 0
        check(np.array_equal(mel_out[:head], item["mel"][:head])
              and np.array_equal(mel_out[len(mel_out) - len(tail):], tail)
              and np.array_equal(mel_out[keep], sp["ref_mels"][keep]),
              f"serve {inp['item_name']}: head, tail or unedited frames differ from the source")


def fresh_noise(reqs: list, seed: int) -> None:
    """Give each request a new generator, so a re-run draws the noise its
    first run drew."""
    for r in reqs:
        r.gen = request_generator(seed, r.item, "cuda")


def serve_profile(server, chunk: dict, seed: int, smi: str) -> dict:
    """One diff chunk re-run on the card: its host time (median of 3), and
    from ``torch.profiler`` its device busy time and operations, K1's share
    and HiFi-GAN's (the vocoder profiled alone on a chunk-shaped mel)."""
    reqs, args = chunk["reqs"], (chunk["s_b"], chunk["t_b"], chunk["b"])

    def run():
        fresh_noise(reqs, seed)
        BatchedEditServer.run_diff_chunk(server, reqs, *args)
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        host.append((time.perf_counter() - t0) * 1e3)
    events, busy = profiled(run)
    kernels = device_ops(events)
    k1 = sum(e.self_device_time_total for e in kernels if "diffnet_block" in e.key) / 1e3
    mel = torch.zeros(chunk["b"], chunk["t_b"], 80, device="cuda") - 4.0
    voc = profiled(lambda: server.infer.vocoder.spec2wav_batch_dev(mel))[1]
    out = dict(shape=[chunk["b"], chunk["t_b"]], s_b=chunk["s_b"],
               host_ms=float(np.median(host)), busy_ms=busy,
               device_ops=sum(e.count for e in kernels), k1_ms=k1, hifigan_ms=voc)
    if busy == 0:
        print(f"[serve] profiled diff chunk: the profiler saw no device time, busy not "
              f"measured; host {out['host_ms']:.3f} ms", flush=True)
        return out
    print(f"[serve] profiled diff chunk B={chunk['b']} x T={chunk['t_b']} (S={chunk['s_b']}, "
          f"{chunk['n']} real rows): host {out['host_ms']:.3f} ms (median of 3), device busy "
          f"{busy:.3f} ms ({busy / out['host_ms']:.3f} of it) in {out['device_ops']} "
          f"operations; K1 {k1:.3f} ms ({k1 / busy:.3f}), HiFi-GAN alone on the chunk's shape "
          f"{voc:.3f} ms ({voc / busy:.3f}); {smi}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
              f"{e.key[:90]}", flush=True)
    return out


def serve_cpu_rerun(hp: dict, server, chunk: dict, results: dict, seed: int) -> dict:
    """One diff chunk again on the card, bit-identical to its first run,
    recording its pitch bins; then on the CPU (plain versions, the card's
    noise and bins replayed, the vocoder left out): mel_out within
    CSV_TOL."""
    reqs, args = chunk["reqs"], (chunk["s_b"], chunk["t_b"], chunk["b"])
    bins: list = []
    fresh_noise(reqs, seed)
    with coarse_pitch_bins(bins, replay=False):
        BatchedEditServer.run_diff_chunk(server, reqs, *args)
    again = all(np.array_equal(r.result["mel_out"], results[r.item["item_name"]]["mel_out"])
                for r in reqs)
    check(again, "serve: a diff chunk run again gave other mels")
    fresh_noise(reqs, seed)
    noise = server.chunk_noise(reqs, chunk["t_b"], chunk["b"]).cpu()
    cpu = BatchedEditServer(SpecDenoiserInfer(hp, "cpu"), max_batch=SERVE_BATCH)
    cpu.infer.vocoder = types.SimpleNamespace(       # mel_out is compared, not audio
        device_batched=False, spec2wav_batch=lambda mels: np.zeros((len(mels), 1)))
    cpu.chunk_noise = lambda *_: noise
    cpu_reqs = [copy.copy(r) for r in reqs]
    t0 = time.perf_counter()
    with coarse_pitch_bins(bins, replay=True) as tally:
        cpu.run_diff_chunk(cpu_reqs, *args)
    err = max(float(np.abs(c.result["mel_out"] - r.result["mel_out"]).max())
              for c, r in zip(cpu_reqs, reqs))
    out = dict(shape=[chunk["b"], chunk["t_b"]], rows=chunk["n"], cpu_s=time.perf_counter() - t0,
               bins_replayed=tally[0], bins=int(sum(b.numel() for b in bins)),
               mel_max_abs_err=err)
    print(f"[serve] diff chunk B={chunk['b']} x T={chunk['t_b']} ({chunk['n']} real rows) run "
          f"again on the card: bit-identical; on the CPU ({out['cpu_s']:.1f} s) with the "
          f"card's noise: pitch bins replayed {tally[0]} of {out['bins']}, mel_out "
          f"max_abs_err {err:.3e} (tol {CSV_TOL})", flush=True)
    check(err <= CSV_TOL, f"serve: card vs CPU diff chunk mel_out error {err} > {CSV_TOL}")
    return out


def serve_cli(argv_hp: list, rows: list, out_dir: str, extra: list) -> dict:
    """``python -m speech_editing_tpu_torch.infer.serve`` in a subprocess
    over ``rows`` as JSONL; returns its numbers, read from its stderr."""
    jsonl = out_dir + ".jsonl"
    with open(jsonl, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    cmd = [sys.executable, "-m", "speech_editing_tpu_torch.infer.serve", *argv_hp,
           "--jsonl", jsonl, "--out-dir", out_dir, "--workers", "2", "--max-wait-ms", "100",
           "--max-batch", str(SERVE_BATCH), *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    err = proc.stderr
    check(proc.returncode == 0, f"serve CLI exited {proc.returncode}:\n{err[-3000:]}")
    served = [ln for ln in err.splitlines() if ln.startswith("| served ")]
    tail = [ln for ln in err.splitlines() if " chunks, fill " in ln]
    check(len(served) == 1 and len(tail) == 1, f"serve CLI output:\n{err[-3000:]}")
    words = served[0].split()
    out = dict(wall_s=wall, served=int(words[2]), p50_ms=float(words[6]),
               p99_ms=float(words[10]), chunks=int(tail[0].split()[1]),
               fill=float(tail[0].split("fill ")[1].split()[0]),
               shapes=int(tail[0].split("; ")[1].split()[0]))
    warm = [ln for ln in err.splitlines() if ln.startswith("| warmup: ") and "shapes in" in ln]
    if warm:
        out.update(warmup_shapes=int(warm[0].split()[2]),
                   warmup_s=float(warm[0].split(" in ")[1].rstrip("s")))
    return out


def read_wavs(out_dir: str, names: list) -> dict:
    waves = {}
    for name in names:
        sr, data = wavfile.read(os.path.join(out_dir, f"{name}.wav"))
        check(sr == SR and data.dtype == np.int16, f"serve CLI {name}.wav: {sr} Hz, {data.dtype}")
        waves[name] = data
    return waves


def serve_path(smi: str, tmp: str, work: str, data_dir: str) -> tuple[dict, dict]:
    """The batch server and the serve CLI at the shipped widths on the run
    path's checkpoint and the infer path's HiFi-GAN V1: 32 requests in batch
    mode (warmed first), checked and timed; one request alone, at another
    row and at its exact-fit bucket; a diff chunk re-run on the CPU; a
    profiled B=16 x T=512 diff chunk; the CLI online with --warmup and
    again with --fast-io, unwarmed, on every other request; the same
    requests on int8 weights. Returns the
    batch run's launches and the statistics."""
    voc_dir = os.path.join(tmp, "hifigan")
    argv_hp = ["--config", "egs/spec_denoiser.yaml", "--exp_name", work, "-hp",
               f"binary_data_dir={data_dir},{RUN_HP},vocoder_ckpt={voc_dir}"]
    hp = set_hparams(arg_parser().parse_args(argv_hp + ["--infer"]), print_hparams=False)
    seed = int(hp.get("seed", 1234))
    d = os.path.join(tmp, "serve")
    os.makedirs(d)
    spec_kw = dict(sample_rate=hp["audio_sample_rate"], fft_size=hp["fft_size"],
                   hop_size=hp["hop_size"], win_length=hp.get("win_size", hp["fft_size"]),
                   num_mels=hp["audio_num_mel_bins"], fmin=hp["fmin"], fmax=hp["fmax"])
    rows = serve_rows(d, spec_kw)
    inputs = [load_request(r, hp) for r in rows]
    names = [r["item_name"] for r in rows]
    audio_in = sum(len(i["wav"]) for i in inputs) / SR

    # batch mode, warmed
    inf = SpecDenoiserInfer(hp, "cuda")
    check(inf.vocoder.kind == "hifigan" and inf.vocoder.device_batched,
          f"serve: vocoder {inf.vocoder.kind}, expected HiFi-GAN on the card")
    server = BatchedEditServer(inf, max_batch=SERVE_BATCH)
    t0 = time.perf_counter()
    n_warm = server.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warmed = set(server.program_shapes)
    rec = ChunkRecorder(server)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = server.edit_many(inputs)
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(server.program_shapes == warmed, "serve: traffic ran a shape warmup did not")
    check_served(inputs, results, rec)
    by_name = dict(zip(names, results))
    diff = rec.of("diff")
    frame_buckets = sorted({c["t_b"] for c in diff})
    token_buckets = sorted({c["s_b"] for c in diff})
    full = [c for c in diff if c["n"] == c["b"]]
    check(len(frame_buckets) >= 4 and len(token_buckets) >= 3 and full
          and any(c["n"] < c["b"] for c in diff),
          f"serve: diff chunks {[(c['s_b'], c['t_b'], c['n']) for c in diff]}")
    audio_out = sum(r["t_frames"] for r in results) * HOP / SR
    dur_s, diff_s = (sum(c["s"] for c in rec.of(st)) for st in ("dur", "diff"))
    stats = dict(requests=len(inputs), source_audio_s=audio_in, edited_audio_s=audio_out,
                 frames=[r["t_frames"] for r in results], warmup_s=warm_s,
                 warmup_shapes=n_warm, batch_s=wall, requests_per_s=len(inputs) / wall,
                 audio_s_per_s=audio_out / wall, dur_chunks_s=dur_s, diff_chunks_s=diff_s,
                 prepare_s=wall - dur_s - diff_s, peak_gib=peak,
                 chunks=[(c["stage"], c["s_b"], c["t_b"], c["n"], c["b"], round(c["s"], 4))
                         for c in rec.chunks],
                 fill=sum(c["n"] for c in diff) / sum(c["b"] for c in diff))
    print(f"[serve] warmup: {n_warm} program shapes in {warm_s:.2f} s; batch mode: "
          f"{len(inputs)} requests ({audio_in:.1f} s of source audio, {audio_out:.1f} s "
          f"edited, {min(stats['frames'])}-{max(stats['frames'])} frames) in {wall:.3f} s: "
          f"{stats['requests_per_s']:.3f} requests/s, {stats['audio_s_per_s']:.3f} audio s/s; "
          f"host front end {stats['prepare_s']:.3f} s, {len(rec.of('dur'))} dur chunks "
          f"{dur_s:.3f} s, {len(diff)} diff chunks {diff_s:.3f} s (fill {stats['fill']:.3f}; "
          f"frame buckets {frame_buckets}, token buckets {token_buckets}, {len(full)} full); "
          f"peak memory {peak:.3f} GiB; launches {launches}; no shape after warmup; {smi}",
          flush=True)
    for c in diff:
        print(f"[serve] diff chunk S={c['s_b']} T={c['t_b']}: {c['n']}/{c['b']} rows, "
              f"{c['s'] * 1e3:.3f} ms host, launches {c['launches']['diffnet_block']} K1",
              flush=True)

    # one request alone, at another row, and at its exact-fit bucket
    alone_name = names[SERVE_ALONE]
    alone = server.edit_many([inputs[SERVE_ALONE]])[0]["mel_out"]
    row1 = server.edit_many([inputs[SERVE_ALONE + 1], inputs[SERVE_ALONE]])[1]["mel_out"]
    check(np.array_equal(alone, by_name[alone_name]["mel_out"])
          and np.array_equal(row1, alone),
          f"serve {alone_name}: alone, co-batched and at row 1 not bit-identical")
    item = inf.preprocess_input(inputs[SERVE_ALONE])
    t_src, t_new = len(item["mel2ph"]), by_name[alone_name]["t_frames"]
    fit = {}
    for b in (SERVE_BATCH, 1):
        fit_srv = BatchedEditServer(inf, max_batch=b, frame_buckets=sorted({t_src, t_new}),
                                    token_buckets=(len(item["edited_ph_token"]),))
        fit_rec = ChunkRecorder(fit_srv)
        got = fit_srv.edit_many([inputs[SERVE_ALONE]])[0]["mel_out"]
        dur = fit_rec.of("dur")[0]["reqs"][0].dur_pred
        per_item = inf.forward_model(item, dur_int=np.round(dur))[2]
        fit[b] = float(np.abs(got - per_item).max()) if got.shape == per_item.shape else np.inf
    print(f"[serve] {alone_name} ({t_new} frames): alone, in its 16-row chunk and at row 1 "
          f"bit-identical; exact-fit bucket vs the per-item driver: max_abs_err "
          f"{fit[SERVE_BATCH]:.3e} at B={SERVE_BATCH}, {fit[1]:.3e} at B=1 "
          f"(tol {SERVE_FIT_TOL})", flush=True)
    check(max(fit.values()) <= SERVE_FIT_TOL,
          f"serve: exact fit vs the per-item driver {fit} > {SERVE_FIT_TOL}")
    stats.update(exact_fit_max_abs_err=fit[SERVE_BATCH], exact_fit_b1_max_abs_err=fit[1])

    cpu_chunk = next(c for c in diff if c["t_b"] == SERVE_CPU_T)
    stats["cpu"] = serve_cpu_rerun(hp, server, cpu_chunk, by_name, seed)
    stats["profile"] = serve_profile(server, next(c for c in full if c["t_b"] == 512), seed, smi)

    # online: the CLI, warmed, and again with --fast-io, unwarmed, on every
    # other request
    online = serve_cli(argv_hp, rows, os.path.join(d, "out"), ["--warmup"])
    fast = serve_cli(argv_hp, rows[::2], os.path.join(d, "fast"), ["--fast-io"])
    check(online["served"] == len(rows) and fast["served"] == len(rows[::2]),
          f"serve CLI served {online['served']} of {len(rows)} and {fast['served']} of "
          f"{len(rows[::2])}")
    check(online["shapes"] == online["warmup_shapes"],
          f"serve CLI: {online['shapes']} program shapes run, {online['warmup_shapes']} warmed")
    waves, fast_waves = read_wavs(os.path.join(d, "out"), names), read_wavs(
        os.path.join(d, "fast"), names[::2])
    ref_fn = os.path.join(d, "ref.wav")
    for name in names:
        save_wav(by_name[name]["wav_out"], ref_fn, SR)
        ref = wavfile.read(ref_fn)[1]
        for label, other in (("--fast-io", fast_waves.get(name, waves[name])),
                             ("batch mode", ref)):
            same = other.shape == waves[name].shape
            check(same and np.array_equal(waves[name], other),
                  f"serve CLI {name}.wav: {label}'s samples differ ("
                  + (f"{int(np.sum(waves[name] != other))} of {other.size}" if same else
                     f"{other.shape} against {waves[name].shape}") + ")")
    print(f"[serve] online CLI (--warmup, --workers 2, --max-wait-ms 100): {online['served']} "
          f"requests in {online['wall_s']:.1f} s (process start and model load included), "
          f"latency p50 {online['p50_ms']:.0f} ms / p99 {online['p99_ms']:.0f} ms, "
          f"{online['chunks']} chunks, fill {online['fill']:.3f}; warmup {online['warmup_shapes']} "
          f"shapes in {online['warmup_s']:.1f} s, none added by the traffic; --fast-io on "
          f"{fast['served']} of them, unwarmed: p50 {fast['p50_ms']:.0f} / p99 "
          f"{fast['p99_ms']:.0f} ms, fill {fast['fill']:.3f}, {fast['wall_s']:.1f} s; "
          f"every wav 16-bit and bit-identical across the two runs and batch mode; {smi}",
          flush=True)
    stats.update(online=online, online_fast_io=fast)

    # int8 weights
    inf8 = SpecDenoiserInfer(dict(hp, serve_quant_int8=True), "cuda")
    t0 = time.perf_counter()
    res8 = BatchedEditServer(inf8, max_batch=SERVE_BATCH).edit_many(inputs)
    wall8 = time.perf_counter() - t0
    same = [(r, q) for r, q in zip(results, res8) if r["t_frames"] == q["t_frames"]]
    check(all(np.isfinite(q["mel_out"]).all() for q in res8) and same,
          "serve int8: non-finite mel_out or no request of the float length")
    diff8 = max(float(np.abs(r["mel_out"] - q["mel_out"]).max()) for r, q in same)
    stats["int8"] = dict(acoustic_bytes=inf8.quant.bytes, acoustic_f32_bytes=inf8.quant.f32_bytes,
                         hifigan_bytes=inf8.vocoder.quant.bytes,
                         hifigan_f32_bytes=inf8.vocoder.quant.f32_bytes,
                         max_quant_err=inf8.quant.max_err, mel_max_abs_diff=diff8,
                         same_length=len(same), batch_s=wall8,
                         requests_per_s=len(inputs) / wall8)
    print(f"[serve] int8 weights: acoustic model {inf8.quant.bytes} bytes against "
          f"{inf8.quant.f32_bytes} in float32, HiFi-GAN {inf8.vocoder.quant.bytes} against "
          f"{inf8.vocoder.quant.f32_bytes}; max quantization error {inf8.quant.max_err:.3e}; "
          f"{len(same)} of {len(inputs)} requests keep the float run's length, their mel_out "
          f"within {diff8:.3e} of it; batch mode {wall8:.3f} s, "
          f"{len(inputs) / wall8:.3f} requests/s; {smi}", flush=True)
    return launches, dict(stats, card=smi)


# -- in-place path ---------------------------------------------------------------

# the in-place editing families: their drivers and shipped configs
INPLACE = (("campnet", CampNetInfer, "egs/campnet.yaml"), ("a3t", A3TInfer, "egs/a3t.yaml"),
           ("editspeech", EditSpeechInfer, "egs/editspeech.yaml"))
# K3 launches of one CampNet forward: its 3 encoder layers and 6 decoder layers
CAMPNET_K3 = 9
INPLACE_CPU_T = 128       # the frame bucket of the chunk re-run on the CPU
INPLACE_CPU_TOL = 1e-3    # card vs CPU mel_out of that chunk
INPLACE_PROFILE_T = 512   # the frame bucket of the profiled chunk
INPLACE_INT8 = "editspeech"   # the family served on int8 weights (LSTM, conv and linear layouts)


def expected_inplace(family: str, forwards: int) -> dict:
    """Launches of ``forwards`` model forwards: K3 for CampNet, nothing else."""
    return {k: (CAMPNET_K3 * forwards if family == "campnet" and k == "flash_mha" else 0)
            for k in COUNTERS}


def write_inplace_checkpoint(cls, hp: dict, work: str, seed: int) -> int:
    """Seeded weights at the config's widths (flax's initializers, then
    every 1-axis parameter and CampNet's mask embedding moved by 0.05 x a
    normal draw, as trained ones are not zero) as a port checkpoint in
    ``work``; returns the parameter count."""
    vocab = build_token_encoder(os.path.join(hp["binary_data_dir"], "phone_set.json")).vocab_size
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = init_like_flax(cls.model_cls(vocab, hp, 80))
        with torch.no_grad():
            for name, p in model.named_parameters():
                if p.ndim <= 1 or name == "mask_emb":
                    p.add_(torch.randn_like(p) * 0.05)
    save_checkpoint(work, {"model": model.state_dict()}, 1)
    return sum(p.numel() for p in model.parameters())


@contextlib.contextmanager
def fusion_indices(found: list, replay: bool):
    """Within the block EditSpeech's splice frames (``fusion_index``) are
    recorded into ``found``; with ``replay`` the recorded ones are taken
    instead and those that differ counted (two frames whose disagreements
    lie within rounding of each other). Yields ``[flips, calls]``."""
    orig, tally = editspeech_module.fusion_index, [0, 0]

    def fusion_index(*args):
        got = orig(*args)
        if not replay:
            found.append(got.clone())
            return got
        want = found[tally[1]].to(got.device)
        tally[0] += int((got != want).sum())
        tally[1] += 1
        return want

    editspeech_module.fusion_index = fusion_index
    try:
        yield tally
    finally:
        editspeech_module.fusion_index = orig


def check_inplace_results(family: str, inputs: list, results: list, rec: ChunkRecorder) -> None:
    """Each chunk launches the family's kernels; every result finite, of
    its source's length, every frame outside the edit's mask the source's."""
    for c in rec.of("fwd"):
        check(c["launches"] == expected_inplace(family, 1),
              f"{family}: chunk {c['s_b']}x{c['t_b']} launched {c['launches']}")
    for inp, res in zip(inputs, results):
        mel, keep = inp["mel"], res["time_mel_masks"][:, 0] == 0
        check(res["mel_out"].shape == mel.shape and np.isfinite(res["mel_out"]).all()
              and np.isfinite(res["wav_out"]).all() and len(res["wav_out"]) == len(mel) * HOP,
              f"{family} {inp['item_name']}: result shape or values")
        check(keep.any() and not keep.all() and np.array_equal(res["mel_out"][keep], mel[keep]),
              f"{family} {inp['item_name']}: frames outside the edit differ from the source")


def inplace_profile(family: str, server, chunk: dict, smi: str) -> dict:
    """One chunk re-run on the card: its host time (median of 3), and from
    ``torch.profiler`` its device busy time and operations, K3's share and
    HiFi-GAN's (profiled alone on a chunk-shaped mel)."""
    reqs, args = chunk["reqs"], (chunk["s_b"], chunk["t_b"], chunk["b"])
    run = lambda: BatchedInPlaceEditServer.run_fwd_chunk(server, reqs, *args)
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        host.append((time.perf_counter() - t0) * 1e3)
    events, busy = profiled(run)
    kernels = device_ops(events)
    k3 = sum(e.self_device_time_total for e in kernels if "attention_fwd" in e.key) / 1e3
    mel = torch.zeros(chunk["b"], chunk["t_b"], 80, device="cuda") - 4.0
    voc = profiled(lambda: server.infer.vocoder.spec2wav_batch_dev(mel))[1]
    out = dict(shape=[chunk["b"], chunk["t_b"]], s_b=chunk["s_b"], rows=chunk["n"],
               host_ms=float(np.median(host)), busy_ms=busy,
               device_ops=sum(e.count for e in kernels), k3_ms=k3, hifigan_ms=voc)
    if busy == 0:
        print(f"[inplace] {family}: profiled chunk: the profiler saw no device time, busy not "
              f"measured; host {out['host_ms']:.3f} ms", flush=True)
        return out
    print(f"[inplace] {family}: profiled chunk B={chunk['b']} x T={chunk['t_b']} "
          f"(S={chunk['s_b']}, {chunk['n']} real rows): host {out['host_ms']:.3f} ms (median of "
          f"3), device busy {busy:.3f} ms ({busy / out['host_ms']:.3f} of it) in "
          f"{out['device_ops']} operations; K3 {k3:.3f} ms ({k3 / busy:.3f}), HiFi-GAN alone on "
          f"the chunk's shape {voc:.3f} ms ({voc / busy:.3f}); {smi}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
              f"{e.key[:90]}", flush=True)
    return out


def inplace_cpu_rerun(family: str, cls, hp: dict, server, chunk: dict, results: dict) -> dict:
    """One chunk again on the card, bit-identical to its first run
    (EditSpeech's splice frames recorded), then on the CPU (plain versions,
    the splice frames replayed and counted, the vocoder left out): mel_out
    within INPLACE_CPU_TOL."""
    reqs, args = chunk["reqs"], (chunk["s_b"], chunk["t_b"], chunk["b"])
    found: list = []
    with fusion_indices(found, replay=False):
        BatchedInPlaceEditServer.run_fwd_chunk(server, reqs, *args)
    again = all(np.array_equal(r.result["mel_out"], results[r.item["item_name"]]["mel_out"])
                for r in reqs)
    check(again, f"{family}: a chunk run again gave other mels")
    cpu = cls.make_server(cls(hp, "cpu"), max_batch=SERVE_BATCH)
    cpu.infer.vocoder = types.SimpleNamespace(       # mel_out is compared, not audio
        device_batched=False, spec2wav_batch=lambda mels: np.zeros((len(mels), 1)))
    cpu_reqs = [copy.copy(r) for r in reqs]
    t0 = time.perf_counter()
    with fusion_indices(found, replay=True) as tally:
        cpu.run_fwd_chunk(cpu_reqs, *args)
    err = max(float(np.abs(c.result["mel_out"] - r.result["mel_out"]).max())
              for c, r in zip(cpu_reqs, reqs))
    splice = int(sum(f.numel() for f in found))
    out = dict(shape=[chunk["b"], chunk["t_b"]], rows=chunk["n"], cpu_s=time.perf_counter() - t0,
               fusion_replayed=tally[0], fusion_rows=splice, mel_max_abs_err=err)
    print(f"[inplace] {family}: chunk B={chunk['b']} x T={chunk['t_b']} ({chunk['n']} real rows) "
          f"run again on the card: bit-identical; on the CPU ({out['cpu_s']:.1f} s): "
          + (f"splice frames replayed {tally[0]} of {splice}, " if family == "editspeech" else "")
          + f"mel_out max_abs_err {err:.3e} (tol {INPLACE_CPU_TOL})", flush=True)
    check(err <= INPLACE_CPU_TOL,
          f"{family}: card vs CPU chunk mel_out error {err} > {INPLACE_CPU_TOL}")
    return out


def inplace_csv(family: str, cls, hp: dict, rows: list, out_dir: str) -> dict:
    """The family's CSV edit API over the infer path's four requests: an
    output and a _ref wav each, one model forward's launches an edit; then
    one request again through a new driver, bit-identical, its frames
    outside the mask the source's."""
    launches = []
    orig = cls.forward_model

    def forward_model(inf, item):
        before = counts()
        out = orig(inf, item)
        launches.append({k: counts()[k] - before[k] for k in COUNTERS})
        return out
    cls.forward_model = forward_model
    t0 = time.perf_counter()
    try:
        cls.example_run(rows, hp, out_dir=out_dir, device="cuda")
    finally:
        cls.forward_model = orig
    wall = time.perf_counter() - t0
    check(len(launches) == len(rows) and all(
        os.path.exists(os.path.join(out_dir, f"{r['item_name']}{sfx}.wav"))
        for r in rows for sfx in ("", "_ref")), f"{family} CSV: {len(launches)} edits, "
                                                  f"wavs {sorted(os.listdir(out_dir))}")
    check(all(n == expected_inplace(family, 1) for n in launches),
          f"{family} CSV: launches {launches}")
    inf = cls(hp, "cuda")
    spec = wav2spec(rows[0]["wav_fn_orig"], **csv_spec_kw(hp))
    item = inf.preprocess_input(dict(rows[0], mel=spec["mel"], wav=spec["wav"]))
    first, second = inf.forward_model(item)[2], inf.forward_model(item)[2]
    keep = inf._frame_mask(item) == 0
    check(np.array_equal(first, second) and np.isfinite(first).all()
          and np.array_equal(first[keep], item["mel"][keep]),
          f"{family} CSV: a request twice differs, or frames outside the mask changed")
    print(f"[inplace] {family}: CSV edit API, {len(rows)} edits in {wall:.2f} s (driver load "
          f"included), launches an edit {launches[0]}; the same request again bit-identical, "
          f"frames outside the mask the source's", flush=True)
    return dict(edits=len(rows), wall_s=wall, launches_per_edit=launches[0])


def csv_spec_kw(hp: dict) -> dict:
    return dict(sample_rate=hp["audio_sample_rate"], fft_size=hp["fft_size"],
                hop_size=hp["hop_size"], win_length=hp.get("win_size", hp["fft_size"]),
                num_mels=hp["audio_num_mel_bins"], fmin=hp["fmin"], fmax=hp["fmax"])


def inplace_family(family: str, cls, config: str, smi: str, tmp: str, data_dir: str,
                   seed: int) -> tuple[dict, dict]:
    """One in-place family at its shipped widths: a seeded port checkpoint,
    the CSV edit API, batch mode over the serve path's 32 requests (warmed;
    checked, timed), one request alone, at another row and at its exact-fit
    bucket with max_batch 1 against the per-item driver (bit for bit), a
    profiled B=16 x T=512 chunk, a 128-frame chunk re-run on the CPU.
    Returns the batch run's launches and the statistics."""
    voc_dir = os.path.join(tmp, "hifigan")
    work = os.path.join(tmp, "inplace", family)
    argv_hp = ["--config", config, "--exp_name", work, "-hp",
               f"binary_data_dir={data_dir},vocoder_ckpt={voc_dir}"]
    hp = set_hparams(arg_parser().parse_args(argv_hp + ["--infer"]), print_hparams=False)
    check(cls.__name__.lower().startswith(family) and family in hp["task_cls"].lower(),
          f"{config}: task_cls {hp['task_cls']}")
    n_params = write_inplace_checkpoint(cls, hp, work, seed)
    csv_rows = [dict(item_name=f"edit{i}", text=text, edited_text=edited,
                     wav_fn_orig=os.path.join(tmp, "csv", f"edit{i}.wav"),
                     edited_region=edited_region, region=region,
                     mfa_textgrid=os.path.join(tmp, "csv", f"edit{i}.TextGrid"))
                for i, (_, _, text, edited, region, edited_region) in enumerate(CSV_ROWS)]
    csv_stats = inplace_csv(family, cls, hp, csv_rows, os.path.join(work, "csv_out"))

    rows = serve_row_specs(os.path.join(tmp, "serve"))
    inputs = [load_request(r, hp) for r in rows]
    names = [r["item_name"] for r in rows]
    inf = cls(hp, "cuda")
    check(inf.vocoder.kind == "hifigan" and inf.vocoder.device_batched,
          f"{family}: vocoder {inf.vocoder.kind}, expected HiFi-GAN on the card")
    server = cls.make_server(inf, max_batch=SERVE_BATCH)
    t0 = time.perf_counter()
    n_warm = server.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warmed = set(server.program_shapes)
    rec = ChunkRecorder(server)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = server.edit_many(inputs)
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(server.program_shapes == warmed, f"{family}: traffic ran a shape warmup did not")
    check_inplace_results(family, inputs, results, rec)
    chunks = rec.of("fwd")
    check(launches == expected_inplace(family, len(chunks)),
          f"{family}: batch launches {launches}")
    by_name = dict(zip(names, results))
    fwd_s = sum(c["s"] for c in chunks)
    audio = sum(r["t_frames"] for r in results) * HOP / SR
    edited = sum(float(r["time_mel_masks"].sum()) for r in results) * HOP / SR
    stats = dict(params=n_params, csv=csv_stats, requests=len(inputs), audio_s=audio,
                 edited_span_s=edited, warmup_s=warm_s, warmup_shapes=n_warm, batch_s=wall,
                 requests_per_s=len(inputs) / wall, audio_s_per_s=audio / wall,
                 edited_span_s_per_s=edited / wall, fwd_chunks_s=fwd_s,
                 prepare_s=wall - fwd_s, peak_gib=peak,
                 chunks=[(c["s_b"], c["t_b"], c["n"], c["b"], round(c["s"], 4)) for c in chunks],
                 fill=sum(c["n"] for c in chunks) / sum(c["b"] for c in chunks))
    print(f"[inplace] {family} ({config}, {n_params} parameters): warmup {n_warm} program "
          f"shapes in {warm_s:.2f} s; batch mode: {len(inputs)} requests ({audio:.1f} s of "
          f"audio, {edited:.1f} s of it edited) in {wall:.3f} s: "
          f"{stats['requests_per_s']:.3f} requests/s, {stats['audio_s_per_s']:.3f} audio s/s "
          f"({stats['edited_span_s_per_s']:.3f} edited s/s); host front end "
          f"{stats['prepare_s']:.3f} s, {len(chunks)} chunks {fwd_s:.3f} s (fill "
          f"{stats['fill']:.3f}); peak memory {peak:.3f} GiB; launches {launches}; no shape "
          f"after warmup; {smi}", flush=True)
    for c in chunks:
        print(f"[inplace] {family} chunk S={c['s_b']} T={c['t_b']}: {c['n']}/{c['b']} rows, "
              f"{c['s'] * 1e3:.3f} ms host", flush=True)

    # one request alone, at another row, and at its exact-fit bucket
    alone_name = names[SERVE_ALONE]
    alone = server.edit_many([inputs[SERVE_ALONE]])[0]["mel_out"]
    row1 = server.edit_many([inputs[SERVE_ALONE + 1], inputs[SERVE_ALONE]])[1]["mel_out"]
    check(np.array_equal(alone, by_name[alone_name]["mel_out"]) and np.array_equal(row1, alone),
          f"{family} {alone_name}: alone, co-batched and at row 1 not bit-identical")
    item = inf.preprocess_input(inputs[SERVE_ALONE])
    fit = cls.make_server(inf, max_batch=1, frame_buckets=(len(item["mel"]),),
                          token_buckets=(len(item[inf._token_field]),))
    got = fit.edit_many([inputs[SERVE_ALONE]])[0]
    per_item = inf.forward_model(item)
    check(np.array_equal(got["mel_out"], per_item[2]) and np.array_equal(got["wav_out"],
                                                                         per_item[0]),
          f"{family} {alone_name}: exact fit at max_batch 1 differs from the per-item driver")
    print(f"[inplace] {family} {alone_name} ({len(item['mel'])} frames): alone, in its 16-row "
          f"chunk and at row 1 bit-identical; at its exact-fit bucket with max_batch 1 the "
          f"server's mel and wav equal the per-item driver's bit for bit", flush=True)
    stats["profile"] = inplace_profile(
        family, server, next(c for c in chunks if c["t_b"] == INPLACE_PROFILE_T
                             and c["n"] == c["b"]), smi)
    stats["cpu"] = inplace_cpu_rerun(family, cls, hp, server,
                                     next(c for c in chunks if c["t_b"] == INPLACE_CPU_T),
                                     by_name)
    if family == "campnet":    # every other request
        online = serve_cli(argv_hp, rows[::2], os.path.join(work, "online"), ["--warmup"])
        check(online["served"] == len(rows[::2]) and online["shapes"] == online["warmup_shapes"],
              f"{family} serve CLI: served {online['served']}, {online['shapes']} shapes run, "
              f"{online['warmup_shapes']} warmed")
        waves = read_wavs(os.path.join(work, "online"), names[::2])
        ref_fn = os.path.join(work, "ref.wav")
        for name in names[::2]:
            save_wav(by_name[name]["wav_out"], ref_fn, SR)
            check(np.array_equal(wavfile.read(ref_fn)[1], waves[name]),
                  f"{family} serve CLI {name}.wav: samples differ from batch mode's")
        print(f"[inplace] {family} online CLI (--warmup, --workers 2, --max-wait-ms 100): "
              f"{online['served']} requests in {online['wall_s']:.1f} s (process start and "
              f"model load included), latency p50 {online['p50_ms']:.0f} ms / p99 "
              f"{online['p99_ms']:.0f} ms, {online['chunks']} chunks, fill "
              f"{online['fill']:.3f}; warmup {online['warmup_shapes']} shapes in "
              f"{online['warmup_s']:.1f} s, none added by the traffic; every wav the batch "
              f"mode's, bit for bit; {smi}", flush=True)
        stats["online"] = online
    if family == INPLACE_INT8:
        inf8 = cls(dict(hp, serve_quant_int8=True), "cuda")
        server8 = cls.make_server(inf8, max_batch=SERVE_BATCH)
        t0 = time.perf_counter()
        res8 = server8.edit_many(inputs)
        wall8 = time.perf_counter() - t0
        check(all(np.isfinite(q["mel_out"]).all() for q in res8), f"{family} int8: non-finite")
        diff8 = max(float(np.abs(r["mel_out"] - q["mel_out"]).max())
                    for r, q in zip(results, res8))
        # again with the float run's splice frames: the weights' own effect
        found: list = []
        with fusion_indices(found, replay=False):
            again = server.edit_many(inputs)
        check(all(np.array_equal(a["mel_out"], r["mel_out"]) for a, r in zip(again, results)),
              f"{family}: batch mode run again gave other mels")
        with fusion_indices(found, replay=True) as tally:
            replayed = server8.edit_many(inputs)
        diff_same = max(float(np.abs(r["mel_out"] - q["mel_out"]).max())
                        for r, q in zip(results, replayed))
        splice = int(sum(f.numel() for f in found))
        stats["int8"] = dict(bytes=inf8.quant.bytes, f32_bytes=inf8.quant.f32_bytes,
                             max_quant_err=inf8.quant.max_err, mel_max_abs_diff=diff8,
                             splice_flips=tally[0], splice_rows=splice,
                             mel_max_abs_diff_same_splice=diff_same,
                             batch_s=wall8, requests_per_s=len(inputs) / wall8)
        print(f"[inplace] {family} int8 weights: {inf8.quant.bytes} bytes against "
              f"{inf8.quant.f32_bytes} in float32; max quantization error "
              f"{inf8.quant.max_err:.3e}; mel_out within {diff8:.3e} of the float run's; "
              f"{tally[0]} of {splice} chunk rows splice at another frame than the float run, "
              f"and with the float run's splice frames mel_out is within {diff_same:.3e}; "
              f"batch mode {wall8:.3f} s, {len(inputs) / wall8:.3f} requests/s; {smi}",
              flush=True)
    return launches, dict(stats, card=smi)


def inplace_path(smi: str, tmp: str, data_dir: str) -> tuple[dict, dict]:
    """The three in-place families in turn (``inplace_family``), after the
    serve path, on its requests, the infer path's CSV requests and HiFi-GAN
    V1 and the run path's phone set. Returns the launches of the three batch
    runs summed and each family's statistics."""
    t0 = time.perf_counter()
    total, stats = {k: 0 for k in COUNTERS}, {}
    for i, (family, cls, config) in enumerate(INPLACE):
        launches, stats[family] = inplace_family(family, cls, config, smi, tmp, data_dir, i)
        total = {k: total[k] + launches[k] for k in COUNTERS}
    stats["seconds"] = time.perf_counter() - t0
    print(f"[inplace] three families in {stats['seconds']:.1f} s; launches {total}", flush=True)
    return total, stats


# -- family train path -------------------------------------------------------------

# the five editing families the run path does not train, each through the
# training entry at its config's widths, in this order: the predictor
# warm-starts from StutterSpeech's checkpoint
FAMILIES = ("stutter_speech", "stutter_predictor", "campnet", "a3t", "editspeech")
FAMILY_TASKS = {"stutter_speech": "StutterSpeechTask", "stutter_predictor":
                "StutterPredictorTask", "campnet": "CampNetTask", "a3t": "A3TTask",
                "editspeech": "EditSpeechTask"}
FAMILY_SPLITS = {"train": 128, "valid": 16, "test": 2}
FAMILY_STEPS, FAMILY_VALID = 12, 2
# the loader in process (ds_workers=0): the run path drives the spawned
# workers, and their start-up was much of each family's minute on a slow host
FAMILY_HP = (f"max_updates={FAMILY_STEPS},val_check_interval={FAMILY_STEPS},"
             f"num_sanity_val_steps=0,eval_max_batches={FAMILY_VALID},tb_log_interval=10,"
             f"test_num={FAMILY_SPLITS['test']},test_save_workers=1,ds_workers=0")
# launches a step, a validation batch and a --infer item (one a batch)
FAMILY_LAUNCHES = {
    "stutter_speech": (dict(NO_LAUNCH, diffnet_block=RUN_LAYERS, diffnet_block_bwd=RUN_LAYERS),
                       dict(NO_LAUNCH, diffnet_block=RUN_LAYERS), EXPECTED_PER_EDIT),
    "campnet": (dict(NO_LAUNCH, flash_mha=CAMPNET_K3, flash_mha_bwd=CAMPNET_K3),
                dict(NO_LAUNCH, flash_mha=CAMPNET_K3), dict(NO_LAUNCH, flash_mha=CAMPNET_K3))}
FAMILY_CPU_STEP = ("stutter_speech", "campnet")   # stepped on the card and on the CPU
# the same families under -hp use_bf16=true: a few steps, one validation
# batch (float32, as JAX validates) and a checkpoint of float32 masters
FAMILY_BF16_STEPS = RUN_WARMUP + 5
FAMILY_BF16_HP = (f"use_bf16=true,max_updates={FAMILY_BF16_STEPS},"
                  f"val_check_interval={FAMILY_BF16_STEPS},num_sanity_val_steps=0,"
                  f"eval_max_batches=1,tb_log_interval=10,ds_workers=0")
FAMILY_BF16_LAUNCHES = {
    "stutter_speech": (dict(NO_LAUNCH, diffnet_block_bf16=RUN_LAYERS,
                            diffnet_block_bwd_bf16=RUN_LAYERS),
                       dict(NO_LAUNCH, diffnet_block=RUN_LAYERS)),
    "campnet": (dict(NO_LAUNCH, flash_mha_bf16=CAMPNET_K3, flash_mha_bwd_bf16=CAMPNET_K3),
                dict(NO_LAUNCH, flash_mha=CAMPNET_K3))}
FAMILY_BF16_CPU_STEP = ("campnet",)


@contextlib.contextmanager
def warm_starts(found: list):
    """Records the predictor's ``txt_encoder`` right after each warm start
    (before any step), and the checkpoint it came from."""
    orig = StutterPredictorTask.warm_start_text_encoder

    def wrapper(task, model, path):
        ckpt = orig(task, model, path)
        found.append((ckpt, {k: v.clone() for k, v in model.txt_encoder.state_dict().items()}))
        return ckpt

    StutterPredictorTask.warm_start_text_encoder = wrapper
    try:
        yield found
    finally:
        StutterPredictorTask.warm_start_text_encoder = orig


def family_train(family: str, smi: str, tmp: str, data_dir: str,
                 bf16: bool = False) -> tuple[dict, dict]:
    """One family through the training entry on the card at its config's
    widths: FAMILY_STEPS steps, one validation of FAMILY_VALID batches and a
    checkpoint, then ``--infer`` on the test split from that checkpoint.
    Every step's, validation batch's and item's launches are checked, and
    every metric is finite; the timed steps (after RUN_WARMUP), peak memory
    and a profiled median step are printed; StutterSpeech and CampNet step
    once on the card and on the CPU. With ``bf16``, under ``-hp
    use_bf16=true``: FAMILY_BF16_STEPS steps, one validation batch and a
    checkpoint of float32 masters, no ``--infer``; CampNet steps on the card
    and on the CPU at the BF16_* bars, and EditSpeech's profile must show
    cuDNN's recurrence. Returns the launches and statistics."""
    q = lambda xs, p: float(np.percentile(xs, p))
    root = os.path.join(tmp, "family_bf16" if bf16 else "family")
    work = os.path.join(root, family)
    extra = (f",spec_denoiser_work_dir={os.path.join(root, 'stutter_speech')}"
             if family == "stutter_predictor" else "")
    steps, n_valid = (FAMILY_BF16_STEPS, 1) if bf16 else (FAMILY_STEPS, FAMILY_VALID)
    argv = ["--config", f"egs/{family}.yaml", "--exp_name", work, "-hp",
            f"binary_data_dir={data_dir},vocoder_ckpt={os.path.join(tmp, 'hifigan')},"
            f"{FAMILY_BF16_HP if bf16 else FAMILY_HP}{extra}"]
    if bf16:
        per_step, per_valid = FAMILY_BF16_LAUNCHES.get(family, (NO_LAUNCH,) * 2)
        per_item = NO_LAUNCH
    else:
        per_step, per_valid, per_item = FAMILY_LAUNCHES.get(family, (NO_LAUNCH,) * 3)
    label = f"{family} bf16" if bf16 else family
    rec, found = RunRecorder(), []
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with rec.instrumented(), warm_starts(found):
        trainer = run_entry(argv)
    train_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = counts()
    check(type(trainer.task).__name__ == FAMILY_TASKS[family],
          f"{family}: task {type(trainer.task).__name__}")
    check(bool(trainer.hp.get("use_bf16")) == bf16, f"{label}: use_bf16 {trainer.hp.get('use_bf16')}")
    check(len(rec.steps) == steps and len(rec.valid) == n_valid,
          f"{label}: {len(rec.steps)} steps, {len(rec.valid)} validation batches")
    for st in rec.steps:
        check(st["launches"] == per_step,
              f"{label} step {st['step']}: launches {st['launches']} != {per_step}")
        m = {k: float(v) for k, v in st["metrics"].items()}
        check(all(np.isfinite(v) for v in m.values()) and m["nan_grads"] == 0,
              f"{label} step {st['step']}: non-finite metrics {m}")
    for moved in rec.valid:
        check(moved == per_valid, f"{label} validation batch: launches {moved} != {per_valid}")
    ckpt = os.path.join(work, f"model_ckpt_steps_{steps}.ckpt")
    check(os.path.exists(ckpt), f"{label}: checkpoints {sorted(os.listdir(work))}")
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)["state"]
    check(float_dtypes(saved) == {torch.float32},
          f"{label}: the checkpoint holds {float_dtypes(saved)}, not float32 only")
    stats = {"task": FAMILY_TASKS[family], "train_s": train_s, "peak_gib": peak_gib,
             "params": sum(p.numel() for p in trainer.model.parameters())}
    if family == "stutter_predictor":
        src = os.path.join(root, "stutter_speech", f"model_ckpt_steps_{steps}.ckpt")
        enc = {k[len("fs.encoder."):]: v for k, v in
               torch.load(src, map_location="cpu", weights_only=True)["state"]["model"].items()
               if k.startswith("fs.encoder.")}
        check(len(found) == 1 and found[0][0] == src and sorted(found[0][1]) == sorted(enc)
              and all(torch.equal(found[0][1][k].cpu(), v) for k, v in enc.items()),
              f"{family}: txt_encoder is not {src}'s fs.encoder bit for bit")
        print(f"[family] {family}: txt_encoder warm-started from {src}: its fs.encoder "
              f"({len(enc)} tensors) bit for bit", flush=True)

    timed = rec.steps[RUN_WARMUP:]
    ev, host = [st["event_ms"] for st in timed], [st["host_ms"] for st in timed]
    m = {k: float(v) for k, v in rec.steps[-1]["metrics"].items()}
    stats.update(timed_steps=len(timed), launches_per_step=per_step,
                 host_ms_p50=q(host, 50), host_ms_p75=q(host, 75), event_ms_p50=q(ev, 50),
                 steps_per_s_host=1e3 / q(host, 50),
                 padded_frames_p50=q([st["shape"][1] for st in timed], 50),
                 real_frames_per_step_mean=sum(st["frames"] for st in timed) / len(timed),
                 last_metrics=m)
    print(f"[family] {label} (egs/{family}.yaml, {stats['params']} parameters), "
          f"{len(timed)} timed steps of {steps}: host clock p50 "
          f"{stats['host_ms_p50']:.3f} ms, p75 {stats['host_ms_p75']:.3f} ms "
          f"({stats['steps_per_s_host']:.2f} steps/s), CUDA events p50 "
          f"{stats['event_ms_p50']:.3f} ms; padded frames p50 "
          f"{stats['padded_frames_p50']:.0f}, {stats['real_frames_per_step_mean']:.0f} real "
          f"frames a step; launches a step {per_step}; peak memory {peak_gib:.3f} GiB; "
          f"{train_s:.1f} s with the validation and the checkpoint; {smi}", flush=True)
    print(f"[family] {label} last step: "
          + " ".join(f"{k}={v:.5f}" for k, v in sorted(m.items())), flush=True)
    mid = sorted(timed, key=lambda st: st["shape"][1])[len(timed) // 2]
    raw = {k: v.pin_memory() if isinstance(v, torch.Tensor) else v
           for k, v in mid["raw"].items()}
    b, t = mid["shape"]
    events: list = []
    busy_ms = profile_step(trainer, raw, mid["host_ms"], top=8,
                           label=f"{label} B={b} x T={t}", keep=events)
    stats.update(profiled_batch=[b, t], profiled_host_ms=mid["host_ms"],
                 profiled_busy_ms=busy_ms,
                 profiled_busy_share=None if busy_ms is None else busy_ms / mid["host_ms"])
    if bf16 and family == "editspeech":
        stats["recurrence"] = check_cudnn_recurrence(events)
    if family in (FAMILY_BF16_CPU_STEP if bf16 else FAMILY_CPU_STEP):
        keys = trainer.task.effective_batch_keys()
        compare_step_with_cpu(label, lambda dev: Trainer(trainer.task, trainer.hp, dev,
                                                         dropout=False),
                              trainer.train_step.state_dict(), {k: raw[k][:2] for k in keys},
                              diffusion=family == "stutter_speech", bf16=bf16)
    if bf16:
        return launches, dict(stats, card=smi)

    # --infer from the checkpoint: the state loaded bit for bit, every item's launches
    rec_t, irec = RunRecorder(), InferRecorder()
    before = counts()
    t0 = time.perf_counter()
    with rec_t.instrumented(), irec.instrumented():
        tester = run_entry(argv + ["--infer"])
    infer_s = time.perf_counter() - t0
    launches = {k: launches[k] + counts()[k] - before[k] for k in COUNTERS}
    check(states_equal(rec_t.loaded, saved),
          f"{family} --infer: the loaded state is not the checkpoint's bit for bit")
    gen_dir = os.path.join(work, f"generated_{FAMILY_STEPS}_test")
    meta = check_test_set(gen_dir, irec, FAMILY_SPLITS["test"], per_item)
    if family == "stutter_predictor":
        with open(os.path.join(gen_dir, "meta.csv")) as f:
            header = next(csv.reader(f))
        check(header[-1] == "stutter_pred" and all(
            set(r[-1].split()) <= {"0", "1", "2"} and r[-1] for r in meta),
            f"{family}: meta.csv {header} {meta}")
    stats.update(infer_s=infer_s, infer_items=len(meta), infer_forward_s=irec.seconds["forward"],
                 infer_vocoder_s=irec.seconds["vocoder"], infer_launches_per_item=per_item)
    print(f"[family] {family} --infer: {len(meta)} test items from step "
          f"{tester.global_step}'s checkpoint (loaded bit for bit) in {infer_s:.1f} s "
          f"(forwards {irec.seconds['forward']:.2f} s, HiFi-GAN {irec.seconds['vocoder']:.2f} "
          f"s), launches an item {per_item}; frames outside the mask the ground truth's"
          + ("; block labels in meta.csv" if family == "stutter_predictor" else ""), flush=True)
    return launches, dict(stats, card=smi)


def family_train_path(smi: str, tmp: str, bf16: bool = False) -> tuple[dict, dict]:
    """The five families (FAMILIES) through the training entry on one
    synthetic corpus with per-frame stutter labels (FAMILY_SPLITS, 150-700
    frames, written by the float32 pass and read again by the ``bf16``
    one) and the infer path's HiFi-GAN. Returns the launches summed and
    each family's statistics."""
    t0 = time.perf_counter()
    data_dir = os.path.join(tmp, "family_data")
    if not bf16:
        write_run_corpus(data_dir, seed=3, splits=FAMILY_SPLITS, stutter=True)
    total, stats = dict(NO_LAUNCH), {}
    for family in FAMILIES:
        launches, stats[family] = family_train(family, smi, tmp, data_dir, bf16)
        total = {k: total[k] + launches[k] for k in COUNTERS}
    stats["seconds"] = time.perf_counter() - t0
    print(f"[family] five families{' in bf16' if bf16 else ''} in {stats['seconds']:.1f} s; "
          f"launches {total}", flush=True)
    names = ("diffnet_block_bf16", "diffnet_block_bwd_bf16", "flash_mha_bf16",
             "flash_mha_bwd_bf16") if bf16 else ("diffnet_block", "diffnet_block_bwd",
                                                 "flash_mha", "flash_mha_bwd")
    for name in names:
        check(total[name] > 0, f"{name} was not launched on the family train path")
    return total, stats


def check_cudnn_recurrence(events: list) -> dict:
    """EditSpeech's bf16 step runs its LSTMs through cuDNN's recurrence
    (``aten::_cudnn_rnn``, a few launches a layer), not PyTorch's per-time-
    step cell (``aten::_thnn_fused_lstm_cell``, launches a frame): the
    operation counts from a profiled step."""
    host = {e.key: e.count for e in host_ops(events)}
    cudnn = sum(n for k, n in host.items() if "_cudnn_rnn" in k)
    cells = sum(n for k, n in host.items() if "lstm_cell" in k)
    print(f"[family] editspeech bf16 recurrence: {cudnn} aten::_cudnn_rnn calls (forward and "
          f"backward), {cells} per-step LSTM cell calls", flush=True)
    check(cudnn > 0 and cells == 0,
          f"editspeech bf16: the LSTMs left cuDNN ({cudnn} cuDNN calls, {cells} cell calls)")
    return dict(cudnn_rnn_calls=cudnn, lstm_cell_calls=cells)


# -- switches path -----------------------------------------------------------------

# the editing configs' remaining switches: each a few steps of
# egs/spec_denoiser.yaml as shipped on the run path's corpus, the loader in
# process, with a validation batch and a checkpoint; the three model
# switches in float32, gradient accumulation in bf16 as the yaml ships it
SWITCH_STEPS, SWITCH_ACCUM = 3, 2
SWITCHES = (("ref_pad_compat", "ref_pad_compat=true,use_bf16=False"),
            ("no_diffusion", "no_diffusion=true,use_bf16=False"),
            ("use_masked_cond", "use_masked_cond=false,use_bf16=False"),
            ("accumulate", f"accumulate_grad_batches={SWITCH_ACCUM}"))
SWITCH_HP = (f"max_updates={SWITCH_STEPS},val_check_interval={SWITCH_STEPS},"
             "num_sanity_val_steps=0,eval_max_batches=1,tb_log_interval=10,ds_workers=0,"
             "test_num=1,test_save_workers=1")
EXPECTED_SWITCH_STEP = dict(
    (name, EXPECTED_PER_RUN_STEP) for name, _ in SWITCHES[:3])
EXPECTED_SWITCH_STEP["accumulate"] = dict(
    NO_LAUNCH, diffnet_block_bf16=SWITCH_ACCUM * RUN_LAYERS,
    diffnet_block_bwd_bf16=SWITCH_ACCUM * RUN_LAYERS)
# an item of --infer under no_diffusion: one DiffNet call, no reverse run
EXPECTED_ONE_SHOT_ITEM = dict(NO_LAUNCH, diffnet_block=RUN_LAYERS)


@contextlib.contextmanager
def block_masks(tally: dict):
    """Counts DiffNet's block calls by their mask while the block runs:
    ``tally["null"]`` those without one (``ref_pad_compat``), ``"masked"``
    those with. The count wraps the names ``modules/wavenet.py`` calls, so
    the kernels' own launch counters are untouched."""
    orig = {n: getattr(wavenet_module, n) for n in ("diffnet_block", "diffnet_block_train")}

    def counted(fn):
        def wrapper(x, cond, step, mask, *args, **kwargs):
            tally["null" if mask is None else "masked"] += 1
            return fn(x, cond, step, mask, *args, **kwargs)
        return wrapper

    for name, fn in orig.items():
        setattr(wavenet_module, name, counted(fn))
    try:
        yield tally
    finally:
        for name, fn in orig.items():
            setattr(wavenet_module, name, fn)


def switch_run(name: str, hp: str, smi: str, tmp: str,
               data_dir: str) -> tuple[dict, tuple, dict]:
    """One switch through the training entry: SWITCH_STEPS updates, each
    moving the launch counters as expected (accumulation: both microbatches'
    bf16 K1 and K5), the blocks called without a mask under
    ``ref_pad_compat`` and with one otherwise, a validation batch and a
    checkpoint; a 2-utterance update of the shortest batch (two microbatches
    under accumulation) on the card and on the CPU. Returns the statistics,
    (B, T) of the median batch and the launches of the switch's own runs
    (training, and ``--infer`` under ``no_diffusion``), read before the
    card's twin of the CPU step runs."""
    q = lambda xs, p: float(np.percentile(xs, p))
    work = os.path.join(tmp, "switches", name)
    argv = ["--config", "egs/spec_denoiser.yaml", "--exp_name", work, "-hp",
            f"binary_data_dir={data_dir},vocoder_ckpt={os.path.join(tmp, 'hifigan')},"
            f"{SWITCH_HP},{hp}"]
    rec, tally = RunRecorder(), {"null": 0, "masked": 0}
    t0 = time.perf_counter()
    reset_counts()
    with rec.instrumented(), block_masks(tally):
        trainer = run_entry(argv)
    seconds = time.perf_counter() - t0
    launches = counts()
    if name == "no_diffusion":
        irec = InferRecorder()
        with irec.instrumented():
            tester = run_entry(argv + ["--infer"])
        moved = {k: counts()[k] - launches[k] for k in COUNTERS}
        launches = counts()
    expected, bf16 = EXPECTED_SWITCH_STEP[name], name == "accumulate"
    check(len(rec.steps) == SWITCH_STEPS and len(rec.valid) == 1,
          f"switch {name}: {len(rec.steps)} updates, {len(rec.valid)} validation batches")
    for st in rec.steps:
        check(st["launches"] == expected,
              f"switch {name} update {st['step']}: launches {st['launches']} != {expected}")
        check(len(st["raws"]) == (SWITCH_ACCUM if bf16 else 1),
              f"switch {name}: {len(st['raws'])} microbatches an update")
        m = {k: float(v) for k, v in st["metrics"].items()}
        check(all(np.isfinite(v) for v in m.values()) and m["nan_grads"] == 0,
              f"switch {name} update {st['step']}: non-finite metrics {m}")
    check(rec.valid[0] == EXPECTED_PER_VALID_BATCH,
          f"switch {name} validation batch: launches {rec.valid[0]}")
    blocks = (SWITCH_STEPS * (SWITCH_ACCUM if bf16 else 1) + 1) * RUN_LAYERS
    want = ({"null": blocks, "masked": 0} if name == "ref_pad_compat"
            else {"null": 0, "masked": blocks})
    check(tally == want, f"switch {name}: block calls by mask {tally} != {want}")
    runs = {k: sum(st["launches"][k] for st in rec.steps) + rec.valid[0][k]
            + (moved[k] if name == "no_diffusion" else 0) for k in COUNTERS}
    check(launches == runs, f"switch {name}: launches {launches} != its updates', validation "
                            f"batch's and items' {runs}")
    check(os.path.exists(os.path.join(work, f"model_ckpt_steps_{SWITCH_STEPS}.ckpt")),
          f"switch {name}: checkpoints {sorted(os.listdir(work))}")
    host = [st["host_ms"] for st in rec.steps]
    m = {k: float(v) for k, v in rec.steps[-1]["metrics"].items()}
    mid = sorted(rec.steps, key=lambda st: st["shape"][1])[len(rec.steps) // 2]
    stats = {"hp": hp, "updates": len(rec.steps), "host_ms_p50": q(host, 50),
             "host_ms_p75": q(host, 75), "launches_per_update": expected,
             "block_calls": tally, "seconds": seconds, "last_metrics": m,
             "median_batch": list(mid["shape"])}
    print(f"[switches] {name} ({hp}): {len(rec.steps)} updates of "
          f"{SWITCH_ACCUM if bf16 else 1} batch(es) at B x T "
          f"{[st['shape'] for st in rec.steps]}; host clock p50 {stats['host_ms_p50']:.3f} "
          f"ms, p75 {stats['host_ms_p75']:.3f} ms an update; launches an update {expected}; "
          f"DiffNet blocks {tally}; a validation batch and a checkpoint; {seconds:.1f} s; "
          f"{smi}", flush=True)
    print(f"[switches] {name} last update: "
          + " ".join(f"{k}={v:.5f}" for k, v in sorted(m.items())), flush=True)
    short = min(rec.steps, key=lambda st: st["shape"][1])
    keys = trainer.task.effective_batch_keys()
    sub = [{k: r[k][:2] for k in keys} for r in short["raws"]]
    compare_step_with_cpu(f"switches {name}", lambda dev: Trainer(trainer.task, trainer.hp, dev,
                                                                  dropout=False),
                          trainer.train_step.state_dict(), sub if bf16 else sub[0], bf16=bf16)
    if name == "no_diffusion":
        check(moved == EXPECTED_ONE_SHOT_ITEM,
              f"switch {name} --infer: launches {moved} != {EXPECTED_ONE_SHOT_ITEM}")
        check_test_set(os.path.join(work, f"generated_{SWITCH_STEPS}_test"), irec, 1,
                       EXPECTED_ONE_SHOT_ITEM)
        stats.update(infer_items=1, infer_launches_per_item=moved,
                     infer_forward_s=irec.seconds["forward"])
        print(f"[switches] {name} --infer: 1 test item from step {tester.global_step}'s "
              f"checkpoint, one DiffNet call ({moved}), its frames outside the mask the "
              f"ground truth's", flush=True)
    return stats, tuple(mid["shape"]), launches


def switches_path(smi: str, tmp: str, data_dir: str) -> tuple[dict, dict, tuple]:
    """Every switch of SWITCHES in turn; returns the launches of their own
    runs summed, each switch's statistics and the ``ref_pad_compat`` run's
    median (B, T)."""
    t0 = time.perf_counter()
    stats, shape, totals = {}, None, dict.fromkeys(COUNTERS, 0)
    for name, hp in SWITCHES:
        stats[name], mid, launches = switch_run(name, hp, smi, tmp, data_dir)
        shape = mid if name == "ref_pad_compat" else shape
        totals = {k: totals[k] + launches[k] for k in COUNTERS}
    stats["seconds"] = time.perf_counter() - t0
    print(f"[switches] {len(SWITCHES)} switches in {stats['seconds']:.1f} s; launches "
          f"{totals}", flush=True)
    return totals, stats, shape


def check_block_without_mask(gen, b: int, t: int) -> dict:
    """K1 (with h) and K5 with a null mask, float32 and bf16, against their
    plain versions at ``ref_pad_compat``'s median batch [b, t] (float32 K1
    at 1e-4 absolute, K5 at BWD_TOL of the largest; the bf16 forms at
    BF16_TOL); the float32 forms timed without the mask beside with it (the
    batch's rows padded to their own lengths) at that shape. Returns each
    kernel's error and the two times."""
    out = {}
    x, cond, step, mask, w = block_inputs(gen, b, t, ragged=True)
    for dtype in (torch.float32, torch.bfloat16):
        bf = dtype == torch.bfloat16
        xs, cs, ss, ms_ = (v.to(dtype) for v in (x, cond, step, mask))
        ws = tuple(v.to(dtype) for v in w)
        fwd = lambda fn, m: fn(xs, cs, ss, m, *ws, dilation=1, return_h=True)
        got, ref = fwd(diffnet_block, None), fwd(diffnet_block_plain, None)
        dxo, dsk = (torch.randn(b, t, x.shape[-1], device="cuda", generator=gen).to(dtype)
                    for _ in range(2))
        bwd = lambda fn, m: fn(got[2], dxo, dsk, m, ws[0], ws[4], 1)
        got_b, ref_b = bwd(diffnet_block_bwd, None), bwd(diffnet_block_bwd_plain, None)
        torch.cuda.synchronize()
        f = lambda ts: [v.float() for v in ts]
        err = (rel_err(f(got), f(ref)) if bf
               else max(float((g - e).abs().max()) for g, e in zip(got, ref)))
        err_b = rel_err(f(got_b), f(ref_b))
        tol, tol_b = (BF16_TOL, BF16_TOL) if bf else (1e-4, BWD_TOL)
        suffix = "_bf16" if bf else ""
        line = (f"[switches] no mask, {'bf16' if bf else 'float32'} B={b} T={t}: diffnet_block "
                f"(with h) err {err:.3e} (tol {tol:.3e}), diffnet_block_bwd err {err_b:.3e} "
                f"(tol {tol_b:.3e})")
        check(err <= tol and err_b <= tol_b, f"no-mask {dtype} B={b} T={t}: {err}, {err_b}")
        out["diffnet_block" + suffix] = {"switches_max_abs_err": err}
        out["diffnet_block_bwd" + suffix] = {"switches_max_abs_err": err_b}
        if not bf:
            times = {"nomask_ms": time_ms(lambda: fwd(diffnet_block, None)),
                     "masked_ms": time_ms(lambda: fwd(diffnet_block, mask))}
            times_b = {"nomask_ms": time_ms(lambda: bwd(diffnet_block_bwd, None)),
                       "masked_ms": time_ms(lambda: bwd(diffnet_block_bwd, mask))}
            out["diffnet_block"].update(times)
            out["diffnet_block_bwd"].update(times_b)
            line += (f"; K1 {times['nomask_ms']:.4f} ms without the mask, "
                     f"{times['masked_ms']:.4f} ms with it; K5 {times_b['nomask_ms']:.4f} ms, "
                     f"{times_b['masked_ms']:.4f} ms")
        print(line, flush=True)
    return out


# -- GAN train path ----------------------------------------------------------------

# a HiFi-TTS-like corpus: utterances of 64-400 frames (0.7-4.6 s at 22,050 Hz,
# hop 256), each a tone with a drifting pitch over a noise floor, its mel
# from the binarizer's wav2spec; egs/hifigan.yaml crops 8192 samples (32
# frames) of each, 16 a batch
GAN_SPLITS = {"train": 64, "valid": 4, "test": 2}
GAN_MIN_T, GAN_MAX_T = 64, 400
GAN_STEPS, GAN_RESUME_TO, GAN_WARMUP = 8, 10, 3
# the validation batch is the sanity run's, so that the 1 GB checkpoint is
# written once, at the end (an interval validation at the last step writes it
# twice)
GAN_HP = (f"max_updates={GAN_STEPS},val_check_interval={GAN_RESUME_TO + 1},"
          f"num_sanity_val_steps=1,tb_log_interval=5,ds_workers=0,"
          f"test_num={GAN_SPLITS['test']},test_save_workers=1")
GAN_B, GAN_SAMPLES = 16, 8192        # egs/hifigan.yaml's max_sentences and max_samples


def write_gan_corpus(data_dir: str, hp: dict, seed: int = 0) -> None:
    """A binarized vocoder corpus (mel, wav, f0 and pitch zero) of
    GAN_SPLITS items, written by the port's ``IndexedDatasetBuilder``."""
    rs = np.random.RandomState(seed)
    os.makedirs(data_dir)
    for split, n_items in GAN_SPLITS.items():
        builder = IndexedDatasetBuilder(os.path.join(data_dir, split))
        lengths = []
        for i in range(n_items):
            n = int(rs.randint(GAN_MIN_T, GAN_MAX_T + 1)) * HOP
            f0 = rs.uniform(100, 250) * (1 + 0.1 * np.sin(np.arange(n) / SR * rs.uniform(1, 4)))
            wav = (0.3 * np.sin(2 * np.pi * np.cumsum(f0) / SR)
                   + 0.02 * rs.randn(n)).astype(np.float32)
            spec = wav2spec(wav, hp["fft_size"], hp["hop_size"], hp["win_size"],
                            num_mels=hp["audio_num_mel_bins"], fmin=hp["fmin"],
                            fmax=hp["fmax"], sample_rate=hp["audio_sample_rate"])
            t = len(spec["mel"])
            builder.add_item({"item_name": f"{split}_{i}", "mel": spec["mel"].astype(np.float32),
                              "wav": spec["wav"].astype(np.float32),
                              "pitch": np.zeros(t, np.int64), "f0": np.zeros(t, np.float32)})
            lengths.append(t)
        builder.finalize()
        np.save(os.path.join(data_dir, f"{split}_lengths.npy"), np.asarray(lengths))


def gan_states_equal(a: dict, b: dict) -> bool:
    """Bit for bit: both nets, both optimizers' states and the step."""
    if a["step"] != b["step"]:
        return False
    for net in ("model", "disc"):
        if any(not torch.equal(v, b[net][k].to(v.device)) for k, v in a[net].items()):
            return False
    for opt in ("gen_opt", "disc_opt"):
        sa, sb = a[opt]["state"], b[opt]["state"]
        if sorted(sa) != sorted(sb) or any(
                not torch.equal(torch.as_tensor(v), torch.as_tensor(sb[i][k]).to(
                    torch.as_tensor(v).device)) for i in sa for k, v in sa[i].items()):
            return False
    return True


def compare_gan_step_with_cpu(task, hp: dict, state: dict, sub: dict) -> dict:
    """One GAN step on ``sub`` (2 items) on the card and on the CPU from
    ``state``: every loss within STEP_LOSS_RTOL, each net's Adam moments
    within STEP_MOMENT_TOL in relative L2 a tensor, the parameters within
    STEP_PARAM_TOL, but where the step's first moment is within rounding of
    zero (under 1e-2 of its tensor's rms on the CPU), where Adam's
    direction, a near sign, may differ by up to 2 lr."""
    def run(dev: str) -> dict:
        twin = Trainer(task, hp, dev)
        twin.train_step.load_state_dict(copy.deepcopy(state))
        t0 = time.perf_counter()
        metrics = twin.train_step(twin.to_device(sub))
        secs = time.perf_counter() - t0
        step = twin.train_step
        out = {"secs": secs, "metrics": {k: float(v) for k, v in metrics.items()},
               "lr": step.gen_opt.param_groups[0]["lr"]}
        for net, opt, prefix in ((twin.model, step.gen_opt, ""),
                                 (twin.disc, step.disc_opt, "disc.")):
            for name, p in net.named_parameters():
                s = opt.state[p]
                out[prefix + name] = (p.detach().cpu(), s["exp_avg"].cpu(),
                                      s["exp_avg_sq"].cpu())
        return out

    gpu, cpu = run("cuda"), run("cpu")
    loss_err = max(abs(gpu["metrics"][k] - v) / max(abs(v), 1e-12)
                   for k, v in cpu["metrics"].items())
    names = [k for k in cpu if k not in ("secs", "metrics", "lr")]
    moment = max((float((gpu[n][i] - cpu[n][i]).norm() / cpu[n][i].norm().clamp(min=1e-30)), n)
                 for n in names for i in (1, 2))
    worst_param, flips, total = (0.0, ""), 0, 0
    for n in names:
        diff = (gpu[n][0] - cpu[n][0]).abs()
        m = cpu[n][1]
        near_zero = m.abs() <= 1e-2 * m.pow(2).mean().sqrt()
        apart = diff > STEP_PARAM_TOL
        check(bool(near_zero[apart].all()) and float(diff.max()) <= 2.02 * cpu["lr"]
              + STEP_PARAM_TOL, f"[gan] B=2 step: parameter {n} apart by {float(diff.max())}")
        flips += int(apart.sum())
        total += diff.numel()
        worst_param = max(worst_param, (float(diff[~apart].max()) if (~apart).any() else 0.0, n))
    print(f"[gan] B=2 GAN step on the card vs the CPU ({cpu['secs']:.1f} s): loss terms max "
          f"rel err {loss_err:.3e} (tol {STEP_LOSS_RTOL}); Adam moments {moment[0]:.3e} in "
          f"relative L2 ({moment[1]}; tol {STEP_MOMENT_TOL}); parameters {worst_param[0]:.3e} "
          f"(tol {STEP_PARAM_TOL}) but for {flips} of {total} elements whose first moment is "
          f"within rounding of 0, within 2 lr; total_loss {gpu['metrics']['total_loss']:.6f} vs "
          f"{cpu['metrics']['total_loss']:.6f}", flush=True)
    check(loss_err <= STEP_LOSS_RTOL, f"[gan] B=2 step: loss error {loss_err}")
    check(moment[0] <= STEP_MOMENT_TOL, f"[gan] B=2 step: moment error {moment}")
    return {"loss_rel_err": loss_err, "moment_rel_l2": moment[0], "param_err": worst_param[0],
            "sign_flips": flips, "cpu_s": cpu["secs"]}


def gan_path(smi: str, tmp: str) -> tuple[dict, dict]:
    """HiFi-GAN V1's GAN training through the entry on ``egs/hifigan.yaml``
    as shipped (the full MPD and MSD, 16 crops of 8192 samples a batch)
    over a synthetic corpus: GAN_STEPS steps, a validation batch and a
    checkpoint, a resume to GAN_RESUME_TO (both nets and optimizers bit for
    bit), ``--infer`` of the GAN_SPLITS test items (copy synthesis), the
    trained work dir through ``infer/vocoder.py::HifiGAN`` (a mel vocoded as
    the generator gives it), one step on the card and on the CPU, and a
    profiled step. The path launches none of the port's kernels."""
    q = lambda xs, p: float(np.percentile(xs, p))
    t0 = time.perf_counter()
    data_dir, work = os.path.join(tmp, "gan_data"), os.path.join(tmp, "gan", "run")
    cfg = load_config("egs/hifigan.yaml")
    write_gan_corpus(data_dir, cfg)
    corpus_s = time.perf_counter() - t0
    argv = ["--config", "egs/hifigan.yaml", "--exp_name", work, "-hp",
            f"binary_data_dir={data_dir},vocoder_ckpt={os.path.join(tmp, 'hifigan')},{GAN_HP}"]
    first, second = RunRecorder(), RunRecorder()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with first.instrumented():
        trainer = run_entry(argv)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(type(trainer.task).__name__ == "HifiGanTask", f"gan: task {type(trainer.task)}")
    check(len(first.steps) == GAN_STEPS and len(first.valid) == 1,
          f"gan: {len(first.steps)} steps, {len(first.valid)} validation batches")
    for st in first.steps:
        check(st["launches"] == NO_LAUNCH and st["shape"] == (GAN_B, GAN_SAMPLES // HOP),
              f"gan step {st['step']}: launches {st['launches']}, batch {st['shape']}")
        m = {k: float(v) for k, v in st["metrics"].items()}
        check(all(np.isfinite(v) for v in m.values()), f"gan step {st['step']}: {m}")
    ckpt = os.path.join(work, f"model_ckpt_steps_{GAN_STEPS}.ckpt")
    check(os.path.exists(ckpt), f"gan: checkpoints {sorted(os.listdir(work))}")
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)["state"]
    with second.instrumented():
        resumed = run_entry(argv[:-1] + [argv[-1] + f",max_updates={GAN_RESUME_TO}"])
    check(second.steps[0]["step"] == GAN_STEPS + 1
          and len(second.steps) == GAN_RESUME_TO - GAN_STEPS
          and gan_states_equal(second.loaded, saved),
          f"gan resume: not from step {GAN_STEPS} with both nets and optimizers bit for bit")
    print(f"[gan] resume: started at step {GAN_STEPS} with the checkpoint's generator, "
          f"discriminators and both Adam states bit for bit; ran to {resumed.global_step}",
          flush=True)
    before = counts()
    tester = run_entry(argv + ["--infer"])
    launches = counts()
    gen_dir = os.path.join(work, f"generated_{GAN_RESUME_TO}_test", "wavs")
    wavs = sorted(f for f in os.listdir(gen_dir) if f.startswith("[P]") and f.endswith(".wav"))
    check(len(wavs) == GAN_SPLITS["test"] and launches == before,
          f"gan --infer: {wavs}, launches {launches} vs {before}")
    for f in wavs:
        _, pcm = wavfile.read(os.path.join(gen_dir, f))
        check(pcm.size > GAN_MIN_T * HOP // 2 and np.abs(pcm).max() > 0, f"gan --infer {f}")
    vocoder = HifiGAN(dict(resumed.hp, vocoder_ckpt=work), device="cuda")
    check(vocoder.kind == "hifigan", f"gan: the trained work dir loads as {vocoder.kind}")
    mel = np.random.RandomState(4).randn(100, 80).astype(np.float32) * 0.5 - 4.0
    with torch.inference_mode():
        direct = tester.model.eval()(torch.from_numpy(mel)[None].cuda())[0].cpu().numpy()
    check(np.array_equal(vocoder.spec2wav(mel), direct),
          "gan: the vocoder's wav is not the trained generator's")
    print(f"[gan] --infer: {len(wavs)} copy-synthesis wavs from step {tester.global_step}; "
          f"the work dir loads through infer/vocoder.py::HifiGAN and vocodes a 100-frame mel "
          f"bit for bit as the generator does", flush=True)

    timed = first.steps[GAN_WARMUP:]
    ev, host = [st["event_ms"] for st in timed], [st["host_ms"] for st in timed]
    m = {k: float(v) for k, v in first.steps[-1]["metrics"].items()}
    stats = {"batch": [GAN_B, GAN_SAMPLES], "timed_steps": len(timed),
             "event_ms_p50": q(ev, 50), "event_ms_p75": q(ev, 75),
             "host_ms_p50": q(host, 50), "host_ms_p75": q(host, 75),
             "steps_per_s_host": 1e3 / q(host, 50), "peak_gib": peak_gib,
             "launches_per_step": NO_LAUNCH, "last_metrics": m, "corpus_write_s": corpus_s,
             "gen_params": sum(p.numel() for p in trainer.model.parameters()),
             "disc_params": sum(p.numel() for p in trainer.disc.parameters()),
             "ckpt_mb": os.path.getsize(ckpt) / 1e6, "card": smi}
    print(f"[gan] egs/hifigan.yaml (HiFi-GAN V1, {stats['gen_params']} generator and "
          f"{stats['disc_params']} discriminator parameters), B={GAN_B} x {GAN_SAMPLES} "
          f"samples, {len(timed)} timed steps of {GAN_STEPS}: CUDA events p50 "
          f"{stats['event_ms_p50']:.3f} ms, p75 {stats['event_ms_p75']:.3f} ms; host clock "
          f"p50 {stats['host_ms_p50']:.3f} ms, p75 {stats['host_ms_p75']:.3f} ms "
          f"({stats['steps_per_s_host']:.2f} steps/s); no launch of the port's kernels; peak "
          f"memory {peak_gib:.3f} GiB; checkpoint {stats['ckpt_mb']:.1f} MB; {smi}", flush=True)
    print("[gan] last step: " + " ".join(f"{k}={v:.5f}" for k, v in sorted(m.items())),
          flush=True)
    mid = sorted(timed, key=lambda st: st["host_ms"])[len(timed) // 2]
    raw = {k: v.pin_memory() if isinstance(v, torch.Tensor) else v
           for k, v in mid["raw"].items()}
    stats["cpu_step"] = compare_gan_step_with_cpu(
        resumed.task, resumed.hp, resumed.train_step.state_dict(),
        {k: raw[k][:2] for k in resumed.task.effective_batch_keys() if k in raw})
    busy_ms = profile_step(trainer, raw, mid["host_ms"], top=12,
                           label=f"gan B={GAN_B} x {GAN_SAMPLES}")
    stats.update(profiled_host_ms=mid["host_ms"], profiled_busy_ms=busy_ms,
                 profiled_busy_share=None if busy_ms is None else busy_ms / mid["host_ms"],
                 seconds=time.perf_counter() - t0)
    return launches, stats


# -- data path -------------------------------------------------------------------

DATA_SPEAKERS, DATA_PER_SPEAKER = 3, 8
DATA_SECONDS = (1.5, 6.0)
DATA_SPLITS = dict(valid_range=[0, 2], test_range=[2, 4], train_range=[4, -1])
DATA_TOL = 1e-4           # card vs CPU speaker embedding, largest element
EXPECTED_DATA_STEP = dict(EXPECTED_WIDTH_STEP)   # the shipped config: bf16, conv encoder


def write_data_corpus(root: str) -> tuple[str, str, str]:
    """A raw vctk-layout corpus (``wav48/<spk>/<item>.wav``, ``txt/...``)
    of DATA_SPEAKERS x DATA_PER_SPEAKER harmonic utterances, a speaker's f0
    its own; each utterance's TextGrid in ``processed/mfa_outputs`` (its
    text's g2p phones spread evenly); a resemblyzer-format checkpoint of
    seeded weights. Returns (raw dir, processed dir, checkpoint)."""
    rs = np.random.RandomState(11)
    raw, processed = os.path.join(root, "raw"), os.path.join(root, "processed")
    os.makedirs(os.path.join(processed, "mfa_outputs"))
    for s in range(DATA_SPEAKERS):
        spk = f"p{231 + s}"
        for d in ("wav48", "txt"):
            os.makedirs(os.path.join(raw, d, spk))
        for u in range(DATA_PER_SPEAKER):
            name, seconds = f"{spk}_{u:03d}", float(rs.uniform(*DATA_SECONDS))
            wav = csv_wav(seconds, 110 + 45 * s + 5 * rs.rand(), 1000 * s + u)
            save_wav(wav, os.path.join(raw, "wav48", spk, f"{name}.wav"), SR)
            words = [SERVE_WORDS[i] for i in rs.randint(0, len(SERVE_WORDS),
                                                        max(2, int(2.2 * seconds)))]
            with open(os.path.join(raw, "txt", spk, f"{name}.txt"), "w") as f:
                f.write(" ".join(words) + ".")
            write_textgrid(os.path.join(processed, "mfa_outputs", f"{name}.TextGrid"),
                           " ".join(words) + ".", len(wav) // HOP + 1)
    ckpt = os.path.join(root, "voice_encoder.pt")
    torch.save({"model_state": seeded_state_dict(torch.Generator().manual_seed(0))}, ckpt)
    return raw, processed, ckpt


class EncoderRecorder:
    """Wraps the pipeline's stages and the speaker encoder while the data
    pipeline runs: each stage's seconds, each utterance's wav, embedding
    and the device of its encoder, and the CUDA-event time of each encoder
    forward."""

    def __init__(self):
        self.seconds = {"preprocess": 0.0, "binarize": 0.0}
        self.calls, self.events = [], []

    @contextlib.contextmanager
    def instrumented(self):
        rec = self
        orig = {"pre": BasePreprocessor.process, "bin": BaseBinarizer.process,
                "embed": VoiceEncoderCtx.embed_utterance, "fwd": VoiceEncoder.forward}

        def timed(name, key):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                out = orig[name](*args, **kwargs)
                rec.seconds[key] += time.perf_counter() - t0
                return out
            return wrapper

        def embed(ctx, wav, source_sr=22050):
            out = orig["embed"](ctx, wav, source_sr)
            rec.calls.append(dict(wav=np.array(wav), sr=source_sr, emb=out,
                                  device=str(next(ctx.model.parameters()).device)))
            return out

        def forward(model, mels):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig["fwd"](model, mels)
            end.record()
            rec.events.append((start, end, mels.shape[0]))
            return out

        BasePreprocessor.process = timed("pre", "preprocess")
        BaseBinarizer.process = timed("bin", "binarize")
        VoiceEncoderCtx.embed_utterance = embed
        VoiceEncoder.forward = forward
        try:
            yield self
        finally:
            BasePreprocessor.process, BaseBinarizer.process = orig["pre"], orig["bin"]
            VoiceEncoderCtx.embed_utterance, VoiceEncoder.forward = orig["embed"], orig["fwd"]


def data_path(smi: str, tmp: str) -> tuple[dict, dict]:
    """The data phase (module doc, 14); returns the train step's launches
    and the phase's figures."""
    t0 = time.perf_counter()
    root = os.path.join(tmp, "data_pipeline")
    raw, processed, ckpt = write_data_corpus(root)
    binary = os.path.join(root, "binary")
    config = os.path.join(root, "data.yaml")
    with open(config, "w") as f:
        f.write(dump_yaml(dict(base_config=os.path.abspath("egs/spec_denoiser.yaml"),
                               raw_data_dir=raw, processed_data_dir=processed,
                               binary_data_dir=binary, **DATA_SPLITS)))
    stages = {"corpus": time.perf_counter() - t0}
    rec, env = EncoderRecorder(), {k: os.environ.get(k) for k in ("VOICE_ENCODER_CKPT", "N_PROC")}
    os.environ.update(VOICE_ENCODER_CKPT=ckpt, N_PROC="1")
    reset_counts()
    t1 = time.perf_counter()
    try:
        with rec.instrumented():
            align_and_binarize_main(["--config", config, "--skip-align"])
        torch.cuda.synchronize()
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    stages.update(rec.seconds, pipeline=time.perf_counter() - t1)
    check(counts() == NO_LAUNCH, f"data: the pipeline launched {counts()}")
    n_items = DATA_SPEAKERS * DATA_PER_SPEAKER
    stored = [it for split in ("valid", "test", "train")
              for it in (lambda ds: [ds[i] for i in range(len(ds))])(
                  IndexedDataset(os.path.join(binary, split)))]
    check(len(stored) == n_items, f"data: {len(stored)} items binarized of {n_items}")
    check(len(rec.calls) == n_items and all(c["device"] == "cuda:0" for c in rec.calls),
          f"data: the encoder ran {len(rec.calls)} times, on "
          f"{sorted({c['device'] for c in rec.calls})}, for {n_items} items")
    check(all(np.array_equal(it["spk_embed"], c["emb"]) and it["spk_embed"].shape == (256,)
              for it, c in zip(stored, rec.calls)),
          "data: the stored embeddings are not the encoder's")
    ms = [s.elapsed_time(e) for s, e, _ in rec.events]
    partials = [n for _, _, n in rec.events]
    t2 = time.perf_counter()
    cpu = load_voice_encoder(ckpt, "cpu")
    err = max(float(np.abs(c["emb"] - cpu.embed_utterance(c["wav"], c["sr"])).max())
              for c in rec.calls)
    stages["cpu_reembed"] = time.perf_counter() - t2
    check(err <= DATA_TOL, f"data: card vs CPU speaker embedding error {err} > {DATA_TOL}")

    t3 = time.perf_counter()
    hp = load_config(config)
    hp.update(ds_workers=0)
    task = SpecDenoiserTask(hp)
    trainer = Trainer(task, task.hp, "cuda")
    with trainer._loader("train", shuffle=False) as loader:
        batch = next(iter(loader))
    reset_counts()
    metrics = {k: float(v) for k, v in trainer.step(batch).items()}
    torch.cuda.synchronize()
    launches = counts()
    stages["train_step"] = time.perf_counter() - t3
    check(task.hp["use_spk_embed"] and task.hp["use_bf16"] and "spk_embed" in batch,
          "data: the shipped config's step must take the speaker embeddings, in bf16")
    check(launches == EXPECTED_DATA_STEP,
          f"data: train step launches {launches} != {EXPECTED_DATA_STEP}")
    check(all(np.isfinite(v) for v in metrics.values()) and metrics["nan_grads"] == 0,
          f"data: train step metrics {metrics}")
    stats = dict(items=n_items, seconds_of_audio=float(sum(it["sec"] for it in stored)),
                 stage_s=stages, encoder_ms_p50=float(np.median(ms)),
                 encoder_ms_mean=float(np.mean(ms)), encoder_ms_first=ms[0],
                 partials_mean=float(np.mean(partials)), cpu_max_abs_err=err,
                 vocab=task.vocab_size,
                 batch=list(batch["mels"].shape[:2]), launches=launches,
                 seconds=time.perf_counter() - t0, card=smi)
    print(f"[data] {n_items} utterances ({stats['seconds_of_audio']:.1f} s of audio), 3 "
          f"speakers: stages (s) " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; speaker encoder on cuda, {len(ms)} forwards of {stats['partials_mean']:.1f} "
          f"partials on average, CUDA events p50 {stats['encoder_ms_p50']:.3f} ms, mean "
          f"{stats['encoder_ms_mean']:.3f} ms, first {ms[0]:.3f} ms an utterance; card vs CPU "
          f"embedding max_abs_err {err:.3e} (tol {DATA_TOL}); one shipped-config bf16 step "
          f"on B={stats['batch'][0]} x T={stats['batch'][1]}: launches {launches}; {smi}",
          flush=True)
    return launches, stats


def evals_path(work: str) -> dict:
    """The evals phase (module doc, 15) over ``work``'s ``--infer``
    output; returns the numbers."""
    t0 = time.perf_counter()
    gen_dirs = sorted(glob.glob(os.path.join(work, "generated_*_test")))
    check(len(gen_dirs) >= 1, f"evals: no generated_*_test under {work}")
    gen = gen_dirs[-1]
    pat = os.path.join(gen, "wavs", "*")
    n_pairs = len(glob.glob(os.path.join(gen, "wavs", "[[]G_SEG[]]*.wav")))
    check(n_pairs >= 1, f"evals: no [G_SEG] wavs in {gen}")
    command_s = {}
    t1 = time.perf_counter()
    out = {"get_metrics": get_metrics.main([pat])}
    command_s["get_metrics"] = time.perf_counter() - t1
    for name, argv in (("mcd", ["mcd", pat]), ("pitch", ["pitch", pat]),
                       ("pitch_dtw", ["pitch", pat, "--dtw"]),
                       ("stats", ["stats", os.path.join(gen, "meta.csv")])):
        t1, text = time.perf_counter(), io.StringIO()
        with contextlib.redirect_stdout(text):
            batch_tools.main(argv)
        command_s[name] = time.perf_counter() - t1
        out[name] = {k.strip(): float(v) for k, v in (line.split("=") for line in
                                                      text.getvalue().splitlines())}
    gt, gen_wavs = batch_tools.separate_wavs(gen)
    out["separate"] = {"gt": len(os.listdir(gt)), "gen": len(os.listdir(gen_wavs))}
    # the segments' loudness: seeded weights vocode to a near-silent signal
    out["peak"] = {tag: max(float(np.abs(wavfile.read(fn)[1]).max()) for fn in
                            glob.glob(os.path.join(gen, "wavs", f"[[]{tag}[]]*.wav")))
                   for tag in ("G_SEG", "P_SEG")}
    numbers = [v for d in out.values() for v in d.values()]
    check(all(np.isfinite(v) for v in numbers), f"evals: numbers not finite: {out}")
    check(out["separate"]["gt"] == out["separate"]["gen"] >= 1, f"evals: separate {out}")
    out.update(pairs=n_pairs, command_s=command_s, seconds=time.perf_counter() - t0)
    print(f"[evals] {n_pairs} [G_SEG]/[P_SEG] pairs of {os.path.basename(gen)}: "
          + json.dumps({k: out[k] for k in ("get_metrics", "mcd", "pitch", "pitch_dtw")})
          + f"; meta.csv means {out['stats']}; separate {out['separate']}; largest "
          f"|sample| of the 16-bit segments {out['peak']}; seconds "
          + ", ".join(f"{k} {v:.2f}" for k, v in command_s.items())
          + f", {out['seconds']:.2f} in all", flush=True)
    return out


def check_block_serving(gen) -> tuple[float, list]:
    """K1 against its plain version at B=16 and the serving frame buckets,
    each row but the first padded from its own length (a chunk's ragged
    mask); returns the error and the shapes."""
    worst, shapes = 0.0, []
    for t in SERVE_K1_T:
        x, cond, step, mask, w = block_inputs(gen, SERVE_BATCH, t, ragged=True)
        got = diffnet_block(x, cond, step, mask, *w)
        ref = diffnet_block_plain(x, cond, step, mask, *w)
        err = max(float((g - e).abs().max()) for g, e in zip(got, ref))
        check(err <= 1e-4, f"diffnet_block B={SERVE_BATCH} T={t} ragged: error {err} > 1e-4")
        print(f"[kernel] diffnet_block B={SERVE_BATCH} T={t} ragged (serve), "
              f"{plan_text('diffnet_block', SERVE_BATCH, t, 1)}: max_abs_err={err:.3e} "
              f"(tol 1e-4)", flush=True)
        worst = max(worst, err)
        shapes.append(dict(b=SERVE_BATCH, t=t, ragged=True, path="serve", max_err=err))
    return worst, shapes


PHASE_S: dict = {}
_PHASE_T0 = [time.perf_counter()]


def phase_done(name: str) -> None:
    """Records and prints the seconds since the last phase ended."""
    now = time.perf_counter()
    PHASE_S[name] = now - _PHASE_T0[0]
    _PHASE_T0[0] = now
    print(f"[phase] {name}: {PHASE_S[name]:.1f} s", flush=True)


# the timing-only modes: the kernels they build and the function that times them
TIMING_MODES = {"--time-attention": (("flash_attention", "flash_attention_bwd"), time_attention),
                "--time-mel": (("mel_kernel",), time_mel),
                "--time-diffnet": (("diffnet_block", "diffnet_block_bwd"), time_diffnet)}


def main() -> None:
    timing = TIMING_MODES.get(sys.argv[1]) if len(sys.argv) == 2 else None
    if sys.argv[1:] and timing is None:
        fail(f"usage: python3 chip_smoke.py [{' | '.join(TIMING_MODES)}]; got {sys.argv[1:]}")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU")
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"[device] {kind} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    float32_on_card()
    print("[device] TF32 off for matmul and cuDNN; bf16 products reduce in float32",
          flush=True)

    t0 = time.perf_counter()
    if timing:
        names, run = timing
        build.build_all(names)
        print(smi, flush=True)
        run(torch.Generator(device="cuda").manual_seed(0))
        return
    reports = build.build_all()
    phase_done("build")
    print(f"[build] {len(build.SOURCES)} kernels ({', '.join(build.SOURCES)}) in "
          f"{time.perf_counter() - t0:.1f} s; built now: {sorted(reports)}", flush=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
    for name, c in print_sass().items():
        check(c["bf16"]["HGMMA"] > 0 and c["bf16"]["HMMA"] == 0,
              f"{name}: the bf16 kernels must run on wgmma (HGMMA), not mma.sync")

    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [phase_diffnet_block(gen), phase_diffnet_block_bf16(gen),
               phase_diffnet_block_bwd(gen), phase_diffnet_block_bwd_bf16(gen), phase_mel(),
               phase_attention(gen), phase_attention_bf16(gen), phase_attention_bwd(gen),
               phase_attention_bwd_bf16(gen)]
    widths = check_block_widths(gen)
    phase_done("kernels")
    for k in kernels:       # the other widths' errors count in each K1 and K5 form's
        if k["name"] in widths:
            k["widths_max_abs_err"] = widths[k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], widths[k["name"]])
    edit_launches, rtf = edit_path(gen)
    phase_done("edit")
    train_launches, train = train_path()
    phase_done("train")
    train_bf16_launches, train_bf16 = train_path(bf16=True)
    phase_done("train bf16")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_run_")
    try:
        run_launches, run_stats = run_path(smi, tmp)
        phase_done("run")
        work, data_dir = os.path.join(tmp, "checkpoints", "run"), os.path.join(tmp, "data")
        run_bf16_launches, run_bf16_stats = run_bf16_path(smi, tmp, data_dir)
        phase_done("run bf16")
        infer_launches, csv_launches, infer_stats, infer_frames = infer_path(
            smi, tmp, work, data_dir)
        phase_done("infer")
        serve_launches, serve_stats = serve_path(smi, tmp, work, data_dir)
        phase_done("serve")
        inplace_launches, inplace_stats = inplace_path(smi, tmp, data_dir)
        phase_done("inplace")
        family_launches, family_stats = family_train_path(smi, tmp)
        phase_done("family train")
        family_bf16_launches, family_bf16_stats = family_train_path(smi, tmp, bf16=True)
        phase_done("family train bf16")
        width_stats = width_override_path(smi, data_dir)
        phase_done("width")
        switch_launches, switch_stats, switch_shape = switches_path(smi, tmp, data_dir)
        for name in ("diffnet_block", "diffnet_block_bwd", "diffnet_block_bf16",
                     "diffnet_block_bwd_bf16"):
            check(switch_launches[name] > 0, f"{name} was not launched on the switches path")
        no_mask = check_block_without_mask(gen, *switch_shape)
        phase_done("switches")
        gan_launches, gan_stats = gan_path(smi, tmp)
        check(gan_launches == NO_LAUNCH, f"the GAN path launched {gan_launches}")
        phase_done("gan train")
        data_launches, data_stats = data_path(smi, tmp)
        phase_done("data")
        evals_stats = evals_path(work)
        phase_done("evals")
    finally:
        shutil.rmtree(tmp)
    block = kernels[0]
    block["infer_max_abs_err"] = check_block_at(gen, infer_frames)
    block["serve_max_abs_err"], block["shapes"] = check_block_serving(gen)
    block["max_abs_err"] = max(block["max_abs_err"], block["infer_max_abs_err"],
                               block["serve_max_abs_err"])
    for k in kernels:
        if k["name"] in no_mask:
            k.update(no_mask[k["name"]])
            k["max_abs_err"] = max(k["max_abs_err"], k["switches_max_abs_err"])
        k["launches_by_path"] = {"edit": edit_launches[k["name"]],
                                 "train": train_launches[k["name"]],
                                 "train_bf16": train_bf16_launches[k["name"]],
                                 "run": run_launches[k["name"]],
                                 "run_bf16": run_bf16_launches[k["name"]],
                                 "infer": infer_launches[k["name"]],
                                 "csv_edit": csv_launches[k["name"]],
                                 "serve": serve_launches[k["name"]],
                                 "inplace": inplace_launches[k["name"]],
                                 "family_train": family_launches[k["name"]],
                                 "family_train_bf16": family_bf16_launches[k["name"]],
                                 "switches": switch_launches[k["name"]],
                                 "data": data_launches[k["name"]]}
        k["launches"] = sum(k["launches_by_path"].values())
        k["kernel_ms"] = k["ms"]
        check(k["launches"] > 0, f"{k['name']} was not launched on a main path")
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "tol", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    check(inplace_launches["flash_mha"] > 0, "flash_mha was not launched on the in-place path")
    print(json.dumps({"edit_rtf": rtf, "train_step": train, "train_step_bf16": train_bf16,
                      "run": run_stats,
                      "run_bf16": run_bf16_stats, "infer": infer_stats, "serve": serve_stats,
                      "inplace": inplace_stats, "family_train": family_stats,
                      "family_train_bf16": family_bf16_stats, "phase_s": PHASE_S,
                      "width_override": width_stats, "switches": switch_stats,
                      "gan_train": gan_stats, "data": data_stats, "evals": evals_stats,
                      "card": smi}))
    print(smi)
    extra = ("warm_ms", "warm_plain_ms", "host_us", "train_ms", "train_plain_ms",
             "train_bound_ms", "train_device_ms", "train_ops_per_call", "train_host_us",
             "device_ms", "ops_per_call", "library_device_ms", "old_bound_ms", "cufft_ms",
             "cufft_device_ms", "cufft_ops_per_call", "shapes", "infer_max_abs_err",
             "serve_max_abs_err", "campnet_shapes", "f32_ms", "autograd_err", "gflop",
             "mbytes", "widths_max_abs_err", "cublas_ms", "cublas_device_ms",
             "cublas_ops_per_call", "train_gflop", "train_mbytes", "train_bound_by",
             "train_cublas_ms", "train_cublas_device_ms", "train_cublas_ops_per_call",
             "switches_max_abs_err", "nomask_ms", "masked_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys + extra if key in k}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
