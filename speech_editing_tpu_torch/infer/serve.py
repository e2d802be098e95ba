"""Online region-edit server CLI: the port of the JAX package's
``infer/serve.py``.

    python -m speech_editing_tpu_torch.infer.serve --config egs/spec_denoiser.yaml \
        --exp_name NAME (--jsonl requests.jsonl | --jsonl - | --csv edits.csv) \
        [--warmup] [--max-wait-ms 100] [--out-dir serve_out] [--device cpu]

A serving surface over ``infer/online.py`` for FluentSpeech and, picked
by the config's ``task_cls``, the in-place families (CampNet, A3T,
EditSpeech: ``infer/editors.py``): requests stream in (JSONL on
stdin or from a file — one request per line, submitted the moment it is
read — or a CSV batch), the deadline scheduler batches device work, and
each result is written as it completes, ``<out-dir>/<item_name>.wav``, with
its queue-inclusive latency on stderr; at the end the latency p50 / p99,
the chunks' fill and the number of program shapes run. ``--warmup`` runs
every configured (program, batch, bucket) shape before accepting traffic.
It runs on the GPU unless ``--device cpu`` is given.

Request schema (JSONL object / CSV row):
``item_name, text, edited_text, region, edited_region, wav_fn_orig``
(+ optional precomputed ``mel2ph`` list when no MFA is installed, or an
``mfa_textgrid`` path; without either the MFA TextGrid path of the
per-item driver applies).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Optional, Sequence

import numpy as np


def _load_request(row: dict, hp) -> dict:
    from speech_editing_tpu_torch.utils.audio.dsp import wav2spec

    res = wav2spec(row["wav_fn_orig"],
                   sample_rate=hp["audio_sample_rate"],
                   fft_size=hp["fft_size"], hop_size=hp["hop_size"],
                   win_length=hp.get("win_size", hp["fft_size"]),
                   num_mels=hp["audio_num_mel_bins"],
                   fmin=hp["fmin"], fmax=hp["fmax"])
    inp = dict(row)
    if isinstance(inp.get("mel2ph"), (list, str)):
        m2p = inp["mel2ph"]
        inp["mel2ph"] = np.asarray(
            json.loads(m2p) if isinstance(m2p, str) else m2p, np.int64)
    inp.update(mel=res["mel"], wav=res["wav"])
    return inp


def iter_jsonl(fp):
    for line in fp:
        line = line.strip()
        if line:
            yield json.loads(line)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="online region-edit server (continuous batching)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--exp_name", required=True)
    ap.add_argument("--jsonl", default=None,
                    help="JSONL request stream ('-' = stdin); each line "
                         "submits immediately")
    ap.add_argument("--csv", default=None, help="CSV batch of requests")
    ap.add_argument("--out-dir", dest="out_dir", default="serve_out")
    ap.add_argument("--max-wait-ms", dest="max_wait_ms", type=float,
                    default=100.0)
    ap.add_argument("--max-batch", dest="max_batch", type=int, default=16)
    ap.add_argument("--warmup", action="store_true",
                    help="run every bucket program once before traffic")
    ap.add_argument("--warmup-workers", dest="warmup_workers", type=int,
                    default=4, help="concurrent warmup shapes")
    ap.add_argument("-hp", "--hparams", default="",
                    help="extra dotted overrides, as run.py")
    ap.add_argument("--workers", type=int, default=2,
                    help="scheduler threads (2 overlaps the result fetch "
                         "with the next chunk's launches)")
    ap.add_argument("--fast-io", dest="fast_io", action="store_true",
                    help="serve_wav_int16 + serve_fetch_mel=off: int16 PCM "
                         "made on the device (bit-identical wav files, 4x "
                         "fewer fetch bytes) and no mel fetch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from speech_editing_tpu_torch.config.hparams import arg_parser, set_hparams
    from speech_editing_tpu_torch.infer.editors import INFER_BY_TASK, infer_cls_for_hp
    from speech_editing_tpu_torch.infer.online import OnlineEditServer
    from speech_editing_tpu_torch.infer.spec_denoiser import (SpecDenoiserInfer,
                                                              load_dataset_info)
    from speech_editing_tpu_torch.training.trainer import cuda_or_cpu, float32_on_card
    from speech_editing_tpu_torch.utils.audio.io import save_wav

    if not (args.jsonl or args.csv):
        ap.error("one of --jsonl / --csv is required")
    device = cuda_or_cpu(args.device, "serve")
    float32_on_card()
    hp = set_hparams(arg_parser().parse_args(
        ["--config", args.config, "--exp_name", args.exp_name, "--infer"]
        + (["--hparams", args.hparams] if args.hparams else [])), print_hparams=False)
    if args.fast_io:
        hp = dict(hp, serve_wav_int16=True, serve_fetch_mel="off")
    task_cls = str(hp.get("task_cls", "")).lower()
    in_place = any(k in task_cls for k in INFER_BY_TASK)
    infer_ins = (infer_cls_for_hp(hp) if in_place else SpecDenoiserInfer)(hp, device)
    server = infer_ins.make_server(infer_ins, max_batch=args.max_batch)

    os.makedirs(args.out_dir, exist_ok=True)
    srv = OnlineEditServer(server, max_wait_ms=args.max_wait_ms,
                           workers=args.workers)
    if args.warmup:
        t0 = time.perf_counter()
        n = srv.warmup(verbose=True, workers=args.warmup_workers)
        print(f"| warmup: {n} program shapes in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)

    lock = threading.Lock()
    done = []

    def finish(name, fut):
        try:
            r = fut.result()
        except Exception as e:  # surfaced per request
            print(f"| {name}: FAILED {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)
            return
        path = os.path.join(args.out_dir, f"{name}.wav")
        save_wav(r["wav_out"], path, hp["audio_sample_rate"])
        with lock:
            done.append((name, fut.latency_s))
        print(f"| {name}: {r['t_frames']} frames -> {path} "
              f"(latency {fut.latency_s * 1e3:.0f} ms)", file=sys.stderr,
              flush=True)

    fp = None
    if args.csv:
        rows = load_dataset_info(args.csv)
    else:
        fp = sys.stdin if args.jsonl == "-" else open(args.jsonl)
        rows = iter_jsonl(fp)

    waiters = []
    try:
        for row in rows:
            inp = _load_request(row, hp)
            fut = srv.submit(inp)
            th = threading.Thread(target=finish,
                                  args=(row["item_name"], fut), daemon=True)
            th.start()
            waiters.append(th)
    finally:
        if fp is not None and fp is not sys.stdin:
            fp.close()
        srv.close()  # drains
    for th in waiters:
        th.join(timeout=600)
    if done:
        lat = np.asarray([d[1] for d in done]) * 1e3
        print(f"| served {len(done)} requests: latency p50 "
              f"{np.percentile(lat, 50):.0f} ms / p99 "
              f"{np.percentile(lat, 99):.0f} ms", file=sys.stderr, flush=True)
    launches = srv.launches     # (stage, s_b, t_b, n_real, b_eff, n_merged)
    fill = sum(ln[3] for ln in launches) / max(sum(ln[4] for ln in launches), 1)
    print(f"| {len(launches)} chunks, fill {fill:.3f} (real rows over batch rows); "
          f"{len(server.program_shapes)} program shapes run", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
