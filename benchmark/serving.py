"""The serving program under test, built as the serve CLI builds it
(``speech_editing_tpu_torch/infer/serve.py``), and the benchmark's own spans
around the calls into its layers.

Set-up writes the cell's seeded checkpoints (the acoustic model and HiFi-GAN
V1, made on the device by ``weights.py``) and the phone set where the
program reads them, turns TF32 off as the CLI does (``float32_on_card``),
builds the configuration's driver and its batch server and wraps that in
``OnlineEditServer``. ``Spans`` then records, without changing what runs:
each request's host front end (``online_prepare``), each device chunk
(``run_<stage>_chunk``: its buckets, real rows, batch, requests, host
interval, launches), and the chunks and each vocoder call as
``record_function`` ranges that the traced window reads. ``Stamper`` times
each request's completion on the benchmark's own clock.
"""

from __future__ import annotations

import importlib
import json
import os
import threading
import time

import torch

from benchmark.trace import range_name
from benchmark.weights import seeded_state_dict


def obj(path: str):
    """``module:attr`` -> the object."""
    mod, _, attr = path.partition(":")
    return getattr(importlib.import_module(mod), attr)


def oracle(run):
    return importlib.import_module(f"benchmark.oracles.{run.config['oracle']}")


def write_model_checkpoints(run, hp: dict, vocab: int) -> dict:
    """The acoustic model's and the vocoder's seeded weights as the
    program's checkpoints under ``run.tmp``; returns them (on the device)."""
    orc = oracle(run)
    with torch.device("meta"):
        model = orc.reference_model(run.config, vocab)
        voc = orc.reference_vocoder(run.config)
    sd = seeded_state_dict(model, run.seed, run.device, run.config.get("weights", {}))
    vsd = seeded_state_dict(voc, run.seed + 1, run.device, run.config.get("vocoder_weights", {}))
    for d, state in ((hp["work_dir"], sd), (hp["vocoder_ckpt"], vsd)):
        os.makedirs(d, exist_ok=True)
        torch.save({"state": {"model": state}, "steps": 1, "epoch": 0, "val_loss": None},
                   os.path.join(d, "model_ckpt_steps_1.ckpt"))
    with open(os.path.join(hp["vocoder_ckpt"], "config.yaml"), "w") as f:
        f.writelines(f"{k}: {json.dumps(v)}\n" for k, v in run.config["vocoder"].items())
    # host copies for the reference, which runs once the program is gone
    return {"model": {k: v.cpu() for k, v in sd.items()},
            "vocoder": {k: v.cpu() for k, v in vsd.items()}}


def serving_hp(run, data_dir: str) -> dict:
    hp = dict(run.config["hp"], seed=int(run.seed) % (2 ** 31), binary_data_dir=data_dir,
              work_dir=os.path.join(run.tmp, "work"),
              vocoder_ckpt=os.path.join(run.tmp, "hifigan"))
    return hp


def build(run, hp: dict):
    """(online server, batch server, driver) as the serve CLI builds them,
    with the mix's server settings."""
    from speech_editing_tpu_torch.infer.online import OnlineEditServer
    from speech_editing_tpu_torch.training.trainer import float32_on_card

    if run.device == "cuda":
        float32_on_card()
    srv = run.mix["server"]
    infer = obj(run.config["program"]["infer"])(hp, run.device)
    server = infer.make_server(infer, max_batch=srv["max_batch"],
                               frame_buckets=tuple(srv["frame_buckets"]),
                               token_buckets=tuple(srv["token_buckets"]),
                               adaptive_tail=srv["adaptive_tail"],
                               merge_token_tails=srv["merge_token_tails"])
    online = OnlineEditServer(server, max_wait_ms=srv["max_wait_ms"], workers=srv["workers"])
    return online, server, infer


class Stamper:
    """Completion times on the benchmark's clock: a thread polls every
    watched future's ``done()`` each ``poll_s`` and stamps the first
    ``perf_counter`` at which it saw it done. Nothing is taken from the
    program's own timing of its futures."""

    def __init__(self, poll_s: float = 0.002):
        self.poll_s = poll_s
        self.lock = threading.Lock()
        self.pending: dict = {}
        self.done_at: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def watch(self, key, fut) -> None:
        with self.lock:
            self.pending[key] = fut

    def sweep(self) -> None:
        """Stamps every watched future that is done now."""
        with self.lock:
            items = list(self.pending.items())
        seen = [k for k, fut in items if fut.done()]
        now = time.perf_counter()
        with self.lock:
            for k in seen:
                self.pending.pop(k, None)
                self.done_at.setdefault(k, now)

    def _poll(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.sweep()

    def close(self) -> None:
        """Stops the thread after a last sweep."""
        self._stop.set()
        self._thread.join()
        self.sweep()


class Spans:
    """The benchmark's spans around the program's layers (see the module
    doc). ``requests``: {item name: {"t_prep": (start, end), "chunks": [(stage,
    start, end)], "dur_pred": array}}; ``chunks``: dicts of stage, s_b, t_b,
    n, b, start, end, names, frames, range."""

    def __init__(self, server, infer):
        self.lock = threading.Lock()
        self.requests: dict = {}
        self.chunks: list = []
        self._by_req: dict = {}
        self._wrap_prepare(server)
        for stage in type(server).STAGES:
            name = f"run_{stage}_chunk"
            setattr(server, name, self._wrap_chunk(stage, getattr(server, name)))
        voc = infer.vocoder
        if getattr(voc, "device_batched", False):
            voc.spec2wav_batch_dev = self._wrap_vocoder(voc.spec2wav_batch_dev)

    def clear(self) -> None:
        with self.lock:
            self.requests.clear()
            self.chunks.clear()
            self._by_req.clear()

    def _wrap_prepare(self, server):
        orig = server.online_prepare

        field = getattr(server.infer, "_token_field", "edited_ph_token")

        def online_prepare(inp, seed):
            t0 = time.perf_counter()
            req = orig(inp, seed)
            t1 = time.perf_counter()
            with self.lock:
                self.requests[inp["item_name"]] = {"t_prep": (t0, t1), "chunks": [],
                                                   "tokens": len(req.item[field])}
                self._by_req[id(req)] = inp["item_name"]
            return req
        server.online_prepare = online_prepare

    def _wrap_chunk(self, stage, orig):
        def run_chunk(reqs, s_b, t_b, b_eff):
            with self.lock:
                index = len(self.chunks)
                rec = dict(stage=stage, s_b=s_b, t_b=t_b, n=len(reqs), b=b_eff,
                           names=[self._by_req.get(id(r)) for r in reqs],
                           range=range_name(f"chunk.{stage}", index))
                self.chunks.append(rec)
            rec["start"] = time.perf_counter()
            with torch.profiler.record_function(rec["range"]):
                orig(reqs, s_b, t_b, b_eff)
            rec["end"] = time.perf_counter()
            rec["frames"] = [self._frames(stage, r) for r in reqs]
            with self.lock:
                for name, r in zip(rec["names"], reqs):
                    entry = self.requests.get(name)
                    if entry is None:
                        continue
                    entry["chunks"].append((stage, rec["start"], rec["end"]))
                    if getattr(r, "dur_pred", None) is not None and stage == "dur":
                        entry["dur_pred"] = r.dur_pred.copy()
        return run_chunk

    @staticmethod
    def _frames(stage, r) -> int:
        """The real frames of a request in a chunk of ``stage``."""
        if r.result is not None:
            return int(r.result["t_frames"])
        return int(len(r.item["mel2ph"]))

    def _wrap_vocoder(self, orig):
        def spec2wav_batch_dev(mels):
            with torch.profiler.record_function("bench.vocoder"):
                return orig(mels)
        return spec2wav_batch_dev


def warm_pairs(server, token_counts, frame_counts) -> list:
    """(token bucket, frame bucket) pairs of the requests, each frame bucket
    with its neighbours: the edited length of a request moves it by at most
    one bucket."""
    fbs = list(server.frame_buckets)
    pairs = set()
    for s, t in zip(token_counts, frame_counts):
        sb, tb = server._tb(s), server._fb(t)
        i = fbs.index(tb) if tb in fbs else len(fbs) - 1
        for j in (i - 1, i, i + 1):
            if 0 <= j < len(fbs):
                pairs.add((sb, fbs[j]))
    return sorted(pairs)


def setup(run, n_requests: int) -> dict:
    """The serving cell's set-up: the phone set, ``n_requests`` generated
    requests, the seeded checkpoints, the server as the CLI builds it, its
    warm-up over the (token, frame) buckets the requests reach, and the
    spans. Leaves ``hp``, ``phones`` and the weights in ``run.record``."""
    from benchmark.reference.frontend import encode, phone_set, text_to_phones
    from benchmark.traffic.generate import edit_requests, words

    mix = run.mix
    phones = phone_set(words(mix))
    data_dir = os.path.join(run.tmp, "data")
    os.makedirs(data_dir)
    with open(os.path.join(data_dir, "phone_set.json"), "w") as f:
        json.dump(phones, f)
    hp = serving_hp(run, data_dir)
    rows = edit_requests(mix, run.config["hp"], run.seed, os.path.join(run.tmp, "requests"),
                         n_requests)
    run.mark("requests")
    weights = write_model_checkpoints(run, hp, len(phones) + 3)
    run.mark("checkpoints")
    online, server, infer = build(run, hp)
    run.mark("program")
    from speech_editing_tpu_torch.infer.serve import _load_request

    tokens = [len(encode(text_to_phones(r["edited_text"])[0], phones)) for r in rows]
    frames = [int(r["source_s"] * hp["audio_sample_rate"]) // hp["hop_size"] + 1 for r in rows]
    online.warmup(pairs=warm_pairs(server, tokens, frames))
    warmed = set(server.program_shapes)
    spans = Spans(server, infer)
    if run.device == "cuda":
        torch.cuda.synchronize()
    run.mark(f"warm-up of {len(warmed)} shapes")
    run.record.update(hp=hp, phones=phones, weights=weights)
    return dict(online=online, server=server, infer=infer, rows=rows, warmed=warmed,
                spans=spans, load=lambda row: _load_request(row, hp))
