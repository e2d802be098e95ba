"""What the metric readers (``metrics/<name>.py``) share: the statistics
over requests and chunks, the shares read from the traced window, and the
whole step's share of the peak. A model's products and its attention calls'
work come from the configuration's oracle (``oracles/<config>.py``)."""

from __future__ import annotations

import math

from benchmark import work
from benchmark.serving import oracle
from benchmark.trace import ranges_in


def percentile(values, p: float) -> float | None:
    """The nearest-rank ``p``-th percentile of every value (a failed
    request is +inf and counts): the smallest value with at least ``p`` % of
    them at or below it."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]


def latency_ms(run, p: float):
    lat = run.record.get("latency_s")
    if not lat:
        return None
    return percentile(lat, p) * 1e3


def fill(run):
    """Real rows over batch rows, in %, over every chunk the scheduler launched
    (``OnlineEditServer.launches``)."""
    launches = run.record.get("launches")
    if not launches:
        return None
    return 100.0 * sum(n[3] for n in launches) / sum(n[4] for n in launches)


def front_end_ms(run):
    """Mean host ms a request spent in ``online_prepare``."""
    spans = run.record.get("spans")
    preps = [r["t_prep"][1] - r["t_prep"][0] for r in spans.requests.values()] if spans else []
    return 1e3 * sum(preps) / len(preps) if preps else None


def queue_wait_ms(run, p: float = 95.0):
    """The ``p``-th percentile over requests of the time from entering each
    stage's queue (the front end's end; the end of the stage before) to the
    start of that stage's chunk, summed over the stages."""
    spans = run.record.get("spans")
    waits = []
    for r in (spans.requests.values() if spans else ()):
        if not r["chunks"]:
            continue
        ready, total = r["t_prep"][1], 0.0
        for _, start, end in sorted(r["chunks"], key=lambda c: c[1]):
            total += max(0.0, start - ready)
            ready = end
        waits.append(total)
    return None if not waits else percentile(waits, p) * 1e3


def vocoder_share(run):
    """Device time launched inside the ``bench.vocoder`` range over all
    device time of the traced window, in %."""
    tr = run.tracer
    if tr is None:
        return None
    total = tr.device_s()
    return 100.0 * tr.device_s(under="bench.vocoder") / total if total > 0 else None


def device_idle(run):
    """The traced window's share, in %, in which no device operation ran."""
    tr = run.tracer
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def k1_roofline_chunks(run, stage: str):
    """K1's share of its roofline over the chunks of ``stage`` wholly inside
    the traced window: each launch's least time at its chunk's live frames,
    summed, over the launches' device time."""
    tr, spans = run.tracer, run.record.get("spans")
    if tr is None or spans is None:
        return None
    hp = run.config["hp"]
    inside = ranges_in(tr, f"bench.chunk.{stage}")
    by_chunk = {c["range"]: c for c in spans.chunks}
    least = spent = 0.0
    for name, durs in tr.by_range("diffnet_block_kernel", f"bench.chunk.{stage}").items():
        if name not in inside or name not in by_chunk:
            continue
        frames = sum(by_chunk[name]["frames"])
        least += len(durs) * work.bound_s(*work.k1(frames, hp["residual_channels"],
                                                   hp["hidden_size"]))
        spent += sum(durs) / 1e6
    return 100.0 * least / spent if spent > 0 else None


def union_s(intervals, lo: float, hi: float) -> float:
    total, end = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b > end:
            total, end = total + b - max(a, end), b
    return total


def serve_mfu(run, stage: str):
    """Model FLOPs of the real rows of every ``stage`` chunk wholly inside
    the window and outside the traced one (the configuration's
    ``edit_frame`` work a frame), over the union of those chunks' host
    intervals, over the peak, in %."""
    spans = run.record.get("spans")
    if spans is None:
        return None
    lo, hi = run.window
    chunks = untraced(run, [c for c in spans.chunks if c["stage"] == stage and "end" in c
                            and c["start"] >= lo and c["end"] <= hi])
    if not chunks:
        return None
    tokens = {n: r.get("tokens", 0) for n, r in spans.requests.items()}
    flops = sum(oracle(run).edit_flops(run.config, f, tokens.get(n, 0))
                for c in chunks for n, f in zip(c["names"], c["frames"]))
    busy = union_s([(c["start"], c["end"]) for c in chunks], lo, hi)
    return 100.0 * flops / busy / work.peak_flops() if busy > 0 else None


KERNELS = {"k1": ("diffnet_block_kernel",), "k5": ("shift_scatter_kernel", "gate_bwd_kernel"),
           "k3": ("attention_fwd_kernel",), "k4": ("attention_bwd_kernel",)}


def step_roofline(run, kernel: str):
    """A kernel's share of its roofline over the steps wholly inside the
    traced window: each launch's least time at its step's real frames over
    the launches' device time, in %."""
    tr, steps = run.tracer, run.record.get("steps")
    if tr is None or not steps:
        return None
    hp = run.config["hp"]
    c, h = hp.get("residual_channels"), hp["hidden_size"]
    attention_calls = getattr(oracle(run), "attention_calls", None)
    if kernel in ("k3", "k4") and attention_calls is None:
        return None
    inside = ranges_in(tr, "bench.step")
    by_step = {s["range"]: s for s in steps}
    least = spent = 0.0
    for name in KERNELS[kernel]:
        for rng, durs in tr.by_time(name, "bench.step").items():
            if rng not in inside or rng not in by_step:
                continue
            st = by_step[rng]
            if kernel in ("k3", "k4"):
                # the step's nine calls together, against all their time
                least += work.bound_s(*attention_calls(hp, st, kernel == "k4"))
            else:
                flops, n_bytes = (work.k1(st["frames"], c, h, with_h=True) if kernel == "k1"
                                  else work.k5(st["frames"], c))
                # K5's least time is the pair's: split it over its two launches
                share = 1.0 if kernel == "k1" else 0.5
                least += len(durs) * share * work.bound_s(flops, n_bytes)
            spent += sum(durs) / 1e6
    return 100.0 * least / spent if spent > 0 else None


def untraced(run, spans: list) -> list:
    """The spans (dicts with ``start`` and ``end``) that do not overlap the
    traced window, whose profiler slows the host."""
    if run.tracer is None:
        return spans
    a, b = run.tracer.host_window
    return [s for s in spans if s["end"] <= a or s["start"] >= b]


def train_mfu(run):
    """Model FLOPs of the window's steps outside the traced window (forward
    and backward: three times the forward's products) over those steps'
    seconds, loader waits included, over the TF32 peak, in %."""
    steps = untraced(run, run.record.get("steps") or [])
    spent = sum(s["end"] - s["start"] for s in steps)
    if not steps or spent <= 0:
        return None
    flops = sum(oracle(run).train_flops(run.config, s) for s in steps)
    return 100.0 * flops / spent / work.peak_flops()


def audio_s_per_s(run):
    """Seconds of edited audio whose results arrived in the window, over the
    window's seconds."""
    audio = run.record.get("audio_s")
    return audio / run.window_s if audio is not None and run.window_s > 0 else None


def completed_mfu(run):
    """Model FLOPs of every request whose result arrived in the window,
    outside the traced part of it, over those seconds, over the TF32 peak,
    in %."""
    done, spans = run.record.get("completed"), run.record.get("spans")
    if not done or spans is None:
        return None
    lo, hi = run.window
    cut = run.tracer.host_window if run.tracer is not None else (hi, hi)
    spent = (hi - lo) - max(0.0, min(hi, cut[1]) - max(lo, cut[0]))
    flops = sum(oracle(run).edit_flops(run.config, f,
                                       spans.requests.get(n, {}).get("tokens", 0))
                for t, n, f in done if lo <= t <= hi and not cut[0] <= t <= cut[1])
    return 100.0 * flops / spent / work.peak_flops() if spent > 0 else None
