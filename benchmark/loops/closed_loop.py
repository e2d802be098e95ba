"""A closed loop of edit requests into ``OnlineEditServer``: an editing job
fanned over ``clients`` threads, each keeping ``outstanding`` requests in
flight (it reads and submits its next as its oldest returns), with the
online server's settings of the mix. The window's work is the seconds of
edited audio whose results arrived inside it, as the benchmark's own clock
sees them (``serving.Stamper``); requests still in flight when it closes
are waited for (they are compared, not counted).
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from benchmark import serving
from benchmark.loops.open_loop import control as _open_control
from benchmark.loops.open_loop import finish
from benchmark.trace import TRACE_AT, Trace


def run(run) -> None:
    mix = run.mix
    st = serving.setup(run, n_requests=mix["sources"]["count"])
    warm_s = float(mix.get("warm_s", 0.0))
    if warm_s > 0:
        window(run, st, warm_s, first_index=10 ** 6)
        st["spans"].clear()
        st["online"].launches.clear()
        run.mark("traffic warm-up")
    w = window(run, st, run.seconds, trace=run.trace)
    finish(run, st, w)


def window(run, st: dict, seconds: float, first_index: int = 0, trace: bool = False) -> dict:
    mix, online, rows = run.mix, st["online"], st["rows"]
    tracer = Trace(run.tmp) if trace else None
    per_client, n_clients = int(mix["outstanding"]), int(mix["clients"])
    lock = threading.Lock()
    futures: dict = {}
    counter = [0]
    stamper = serving.Stamper()
    t0 = time.perf_counter()
    stop_at = t0 + seconds

    def res_name(i: int) -> str:
        return f"{rows[i % len(rows)]['item_name']}.{first_index + i}"

    def client() -> None:
        inflight = deque()
        while True:
            while len(inflight) < per_client and time.perf_counter() < stop_at:
                with lock:
                    i = counter[0]
                    counter[0] += 1
                row = rows[i % len(rows)]
                inp = st["load"](row)
                t_sub = time.perf_counter()
                fut = online.submit(dict(inp, item_name=res_name(i)))
                stamper.watch(i, fut)
                with lock:
                    futures[i] = (fut, t_sub)
                inflight.append(fut)
            if not inflight:
                return
            try:
                inflight.popleft().result(timeout=max(1.0, stop_at - time.perf_counter()
                                                      + mix.get("drain_s", 60.0)))
            except Exception:
                pass

    threads = [threading.Thread(target=client, daemon=True) for _ in range(n_clients)]
    for th in threads:
        th.start()
    if tracer is not None:
        at = t0 + seconds * TRACE_AT
        time.sleep(max(0.0, at - time.perf_counter()))
        tracer.start()
        time.sleep(min(mix.get("trace_s", 6.0), 0.5 * seconds))
        tracer.stop()
    for th in threads:
        th.join()
    stamper.close()
    results, lat, completed = {}, [], []
    for k in sorted(futures):
        fut, t_sub = futures[k]
        try:
            results[k] = fut.result(timeout=0)
            done_at = stamper.done_at[k]
            lat.append(done_at - t_sub)
            completed.append((done_at, res_name(k), int(results[k]["t_frames"])))
        except Exception:       # never came, or failed
            lat.append(float("inf"))
    return dict(t0=t0, seconds=seconds, n_window=len(futures), latency_s=lat,
                late_s=np.zeros(max(1, len(futures))), results=results,
                backlog=sum(1 for t, _, _ in completed if t > stop_at), tracer=tracer,
                completed=completed)


def control(run) -> dict:
    """As the open loop's: the reference in TF32 against float32 over
    ``check.sample`` of the generated requests."""
    return _open_control(run)
