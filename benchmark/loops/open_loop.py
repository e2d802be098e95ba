"""An open loop of edit requests into ``OnlineEditServer``: arrivals at the
mix's fixed rate, each dispatched at its due time to a pool of client
threads, which read the request as the serve CLI does (``_load_request``:
the wav's log-mel) and ``submit`` it (the front end then runs in the client's
thread). A request's latency runs from its due time to its result, as the
benchmark's own clock sees it (``serving.Stamper``).

Arrivals start ``lead_s`` before the window (set-up's last part: traffic
through every layer, so that the window opens on a loaded server and not an
empty one) and run on without a break; the window holds the requests due in
its ``seconds``, and requests keep arriving after it until each of the
window's has its result (at most ``drain_s`` more), so the window's last
requests meet the same load as its first. The generator's lateness (submit
start against due time) and the backlog at the window's end are reported on
standard error.
"""

from __future__ import annotations

import gc
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark import serving
from benchmark.trace import TRACE_AT, Trace
from benchmark.traffic.generate import due_times, lead_times


def run(run) -> None:
    due = due_times(run.mix, run.seed, run.seconds)
    lead = lead_times(run.mix, run.seed, float(run.mix.get("lead_s", 0.0)))
    st = serving.setup(run, n_requests=len(due) + len(lead))
    w = window(run, st, due, run.seconds, lead=lead, trace=run.trace)
    finish(run, st, w)


def window(run, st: dict, due: np.ndarray, seconds: float, lead=(), trace: bool = False,
           wait_all: bool = False, first_index: int = 0) -> dict:
    """Dispatches ``st["rows"]`` at ``due`` (seconds from the window's start),
    after the lead-in at ``lead`` (seconds before it, negative), until the
    window's requests are done (with ``wait_all``, then until every request
    dispatched is); returns what it saw. Request ``k`` is the ``k``-th due
    time (the lead-in's follow them: ``len(due) + j``) and is named after
    its row and ``first_index + k``."""
    mix, online, rows = run.mix, st["online"], st["rows"]
    n_window = int((due < seconds).sum())
    order = [(float(t), len(due) + j) for j, t in enumerate(lead)] + \
        [(float(t), k) for k, t in enumerate(due)]
    order.sort()
    futures: dict = {}
    late = np.full(len(order), np.nan)
    tracer = Trace(run.tmp) if trace else None
    t_trace = (seconds * TRACE_AT, min(mix.get("trace_s", 6.0), 0.5 * seconds))
    lock = threading.Lock()
    stamper = serving.Stamper()

    def client(k: int, t_due: float) -> None:
        row = rows[k % len(rows)]
        inp = st["load"](row)
        t_sub = time.perf_counter()
        late[k] = t_sub - t_due
        fut = online.submit(dict(inp, item_name=f"{row['item_name']}.{first_index + k}"))
        stamper.watch(k, fut)
        with lock:
            futures[k] = fut

    def window_done() -> bool:
        with lock:
            got = [futures.get(k) for k in range(n_window)]
        return all(g is not None and g.done() for g in got)

    def backlog_now() -> int:
        with lock:
            return sum(1 for k in range(n_window) if k not in futures or not futures[k].done())

    pool = ThreadPoolExecutor(max_workers=mix["clients"])
    t0 = time.perf_counter() - (order[0][0] if order and order[0][0] < 0 else 0.0)
    deadline = t0 + seconds + mix.get("drain_s", 60.0)
    trace_state, i, backlog, opened = 0, 0, None, not len(lead)
    while True:
        now = time.perf_counter()
        if not opened and now >= t0:
            # the readers' spans and chunks start with the window
            st["spans"].clear()
            online.launches.clear()
            run.marks.append(("traffic lead-in", t0))
            opened = True
        if tracer is not None and trace_state == 0 and now >= t0 + t_trace[0]:
            tracer.start()
            trace_state = 1
        elif trace_state == 1 and now >= t0 + t_trace[0] + t_trace[1]:
            tracer.stop()
            trace_state = 2
        if backlog is None and now >= t0 + seconds:
            backlog = backlog_now()
        if now >= t0 + seconds and (window_done() or now > deadline):
            break
        if i < len(order) and now >= t0 + order[i][0]:
            pool.submit(client, order[i][1], t0 + order[i][0])
            i += 1
            continue
        nxt = t0 + order[i][0] if i < len(order) else now + 0.05
        time.sleep(max(0.0, min(nxt - now, 0.01)))
    if trace_state == 1:
        tracer.stop()
    pool.shutdown(wait=True)
    if wait_all:
        for fut in list(futures.values()):
            try:
                fut.result(timeout=120)
            except Exception:
                pass
    stamper.close()
    lat, results, completed = [], {}, []
    for k in range(n_window):
        fut, name = futures.get(k), f"{rows[k % len(rows)]['item_name']}.{first_index + k}"
        try:
            results[k] = fut.result(timeout=0)
            done_at = stamper.done_at[k]
            lat.append(done_at - (t0 + due[k]))
            completed.append((done_at, name, int(results[k]["t_frames"])))
        except Exception:       # never came, or failed: it misses every limit
            lat.append(float("inf"))
    return dict(t0=t0, seconds=seconds, n_window=n_window, latency_s=lat,
                late_s=late[:n_window], results=results, backlog=backlog, tracer=tracer,
                completed=completed)


def finish(run, st: dict, w: dict) -> None:
    """Closes the server, records the window for the readers, frees the
    program and compares a sample of the window's results with the
    reference."""
    online, server, spans, rows = st["online"], st["server"], st["spans"], st["rows"]
    online.close(drain=False)
    if run.device == "cuda":
        torch.cuda.synchronize()
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    lat, n_window = w["latency_s"], w["n_window"]
    run.window = (w["t0"], w["t0"] + w["seconds"])
    run.attempted, run.failed = n_window, int(sum(1 for v in lat if not np.isfinite(v)))
    hop, sr = run.record["hp"]["hop_size"], run.record["hp"]["audio_sample_rate"]
    t0, t1 = run.window
    run.record.update(latency_s=lat, spans=spans, launches=list(online.launches),
                      unwarmed=len(set(server.program_shapes) - st["warmed"]),
                      completed=w["completed"],
                      audio_s=sum(f * hop / sr for t, _, f in w["completed"] if t0 <= t <= t1))
    run.tracer = w["tracer"]
    late = w["late_s"]
    run.notes.append(f"generator lateness over the window's {n_window} requests: p50 "
                     f"{np.nanmedian(late) * 1e3:.3f} ms, max {np.nanmax(late) * 1e3:.3f} ms; "
                     f"backlog at the window's end {w['backlog']}; chunks "
                     f"{len(online.launches)}; program shapes after warm-up "
                     f"{run.record['unwarmed']}")
    sample = _sample(w["results"], run.seed, run.mix["check"]["sample"])
    outputs, sampled_rows = {}, []
    for k in sample:
        row = rows[k % len(rows)]
        name = f"{row['item_name']}.{k}"
        outputs[name] = dict(w["results"][k], dur_pred=spans.requests[name].get("dur_pred"))
        sampled_rows.append(dict(row, item_name=name))
    del online, server, w["results"]
    st.clear()
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    serving.oracle(run).check_served(run, run.record["hp"], run.record["phones"], sampled_rows,
                                     outputs, run.record["weights"])


def _sample(results: dict, seed: int, k: int) -> list:
    """``k`` served requests (their indices) drawn from the seed, the
    longest among them."""
    if not results:
        return []
    longest = max(results, key=lambda i: results[i]["t_frames"])
    rest = sorted(i for i in results if i != longest)
    rng = np.random.RandomState((seed + 104729) % (2 ** 32))
    pick = [int(i) for i in rng.choice(rest, size=min(k - 1, len(rest)), replace=False)]
    return [longest] + pick


def control(run) -> dict:
    """The control's gaps at the cell's size for ``run.seed``: the window's
    requests as a run generates them, ``check.sample`` of them (the
    longest source among them), the reference in TF32 against float32."""
    from benchmark.reference.frontend import phone_set
    from benchmark.traffic.generate import edit_requests, words

    if "arrival" in run.mix:
        due = due_times(run.mix, run.seed, run.seconds)
        n_req, n = len(due), int((due < run.seconds).sum())
    else:
        n_req = n = run.mix["sources"]["count"]
    phones = phone_set(words(run.mix))
    hp = serving.serving_hp(run, run.tmp)
    rows = edit_requests(run.mix, run.config["hp"], run.seed, run.tmp, n_req)
    rows = [dict(r, item_name=f"{r['item_name']}.{i}") for i, r in enumerate(rows[:n])]
    rng = np.random.RandomState((run.seed + 104729) % (2 ** 32))
    longest = max(range(n), key=lambda i: rows[i]["source_s"])
    pick = [longest] + [int(i) for i in rng.choice([i for i in range(n) if i != longest],
                                                    run.mix["check"]["sample"] - 1,
                                                    replace=False)]
    with torch.device("meta"):
        model = serving.oracle(run).reference_model(run.config, len(phones) + 3)
        voc = serving.oracle(run).reference_vocoder(run.config)
    from benchmark.weights import seeded_state_dict

    weights = {"model": seeded_state_dict(model, run.seed, run.device,
                                          run.config.get("weights", {})),
               "vocoder": seeded_state_dict(voc, run.seed + 1, run.device,
                                            run.config.get("vocoder_weights", {}))}
    return serving.oracle(run).control_served(run, hp, phones, [rows[i] for i in pick], weights)
