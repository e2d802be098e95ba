"""The knee of an open-loop serving cell: one set-up, then a window at each
offered rate, lowest first, each drained before the next.

    python3 -m benchmark.sweep --workload fluentspeech.online --seed 5 \
        --seconds 20 --rates 2,3,4,5,6,8

For each rate it prints one JSON line: the requests due in the window, how
many had their result by the window's end and the backlog then, the latency
p50 and p95 over the window's requests (from the due time), the chunks'
fill, the mean front end, the generator's lateness and the median latency
of the window's first and second halves. The knee is the
highest rate whose completions keep pace with arrivals, with no backlog
growing through the window: a backlog at the window's end that stays near
what the requests in service hold (the rate times the latency) and does not
grow from one rate to the next. The cell then runs at four fifths of it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np


def main(argv=None) -> int:
    from benchmark import serving
    from benchmark.harness import Run, cell, load_json
    from benchmark.loops.open_loop import window
    from benchmark.readers import percentile
    from benchmark.traffic.generate import due_times

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    with open("BENCHMARK.json") as f:
        w = cell(json.load(f), args.workload)
    rates = [float(r) for r in args.rates.split(",")]
    mix = load_json(f"traffic/{w['traffic']}.json")
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    with tempfile.TemporaryDirectory(prefix="sweep-", dir=base) as tmp:
        run = Run(args.workload, args.seed, args.seconds, False, tmp, "cuda",
                  load_json(f"configs/{w['config']}.json"), mix)
        st = serving.setup(run, n_requests=int(max(rates) * args.seconds))
        lead_s = float(mix.get("lead_s", 0.0))
        if lead_s > 0:      # as a run's set-up: traffic through the whole path first
            window(run, st, due_times(mix, args.seed + 1, lead_s), lead_s, wait_all=True,
                   first_index=10 ** 6)
        for rate in rates:
            m = dict(mix, arrival=dict(mix["arrival"], rate_per_s=rate))
            due = due_times(m, args.seed, args.seconds)
            n_before = len(st["online"].launches)
            res = window(run, st, due, args.seconds, wait_all=True)
            launches = st["online"].launches[n_before:]
            preps = [r["t_prep"][1] - r["t_prep"][0] for r in st["spans"].requests.values()]
            st["spans"].requests.clear()
            lat = res["latency_s"]
            half = len(lat) // 2
            print(json.dumps(dict(
                rate_per_s=rate, due=res["n_window"],
                done_by_window_end=res["n_window"] - res["backlog"], backlog=res["backlog"],
                p50_ms=percentile(lat, 50) * 1e3, p95_ms=percentile(lat, 95) * 1e3,
                p50_first_half_ms=percentile(lat[:half], 50) * 1e3,
                p50_second_half_ms=percentile(lat[half:], 50) * 1e3,
                p95_first_half_ms=percentile(lat[:half], 95) * 1e3,
                p95_second_half_ms=percentile(lat[half:], 95) * 1e3,
                fill=sum(x[3] for x in launches) / max(1, sum(x[4] for x in launches)),
                chunks=len(launches), front_end_ms=1e3 * float(np.mean(preps)),
                late_p50_ms=1e3 * float(np.nanmedian(res["late_s"])),
                late_max_ms=1e3 * float(np.nanmax(res["late_s"])))), flush=True)
        st["online"].close(drain=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
