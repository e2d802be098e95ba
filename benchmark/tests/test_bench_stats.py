"""The statistics the readers take: a percentile over every request, a rate
over the window, the device's idle share as a union of intervals."""

import math
from types import SimpleNamespace

from benchmark import readers
from benchmark.harness import read_metric
from benchmark.trace import Trace, _union


def test_percentile_nearest_rank_over_all_requests():
    v = list(range(1, 101))
    assert readers.percentile(v, 50) == 50
    assert readers.percentile(v, 95) == 95
    assert readers.percentile([3.0], 95) == 3.0
    # a failed request is +inf and counts: 6 of 100 missing put p95 at inf
    assert math.isinf(readers.percentile(v[:94] + [math.inf] * 6, 95))
    assert readers.percentile(v[:95] + [math.inf] * 5, 95) == 95


def test_latency_readers_in_ms():
    run = SimpleNamespace(record={"latency_s": [0.1 * i for i in range(1, 21)]})
    assert abs(read_metric("edit_p50_ms", run) - 1000.0) < 1e-9
    assert abs(read_metric("edit_p95_ms", run) - 1900.0) < 1e-9


def test_rate_over_the_window():
    steps = [{"frames": 1000, "start": 0.0, "end": 0.1}] * 30
    run = SimpleNamespace(record={"steps": steps}, window=(10.0, 13.0), window_s=3.0)
    assert read_metric("train_frames_per_s", run) == 10000.0


def test_idle_is_one_minus_the_union_of_device_intervals():
    tr = Trace.__new__(Trace)
    tr.kernels = [("a", 0.0, 10.0, "kernel", None), ("b", 5.0, 10.0, "kernel", None),
                  ("c", 30.0, 10.0, "kernel", None)]
    assert _union(tr.kernels) == 25.0           # [0, 15] and [30, 40]
    tr.busy_s, tr.window_s = 25.0 / 1e6, 50.0 / 1e6
    run = SimpleNamespace(tracer=tr)
    assert abs(read_metric("device_idle.online", run) - 50.0) < 1e-9
    assert abs(readers.union_s([(0, 2), (1, 3), (5, 6)], 0.5, 5.5) - 3.0) < 1e-12


def test_fill_over_every_launch():
    run = SimpleNamespace(record={"launches": [("dur", 32, 128, 4, 16, 0),
                                               ("diff", 32, 128, 12, 16, 0)]})
    assert read_metric("fill.online", run) == 50.0
    # one reader for every kind: metrics/fill.py
    assert read_metric("fill.offline", run) == 50.0


def test_queue_wait_sums_the_stages():
    req = {"t_prep": (0.0, 1.0), "chunks": [("dur", 1.5, 2.0), ("diff", 2.25, 3.0)]}
    spans = SimpleNamespace(requests={"a": req})
    run = SimpleNamespace(record={"spans": spans})
    assert abs(read_metric("queue_wait_ms.online", run) - 750.0) < 1e-9
