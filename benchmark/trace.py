"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over CPU and
CUDA activity (every thread's ranges, where this torch can), written as a
Chrome trace into the run's temporary directory and read back here.

The window opens and closes ``EDGE_S`` of host sleep away from the work it
keeps, as the device's timestamps can read behind the host's. Device busy
time is the union of the intervals of kernels, copies and sets (cuDNN runs
some work on streams of its own, so summed durations can exceed it). Each
kernel is tied to the host range that launched it: the runtime call of the
same correlation id, then the innermost ``bench.*`` range of that thread
around it.
"""

from __future__ import annotations

import bisect
import json
import os
import time

import torch

EDGE_S = 0.05
TRACE_AT = 0.3          # the traced part of a window starts at this share of it
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _profile():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        from torch._C._profiler import _ExperimentalConfig

        return profile(activities=acts,
                       experimental_config=_ExperimentalConfig(profile_all_threads=True))
    except (ImportError, TypeError):
        return profile(activities=acts)


class Trace:
    """``start()`` and ``stop()`` around the traced window; afterwards
    ``busy_s``, ``window_s``, ``host_window`` (the traced part on the
    host's ``perf_counter``), ``kernels`` [(name, start us, dur us, kind,
    range)], the breakdown lists and the helpers below."""

    def __init__(self, out_dir: str):
        self.path = os.path.join(out_dir, "trace.json")
        self.kernels: list = []
        self.launched: list = []       # each device operation's launch time (us), or None

    def start(self) -> None:
        time.sleep(EDGE_S)
        self._prof = _profile()
        self._prof.__enter__()
        self._range = torch.profiler.record_function("bench.trace_window")
        self._range.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.host_window = (self._t0, time.perf_counter())
        self._range.__exit__(None, None, None)
        time.sleep(EDGE_S)
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.path)
        self._read(events)

    def _read(self, events: list) -> None:
        spans = [e for e in events if e.get("ph") == "X"]
        win = [e for e in spans if e.get("name") == "bench.trace_window"]
        if not win:
            raise RuntimeError("trace: the window's range is missing from the profile")
        w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
        self.window_s = (w1 - w0) / 1e6
        ranges: dict = {}
        for e in spans:
            if e.get("cat") == "user_annotation" and e["name"].startswith("bench.") \
                    and e["name"] != "bench.trace_window":
                ranges.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"], e["name"]))
        for v in ranges.values():
            v.sort()
        launch = {e["args"]["correlation"]: (e["tid"], e["ts"]) for e in spans
                  if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
        device = []
        for e in spans:
            if e.get("cat") not in DEVICE_CATS:
                continue
            a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if b <= a:
                continue
            where = launch.get(e.get("args", {}).get("correlation"))
            device.append((e["name"], a, b - a, e.get("cat"),
                           self._enclosing(ranges, *where) if where else None))
            self.launched.append(where[1] if where else None)
        self.kernels = device
        self.busy_s = _union(device) / 1e6
        self._host_ranges = [r for v in ranges.values() for r in v]
        self._w0, self._w1 = w0, w1

    @staticmethod
    def _enclosing(ranges: dict, tid, ts):
        """The innermost ``bench.*`` range of thread ``tid`` around ``ts``:
        of the ranges that start by ``ts``, the latest that holds it (ranges
        of one thread nest, so a few steps back find it)."""
        rs = ranges.get(tid, ())
        i = bisect.bisect_right(rs, (ts, float("inf"), "")) - 1
        for a, b, name in rs[max(0, i - 64):i + 1][::-1]:
            if a <= ts <= b:
                return name
        return None

    # -- helpers for the metric readers ----------------------------------------
    def device_s(self, match=None, under=None) -> float:
        """Seconds of device operations whose name contains ``match`` and
        whose launching range starts with ``under`` (either None: any)."""
        return sum(d for n, _, d, _, r in self.kernels
                   if (match is None or match in n)
                   and (under is None or (r is not None and r.startswith(under)))) / 1e6

    def by_range(self, match: str, under: str) -> dict:
        """{range name: [device us of each operation named ``match``]} over
        the ranges that start with ``under``."""
        out: dict = {}
        for n, _, d, _, r in self.kernels:
            if match in n and r is not None and r.startswith(under):
                out.setdefault(r, []).append(d)
        return out

    def by_time(self, match: str, prefix: str) -> dict:
        """{range name: [device us of each operation named ``match``]}, an
        operation going to the ``prefix#i`` range (of any thread) whose
        interval holds its launch: for work launched on other threads, as
        autograd's backward is, inside ranges that follow one another."""
        spans = sorted((a, b, n) for a, b, n in self._host_ranges if n.startswith(prefix + "#"))
        starts = [a for a, _, _ in spans]
        out: dict = {}
        for (n, _, d, _, _), ts in zip(self.kernels, self.launched):
            if match not in n or ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and spans[i][0] <= ts <= spans[i][1]:
                out.setdefault(spans[i][2], []).append(d)
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops: dict = {}
        for n, _, d, _, _ in self.kernels:
            ops[n] = ops.get(n, 0.0) + d / 1e6
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        ivs = sorted((a, a + d) for _, a, d, _, _ in self.kernels)
        gaps, end = [], self._w0
        for a, b in ivs:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self._w1 > end:
            gaps.append((end, self._w1))
        idle = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            label, over = "no benchmark range", 0.0
            for ra, rb, name in self._host_ranges:
                o = min(b, rb) - max(a, ra)
                if o > over:
                    label, over = name.split("#")[0], o
            idle.append((label, (b - a) / 1e6))
        return {"device_ops": [[n, s] for n, s in device_ops],
                "idle_gaps": [[n, s] for n, s in idle]}


def _union(device: list) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted((a, a + d) for _, a, d, _, _ in device):
        if b > end:
            total, end = total + b - max(a, end), b
    return total


def range_name(kind: str, index: int) -> str:
    """The name of the ``index``-th range of ``kind``: ``bench.<kind>#<i>``."""
    return f"bench.{kind}#{index}"


def ranges_in(trace: Trace, prefix: str) -> set:
    """The ranges named ``prefix#i`` that lie wholly inside the window."""
    return {name for a, b, name in trace._host_ranges
            if name.startswith(prefix + "#") and a >= trace._w0 and b <= trace._w1}

