"""One run of one cell: what it was asked, what it recorded, and the line it
prints.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
configuration is ``configs/<name>.json``; the mix is ``traffic/<name>.json``,
which names its loop, ``loops/<loop>.py``; each metric is read by
``metrics/<metric name>.py``, or where there is none by
``metrics/<the name before its first dot>.py`` (one reader for
``fill.online`` and ``fill.offline``), whose ``read(run)`` returns a
number, or None where the run gave it nothing to read. A later cell, mix or
metric is a new file of these and a new entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "speech_editing_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(rel: str) -> dict:
    with open(HERE / rel) as f:
        return json.load(f)


@dataclass
class Run:
    """What a loop is given and what it leaves for the readers."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    tmp: str
    device: str = "cuda"
    config: dict = field(default_factory=dict)
    mix: dict = field(default_factory=dict)
    # set by the loop
    window: tuple = (0.0, 0.0)          # perf_counter at the window's start and end
    setup_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    record: dict = field(default_factory=dict)
    tracer: object = None
    compared: list = field(default_factory=list)   # (name, value, limit)
    memory_peak_bytes: int = 0
    notes: list = field(default_factory=list)
    marks: list = field(default_factory=list)     # (set-up phase, perf_counter at its end)

    def mark(self, phase: str) -> None:
        self.marks.append((phase, time.perf_counter()))

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def compare(self, name: str, value: float, limit: float) -> None:
        self.compared.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.compared) and all(v <= lim for _, v, lim in self.compared)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def read_metric(name: str, run: Run):
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def loop_module(mix: dict):
    return importlib.import_module(f"benchmark.loops.{mix['loop']}")


def execute(bench: dict, workload: str, seed: int, seconds: float, trace: bool, tmp: str,
            device: str = "cuda", overrides: dict | None = None,
            started: tuple | None = None) -> tuple:
    """Runs the cell; returns (run, metrics {name: (value, unit)}).
    ``overrides`` replace keys of the configuration's ``hp`` and
    ``vocoder`` and of the mix (tests, at tiny sizes). ``started``:
    (perf_counter, seconds since the process started) at one moment, from
    which ``setup_s`` is the process's age when the window opened."""
    w = cell(bench, workload)
    config = load_json(f"configs/{w['config']}.json")
    if overrides:
        config = dict(config, hp=dict(config["hp"], **overrides.get("hp", {})),
                      vocoder=dict(config.get("vocoder", {}), **overrides.get("vocoder", {})))
    mix = load_json(f"traffic/{w['traffic']}.json")
    if overrides and "mix" in overrides:
        mix = dict(mix, **overrides["mix"])
    run = Run(workload, seed, seconds, trace, tmp, device, config, mix)
    loop_module(mix).run(run)
    if started is not None:
        run.setup_s = started[1] + (run.window[0] - started[0])
        t, parts = started[0], []
        for phase, at in run.marks:
            parts.append(f"{phase} {at - t:.3f}")
            t = at
        run.notes.append(f"set-up {run.setup_s:.3f} s: process start to run "
                         f"{started[1]:.3f}; " + ", ".join(parts))
    values = {}
    for m in metrics_for(bench, workload, trace):
        v = read_metric(m["name"], run)
        if v is not None:
            values[m["name"]] = (float(v), m["unit"])
    return run, values


def result_line(run: Run, values: dict, device: dict, breakdown=None) -> dict:
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": {k: {"value": v, "unit": u} for k, (v, u) in values.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in run.compared}
    return out

