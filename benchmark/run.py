"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

    python3 -m benchmark.run --workload fluentspeech.online --seed 7 \
        --seconds 36 --trace 0

from the root of a checkout on a machine with CUDA cards. Set-up makes the
cell's inputs and weights from ``--seed``, builds the program under test
(``speech_editing_tpu_torch``) and warms the shapes its traffic uses; then
the window measures for ``--seconds``; then the outputs that the window
produced are compared with the plain reference (``reference/``). The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones, read in a traced window), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``, each compared number beside its limit,
which also close standard error.

Exits non-zero without a result line where CUDA is absent or has fewer cards
than the cell asks for, or where ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

T_MAIN = time.perf_counter()


def main(argv=None) -> int:
    from benchmark.harness import (cell, execute, forbidden_modules, process_age_s,
                                   result_line)

    age0 = process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open("BENCHMARK.json") as f:
        bench = json.load(f)
    chips = int(cell(bench, args.workload)["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    with tempfile.TemporaryDirectory(prefix="bench-", dir=base) as tmp:
        run, values = execute(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), tmp, started=(T_MAIN, age0))
        found = forbidden_modules()
        if found:
            print(f"benchmark: modules loaded that the benchmark must not load: {found}",
                  file=sys.stderr)
            return 3
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                  "memory_peak_bytes": int(run.memory_peak_bytes)}
        breakdown = None
        if args.trace:
            device.update(busy_s=run.tracer.busy_s, window_s=run.tracer.window_s)
            breakdown = run.tracer.breakdown()
        line = result_line(run, values, device, breakdown)
    for note in run.notes:
        print(note, file=sys.stderr)
    for name, v, lim in run.compared:
        print(f"compared {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
