"""The two readings each compared number's limit is set from: the program's
gaps over many seeds (full runs of the cell, short windows at the cell's own
load) and the control's (the reference in the precision below the stated
one, TF32, put in the program's place) over a few, all in one process.

    python3 -m benchmark.readings --workload fluentspeech.online \
        --seeds 101,102,103 --control-seeds 201,202,203 --seconds 5

Prints one JSON line a run: its kind (program or control), seed and gaps.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def main(argv=None) -> int:
    from benchmark.harness import Run, cell, execute, load_json, loop_module

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    with open("BENCHMARK.json") as f:
        bench = json.load(f)
    w = cell(bench, args.workload)
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        with tempfile.TemporaryDirectory(prefix="control-", dir=base) as tmp:
            run = Run(args.workload, s, args.seconds, False, tmp, "cuda",
                      load_json(f"configs/{w['config']}.json"),
                      load_json(f"traffic/{w['traffic']}.json"))
            g = loop_module(run.mix).control(run)
            print(json.dumps(dict(kind="control", seed=s, **{k: v for k, v in g.items()
                                                             if k.endswith("gap")})), flush=True)
    for s in [int(x) for x in args.seeds.split(",") if x]:
        with tempfile.TemporaryDirectory(prefix="readings-", dir=base) as tmp:
            run, _ = execute(bench, args.workload, s, args.seconds, False, tmp)
            gaps = dict({n: v for n, v, _ in run.compared}, **run.record.get("gaps", {}))
            print(json.dumps(dict(kind="program", seed=s, correct=run.correct, **gaps)),
                  flush=True)
            for note in run.notes:
                print(note, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
