"""The control comes out not correct: the reference in TF32 put in the
program's place, at the cell's own size, on three seeds, fails at least one
of the cell's limits. Needs the card (TF32 exists only there)."""

import json
import os
import tempfile

import pytest

from benchmark.harness import Run, load_json, loop_module
from benchmark.tests.tiny import ROOT


@pytest.mark.card
@pytest.mark.parametrize("workload", ["fluentspeech.online", "fluentspeech.train",
                                      "campnet.offline", "campnet.train"])
def test_the_control_fails_a_limit(card, workload):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    w = next(c for c in bench["workloads"] if c["name"] == workload)
    limits = load_json(f"limits/{workload}.json")
    for seed in (1, 2, 3):
        with tempfile.TemporaryDirectory() as tmp:
            run = Run(workload, seed, float(bench["run_seconds"]), False, tmp, card,
                      load_json(f"configs/{w['config']}.json"),
                      load_json(f"traffic/{w['traffic']}.json"))
            gaps = loop_module(run.mix).control(run)
        assert any(gaps[k] > lim for k, lim in limits.items() if k in gaps), (seed, gaps)
