"""Tiny sizes of the cells for the CPU tests: the published structure at
small widths and short runs."""

import json
import os
import tempfile
import time

import torch

from benchmark.harness import execute

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HP = {"hidden_size": 32, "residual_channels": 32, "residual_layers": 2, "timesteps": 2,
      "enc_dilations": [1]}
OVERRIDES = {
    "fluentspeech.online": {
        "hp": HP, "vocoder": {"upsample_initial_channel": 32},
        "mix": {"sources": {"count": 4, "median_s": 1.6, "sigma": 0.2, "min_s": 1.5,
                            "max_s": 2.5, "words_per_s": 2.6, "f0_hz": [90.0, 220.0]},
                "arrival": {"kind": "poisson", "rate_per_s": 3.0}, "clients": 2,
                "check": {"sample": 3}, "lead_s": 1.0}},
    "fluentspeech.train": {
        "hp": dict(HP, max_tokens=3000, ds_workers=0),
        "mix": {"corpus": {"count": 48, "median_s": 1.5, "sigma": 0.3, "min_s": 1.0,
                           "max_s": 3.0, "frames_per_phone": 8.0, "unvoiced": 0.2,
                           "speakers": 4}}},
}
OVERRIDES["campnet.offline"] = {
    "hp": {"hidden_size": 32}, "vocoder": {"upsample_initial_channel": 32},
    "mix": dict(OVERRIDES["fluentspeech.online"]["mix"], clients=2, outstanding=2, warm_s=0.0)}
OVERRIDES["campnet.train"] = {"hp": {"hidden_size": 32, "max_tokens": 3000, "ds_workers": 0},
                              "mix": OVERRIDES["fluentspeech.train"]["mix"]}


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def run_cell(workload: str, seed: int = 3, seconds: float = 2.0, device: str = "cpu"):
    """(run, metrics) of one run of ``workload`` at the tiny size."""
    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as tmp:
        return execute(bench(), workload, seed, seconds, False, tmp, device=device,
                       overrides=OVERRIDES[workload], started=(time.perf_counter(), 0.0))
