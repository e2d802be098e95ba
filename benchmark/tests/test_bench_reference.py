"""The reference against the port at tiny widths on the CPU: a whole run of
each cell (its generator, the program, the window, the comparison) comes out
correct, with the program within float rounding of the reference."""

import pytest

from benchmark.tests.tiny import run_cell


@pytest.mark.parametrize("workload,metrics", [
    ("fluentspeech.online", {"edit_p50_ms", "edit_p95_ms", "setup_s"}),
    ("campnet.offline", {"audio_s_per_s", "setup_s"})])
def test_served_edits_match_the_reference(workload, metrics):
    run, values = run_cell(workload)
    assert run.correct, run.compared
    gaps = {n: v for n, v, _ in run.compared}
    assert gaps["mel_gap"] < 1e-4 and gaps["wav_gap"] < 1e-4
    assert gaps.get("dur_gap", 0.0) < 1e-4
    assert run.attempted > 0 and run.failed == 0
    assert set(values) == metrics


@pytest.mark.parametrize("workload", ["fluentspeech.train", "campnet.train"])
def test_training_steps_match_the_reference(workload):
    run, values = run_cell(workload)
    assert run.correct, run.compared
    gaps = {n: v for n, v, _ in run.compared}
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4
    assert set(values) == {"train_frames_per_s", "setup_s"}
