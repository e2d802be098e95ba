"""A run with the timed path broken underneath comes out not correct: each
fault that a cell can have, planted in the program at the tiny size on the
CPU (the harness's look for a card is the one part skipped)."""

import importlib

import pytest
import torch

from benchmark.tests.tiny import run_cell


@pytest.mark.parametrize("workload,where", [
    ("fluentspeech.online", "speech_editing_tpu_torch.infer.spec_denoiser:SpecDenoiserInfer._infer"),
    ("campnet.offline",
     "speech_editing_tpu_torch.infer.editors:CampNetInfer._model_mel_out_batch")])
def test_an_answer_altered_where_it_is_produced(monkeypatch, workload, where):
    """Every row's mel, as the device program returns it, moved at one frame
    inside the edit."""
    module, _, attr = where.partition(":")
    cls_name, meth = attr.split(".")
    cls = getattr(importlib.import_module(module), cls_name)
    orig = getattr(cls, meth)

    def altered(self, *args, **kwargs):
        out = orig(self, *args, **kwargs).clone()
        out[:, out.shape[1] // 2] += 0.05
        return out
    monkeypatch.setattr(cls, meth, altered)
    run, _ = run_cell(workload)
    assert not run.correct, run.compared


def test_a_request_that_never_comes(monkeypatch):
    from speech_editing_tpu_torch.infer.online import OnlineEditServer

    orig = OnlineEditServer.submit

    def dropping(self, inp, seed=None):
        # the window's second request (named after its index, 1) is lost:
        # its future never resolves
        if inp["item_name"].rsplit(".", 1)[1] == "1":
            from speech_editing_tpu_torch.infer.online import EditFuture
            return EditFuture()
        return orig(self, inp, seed)
    monkeypatch.setattr(OnlineEditServer, "submit", dropping)
    monkeypatch.setitem(__import__("benchmark.tests.tiny", fromlist=["x"]).OVERRIDES[
        "fluentspeech.online"]["mix"], "drain_s", 5.0)
    run, _ = run_cell("fluentspeech.online")
    assert run.failed >= 1 and not run.correct, run.compared


@pytest.mark.parametrize("workload", ["fluentspeech.train", "campnet.train"])
def test_a_step_that_returns_its_state_unchanged(monkeypatch, workload):
    from speech_editing_tpu_torch.training.train_state import TrainStep

    orig = TrainStep._apply

    def unchanged(self, n_micro):
        before = [p.detach().clone() for p in self.params]
        out = orig(self, n_micro)
        with torch.no_grad():
            for p, b in zip(self.params, before):
                p.copy_(b)
        return out
    monkeypatch.setattr(TrainStep, "_apply", unchanged)
    run, _ = run_cell(workload)
    assert not run.correct, run.compared
    assert dict((n, v) for n, v, _ in run.compared)["change_median_gap"] >= 0.99


@pytest.mark.parametrize("workload", ["fluentspeech.train", "campnet.train"])
def test_half_of_the_batch_left_out(monkeypatch, workload):
    from speech_editing_tpu_torch.training.trainer import Trainer

    orig = Trainer._device_batch

    def half(self, raw, shard=True):
        out = orig(self, raw, shard)
        n = max(1, next(iter(out.values())).shape[0] // 2)
        return {k: v[:n] for k, v in out.items()}
    monkeypatch.setattr(Trainer, "_device_batch", half)
    run, _ = run_cell(workload)
    assert not run.correct, run.compared
