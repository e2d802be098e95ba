"""The training loop over a generated corpus: ``Trainer.step`` over batches
from the trainer's own train loader (spawned workers, ``ds_workers`` of the
configuration), the loop ``Trainer.fit`` runs, without validation or
checkpoints inside the window.

Set-up writes the corpus, builds the trainer as the training entry does (TF32
off), loads the seeded weights and takes the first epoch's steps through the
same loader and call: the first ``check.steps`` of them are the steps the
reference follows (their losses, the first gradient as Adam holds it, the
parameters after them), and the epoch warms every batch shape the window
meets. The window then steps for ``seconds``; its frames are the real
(unpadded) mel frames of every step it completed, its time runs to the
device's end of its last step.
"""

from __future__ import annotations

import gc
import os
import time

import torch

from benchmark.serving import obj, oracle
from benchmark.trace import TRACE_AT, Trace, range_name
from benchmark.reference.frontend import phone_set
from benchmark.traffic.generate import words, write_corpus
from benchmark.weights import seeded_state_dict


def run(run) -> None:
    from speech_editing_tpu_torch.training.trainer import Trainer, float32_on_card

    mix, config = run.mix, run.config
    data_dir = os.path.join(run.tmp, "data")
    hp = dict(config["hp"], seed=int(run.seed) % (2 ** 31), binary_data_dir=data_dir,
              work_dir=os.path.join(run.tmp, "work"))
    hp.update(mix.get("hp", {}))
    items = write_corpus(mix, hp, run.seed, data_dir)
    run.mark("corpus")
    if run.device == "cuda":
        float32_on_card()
    task = obj(config["program"]["task"])(hp)
    hp = dict(hp, vocab_size=task.vocab_size)
    trainer = Trainer(task, task.hp, run.device)
    orc = oracle(run)
    with torch.device("meta"):
        ref = orc.reference_model(dict(config, hp=hp), task.vocab_size)
    weights = seeded_state_dict(ref, run.seed, run.device, config.get("weights", {}))
    trainer.model.load_state_dict(weights)
    weights = {k: v.cpu() for k, v in weights.items()}
    trainer._build_state()
    run.mark("trainer and weights")
    loader = trainer._loader("train", shuffle=True, endless=True)
    epoch0 = len(loader.sampler.batches(0))
    batches = iter(loader)
    waits, steps = [], []

    def step(index: int, timed: bool):
        t0 = time.perf_counter()
        raw = next(batches)
        t1 = time.perf_counter()
        with torch.profiler.record_function(range_name("step", index)):
            metrics = trainer.step(raw)
        t2 = time.perf_counter()
        if timed:
            waits.append(t1 - t0)
            t_len = torch.as_tensor(raw["mel_lengths"]).long()
            s_len = (torch.as_tensor(raw["txt_tokens"]) > 0).sum(1).long()
            steps.append(dict(start=t0, fetched=t1, end=t2, range=range_name("step", index),
                              frames=int(t_len.sum()), tokens=int(s_len.sum()),
                              frames_sq=int((t_len * t_len).sum()),
                              frames_tokens=int((t_len * s_len).sum()),
                              tokens_sq=int((s_len * s_len).sum()),
                              shape=tuple(raw["mels"].shape[:2])))
        return raw, metrics

    # the steps the reference follows, then the rest of the first epoch
    n_check = int(mix["check"]["steps"])
    params = dict(trainer.model.named_parameters())
    recorded = {"loss": [], "names": []}
    for k in range(max(n_check, epoch0)):
        raw, metrics = step(-1 - k, False)
        if k == 0:
            run.mark("first batch and step")
        if k < n_check:
            recorded["loss"].append(float(metrics["total_loss"]))
            recorded["names"].append(list(raw["item_name"]))
        if k == 0:
            beta1 = float(hp.get("optimizer_adam_beta1", 0.9))
            state = trainer.train_step.optimizer.state
            recorded["grad"] = {n: (state[p]["exp_avg"] / (1 - beta1)).cpu()
                                for n, p in params.items() if "exp_avg" in state.get(p, {})}
        if k == n_check - 1:
            recorded["params"] = {n: p.detach().cpu().clone() for n, p in params.items()}
    if run.device == "cuda":
        torch.cuda.synchronize()
    run.mark(f"the first epoch's other {max(n_check, epoch0) - 1} steps")

    tracer = Trace(run.tmp) if run.trace else None
    trace_at = (TRACE_AT * run.seconds,
                min(mix.get("trace_s", 3.0), 0.5 * run.seconds))
    t0 = time.perf_counter()
    i, traced = 0, 0
    while time.perf_counter() < t0 + run.seconds:
        if tracer is not None and traced == 0 and time.perf_counter() >= t0 + trace_at[0]:
            tracer.start()
            traced = 1
        step(i, True)
        i += 1
        if traced == 1 and time.perf_counter() >= t0 + sum(trace_at):
            tracer.stop()
            traced = 2
    if run.device == "cuda":
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    if traced == 1:
        tracer.stop()
    run.window = (t0, t_end)
    run.memory_peak_bytes = torch.cuda.max_memory_allocated() if run.device == "cuda" else 0
    run.attempted, run.failed = len(steps), 0
    run.tracer = tracer
    run.record.update(steps=steps, loader_wait_s=waits, hp=hp)
    run.notes.append(f"window: {len(steps)} steps, batch shapes {sorted({s['shape'] for s in steps})[:4]}"
                     f"..., {sum(s['frames'] for s in steps)} real frames; set-up steps {epoch0}")
    try:
        loader.close()
    except RuntimeError as e:
        # a worker that died on its way out (seen once in 27 runs: "killed by
        # signal: Aborted" inside the join); torch's shutdown has ended the
        # others and unregistered them before raising, and the window's
        # steps are complete, so the run goes on to its comparison
        run.notes.append(f"the train loader's shutdown raised: {e}")
    del trainer, batches, params
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    orc.check_train(run, hp, recorded, items, weights, phone_set(words(mix)))
    if recorded.get("mismatch"):
        run.notes.append(recorded["mismatch"])


def control(run) -> dict:
    """The control's gaps at the cell's size for ``run.seed``: the corpus and
    weights a run makes, the reference in TF32 against float32 over the
    steps a run follows."""
    mix, config = run.mix, run.config
    hp = dict(config["hp"], seed=int(run.seed) % (2 ** 31))
    hp.update(mix.get("hp", {}))
    items = write_corpus(mix, hp, run.seed, os.path.join(run.tmp, "data"))
    phones = phone_set(words(mix))
    hp = dict(hp, vocab_size=len(phones) + 3)
    orc = oracle(run)
    with torch.device("meta"):
        ref = orc.reference_model(dict(config, hp=hp), hp["vocab_size"])
    weights = {k: v.cpu() for k, v in seeded_state_dict(ref, run.seed, run.device,
                                                         config.get("weights", {})).items()}
    return orc.control_train(run, hp, items, weights, phones, int(mix["check"]["steps"]))
