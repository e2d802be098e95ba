"""Multi-rank dry run of the flagship: the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``.

``dryrun_multichip(n, device)`` starts ``n`` ranks (``spawn_ranks``: a new
Python process each; gloo, on the CPU or every rank on one CUDA device)
and runs three phases on one seeded global batch, each held against the
same program run single-process:

1. data parallel: ``steps`` train steps of the flagship (``TrainStep`` on a
   data mesh of ``n`` ranks), the global batch's diffusion draws injected,
   dropout off; every rank ends with the single-process parameters and Adam
   moments;
2. tensor parallel, when ``n`` is even: the same steps on a (data ``n / 2``,
   model 2) mesh with the parameters split by ``parallel/tp.py``;
3. data-parallel serving: reverse diffusion with per-row injected noise,
   the composite into the reference mel and HiFi-GAN's vocoding, each rank
   on its rows; the rows gathered must equal the single-process program's
   (max |d| below ``SERVE_TOL``).

Rank 0 then runs the single-process program on the global batch itself,
on the same device and thread count, and reports each phase's errors.

Each phase runs in float32 and, with ``"bfloat16"`` in ``dtypes``, in bf16
(``use_bf16``: the train steps; serving stays float32, as the JAX package
serves). The kernels' launch counters are read on every rank around each
phase. A rank that fails fails the run; nothing falls back to fewer ranks.

    python -m speech_editing_tpu_torch.parallel.dryrun [--n 2] [--device cpu] \
        [--full] [--bf16]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from speech_editing_tpu_torch.config.flagship import FLAGSHIP_HP, HIFIGAN_V1_HP
from speech_editing_tpu_torch.models.spec_denoiser.spec_denoiser import GaussianDiffusion
from speech_editing_tpu_torch.models.vocoder.hifigan import HifiGanGenerator
from speech_editing_tpu_torch.ops.cuda.diffnet_block import diffnet_block, diffnet_block_bwd
from speech_editing_tpu_torch.ops.flash_attention import flash_mha, flash_mha_bwd
from speech_editing_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, gather_axis,
                                                    init_distributed, make_mesh, shard_batch)
from speech_editing_tpu_torch.parallel.tp import (make_tp_mesh, param_partition_specs,
                                                  sharded_share)
from speech_editing_tpu_torch.training.tasks.spec_denoiser import build_model, make_loss_fn
from speech_editing_tpu_torch.training.trainer import cuda_or_cpu, float32_on_card
from speech_editing_tpu_torch.training.train_state import TrainStep
from speech_editing_tpu_torch.utils.init import init_like_flax

TINY = dict(hidden_size=32, enc_layers=1, residual_layers=2, residual_channels=16,
            timesteps=2, dur_predictor_layers=1)
TINY_VOCODER = {"upsample_rates": [4, 4], "upsample_kernel_sizes": [8, 8],
                "upsample_initial_channel": 8, "resblock": "2",
                "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]]}
SIL_IDS = (3,)
# the ranks' run against the single-process run (``state_err``): in
# float32 every parameter within 1e-4 and every moment within 1e-3 of its
# tensor's largest element (on the card the embeddings' backward and some
# cuDNN kernels sum with atomics, in another order each run: 1.2e-4
# measured between two runs; 1e-3 is the bar of a step on the card against
# the CPU in ``chip_smoke.py``); in bf16 each rank's gradient is rounded to
# bf16 before the sum over the ranks (one process rounds the sum once, and
# where the ranks' parts cancel the roundings weigh more), so the moments
# are held in relative L2 per tensor, at the worst and the median tensor,
# to the bars of a bf16 step on the card against the CPU (0.1 and 0.02)
TOL = {"float32": {"params": 1e-4, "moments": 1e-3},
       "bfloat16": {"params": 1e-4, "moments_l2": 0.1, "moments_l2_median": 0.02}}
SERVE_TOL = 1e-5          # a served row against the single-process program, as JAX asks
# the JAX dry run's batch: a row a rank of 32 frames and 8 tokens
ROWS, FRAMES, TOKENS = 1, 32, 8
# each kernel's launch counter: its wrapper and attribute
COUNTERS = {"diffnet_block": (diffnet_block, "launches"),
            "diffnet_block_bf16": (diffnet_block, "launches_bf16"),
            "diffnet_block_bwd": (diffnet_block_bwd, "launches"),
            "diffnet_block_bwd_bf16": (diffnet_block_bwd, "launches_bf16"),
            "flash_mha": (flash_mha, "launches"), "flash_mha_bf16": (flash_mha, "launches_bf16"),
            "flash_mha_bwd": (flash_mha_bwd, "launches"),
            "flash_mha_bwd_bf16": (flash_mha_bwd, "launches_bf16")}


def counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in COUNTERS.items()}


def example_batch(b: int, t: int, s: int, vocab: int, seed: int = 0) -> dict:
    """The JAX dry run's batch (numpy): sorted random ``mel2ph``, the middle
    third of each row masked."""
    rs = np.random.RandomState(seed)
    mel2ph = np.clip(np.sort(rs.randint(1, s + 1, (b, t)), axis=-1), 1, s)
    mask = np.zeros((b, t), np.float32)
    mask[:, t // 3: 2 * t // 3] = 1.0
    return {"txt_tokens": rs.randint(1, vocab, (b, s)).astype(np.int64),
            "mels": (rs.randn(b, t, 80) * 0.5).astype(np.float32),
            "mel2ph": mel2ph.astype(np.int64),
            "f0": rs.rand(b, t).astype(np.float32),
            "uv": (rs.rand(b, t) > 0.7).astype(np.float32),
            "time_mel_masks": mask}


def seeded_weights(hp: dict, vocab: int, seed: int) -> dict:
    """The flagship's state_dict from flax's initializers under ``seed``,
    with every parameter flax starts at zero (biases, DiffNet's output
    projection) drawn at 0.02 so that every weight gets a gradient."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_model(vocab, hp)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return model.state_dict()


def vocoder_weights(hp: dict, seed: int) -> dict:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return init_like_flax(HifiGanGenerator(hp)).state_dict()


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def train_steps(hp: dict, model, batch: dict, draws: list, device,
                mesh: Optional[Mesh] = None, specs: Optional[dict] = None) -> tuple:
    """``len(draws)`` steps of ``model`` (a copy is trained) on ``batch``
    (the global batch alone, or this rank's rows of it under ``mesh``) with
    each step's global ``(t, noise)``; (metrics of each step with its host
    seconds, ``step_s``, the state on the CPU)."""
    model = copy.deepcopy(model).to(device)
    step = TrainStep(model, hp, make_loss_fn(model, hp, SIL_IDS, train=False), mesh, specs)
    metrics = []
    for t, noise in draws:
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in step(batch, t=t.to(device), noise=noise.to(device)).items()}
        metrics.append(dict(m, step_s=time.perf_counter() - t0))
    state = step.state_dict()
    return metrics, {"model": {k: v.cpu() for k, v in state["model"].items()},
                     "moments": [{k: s[k].cpu() for k in ("exp_avg", "exp_avg_sq")}
                                 for _, s in sorted(state["optimizer"]["state"].items())]}


def serve_program(model, vocoder, batch: dict, noise: Sequence[torch.Tensor]) -> tuple:
    """The batched inference program: reverse diffusion from ``noise``
    (``timesteps + 1`` tensors [B, T, 80], the initial one first), the
    composite into the reference mel, HiFi-GAN; (mel [B, T, 80], wav)."""
    tm = batch["time_mel_masks"][..., None].float()
    with torch.inference_mode():
        out = model(batch["txt_tokens"], tm, batch["mel2ph"], None, batch["mels"],
                    batch["f0"], batch["uv"], use_pred_pitch=True, noise=list(noise))
        comp = out["mel_out"] * tm + batch["mels"] * (1 - tm)
        return comp, vocoder(comp)


def dp_serve(mesh: Mesh, model, vocoder, batch: dict, noise: Sequence[torch.Tensor]) -> tuple:
    """:func:`serve_program` on this rank's rows of the global ``batch`` and
    ``noise``; the outputs of every rank gathered, on every rank."""
    local = shard_batch(batch, mesh)
    comp, wav = serve_program(model, vocoder, local, shard_batch(list(noise), mesh))
    return gather_axis(comp, 0, mesh, DATA_AXIS), gather_axis(wav, 0, mesh, DATA_AXIS)


# -- spawning ------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(spec: dict) -> None:
    """A rank's process: join the job (or set torchrun's environment),
    run ``spec["fn"]`` and save its result."""
    import importlib

    module, name = spec["fn"].split(":")
    fn = getattr(importlib.import_module(module), name)
    rank, n = spec["rank"], spec["n"]
    torch.set_num_threads(spec["threads"])
    device = torch.device(spec["device"])
    if spec["init"]:
        device = init_distributed("gloo", f"tcp://127.0.0.1:{spec['port']}", n, rank, device)
    else:       # torchrun's environment, for ``fn`` to join through
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(spec["port"]))
    if device.type == "cuda":
        float32_on_card()
        torch.zeros(1, device=device)       # the rank's CUDA context
    ready = time.time() - spec["t_spawn"]
    try:
        result = fn(rank, device, torch.load(spec["inputs"], weights_only=False))
        result["startup_s"] = ready
        torch.save(result, os.path.join(spec["out"], f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, n: int, inputs: dict, device: Any = "cpu", threads: int = 1,
                init: bool = True) -> list:
    """Run ``fn(rank, device, inputs)`` (a function at the top of an
    importable module; it returns a dict) in ``n`` new Python processes
    joined over gloo, every one on ``device``, or with ``init=False`` given
    torchrun's environment to join by themselves; their results in rank
    order. Each process imports only
    ``fn``'s module and what it needs. A rank that exits non-zero stops the
    others and raises here."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [p for p in sys.path if p and os.path.isdir(p)]
        + [os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        path = os.path.join(tmp, "inputs.pt")
        torch.save(inputs, path)
        port, t_spawn = free_port(), time.time()
        procs = []
        for rank in range(n):
            spec = dict(fn=f"{fn.__module__}:{fn.__name__}", rank=rank, n=n, port=port,
                        device=str(device), inputs=path, out=tmp, threads=threads,
                        t_spawn=t_spawn, init=init)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import json, sys; from speech_editing_tpu_torch."
                 "parallel.dryrun import _rank_main; _rank_main(json.loads(sys.argv[1]))",
                 json.dumps(spec)], env=env))
        try:
            while any(p.poll() is None for p in procs):
                failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
                if failed:
                    raise RuntimeError(f"rank {failed[0][0]} exited {failed[0][1]}")
                time.sleep(0.05)
            failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
            if failed:
                raise RuntimeError(f"rank {failed[0][0]} exited {failed[0][1]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]


# -- the dry run ---------------------------------------------------------------------

def _dryrun_rank(rank: int, device, inp: dict) -> dict:
    """The three phases on one rank (see the module doc); then, outside the
    phases' counts, the single-process program on the global batch and each
    phase's errors against it: each rank trains it in its share of the
    dtypes (every rank holds each run's whole state), rank 0 serves it."""
    n = dist.get_world_size()
    out: dict = {"launches": {}, "seconds": {}, "step_s": {}}
    batch = to_device(inp["batch"], device)
    draws = inp["draws"]

    def phase(name, run):
        before, t0 = counts(), time.perf_counter()
        value = run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["seconds"][name] = time.perf_counter() - t0
        out["launches"][name] = {k: v - before[k] for k, v in counts().items()}
        return value

    def hp_of(dtype):
        return dict(inp["hp"], use_bf16=dtype == "bfloat16")

    # the weights in a module of the model's classes (torch's initializers,
    # cheaper than flax's), copied for each phase
    base = GaussianDiffusion(inp["vocab"], inp["hp"], 80)
    base.load_state_dict(inp["weights"])
    mesh, runs = make_mesh(n), {}
    for dtype in inp["dtypes"]:
        runs[f"dp {dtype}"] = phase(f"dp {dtype}", lambda: train_steps(
            hp_of(dtype), base, shard_batch(batch, mesh), draws, device, mesh))
    if n % 2 == 0:
        tp_mesh = make_tp_mesh(n, 2)
        specs = param_partition_specs(base, 2, inp["min_size"])
        out["split_share"] = sharded_share(base, specs)
        for dtype in inp["dtypes"]:
            runs[f"tp {dtype}"] = phase(f"tp {dtype}", lambda: train_steps(
                hp_of(dtype), base, shard_batch(batch, tp_mesh), draws, device, tp_mesh,
                specs))
    model = copy.deepcopy(base).to(device).eval()
    vocoder = HifiGanGenerator(inp["vocoder_hp"])
    vocoder.load_state_dict(inp["vocoder_weights"])
    vocoder.to(device).eval()
    serve = to_device(inp["serve_batch"], device)
    noise = [x.to(device) for x in inp["serve_noise"]]
    mel, wav = phase("serve", lambda: dp_serve(mesh, model, vocoder, serve, noise))
    out["step_s"] = {k: [m["step_s"] for m in metrics] for k, (metrics, _) in runs.items()}
    for dtype in inp["dtypes"][rank::n]:
        ref_metrics, ref = train_steps(hp_of(dtype), base, batch, draws, device)
        for kind in ("dp", "tp"):
            if f"{kind} {dtype}" in runs:
                metrics, state = runs.pop(f"{kind} {dtype}")
                out[f"{kind} {dtype}"] = dict(
                    state_err(state, ref), total_loss=[m["total_loss"] for m in metrics],
                    ref_total_loss=[m["total_loss"] for m in ref_metrics])
    if rank != 0:
        return out
    ref_mel, ref_wav = serve_program(model, vocoder, serve, noise)
    out["serve"] = {"finite": bool(torch.isfinite(mel).all() and torch.isfinite(wav).all()),
                    "mel_max_abs": float((mel - ref_mel).abs().max()),
                    "wav_max_abs": float((wav - ref_wav).abs().max())}
    return out


def state_err(got: dict, ref: dict) -> dict:
    """The largest |got - ref| over the parameters and over the Adam
    moments, each relative to its tensor's largest |ref|; and the moments'
    relative L2 errors, the largest and the median tensor's."""
    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    pairs = [(g[k], r[k]) for g, r in zip(got["moments"], ref["moments"]) for k in r]
    l2 = [float((a - b).norm() / b.norm().clamp(min=1e-30)) for a, b in pairs]
    return {"params": max(rel(got["model"][k], v) for k, v in ref["model"].items()),
            "moments": max(rel(a, b) for a, b in pairs),
            "moments_l2": max(l2), "moments_l2_median": float(np.median(l2))}


def dryrun_multichip(n: int = 2, device: Any = "cuda", full: bool = False,
                     dtypes: Sequence[str] = ("float32",), steps: int = 1,
                     batch: Optional[dict] = None, serve_rows: int = ROWS,
                     serve_frames: int = FRAMES, min_size: int = 256,
                     log: Callable = print) -> dict:
    """The dry run of the module doc over ``n`` ranks on ``device``: the
    flagship at its full width (``full``) or the JAX dry run's tiny one, on
    ``batch`` (the JAX dry run's ``ROWS`` a rank by default), serving
    ``serve_rows`` rows a rank, splitting parameters of ``min_size``
    elements or more. An error over ``TOL`` against the single-process
    run, a non-finite loss or a served row off by ``SERVE_TOL`` raises.
    Returns the errors, every rank's launches and seconds a phase, and the
    ranks' start-up seconds."""
    device = cuda_or_cpu(device, "dryrun_multichip")
    seed = 0
    hp = dict(FLAGSHIP_HP) if full else dict(FLAGSHIP_HP, **TINY)
    vocab = 80 if full else 40
    vocoder_hp = dict(HIFIGAN_V1_HP) if full else dict(TINY_VOCODER)
    if batch is None:
        batch = example_batch(ROWS * n, FRAMES, TOKENS, vocab, seed)
    b = len(batch["txt_tokens"])
    gen = torch.Generator().manual_seed(seed)
    shape = tuple(np.shape(batch["mels"]))
    draws = [(torch.randint(0, hp["timesteps"] + 1, (b,), generator=gen),
              torch.randn(shape, generator=gen)) for _ in range(steps)]
    serve_batch = example_batch(serve_rows * n, serve_frames, TOKENS, vocab, seed + 1)
    serve_noise = [torch.randn(serve_rows * n, serve_frames, 80, generator=gen)
                   for _ in range(hp["timesteps"] + 1)]
    inputs = dict(hp=hp, vocab=vocab, weights=seeded_weights(hp, vocab, seed),
                  vocoder_hp=vocoder_hp, vocoder_weights=vocoder_weights(vocoder_hp, seed),
                  batch=batch, draws=draws, dtypes=list(dtypes), min_size=min_size,
                  serve_batch=serve_batch, serve_noise=serve_noise)
    t0 = time.perf_counter()
    # on the card the host's cores are shared out among the ranks; on the CPU
    # one thread a rank, as the tests run
    threads = 1 if device.type == "cpu" else max(1, (os.cpu_count() or 1) // n)
    results = spawn_ranks(_dryrun_rank, n, inputs, device, threads=threads)
    first = results[0]
    report: dict = {"n": n, "device": str(device), "ranks_s": time.perf_counter() - t0,
                    "startup_s": [r["startup_s"] for r in results],
                    "launches": [r["launches"] for r in results],
                    "seconds": [r["seconds"] for r in results],
                    "step_s": [r["step_s"] for r in results],
                    "serve": dict(first["serve"], rows=serve_rows * n, frames=serve_frames)}
    if "split_share" in first:
        report["split_share"] = first["split_share"]
    for name, r in [(k, v) for res in results for k, v in res.items()
                    if k.startswith(("dp ", "tp "))]:
        report[name] = r
        bound = TOL[name.split()[1]]
        log(f"[dryrun] {name}: {steps} steps on {n} ranks vs one process: params "
            f"{r['params']:.3e}, Adam moments {r['moments']:.3e} (relative to each tensor's "
            f"max), {r['moments_l2']:.3e} and {r['moments_l2_median']:.3e} (relative L2, the "
            f"worst and the median tensor); tol {bound}; total_loss {r['total_loss']} (one "
            f"process {r['ref_total_loss']})")
        if not (np.all(np.isfinite(r["total_loss"]))
                and all(r[k] <= v for k, v in bound.items())):
            raise RuntimeError(f"dryrun {name}: {r}")
    sv = report["serve"]
    log(f"[dryrun] serve: {sv['rows']} rows x {serve_frames} frames on {n} ranks vs one "
        f"process: mel max|d| {sv['mel_max_abs']:.3e}, wav max|d| {sv['wav_max_abs']:.3e} "
        f"(tol {SERVE_TOL:.0e})")
    if not (sv["finite"] and sv["mel_max_abs"] < SERVE_TOL and sv["wav_max_abs"] < SERVE_TOL):
        raise RuntimeError(f"dryrun serve: {sv}")
    return report


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--full", action="store_true", help="the flagship's full width")
    p.add_argument("--bf16", action="store_true", help="the train phases in bf16 too")
    args = p.parse_args(argv)
    report = dryrun_multichip(args.n, args.device, args.full,
                              ("float32", "bfloat16") if args.bf16 else ("float32",))
    print(json.dumps({k: v for k, v in report.items() if k != "launches"}))
    return report


if __name__ == "__main__":
    main()
