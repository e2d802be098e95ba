"""Rank functions of the port's multi-rank tests (not a test module): each
runs in a rank that ``parallel.dryrun.spawn_ranks`` spawned and returns a
dict. They import torch and the port alone, so that a rank starts fast."""

import contextlib
import io
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from speech_editing_tpu_torch.parallel.mesh import (DATA_AXIS, data_parallel, draw_rows,
                                                    gather_axis, global_mean, global_sums,
                                                    local_rows, make_mesh,
                                                    pad_batch_to_multiple, replicate_tree,
                                                    shard_batch, to_host_local)
from speech_editing_tpu_torch.parallel.tp import (MODEL_AXIS, make_tp_mesh,
                                                  param_partition_specs, shard_params, split_dim)


def reductions(rank, device, inp):
    """The global reductions and draws on 2 ranks: rank r holds rows
    ``x[r]``; a plain sum and mean of the global batch, with gradients."""
    mesh = make_mesh()
    x = torch.tensor(inp["x"][rank], requires_grad=True)
    with data_parallel(mesh):
        (s,) = global_sums(x.sum())
        m = global_mean(x ** 2)
        gen = torch.Generator().manual_seed(3)
        drawn = draw_rows(2, lambda n: torch.randn(n, 3, generator=gen))
        rows = local_rows(torch.arange(4.0), 2)
    (s + m).backward()
    y = torch.full((3,), float(rank))
    replicate_tree({"y": y}, mesh)
    return {"sum": float(s), "mean": float(m), "grad": x.grad.numpy(), "drawn": drawn.numpy(),
            "rows": rows.numpy(), "replicated": y.numpy(),
            "gathered": gather_axis(torch.tensor([float(rank)]), 0, mesh, DATA_AXIS).numpy()}


def _gaussian_diffusion(inp):
    from speech_editing_tpu_torch.models.spec_denoiser.spec_denoiser import \
        GaussianDiffusion
    model = GaussianDiffusion(inp["vocab"], inp["hp"], 80)
    model.load_state_dict(inp["weights"])
    return model


def train_steps(rank, device, inp):
    """The FluentSpeech step on a (data, model) mesh of ``inp["tp"]`` model
    ranks, one step a global batch of ``inp["batches"]`` (padded to the data
    axis, this rank's rows) with its injected global draws; each step's
    metrics, the full gradients after the last step (summed over the data
    group), whether this rank's own loss and gradients were finite, and the
    state (rank 0)."""
    return _steps(rank, inp)


def step_cases(rank, device, inp):
    """:func:`train_steps` for each of ``inp["cases"]``, each from the
    weights given."""
    return {"cases": [_steps(rank, dict(inp, **case)) for case in inp["cases"]]}


def _steps(rank, inp):
    from speech_editing_tpu_torch.training.tasks.spec_denoiser import make_loss_fn
    from speech_editing_tpu_torch.training.train_state import TrainStep

    tp = inp.get("tp", 1)
    mesh = make_tp_mesh(dist.get_world_size(), tp)
    model = _gaussian_diffusion(inp)
    specs = param_partition_specs(model, tp, inp.get("min_size", 2048)) if tp > 1 else None
    step = TrainStep(model, inp["hp"], make_loss_fn(model, inp["hp"], inp["sil"], train=False),
                     mesh, specs)
    metrics, rows = [], []
    for batch, (t, noise) in zip(inp["batches"], inp["draws"]):
        local = shard_batch(pad_batch_to_multiple(batch, mesh.data_size), mesh)
        local = {k: torch.as_tensor(v) for k, v in local.items()}
        rows.append(int(local["txt_tokens"].shape[0]))
        metrics.append({k: float(v) for k, v in step(local, t=t, noise=noise).items()})
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    state = step.state_dict()
    split = {n: tuple(step.opt_params[i].shape) for i, n in
             enumerate(n for n, _ in model.named_parameters()) if i in step.split}
    return {"metrics": metrics, "grads": grads, "rows": rows, "split": split,
            "state": state if rank == 0 else None,
            "finite": all(np.isfinite(v) for m in metrics for v in m.values())
            and all(bool(torch.isfinite(g).all()) for g in grads.values())}


def tp_round_trip(rank, device, inp):
    """A full state loaded into a tensor-parallel step: this rank's slices
    of the parameters and moments, and the state it gathers back."""
    from speech_editing_tpu_torch.training.tasks.spec_denoiser import make_loss_fn
    from speech_editing_tpu_torch.training.train_state import TrainStep

    mesh = make_tp_mesh(dist.get_world_size(), 2)
    model = _gaussian_diffusion(inp)
    specs = param_partition_specs(model, 2, inp["min_size"])
    step = TrainStep(model, inp["hp"], make_loss_fn(model, inp["hp"], inp["sil"]), mesh, specs)
    step.load_state_dict(inp["state"])
    names = [n for n, _ in model.named_parameters()]
    slices = {names[i]: (step.opt_params[i].detach().clone(),
                         step.optimizer.state[step.opt_params[i]]["exp_avg"].clone())
              for i in step.split}
    dims = {n: split_dim(s) for n, s in specs.items()}
    sharded = shard_params(dict(model.named_parameters()), mesh, specs)
    return {"slices": slices, "state": step.state_dict(), "model_axis": mesh.index(MODEL_AXIS),
            "dims": dims, "shard_params": {n: sharded[n] for n in slices},
            "to_host_local": to_host_local({n: p for n, (p, _) in slices.items()}, mesh, dims)}


def run_entry(rank, device, inp):
    """``speech_editing_tpu_torch.run`` with ``inp["argv"]``, joining the
    job from torchrun's environment; what the rank printed, its step, its
    mesh and its model's weights."""
    from speech_editing_tpu_torch.run import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer = run(inp["argv"])
    return {"out": out.getvalue(), "step": trainer.global_step, "mesh": str(trainer.mesh),
            "model": trainer.model.state_dict(), "joined": trainer.mesh.size}


# -- helpers of the tests that run the training entry on two ranks ---------------

def write_sd_config(d):
    """A tiny FluentSpeech config over ``egs/spec_denoiser.yaml`` and a
    synthetic corpus in ``d``, predictor dropout on; its path."""
    from speech_editing_tpu_torch.config.hparams import dump_yaml
    from tests.helpers import TINY_HP, VOCAB, write_synth_corpus

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    write_synth_corpus(str(d / "data"), np.random.RandomState(0), n_items=8)
    phones = ["|", ",", "sil"] + [f"P{i}" for i in range(VOCAB - 6)]
    (d / "data" / "phone_set.json").write_text(json.dumps(phones))
    cfg = dict(TINY_HP, base_config=os.path.join(repo, "egs", "spec_denoiser.yaml"),
               binary_data_dir=str(d / "data"), decoder_type="fft", residual_channels=16,
               max_updates=4, val_check_interval=2, num_sanity_val_steps=1,
               eval_max_batches=2, tb_log_interval=1, max_sentences=4, ds_workers=0,
               num_ckpt_keep=2, num_valid_plots=0, predictor_dropout=0.2, use_bf16=False)
    (d / "tiny.yaml").write_text(dump_yaml(cfg))
    return str(d / "tiny.yaml")


def single_and_two_ranks(argv, work_single, work_multi):
    """``run`` in this process into ``work_single``, then on two ranks under
    torchrun's environment into ``work_multi``: (the trainer, the ranks'
    results)."""
    from speech_editing_tpu_torch.parallel.dryrun import spawn_ranks
    from speech_editing_tpu_torch.run import run

    single = run(argv + ["--exp_name", work_single])
    got = spawn_ranks(run_entry, 2, {"argv": argv + ["--exp_name", work_multi]}, init=False)
    return single, got


def assert_same_checkpoint(work_a, work_b, tol=1e-5):
    """The last checkpoints of two work dirs hold the same steps, weights
    and optimizer moments, within ``tol``."""
    from speech_editing_tpu_torch.training.checkpoint import get_last_checkpoint, load_checkpoint

    (pa, sa), (pb, sb) = get_last_checkpoint(work_a), get_last_checkpoint(work_b)
    assert sa == sb and pa is not None
    a, b = load_checkpoint(pa)["state"], load_checkpoint(pb)["state"]
    assert sorted(a) == sorted(b)
    for part in a:
        if isinstance(a[part], dict) and "state" in a[part]:       # an optimizer
            for i, st in a[part]["state"].items():
                for k in ("exp_avg", "exp_avg_sq"):
                    torch.testing.assert_close(b[part]["state"][i][k], st[k], atol=tol, rtol=tol)
        elif isinstance(a[part], dict):                              # a state_dict
            for k, v in a[part].items():
                torch.testing.assert_close(b[part][k], v, atol=tol, rtol=tol, msg=k)
        else:
            assert a[part] == b[part], part


def assert_rank0_alone_logs(got, work):
    """Both ranks joined; rank 0 printed the steps and validations and kept
    the one terminal log; rank 1 printed nothing."""
    assert got[0]["joined"] == got[1]["joined"] == 2
    assert "| step " in got[0]["out"] and "| validation @ step" in got[0]["out"]
    assert got[1]["out"] == "", got[1]["out"]
    assert len(os.listdir(os.path.join(work, "terminal_logs"))) == 1


def serve_rows(rank, device, inp):
    """``parallel.dryrun.dp_serve`` of ``inp``'s FluentSpeech and HiFi-GAN
    weights on this rank's rows: the gathered (mel, wav)."""
    from speech_editing_tpu_torch.models.vocoder.hifigan import HifiGanGenerator
    from speech_editing_tpu_torch.parallel.dryrun import dp_serve

    model = _gaussian_diffusion(inp).eval()
    vocoder = HifiGanGenerator(inp["vocoder_hp"])
    vocoder.load_state_dict(inp["vocoder_weights"])
    batch = {k: torch.as_tensor(v) for k, v in inp["batch"].items()}
    mel, wav = dp_serve(make_mesh(), model, vocoder.eval(), batch, inp["noise"])
    return {"mel": mel, "wav": wav, "rows": int(batch["txt_tokens"].shape[0]) // 2}
