"""Training checkpoints: ``<work_dir>/model_ckpt_steps_{N}.ckpt``.

The port's checkpoint is a ``torch.save`` of ``{"state":
TrainStep.state_dict() (or a GAN step's: both nets and both optimizers,
the generator under ``model``), "steps", "epoch", "val_loss"}``, written to a
temporary file and renamed into place; the ``num_ckpt_keep`` newest are
kept, and with ``save_best`` a checkpoint whose ``val_loss`` beats the one
in ``model_ckpt_best.pt`` replaces it, as in the JAX package's
``training/checkpoint.py``. In a job of several ranks every rank calls
``save_checkpoint`` (its state gathered first, a collective under tensor
parallelism) and rank 0 alone writes.

The JAX package's checkpoints (a pickled flax ``TrainState`` and optax
states of numpy arrays) load too, their parameters and the adamw chain's
state (Adam's count and moments, the schedule's count): a restricted
unpickler maps every JAX, flax, optax and JAX-package class to a plain
stand-in, so loading one imports none of them.
"""

from __future__ import annotations

import glob
import os
import pickle
import re
import zipfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from speech_editing_tpu_torch.parallel.mesh import is_main

_STEPS = re.compile(r".*steps_(\d+)\.ckpt")


def get_all_ckpts(work_dir: str) -> list[str]:
    """The work dir's checkpoints, newest (most steps) first."""
    return sorted(glob.glob(os.path.join(work_dir, "model_ckpt_steps_*.ckpt")),
                  key=lambda p: -int(_STEPS.findall(p)[0]))


def get_last_checkpoint(work_dir: str) -> Tuple[Optional[str], int]:
    ckpts = get_all_ckpts(work_dir)
    if not ckpts:
        return None, 0
    return ckpts[0], int(_STEPS.findall(ckpts[0])[0])


def _write(path: str, payload: dict) -> None:
    tmp = path + ".part"
    torch.save(payload, tmp)
    os.replace(tmp, path)   # a crash mid-write leaves the previous file whole


def save_checkpoint(work_dir: str, state: dict, steps: int, epoch: int = 0,
                    val_loss: Optional[float] = None, num_ckpt_keep: int = 3,
                    save_best: bool = False) -> str:
    """Write ``state`` (``TrainStep.state_dict()``) at ``steps``, on rank 0
    alone; returns the checkpoint's path."""
    path = os.path.join(work_dir, f"model_ckpt_steps_{steps}.ckpt")
    if not is_main():
        return path
    os.makedirs(work_dir, exist_ok=True)
    payload = {"state": state, "steps": int(steps), "epoch": int(epoch),
               "val_loss": None if val_loss is None else float(val_loss)}
    _write(path, payload)
    for old in get_all_ckpts(work_dir)[num_ckpt_keep:]:
        os.remove(old)
    if save_best and val_loss is not None:
        best_path = os.path.join(work_dir, "model_ckpt_best.pt")
        best = np.inf
        if os.path.exists(best_path):
            stored = load_checkpoint(best_path)["val_loss"]
            best = np.inf if stored is None else stored
        if val_loss < best:
            _write(best_path, payload)
    return path


class _StandIn:
    """A JAX, flax or optax object as pickle rebuilds it: the arguments of
    its constructor in ``args`` and its pickled state in ``__dict__``."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {"state": state})


_FOREIGN = ("jax", "jaxlib", "flax", "optax", "speech_editing_tpu")
_NUMPY = {("numpy", "ndarray"), ("numpy", "dtype"),
          ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
          ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar")}


class _JaxCheckpointUnpickler(pickle.Unpickler):
    """Builds numpy arrays and containers; every class of the JAX stack
    becomes a :class:`_StandIn`; any other class refuses to load."""

    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _FOREIGN:
            return type(name, (_StandIn,), {"__module__": module})
        if (module, name) in _NUMPY:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"a JAX checkpoint does not hold {module}.{name}")


def _plain_tree(node: Any) -> Any:
    """A parameter tree of dicts and numpy arrays (a flax ``FrozenDict``
    stand-in becomes the dict it wraps)."""
    if isinstance(node, _StandIn) and len(node.args) == 1 and isinstance(node.args[0], dict):
        node = node.args[0]
    if isinstance(node, dict):
        return {k: _plain_tree(v) for k, v in node.items()}
    if isinstance(node, np.ndarray):
        return node
    raise TypeError(f"unexpected {type(node).__name__} in a JAX parameter tree")


def _optax_states(node: Any, found: dict) -> None:
    """Every optax state stand-in in ``node`` (an optimizer state: nested
    tuples of states), by class name. The chain's layout depends on the
    clip transforms before adamw, so the states are found by name."""
    if isinstance(node, _StandIn):
        found.setdefault(type(node).__name__, []).append(node)
        children = node.args
    elif isinstance(node, (tuple, list)):
        children = node
    else:
        return
    for child in children:
        _optax_states(child, found)


def _adam_state(opt_state: Any) -> Optional[dict]:
    """``{"count", "mu", "nu", "schedule_count"}`` of the adamw chain of
    ``build_optimizer`` (``ScaleByAdamState`` and, for a scheduled lr,
    ``ScaleByScheduleState``), or None where there is no Adam state."""
    found: dict = {}
    _optax_states(opt_state, found)
    adam, sched = found.get("ScaleByAdamState", []), found.get("ScaleByScheduleState", [])
    if not adam:
        return None
    if len(adam) > 1 or len(sched) > 1:
        raise ValueError(f"a JAX optimizer state with {len(adam)} Adam and {len(sched)} "
                         "schedule states")
    count, mu, nu = adam[0].args
    return {"count": int(np.asarray(count)), "mu": _plain_tree(mu), "nu": _plain_tree(nu),
            "schedule_count": int(np.asarray(sched[0].args[0])) if sched else None}


def load_jax_checkpoint(path: str) -> dict:
    """A JAX package checkpoint -> ``{"jax_params": numpy tree, "jax_adam":
    see :func:`_adam_state` (None where the state holds none), "steps",
    "epoch", "val_loss"}``, without importing JAX. A HiFi-GAN checkpoint
    gives its generator's parameters: a ``GanTrainState`` keeps them in its
    ``gen_params`` field (its ``params`` is a property, which pickle does
    not keep), and a plain ``{"gen", "disc"}`` tree under ``gen``, as the
    JAX package's vocoder reads them. A ``GanTrainState`` also gives
    ``jax_disc_params`` and both optimizers' Adam states, ``jax_gen_adam``
    and ``jax_disc_adam``."""
    with open(path, "rb") as f:
        payload = _JaxCheckpointUnpickler(f).load()
    state = payload["state"]
    fields = state if isinstance(state, dict) else state.__dict__
    params = _plain_tree(fields["gen_params"] if "gen_params" in fields else fields["params"])
    if "gen" in params and "disc" in params:
        params = params["gen"]
    out = {"jax_params": params, "jax_adam": _adam_state(fields.get("opt_state")),
           "steps": int(payload["steps"]), "epoch": int(payload.get("epoch", 0)),
           "val_loss": payload.get("val_loss")}
    if "gen_params" in fields:
        out.update(jax_disc_params=_plain_tree(fields["disc_params"]),
                   jax_gen_adam=_adam_state(fields["gen_opt"]),
                   jax_disc_adam=_adam_state(fields["disc_opt"]))
    return out


def load_checkpoint(path: str, map_location: Any = "cpu") -> dict:
    """A port checkpoint (its tensors onto ``map_location``) or a JAX
    package checkpoint (see :func:`load_jax_checkpoint`)."""
    if zipfile.is_zipfile(path):
        return torch.load(path, map_location=map_location, weights_only=True)
    return load_jax_checkpoint(path)


def load_subtree(path: str, prefix: str) -> dict:
    """One sub-model of a checkpoint, for a warm start: from a port
    checkpoint the model's tensors under ``prefix`` (e.g. ``fs.encoder``),
    the prefix and its dot stripped; from a JAX checkpoint the parameter
    subtree at the same path (``fs/encoder``), numpy leaves in the flax
    layout, for the caller to convert. A missing path raises ``KeyError``."""
    payload = load_checkpoint(path)
    if "jax_params" in payload:
        node = payload["jax_params"]
        for part in prefix.split("."):
            if not isinstance(node, dict) or part not in node:
                raise KeyError(f"{path}: the JAX checkpoint has no {prefix.replace('.', '/')}")
            node = node[part]
        return node
    head = prefix + "."
    sub = {k[len(head):]: v for k, v in payload["state"]["model"].items()
           if k.startswith(head)}
    if not sub:
        raise KeyError(f"{path}: the checkpoint has no {prefix}.* tensors")
    return sub
