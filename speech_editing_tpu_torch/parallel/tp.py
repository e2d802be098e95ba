"""Tensor parallelism over a 2-D (data, model) mesh: the counterpart of the
JAX package's ``parallel/tp.py``.

The partition rule is JAX's size heuristic, decided in the flax layout of
each parameter, so that the same parameters are split along the same
logical axis as there: a kernel of at least ``min_size`` elements whose
name does not match ``_REPLICATE_RE`` is split along its last (output)
axis, else the one before, else the first that divides, where that axis
divides by the model axis's size and holds at least two rows a rank.
Biases and norms stay whole. ``param_partition_specs`` maps each flax
axis onto the torch tensor through the layouts that
``utils/convert_jax_params.py`` converts between (a ``Linear`` weight is
the flax ``Dense`` kernel transposed, a ``Conv1d`` weight ``[out, in, k]``
the flax ``[k, in, out]``, the packed attention projections the flax
``[E, h, d]`` and ``[h, d, E]`` kernels, an LSTM's or GRU's stacked gates
one flax ``[in, H]`` kernel a gate) and returns the spec in the torch
layout: a tuple with ``MODEL_AXIS`` at the split dim, or ``()``.

Execution keeps the math of the single-device step, as GSPMD does: each
model rank keeps its slice of every split parameter and of its Adam
moments (``shard_params``); after each update the slices are all-gathered
over the model group into the full parameters that the modules (and the
hand-written kernels) run with, and each rank's slice of the gradient is
cut from the full gradient (``training/train_state.py``). Splitting the
products themselves over the model axis is not done here.

Enable with ``tp_size: N`` (a divisor of the world size); the trainer
builds the mesh as ``{"data": world // N, "model": N}``.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch
from torch import nn

from speech_editing_tpu_torch.modules.conformer import Pointwise
from speech_editing_tpu_torch.modules.transformer import MultiheadAttention
from speech_editing_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, gather_axis, make_mesh

MODEL_AXIS = "model"

# parameters matching these name fragments are never split (small / 1-D /
# shape-sensitive)
_REPLICATE_RE = re.compile(r"(bias|scale|gamma|beta|_g$|logdet|actnorm)", re.IGNORECASE)


def _spec_for(path: str, shape: tuple, tp: int, min_size: int = 2048) -> tuple:
    """JAX's rule on one flax-layout shape: ``()`` or a tuple with
    ``MODEL_AXIS`` at the split axis."""
    if tp <= 1 or len(shape) < 2 or int(np.prod(shape)) < min_size \
            or _REPLICATE_RE.search(path):
        return ()
    # axis preference: last (out features), then second-to-last (in), then rest
    for ax in [len(shape) - 1, len(shape) - 2] + list(range(len(shape) - 2)):
        if shape[ax] % tp == 0 and shape[ax] >= 2 * tp:
            spec = [None] * len(shape)
            spec[ax] = MODEL_AXIS
            return tuple(spec)
    return ()


def flax_layouts(model: nn.Module) -> dict:
    """{parameter name: (flax shape, torch dim of each flax axis)} in the
    layouts ``convert_jax_params`` converts between; a parameter of a kind
    that map does not name keeps its torch layout."""
    out = {}
    heads_of_out_proj = {id(m.out_proj): m.num_heads for m in model.modules()
                         if isinstance(m, MultiheadAttention)}
    for prefix, mod in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        for name, p in mod.named_parameters(recurse=False):
            full, s = pre + name, tuple(p.shape)
            if p.ndim < 2:
                out[full] = (s, tuple(range(p.ndim)))
            elif isinstance(mod, MultiheadAttention):    # packed q/k/v [3E, E]: [E, h, d] each
                h = mod.num_heads
                out[full] = ((s[1], h, s[1] // h), (1, 0, 0))
            elif id(mod) in heads_of_out_proj:           # [E, E]: flax [h, d, E]
                h = heads_of_out_proj[id(mod)]
                out[full] = ((h, s[1] // h, s[0]), (1, 1, 0))
            elif isinstance(mod, nn.Linear) and name == "weight":
                out[full] = ((s[1], s[0]), (1, 0))
            elif isinstance(mod, Pointwise):             # a flax Dense held as [out, in, 1]
                out[full] = ((s[1], s[0]), (1, 0))
            elif isinstance(mod, nn.Conv1d) and name == "weight":
                out[full] = ((s[2], s[1], s[0]), (2, 1, 0))
            elif isinstance(mod, nn.Conv2d) and name == "weight":
                out[full] = ((s[2], s[3], s[1], s[0]), (2, 3, 1, 0))
            elif isinstance(mod, nn.ConvTranspose1d) and name == "weight":
                out[full] = ((s[2], s[0], s[1]), (2, 0, 1))
            elif isinstance(mod, (nn.LSTM, nn.GRU)) and name.startswith("weight_"):
                gates = 4 if isinstance(mod, nn.LSTM) else 3
                out[full] = ((s[1], s[0] // gates), (1, 0))
            else:                                        # Embedding and the rest
                out[full] = (s, tuple(range(p.ndim)))
    return out


def param_partition_specs(model: nn.Module, tp: int, min_size: int = 2048) -> dict:
    """{parameter name: spec in the torch layout} (see the module doc)."""
    specs = {}
    for name, (shape, dims) in flax_layouts(model).items():
        flax_spec = _spec_for(name, shape, tp, min_size)
        spec = [None] * len(model.get_parameter(name).shape)
        for ax, a in enumerate(flax_spec):
            if a is not None:
                spec[dims[ax]] = a
        specs[name] = tuple(spec) if flax_spec else ()
    return specs


def split_dim(spec: tuple) -> Optional[int]:
    """The torch dim a spec splits, or None."""
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def make_tp_mesh(n: Optional[int] = None, tp: int = 1) -> Mesh:
    """The (data, model) mesh; ``tp`` must divide the ``n`` ranks. The model
    axis is innermost, so a model group is ``tp`` neighbouring ranks."""
    n = torch.distributed.get_world_size() if n is None and \
        torch.distributed.is_initialized() else (1 if n is None else n)
    if n % tp:
        raise ValueError(f"tp={tp} must divide the world size {n}")
    return make_mesh(n, {DATA_AXIS: n // tp, MODEL_AXIS: tp})


def shard(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This model rank's slice of ``x`` under ``spec`` (``x`` if whole)."""
    dim = split_dim(spec)
    n = mesh.axis_size(MODEL_AXIS)
    if dim is None or n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.index(MODEL_AXIS) * size, size)


def shard_params(params: dict, mesh: Mesh, specs: dict) -> dict:
    """{name: this model rank's slice, a copy} of a {name: tensor} dict."""
    return {k: shard(v.detach(), specs.get(k, ()), mesh).clone() for k, v in params.items()}


def gather(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every model rank's slice (an all-gather)."""
    dim = split_dim(spec)
    return x if dim is None else gather_axis(x, dim, mesh, MODEL_AXIS)


def sharded_share(model: nn.Module, specs: dict) -> float:
    """The share of the model's parameter elements that are split."""
    total = split = 0
    for name, p in model.named_parameters():
        total += p.numel()
        split += p.numel() if split_dim(specs.get(name, ())) is not None else 0
    return split / max(total, 1)
