"""Seeded weights, made on the device in one draw, handed to the program and
to the reference alike.

``seeded_state_dict(module, seed, device, rules)`` reads the names and shapes
of ``module``'s parameters (the reference module, built on the ``meta``
device: its names are the program's), draws every value in one
``torch.randn`` call from a ``torch.Generator`` on ``device`` seeded by
``seed``, and scales each tensor: a weight of a convolution or a linear
layer by ``gain / sqrt(fan_in)`` (a transposed convolution's fan-in is
``in_channels * kernel / stride``), an embedding by ``gain``, a norm's
weight (and any other one-number-a-channel parameter) to ``1 + 0.1 noise``
and a bias to ``0.02 noise``; a parameter of no layer (a packed attention
projection, a learned embedding) as a weight of its trailing dimensions. ``rules`` maps a
name's prefix to a gain, or a bias's name to its constant value (``{"set":
v}``), and names the prefixes of a model whose trained scale a random draw
would not give (HiFi-GAN's residual stacks, the duration head's offset).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _fans(module: nn.Module) -> dict:
    """{parameter name: (kind, fan_in)} of every weight."""
    out = {}
    for prefix, m in module.named_modules():
        name = f"{prefix}.weight" if prefix else "weight"
        if isinstance(m, nn.ConvTranspose1d):
            out[name] = ("w", m.in_channels * m.kernel_size[0] / m.stride[0])
        elif isinstance(m, nn.Conv1d):
            out[name] = ("w", m.in_channels * m.kernel_size[0])
        elif isinstance(m, nn.Linear):
            out[name] = ("w", m.in_features)
        elif isinstance(m, nn.Embedding):
            out[name] = ("e", 1)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            out[name] = ("n", 1)
    for name, p in module.named_parameters():     # parameters of no layer above
        if name not in out and not name.endswith("bias"):
            out[name] = ("w", math.prod(p.shape[1:])) if p.dim() >= 2 else ("n", 1)
    return out


def _rule(rules: dict, name: str):
    best = None
    for prefix, value in rules.items():
        if name.startswith(prefix) and (best is None or len(prefix) > len(best[0])):
            best = (prefix, value)
    return None if best is None else best[1]


def seeded_state_dict(module: nn.Module, seed: int, device, rules: dict | None = None) -> dict:
    rules = rules or {}
    names = [(n, tuple(p.shape)) for n, p in module.named_parameters()]
    sizes = [math.prod(s) for _, s in names]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    fans = _fans(module)
    out, at = {}, 0
    for (name, shape), n in zip(names, sizes):
        z = flat[at:at + n].view(shape)
        at += n
        rule = _rule(rules, name)
        if isinstance(rule, dict):
            out[name] = torch.full(shape, float(rule["set"]), device=device)
            continue
        gain = 1.0 if rule is None else float(rule)
        kind, fan = fans.get(name, ("b", 1))
        if kind == "w":
            out[name] = z * (gain / math.sqrt(fan))
        elif kind == "e":
            out[name] = z * gain
        elif kind == "n":
            out[name] = 1.0 + 0.1 * z
        else:
            out[name] = 0.02 * gain * z
    return out
