"""Python scalars applied as the JAX package's weak typing applies them,
and layers applied as flax promotes their inputs and parameters.

JAX rounds a Python scalar to the dtype of the array it meets before the
operation (``math.sqrt(192) * x`` multiplies a bf16 ``x`` by 13.875, not by
13.8564); torch multiplies in float32 by the scalar as given. Under
``use_bf16`` the port's modules pass such scalars through :func:`weak`.
A flax layer given a float32 input computes in float32 with its bf16
parameters promoted; a torch layer refuses the mix: :func:`promoted`
applies a module the flax way.
"""

from __future__ import annotations

import functools

import torch
from torch.func import functional_call


@functools.lru_cache(maxsize=256)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def weak(value: float, like: torch.Tensor) -> float:
    """``value`` rounded to ``like``'s dtype where that is narrower than
    float32 (bf16, fp16); as it is otherwise."""
    if like.dtype in (torch.bfloat16, torch.float16):
        return _rounded(float(value), like.dtype)
    return value


def _low(x: torch.Tensor) -> bool:
    return x.dtype in (torch.bfloat16, torch.float16)


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 where its dtype is narrower (bf16, fp16), as JAX's
    ``preferred_element_type=jnp.float32`` takes a product's operands (their
    products are exact in float32); as it is otherwise."""
    return x.float() if _low(x) else x


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU. In bf16 composed as ``jax.nn.gelu(approximate=False)``
    composes it, ``0.5 x erfc(-x sqrt(0.5))``, each op rounded to bf16;
    in float32 ``F.gelu``."""
    if not _low(x):
        return torch.nn.functional.gelu(x)
    return (0.5 * x) * torch.erfc(-x * weak(0.5 ** 0.5, x))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x). In bf16 composed as ``jnp.logaddexp(x, 0)`` composes
    it, ``max(x, 0) + log1p(exp(-|x|))``, each op rounded to bf16; in
    float32 ``F.softplus``."""
    if not _low(x):
        return torch.nn.functional.softplus(x)
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def mish(x: torch.Tensor) -> torch.Tensor:
    """x tanh(softplus(x)), in bf16 as the JAX DiffNet composes it; in
    float32 ``F.mish``."""
    if not _low(x):
        return torch.nn.functional.mish(x)
    return x * torch.tanh(softplus(x))


class Softplus(torch.nn.Module):
    """:func:`softplus` as a module (in place of ``nn.Softplus``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return softplus(x)


class Mish(torch.nn.Module):
    """:func:`mish` as a module (in place of ``nn.Mish``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mish(x)


def promoted(module: torch.nn.Module, *args, **kwargs):
    """``module(*args, **kwargs)`` in the widest floating dtype among its
    tensor arguments and parameters, both cast to it, as flax's
    ``promote_dtype`` applies a layer: bf16 weights that meet a float32
    input compute in float32 (their gradients return through the casts). A
    plain call where everything already has that dtype."""
    tensors = [t for t in (*args, *kwargs.values(), *module.parameters())
               if torch.is_tensor(t) and t.is_floating_point()]
    if len({t.dtype for t in tensors}) <= 1:
        return module(*args, **kwargs)
    wide = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    cast = lambda t: t.to(wide) if torch.is_tensor(t) and t.is_floating_point() else t
    params = {name: cast(p) for name, p in module.named_parameters()}
    return functional_call(module, params, tuple(cast(a) for a in args),
                           {k: cast(v) for k, v in kwargs.items()})
