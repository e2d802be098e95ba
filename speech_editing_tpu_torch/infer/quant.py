"""Weight-only int8 quantization for the serving programs: the port of the
JAX package's ``infer/quant.py``.

Every floating weight with two or more axes and at least ``min_size``
elements is stored as int8 with one float32 scale per output channel
(absmax symmetric); biases, norms and small tables stay exact. The device
programs dequantize the weights once per call (:func:`dequantized`) and run
on the float32 result, so only the quantization error changes the numbers.

The JAX package reduces over every axis of a flax kernel but the last.
Torch layouts put the output channel elsewhere, so each weight's
reduction follows its flax counterpart (``utils/convert_jax_params.py``):

* ``Conv1d`` ``[out, in, k]`` and ``Linear`` ``[out, in]``: per row;
* ``ConvTranspose1d`` ``[in, out, k]``: per axis 1;
* ``Embedding`` ``[V, D]`` (flax ``[V, D]`` too): per column;
* attention ``in_proj_weight`` ``[3E, E]``: three flax ``DenseGeneral``
  kernels ``[E, h, d]``, each with one scale per ``d`` shared across the
  heads, and each sized on its own against ``min_size``;
* ``LSTM`` ``weight_ih_l{n}`` ``[4H, in]`` and ``weight_hh_l{n}``
  ``[4H, H]``: four flax gate kernels ``[in, H]`` each, per row, each
  gate sized on its own;
* the conformer's ``pos_bias_u``/``pos_bias_v`` ``[h, d]`` (flax ``[h, d]``
  too) and CampNet's ``mask_emb`` ``[1, 1, M]``: per index of the last
  axis.

The int8 values and scales equal the JAX package's leaf for leaf: the same
float32 numpy arithmetic, run on the host.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, NamedTuple, Tuple, Union

import numpy as np
import torch
from torch import nn

from speech_editing_tpu_torch.models.campnet import CampNet
from speech_editing_tpu_torch.modules.conformer import RelPositionMultiHeadAttention
from speech_editing_tpu_torch.modules.transformer import MultiheadAttention


class QLeaf(NamedTuple):
    """One quantized weight: ``q8`` int8 and ``scale`` float32 in a view of
    the weight whose size-1 scale axes are the reduced ones; ``shape`` is
    the weight's own."""

    q8: torch.Tensor
    scale: torch.Tensor
    shape: Tuple[int, ...]


QState = Dict[str, Union[torch.Tensor, QLeaf]]


class ChannelView(NamedTuple):
    """How to see a torch weight as its flax kernels: reshape to ``view``,
    keep the ``keep`` axes (one scale per index), reduce over the rest;
    ``leaves`` flax kernels are packed in it (sized one by one)."""

    view: Tuple[int, ...]
    keep: Tuple[int, ...]
    leaves: int = 1


def channel_views(model: nn.Module) -> Dict[str, ChannelView]:
    """The :class:`ChannelView` of every weight of ``model`` that has two or
    more axes; raises on a module whose layout is not known here."""
    views: Dict[str, ChannelView] = {}
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        for p_name, p in mod.named_parameters(recurse=False):
            if p.ndim < 2:
                continue
            shape = tuple(p.shape)
            if isinstance(mod, (nn.Conv1d, nn.Linear)):
                view = ChannelView(shape, (0,))
            elif isinstance(mod, (nn.ConvTranspose1d, nn.Embedding)):
                view = ChannelView(shape, (1,))
            elif isinstance(mod, MultiheadAttention) and p_name == "in_proj_weight":
                e, h = mod.dim, mod.num_heads
                view = ChannelView((3, h, e // h, e), (0, 2), 3)
            elif isinstance(mod, nn.LSTM) and p_name.startswith("weight_"):
                view = ChannelView(shape, (0,), 4)
            elif ((isinstance(mod, RelPositionMultiHeadAttention) and p_name.startswith("pos_bias"))
                  or (isinstance(mod, CampNet) and p_name == "mask_emb")):
                view = ChannelView(shape, (len(shape) - 1,))
            else:
                raise NotImplementedError(f"quantize: no channel layout for "
                                          f"{prefix}{p_name} of {type(mod).__name__}")
            views[prefix + p_name] = view
    return views


def quantize(state_dict: Dict[str, torch.Tensor], views: Dict[str, ChannelView],
             min_size: int = 4096) -> QState:
    """Host side: the int8 form of every weight in ``views`` whose flax
    kernels hold ``min_size`` elements or more; the rest as they are (CPU
    tensors)."""
    out: QState = {}
    for name, tensor in state_dict.items():
        v = views.get(name)
        if (v is None or not tensor.is_floating_point()
                or tensor.numel() // v.leaves < min_size):
            out[name] = tensor.detach().cpu()
            continue
        arr = tensor.detach().cpu().numpy().astype(np.float32).reshape(v.view)
        red = tuple(i for i in range(arr.ndim) if i not in v.keep)
        absmax = np.abs(arr).max(axis=red, keepdims=True)
        scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        q8 = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
        out[name] = QLeaf(torch.from_numpy(q8), torch.from_numpy(scale), tuple(tensor.shape))
    return out


def dequantize(qstate: QState) -> Dict[str, torch.Tensor]:
    """float32 weights from ``qstate``, on the device its tensors are on."""
    return {name: (q.q8.to(torch.float32) * q.scale).reshape(q.shape)
            if isinstance(q, QLeaf) else q for name, q in qstate.items()}


def quantized_bytes(qstate: QState) -> int:
    """Bytes of the weights as ``qstate`` stores them (scales counted at 4
    bytes each)."""
    return sum(q.q8.numel() + q.scale.numel() * 4 if isinstance(q, QLeaf)
               else q.numel() * q.element_size() for q in qstate.values())


def max_quant_error(state_dict: Dict[str, torch.Tensor], qstate: QState) -> float:
    """The largest ``|w - dequantize(quantize(w))|`` over the quantized
    weights (host, numpy)."""
    err = 0.0
    for name, q in qstate.items():
        if isinstance(q, QLeaf):
            deq = (q.q8.numpy().astype(np.float32) * q.scale.numpy()).reshape(q.shape)
            w = state_dict[name].detach().cpu().numpy().astype(np.float32)
            err = max(err, float(np.abs(w - deq).max()))
    return err


class QuantizedWeights:
    """``model``'s weights in int8 on ``device``: the float copies of the
    quantized ones are dropped from the model, which runs only inside
    :meth:`dequantized`. One lock serializes the programs that share the
    model, as the dequantized weights are swapped into it."""

    def __init__(self, model: nn.Module, min_size: int, device):
        sd = model.state_dict()
        qstate = quantize(sd, channel_views(model), min_size)
        self.max_err = max_quant_error(sd, qstate)
        self.f32_bytes = sum(t.numel() * t.element_size() for t in sd.values())
        self.qstate = {n: QLeaf(q.q8.to(device), q.scale.to(device), q.shape)
                       for n, q in qstate.items() if isinstance(q, QLeaf)}
        self.bytes = quantized_bytes(qstate)
        self.model = model
        self._slots = [(model.get_submodule(n.rpartition(".")[0]), n.rpartition(".")[2])
                       for n in self.qstate]
        # an LSTM keeps its own list of its weights (cuDNN's), refreshed here
        self._rnns = {mod for mod, _ in self._slots if isinstance(mod, nn.RNNBase)}
        self._set(None)
        self._lock = threading.Lock()

    def _set(self, weights) -> None:
        for i, (mod, p) in enumerate(self._slots):
            mod._parameters[p] = None if weights is None else weights[i]
        for rnn in self._rnns:
            rnn._init_flat_weights()

    @contextlib.contextmanager
    def dequantized(self):
        """The model with float32 weights dequantized for this call."""
        with self._lock:
            self._set(list(dequantize(self.qstate).values()))
            try:
                yield self.model
            finally:
                self._set(None)


def maybe_quantized(hp, model: nn.Module, device, who: str):
    """``hp["serve_quant_int8"]``: ``model``'s :class:`QuantizedWeights`
    (printing the largest quantization error), else None."""
    if not hp.get("serve_quant_int8"):
        return None
    q = QuantizedWeights(model, int(hp.get("quant_min_size", 4096)), device)
    print(f"| int8 weight-only serving ({who}): max quant err {q.max_err:.2e}, "
          f"{q.bytes} bytes from {q.f32_bytes}", flush=True)
    return q


def weights(q) -> contextlib.AbstractContextManager:
    """``q.dequantized()``, or nothing to do when ``q`` is None."""
    return contextlib.nullcontext() if q is None else q.dequantized()
