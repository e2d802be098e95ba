"""Kernel K1: the DiffNet gated residual block, forward (``csrc/diffnet_block.cu``).

Replaces the forward of
``speech_editing_tpu/ops/pallas/diffnet_block.py::fused_diffnet_block``
(``_fwd_call``). Unlike the Pallas kernel it takes the ``[B, T]``
nonpadding mask (multiplied into ``x + step`` before the conv) and any
dilation, so the default masked path of the denoiser runs through it; it
does not write the pre-activation ``h``, which only a backward pass needs.
The source note in the ``.cu`` file gives the bound and the design.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from speech_editing_tpu_torch.ops.cuda.build import (check_status, check_tensor,
                                                     current_stream,
                                                     kernel_function, ptr)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 12 + [_I] * 5 + [_P]


def diffnet_block_plain(x, cond, step, mask, wd, bd, wc, bc, wo, bo,
                        dilation: int = 1):
    """Plain PyTorch version of K1 (same arguments, same results)."""
    c = x.shape[-1]
    y = x + step[:, None, :]
    if mask is not None:
        y = y * mask[:, :, None]
    t, d = x.shape[1], dilation
    y_prev = F.pad(y, (0, 0, d, 0))[:, :t]   # y[t - d], zero before the start
    y_next = F.pad(y, (0, 0, 0, d))[:, d:]   # y[t + d], zero past the end
    h = torch.cat([y_prev, y, y_next], dim=-1) @ wd + bd + (cond @ wc + bc)
    g = torch.sigmoid(h[..., :c]) * torch.tanh(h[..., c:])
    o = g @ wo + bo
    return (x + o[..., :c]) / math.sqrt(2.0), o[..., c:]


def diffnet_block(x, cond, step, mask, wd, bd, wc, bc, wo, bo,
                  dilation: int = 1):
    """x [B,T,C]; cond [B,T,H]; step [B,C]; mask [B,T] nonpadding or None;
    wd [3C,2C]; wc [H,2C]; wo [C,2C]; biases [2C] -> (x' [B,T,C], skip [B,T,C]).

    A CPU tensor takes the plain version; a CUDA tensor launches K1."""
    if x.device.type == "cpu":
        return diffnet_block_plain(x, cond, step, mask, wd, bd, wc, bc, wo, bo,
                                   dilation)
    if x.device.type != "cuda":
        raise ValueError(f"diffnet_block: unsupported device {x.device}")
    b, t, c = x.shape
    h = cond.shape[-1]
    if c % 32 or c > 1024 or h % 4 or dilation < 1:
        raise ValueError(f"diffnet_block: unsupported C={c}, H={h}, "
                         f"dilation={dilation}")
    dev = x.device
    for name, tensor, shape in (
            ("x", x, (b, t, c)), ("cond", cond, (b, t, h)), ("step", step, (b, c)),
            ("wd", wd, (3 * c, 2 * c)), ("bd", bd, (2 * c,)),
            ("wc", wc, (h, 2 * c)), ("bc", bc, (2 * c,)),
            ("wo", wo, (c, 2 * c)), ("bo", bo, (2 * c,))):
        check_tensor(tensor, name, shape, dev)
    if mask is not None:
        check_tensor(mask, "mask", (b, t), dev)
    xout = torch.empty_like(x)
    skip = torch.empty_like(x)
    fn = kernel_function("diffnet_block", "diffnet_block_fwd_f32", _ARGTYPES)
    check_status(fn(ptr(x), ptr(cond), ptr(step), ptr(mask), ptr(wd), ptr(bd),
                    ptr(wc), ptr(bc), ptr(wo), ptr(bo), ptr(xout), ptr(skip),
                    b, t, c, h, dilation, current_stream()), "diffnet_block")
    diffnet_block.launches += 1
    return xout, skip


diffnet_block.launches = 0
