"""Kernels K1 and K5: the DiffNet gated residual block, forward
(``csrc/diffnet_block.cu``) and backward (``csrc/diffnet_block_bwd.cu``).

Replace ``speech_editing_tpu/ops/pallas/diffnet_block.py::fused_diffnet_block``:
its forward (``_fwd_call``) and backward (``_bwd_call``). Unlike the Pallas
kernels both take the ``[B, T]`` nonpadding mask (multiplied into ``x +
step`` before the conv) and any dilation, so the default masked path of the
denoiser runs through them. K1 writes the pre-activation ``h`` only when a
gradient is needed. :class:`DiffNetBlockFunction` ties the two together as
``_vjp_fwd``/``_vjp_bwd`` do; its weight, bias, cond and step gradients are
plain products, as the JAX package leaves them to XLA. Both kernels run
their products on the tensor cores as 3xTF32 (float32 accuracy,
``csrc/tf32x3.cuh``); :func:`_tile_plan` picks their rows per CTA and K1's
cluster split from B·T. The source notes in the ``.cu`` files give each
kernel's bound and design.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from speech_editing_tpu_torch.ops.cuda.build import (check_status, check_tensor,
                                                     current_stream,
                                                     kernel_function, ptr)

RSQRT2 = 1.0 / math.sqrt(2.0)
_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [_P] * 13 + [_I] * 7 + [_P]
_BWD_ARGTYPES = [_P] * 9 + [_I] * 5 + [_P]
_C, _H = 256, 192             # the widths the kernels are compiled for (csrc C, H)
_MIN_GRID = 128               # CTAs that fill the H100's 132 SMs


@functools.cache
def _fits64(name: str, dilation: int) -> bool:
    """Whether 64-row tiles of K1 (``name`` "diffnet_block") or K5
    ("diffnet_block_bwd") fit in a block's shared memory on the card at this
    dilation, as the kernel's own library counts it."""
    symbol = "diffnet_block_fwd_fits" if name == "diffnet_block" else "diffnet_block_bwd_fits"
    return bool(kernel_function(name, symbol, [_I, _I])(64, dilation))


def _tile_plan(b: int, t: int, fits64: bool = True) -> tuple[int, int]:
    """(rows per CTA, CTAs per cluster) of K1 and K5 at [B, T].

    64-row tiles where they alone give ``_MIN_GRID`` CTAs and ``fits64``
    (they fit in shared memory); else 16-row tiles, and K1 splits the gate
    columns over a cluster of 2, then 4 CTAs until the grid reaches
    ``_MIN_GRID`` (4 where even that falls short). K5 takes the rows and no
    cluster."""
    if fits64 and b * -(-t // 64) >= _MIN_GRID:
        return 64, 1
    tiles, cluster = b * -(-t // 16), 1
    while cluster < 4 and tiles * cluster < _MIN_GRID:
        cluster *= 2
    return 16, cluster


def _check_aligned(**tensors) -> None:
    """The kernels read and write these in 16-byte vectors."""
    for name, tensor in tensors.items():
        if tensor is not None and tensor.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")


def _shift(y: torch.Tensor, offset: int) -> torch.Tensor:
    """Row t of the result is row t + offset of ``y`` [B, T, C], zero where
    that falls outside [0, T)."""
    t = y.shape[1]
    if offset >= 0:
        return F.pad(y, (0, 0, 0, offset))[:, offset:offset + t]
    return F.pad(y, (0, 0, -offset, 0))[:, :t]


def _conv_input(x, step, mask, dilation):
    """[y(t - d) | y(t) | y(t + d)] with y = (x + step) * mask: [B, T, 3C]."""
    y = x + step[:, None, :]
    if mask is not None:
        y = y * mask[:, :, None]
    return torch.cat([_shift(y, -dilation), y, _shift(y, dilation)], dim=-1)


def diffnet_block_plain(x, cond, step, mask, wd, bd, wc, bc, wo, bo,
                        dilation: int = 1, return_h: bool = False):
    """Plain PyTorch version of K1 (same arguments, same results)."""
    c = x.shape[-1]
    h = _conv_input(x, step, mask, dilation) @ wd + bd + (cond @ wc + bc)
    g = torch.sigmoid(h[..., :c]) * torch.tanh(h[..., c:])
    o = g @ wo + bo
    out = ((x + o[..., :c]) / math.sqrt(2.0), o[..., c:])
    return (*out, h) if return_h else out


def diffnet_block(x, cond, step, mask, wd, bd, wc, bc, wo, bo,
                  dilation: int = 1, return_h: bool = False):
    """x [B,T,C]; cond [B,T,H]; step [B,C]; mask [B,T] nonpadding or None;
    wd [3C,2C]; wc [H,2C]; wo [C,2C]; biases [2C] -> (x' [B,T,C],
    skip [B,T,C]), and h [B,T,2C] after them when ``return_h``.

    A CPU tensor takes the plain version; a CUDA tensor launches K1."""
    if x.device.type == "cpu":
        return diffnet_block_plain(x, cond, step, mask, wd, bd, wc, bc, wo, bo,
                                   dilation, return_h)
    if x.device.type != "cuda":
        raise ValueError(f"diffnet_block: unsupported device {x.device}")
    b, t, c = x.shape
    h = cond.shape[-1]
    if (c, h) != (_C, _H) or dilation < 1:
        raise ValueError(f"diffnet_block: unsupported C={c}, H={h}, "
                         f"dilation={dilation}")
    m, cluster = _tile_plan(b, t, _fits64("diffnet_block", dilation))
    dev = x.device
    for name, tensor, shape in (
            ("x", x, (b, t, c)), ("cond", cond, (b, t, h)), ("step", step, (b, c)),
            ("wd", wd, (3 * c, 2 * c)), ("bd", bd, (2 * c,)),
            ("wc", wc, (h, 2 * c)), ("bc", bc, (2 * c,)),
            ("wo", wo, (c, 2 * c)), ("bo", bo, (2 * c,))):
        check_tensor(tensor, name, shape, dev)
    if mask is not None:
        check_tensor(mask, "mask", (b, t), dev)
    _check_aligned(x=x, cond=cond, step=step, wd=wd, bd=bd, wc=wc, bc=bc, wo=wo,
                   bo=bo)
    xout = torch.empty_like(x)
    skip = torch.empty_like(x)
    h_out = x.new_empty(b, t, 2 * c) if return_h else None
    fn = kernel_function("diffnet_block", "diffnet_block_fwd_f32", _FWD_ARGTYPES)
    check_status(fn(ptr(x), ptr(cond), ptr(step), ptr(mask), ptr(wd), ptr(bd),
                    ptr(wc), ptr(bc), ptr(wo), ptr(bo), ptr(xout), ptr(skip),
                    ptr(h_out), b, t, c, h, dilation, m, cluster, current_stream()),
                 "diffnet_block")
    diffnet_block.launches += 1
    return (xout, skip, h_out) if return_h else (xout, skip)


diffnet_block.launches = 0


def diffnet_block_bwd_plain(h, dxout, dskip, mask, wd, wo, dilation: int = 1):
    """Plain PyTorch version of K5: (h, dx', dskip) -> (dx, dh, g)."""
    c = dxout.shape[-1]
    do = torch.cat([dxout * RSQRT2, dskip], dim=-1)
    dg = do @ wo.t()
    sig, th = torch.sigmoid(h[..., :c]), torch.tanh(h[..., c:])
    dh = torch.cat([dg * th * sig * (1 - sig), dg * sig * (1 - th * th)], dim=-1)
    dy3 = dh @ wd.t()
    dy = (_shift(dy3[..., :c], dilation) + dy3[..., c:2 * c]
          + _shift(dy3[..., 2 * c:], -dilation))
    if mask is not None:
        dy = dy * mask[:, :, None]
    return dy + dxout * RSQRT2, dh, sig * th


def diffnet_block_bwd(h, dxout, dskip, mask, wd, wo, dilation: int = 1):
    """h [B,T,2C] (K1's pre-activation); dxout, dskip [B,T,C]; mask [B,T]
    or None; wd [3C,2C]; wo [C,2C] -> (dx [B,T,C], dh [B,T,2C], g [B,T,C]).

    A CPU tensor takes the plain version; a CUDA tensor launches K5."""
    if h.device.type == "cpu":
        return diffnet_block_bwd_plain(h, dxout, dskip, mask, wd, wo, dilation)
    if h.device.type != "cuda":
        raise ValueError(f"diffnet_block_bwd: unsupported device {h.device}")
    b, t, c = dxout.shape
    if c != _C or dilation < 1:
        raise ValueError(f"diffnet_block_bwd: unsupported C={c}, "
                         f"dilation={dilation}")
    m, _ = _tile_plan(b, t, _fits64("diffnet_block_bwd", dilation))
    dev = h.device
    for name, tensor, shape in (
            ("h", h, (b, t, 2 * c)), ("dxout", dxout, (b, t, c)),
            ("dskip", dskip, (b, t, c)), ("wd", wd, (3 * c, 2 * c)),
            ("wo", wo, (c, 2 * c))):
        check_tensor(tensor, name, shape, dev)
    if mask is not None:
        check_tensor(mask, "mask", (b, t), dev)
    _check_aligned(h=h, dxout=dxout, dskip=dskip, wd=wd, wo=wo)
    dx, g = torch.empty_like(dxout), torch.empty_like(dxout)
    dh = torch.empty_like(h)
    fn = kernel_function("diffnet_block_bwd", "diffnet_block_bwd_f32",
                         _BWD_ARGTYPES)
    check_status(fn(ptr(h), ptr(dxout), ptr(dskip), ptr(mask), ptr(wo),
                    ptr(wd), ptr(dx), ptr(dh), ptr(g), b, t, c, dilation, m,
                    current_stream()), "diffnet_block_bwd")
    diffnet_block_bwd.launches += 1
    return dx, dh, g


diffnet_block_bwd.launches = 0


class DiffNetBlockFunction(torch.autograd.Function):
    """K1 forward (saving ``h``) and K5 backward, with the weight, bias,
    cond and step gradients of ``_vjp_bwd`` as plain products. On CPU
    tensors both halves run their plain versions, so the CPU tests exercise
    the same decomposition."""

    @staticmethod
    def forward(ctx, x, cond, step, mask, wd, bd, wc, bc, wo, bo, dilation):
        xout, skip, h = diffnet_block(x, cond, step, mask, wd, bd, wc, bc, wo,
                                      bo, dilation, return_h=True)
        ctx.save_for_backward(x, cond, step, mask, h, wd, wc, wo)
        ctx.dilation = dilation
        return xout, skip

    @staticmethod
    def backward(ctx, dxout, dskip):
        x, cond, step, mask, h, wd, wc, wo = ctx.saved_tensors
        d = ctx.dilation
        dxout, dskip = dxout.contiguous(), dskip.contiguous()
        dx, dh, g = diffnet_block_bwd(h, dxout, dskip, mask, wd, wo, d)
        b, t, c = x.shape
        dh2 = dh.reshape(b * t, 2 * c)
        do = torch.cat([dxout * RSQRT2, dskip], dim=-1).reshape(b * t, 2 * c)
        dwd = _conv_input(x, step, mask, d).reshape(b * t, 3 * c).t() @ dh2
        dwc = cond.reshape(b * t, -1).t() @ dh2
        dwo = g.reshape(b * t, c).t() @ do
        dbias = dh2.sum(0)                # bd and bc both add into h
        dcond = dh @ wc.t()
        # step reaches the loss only through y: dx = dy * mask + dx' / sqrt(2)
        dstep = (dx - dxout * RSQRT2).sum(1)
        return (dx, dcond, dstep, None, dwd, dbias, dwc, dbias, dwo, do.sum(0),
                None)


def diffnet_block_train(x, cond, step, mask, wd, bd, wc, bc, wo, bo,
                        dilation: int = 1):
    """:func:`diffnet_block` with a gradient: K1 forward, K5 backward."""
    return DiffNetBlockFunction.apply(x, cond, step, mask, wd, bd, wc, bc, wo,
                                      bo, dilation)
