"""Kernels K1 and K5: the DiffNet gated residual block, forward
(``csrc/diffnet_block.cu``) and backward (``csrc/diffnet_block_bwd.cu``).

Replace ``speech_editing_tpu/ops/pallas/diffnet_block.py::fused_diffnet_block``:
its forward (``_fwd_call``) and backward (``_bwd_call``). Unlike the Pallas
kernels both take the ``[B, T]`` nonpadding mask (multiplied into ``x +
step`` before the conv) and any dilation, so the default masked path of the
denoiser runs through them. K1 writes the pre-activation ``h`` only when a
gradient is needed. :class:`DiffNetBlockFunction` ties the two together as
``_vjp_fwd``/``_vjp_bwd`` do; its weight, bias, cond and step gradients are
plain products, as the JAX package leaves them to XLA.
:class:`DiffNetBlockRematFunction` (``remat_diffnet``) keeps no ``h``: its
backward launches K1 again to write it. Both kernels take
float32, their products on the tensor cores as 3xTF32 (float32 accuracy,
``csrc/tf32x3.cuh``), or bfloat16, with f32 accumulation and the Pallas
kernels' roundings (Hopper's wgmma, weights by TMA multicast over a
cluster: ``csrc/diffnet_bf16.cuh``); the wrappers dispatch on the dtype,
and the plain versions emulate both. :func:`_tile_plan` picks the float32
forms' rows per CTA and K1's cluster split from B·T,
:func:`_tile_plan_bf16` the bf16 forms' clusters. The source notes in the
``.cu`` files give each kernel's bound and design.

:func:`diffnet_block_takes` states the kernels' envelope: the widths
compiled (``WIDTHS``), float32 or bfloat16. On the card a call outside it
raises, naming the kernel and the shape. Launches are counted per dtype:
``launches`` (float32) and ``launches_bf16``.
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
# (C, H) of K1 as compiled (``with_widths`` in csrc/diffnet_block.cu); K5 takes
# their C (``with_channels`` in csrc/diffnet_block_bwd.cu)
WIDTHS = ((256, 192), (128, 192), (256, 256), (128, 256))
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}   # the entry points a dtype
_MIN_GRID = 128               # CTAs that fill the H100's 132 SMs


def diffnet_block_takes(c: int, h: int | None, dilation: int, dtype) -> bool:
    """Whether K1 (``h`` the conditioner's width) or K5 (``h`` None) runs a
    block of C=``c`` residual channels at this dilation and ``dtype``:
    widths as compiled (``WIDTHS``), a dilation of at least 1, float32 or
    bfloat16."""
    widths = any(c == wc and h in (None, wh) for wc, wh in WIDTHS)
    return widths and dilation >= 1 and dtype in _SUFFIX


def _check_envelope(who: str, c: int, h: int | None, dilation: int, dtype) -> None:
    if not diffnet_block_takes(c, h, dilation, dtype):
        width = f"C={c}" if h is None else f"C={c}, H={h}"
        raise ValueError(f"{who}: {width}, dilation={dilation}, dtype {dtype} is outside the "
                         f"kernel's envelope (widths {WIDTHS}, float32 or bfloat16); run it "
                         "on the CPU")


@functools.cache
def _fits64(name: str, dilation: int, suffix: str = "f32", c: int = 256,
            h: int = 192) -> bool:
    """Whether 64-row tiles of K1 (``name`` "diffnet_block") or K5
    ("diffnet_block_bwd") in the form ``suffix`` ("f32" or "bf16") fit in a
    block's shared memory on the card at this dilation and these widths, as
    the kernel's own library counts it."""
    if name == "diffnet_block":
        symbol = "diffnet_block_fwd_fits" if suffix == "f32" else "diffnet_block_fwd_bf16_fits"
        return bool(kernel_function(name, symbol, [_I] * 4)(64, dilation, c, h))
    symbol = "diffnet_block_bwd_fits" if suffix == "f32" else "diffnet_block_bwd_bf16_fits"
    return bool(kernel_function(name, symbol, [_I] * 3)(64, dilation, c))


def _tile_plan(b: int, t: int, fits64: bool = True, c: int = 256) -> tuple[int, int]:
    """(rows per CTA, CTAs per cluster) of K1 and K5 at [B, T] and C=``c``.

    64-row tiles where they alone give ``_MIN_GRID`` CTAs and ``fits64``
    (they fit in shared memory); else 16-row tiles, and K1 splits the gate
    columns over a cluster of 2, then 4 CTAs until the grid reaches
    ``_MIN_GRID`` (the largest where even that falls short), each CTA
    keeping at least 64 of them (2 CTAs at most at C=128). K5 takes the
    rows and no cluster."""
    if fits64 and b * -(-t // 64) >= _MIN_GRID:
        return 64, 1
    tiles, cluster = b * -(-t // 16), 1
    while cluster < min(4, c // 64) and tiles * cluster < _MIN_GRID:
        cluster *= 2
    return 16, cluster


_SMS = 132                    # the H100's SMs: one bf16 CTA fits on each


def _share(tiles: int) -> int:
    """CTAs of a bf16 cluster that share the weights, over ``tiles``
    64-row tiles (the last cluster's missing tiles are padding CTAs that
    only load): 4 where the grid is one wave of 16 or more CTAs, else 2
    (from 2 tiles). Past one wave, clusters of 4 whole SMs fit the SMs a
    wave leaves free worse than clusters of 2 (``probe_diffnet.py
    --share``: both kernels slower with 4 at the bf16 flagship step's
    624 tiles)."""
    return 4 if 16 <= tiles <= _SMS else 2 if tiles >= 2 else 1


def _tile_plan_bf16(b: int, t: int, c: int = 256, split_ok: bool = True) -> tuple[int, int]:
    """(split, share) of the bf16 forms of K1 and K5 (``split_ok`` False)
    at [B, T] and C=``c``, on 64-row tiles. Where the tiles alone give
    ``_MIN_GRID`` / 2 CTAs, or for K5, clusters of :func:`_share`
    neighbouring tiles share the weights (split 1); else K1 splits the
    gate columns over a cluster of 2, then 4 CTAs until the grid reaches
    ``_MIN_GRID`` (the largest where even that falls short), each CTA
    keeping at least 64 of them (share 1)."""
    tiles = b * -(-t // 64)
    if not split_ok or tiles >= _MIN_GRID // 2:
        return 1, _share(tiles)
    split = 1
    while split < min(4, c // 64) and tiles * split < _MIN_GRID:
        split *= 2
    return split, 1


def _plan(name: str, b: int, t: int, dilation: int, suffix: str, c: int,
          h: int = 192) -> tuple[int, int]:
    """The two plan arguments of K1's (``name`` "diffnet_block") or K5's
    launch in the form ``suffix``: (rows, cluster) for float32, (split,
    share) for bf16, whose 64-row tiles must fit in shared memory."""
    fits = _fits64(name, dilation, suffix, c, h)
    if suffix == "f32":
        return _tile_plan(b, t, fits, c)
    if not fits:
        raise RuntimeError(f"{name}: the bf16 form's 64-row tiles do not fit in shared "
                           f"memory at C={c}, dilation={dilation}")
    return _tile_plan_bf16(b, t, c, name == "diffnet_block")


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


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in f32. bf16 operands on the CPU are upcast
    (their products are exact in f32) and the result is f32; on the card
    cuBLAS multiplies bf16 with f32 accumulation and rounds once to bf16
    (``float32_on_card`` keeps its split-K reductions in f32). Float32 is
    a plain product."""
    if a.dtype == torch.bfloat16 and a.device.type == "cpu":
        return a.float() @ b.float()
    return a @ b


def _plain_bf16(x, cond, step, mask, wd, bd, wc, bc, wo, bo, dilation, return_h):
    """K1's bf16 form, rounded where ``_fwd_kernel`` rounds: y = (x + step)
    * mask in bf16; f32 products of the bf16 operands; h = conv + cond @ Wc
    + bf16(bd + bc) in f32, stored as bf16; the gate from the f32 h, g
    rounded to bf16 for the Wo product; x' and skip computed in f32 and
    stored as bf16."""
    c, bf = x.shape[-1], torch.bfloat16
    f = lambda t: t.float()
    hf = (f(_conv_input(x, step, mask, dilation)) @ f(wd) + f(cond) @ f(wc)) + f(bd + bc)
    g = (torch.sigmoid(hf[..., :c]) * torch.tanh(hf[..., c:])).to(bf)
    o = f(g) @ f(wo) + f(bo)
    out = (((f(x) + o[..., :c]) * RSQRT2).to(bf), o[..., c:].to(bf))
    return (*out, hf.to(bf)) if return_h else out


def diffnet_block_plain(x, cond, step, mask, wd, bd, wc, bc, wo, bo,
                        dilation: int = 1, return_h: bool = False):
    """Plain PyTorch version of K1 (same arguments, same results), float32
    or bf16."""
    if x.dtype == torch.bfloat16:
        return _plain_bf16(x, cond, step, mask, wd, bd, wc, bc, wo, bo, dilation, return_h)
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
    skip [B,T,C]), and h [B,T,2C] after them when ``return_h``. Every
    tensor float32, or every one bfloat16.

    A CPU tensor takes the plain version; a CUDA tensor launches K1 (its
    float32 or bf16 form), and raises outside :func:`diffnet_block_takes`."""
    if x.device.type == "cpu":
        return diffnet_block_plain(x, cond, step, mask, wd, bd, wc, bc, wo, bo,
                                   dilation, return_h)
    if x.device.type != "cuda":
        raise ValueError(f"diffnet_block: unsupported device {x.device}")
    b, t, c = x.shape
    h = cond.shape[-1]
    _check_envelope("diffnet_block", c, h, dilation, x.dtype)
    suffix = _SUFFIX[x.dtype]
    plan = _plan("diffnet_block", b, t, dilation, suffix, c, h)
    dev = x.device
    for name, tensor, shape in (
            ("x", x, (b, t, c)), ("cond", cond, (b, t, h)), ("step", step, (b, c)),
            ("wd", wd, (3 * c, 2 * c)), ("bd", bd, (2 * c,)),
            ("wc", wc, (h, 2 * c)), ("bc", bc, (2 * c,)),
            ("wo", wo, (c, 2 * c)), ("bo", bo, (2 * c,))):
        check_tensor(tensor, name, shape, dev, x.dtype)
    if mask is not None:
        check_tensor(mask, "mask", (b, t), dev, x.dtype)
    _check_aligned(x=x, cond=cond, step=step, wd=wd, bd=bd, wc=wc, bc=bc, wo=wo,
                   bo=bo)
    xout = torch.empty_like(x)
    skip = torch.empty_like(x)
    h_out = x.new_empty(b, t, 2 * c) if return_h else None
    fn = kernel_function("diffnet_block", f"diffnet_block_fwd_{suffix}", _FWD_ARGTYPES)
    check_status(fn(ptr(x), ptr(cond), ptr(step), ptr(mask), ptr(wd), ptr(bd),
                    ptr(wc), ptr(bc), ptr(wo), ptr(bo), ptr(xout), ptr(skip),
                    ptr(h_out), b, t, c, h, dilation, *plan, current_stream()),
                 "diffnet_block")
    if suffix == "f32":
        diffnet_block.launches += 1
    else:
        diffnet_block.launches_bf16 += 1
    return (xout, skip, h_out) if return_h else (xout, skip)


diffnet_block.launches = diffnet_block.launches_bf16 = 0


def diffnet_block_bwd_plain(h, dxout, dskip, mask, wd, wo, dilation: int = 1):
    """Plain PyTorch version of K5: (h, dx', dskip) -> (dx, dh, g), float32,
    or bf16 rounded where ``_bwd_kernel`` rounds (do to bf16 for the Wo
    product, dh to bf16 for the Wd product and its output, dx and g)."""
    c = dxout.shape[-1]
    bf16 = dxout.dtype == torch.bfloat16
    f = (lambda t: t.float()) if bf16 else (lambda t: t)
    do = torch.cat([f(dxout) * RSQRT2, f(dskip)], dim=-1)
    dg = f(do.to(dxout.dtype)) @ f(wo).t()
    hf = f(h)
    sig, th = torch.sigmoid(hf[..., :c]), torch.tanh(hf[..., c:])
    dh = torch.cat([dg * th * sig * (1 - sig), dg * sig * (1 - th * th)], dim=-1)
    dh = dh.to(dxout.dtype)
    dy3 = f(dh) @ f(wd).t()
    dy = (_shift(dy3[..., :c], dilation) + dy3[..., c:2 * c]
          + _shift(dy3[..., 2 * c:], -dilation))
    if mask is not None:
        dy = dy * f(mask)[:, :, None]
    return ((dy + f(dxout) * RSQRT2).to(dxout.dtype), dh,
            (sig * th).to(dxout.dtype))


def diffnet_block_bwd(h, dxout, dskip, mask, wd, wo, dilation: int = 1):
    """h [B,T,2C] (K1's pre-activation); dxout, dskip [B,T,C]; mask [B,T]
    or None; wd [3C,2C]; wo [C,2C] -> (dx [B,T,C], dh [B,T,2C], g [B,T,C]).
    Every tensor float32, or every one bfloat16.

    A CPU tensor takes the plain version; a CUDA tensor launches K5 (its
    float32 or bf16 form), and raises outside :func:`diffnet_block_takes`."""
    if h.device.type == "cpu":
        return diffnet_block_bwd_plain(h, dxout, dskip, mask, wd, wo, dilation)
    if h.device.type != "cuda":
        raise ValueError(f"diffnet_block_bwd: unsupported device {h.device}")
    b, t, c = dxout.shape
    _check_envelope("diffnet_block_bwd", c, None, dilation, dxout.dtype)
    suffix = _SUFFIX[dxout.dtype]
    rows, share = _plan("diffnet_block_bwd", b, t, dilation, suffix, c)
    dev = h.device
    for name, tensor, shape in (
            ("h", h, (b, t, 2 * c)), ("dxout", dxout, (b, t, c)),
            ("dskip", dskip, (b, t, c)), ("wd", wd, (3 * c, 2 * c)),
            ("wo", wo, (c, 2 * c))):
        check_tensor(tensor, name, shape, dev, dxout.dtype)
    if mask is not None:
        check_tensor(mask, "mask", (b, t), dev, dxout.dtype)
    _check_aligned(h=h, dxout=dxout, dskip=dskip, wd=wd, wo=wo)
    dx, g = torch.empty_like(dxout), torch.empty_like(dxout)
    dh = torch.empty_like(h)
    fn = kernel_function("diffnet_block_bwd", f"diffnet_block_bwd_{suffix}",
                         _BWD_ARGTYPES)
    check_status(fn(ptr(h), ptr(dxout), ptr(dskip), ptr(mask), ptr(wo),
                    ptr(wd), ptr(dx), ptr(dh), ptr(g), b, t, c, dilation,
                    rows if suffix == "f32" else share, current_stream()), "diffnet_block_bwd")
    if suffix == "f32":
        diffnet_block_bwd.launches += 1
    else:
        diffnet_block_bwd.launches_bf16 += 1
    return dx, dh, g


diffnet_block_bwd.launches = diffnet_block_bwd.launches_bf16 = 0


def _block_grads(x, cond, step, mask, h, wd, wc, wo, dilation, dxout, dskip):
    """The block's gradients from its saved inputs and ``h``: K5 for dx, dh
    and g, then the weight, bias, cond and step gradients of ``_vjp_bwd``
    as plain products (f32 accumulation, each cast to its weight's or
    input's dtype: a no-op in float32)."""
    d = dilation
    dxout, dskip = dxout.contiguous(), dskip.contiguous()
    dx, dh, g = diffnet_block_bwd(h, dxout, dskip, mask, wd, wo, d)
    b, t, c = x.shape
    dh2 = dh.reshape(b * t, 2 * c)
    do = torch.cat([dxout.float() * RSQRT2, dskip.float()], dim=-1)
    do = do.to(g.dtype).reshape(b * t, 2 * c)
    dwd = _mm(_conv_input(x, step, mask, d).reshape(b * t, 3 * c).t(), dh2)
    dwc = _mm(cond.reshape(b * t, -1).t(), dh2)
    dwo = _mm(g.reshape(b * t, c).t(), do)
    dbias = dh2.float().sum(0).to(wd.dtype)     # bd and bc both add into h
    dcond = _mm(dh, wc.t()).to(cond.dtype)
    # step reaches the loss only through y: dx = dy * mask + dx' / sqrt(2)
    dstep = (dx.float() - dxout.float() * RSQRT2).sum(1).to(step.dtype)
    return (dx, dcond, dstep, None, dwd.to(wd.dtype), dbias, dwc.to(wc.dtype), dbias,
            dwo.to(wo.dtype), do.float().sum(0).to(wo.dtype), None)


class DiffNetBlockFunction(torch.autograd.Function):
    """K1 forward (saving ``h``) and K5 backward (:func:`_block_grads`). On
    CPU tensors both halves run their plain versions, so the CPU tests
    exercise the same decomposition."""

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
        return _block_grads(x, cond, step, mask, h, wd, wc, wo, ctx.dilation, dxout, dskip)


class DiffNetBlockRematFunction(torch.autograd.Function):
    """The block under ``remat_diffnet`` (the JAX package's ``nn.remat`` of
    the block): K1 forward saving its inputs and weights but not ``h``
    [B, T, 2C]; the backward launches K1 again, with ``h``, then K5 as
    :class:`DiffNetBlockFunction` does. Gradients equal that Function's:
    the recomputed ``h`` is the forward's, bit for bit, since K1 (and its
    plain version) is deterministic."""

    @staticmethod
    def forward(ctx, x, cond, step, mask, wd, bd, wc, bc, wo, bo, dilation):
        xout, skip = diffnet_block(x, cond, step, mask, wd, bd, wc, bc, wo, bo, dilation)
        ctx.save_for_backward(x, cond, step, mask, wd, bd, wc, bc, wo, bo)
        ctx.dilation = dilation
        return xout, skip

    @staticmethod
    def backward(ctx, dxout, dskip):
        x, cond, step, mask, wd, bd, wc, bc, wo, bo = ctx.saved_tensors
        h = diffnet_block(x, cond, step, mask, wd, bd, wc, bc, wo, bo, ctx.dilation,
                          return_h=True)[2]
        return _block_grads(x, cond, step, mask, h, wd, wc, wo, ctx.dilation, dxout, dskip)


def diffnet_block_train(x, cond, step, mask, wd, bd, wc, bc, wo, bo,
                        dilation: int = 1, remat: bool = False):
    """:func:`diffnet_block` with a gradient: K1 forward, K5 backward; with
    ``remat`` the forward keeps no ``h`` and the backward recomputes it
    with K1 (:class:`DiffNetBlockRematFunction`)."""
    fn = DiffNetBlockRematFunction if remat else DiffNetBlockFunction
    return fn.apply(x, cond, step, mask, wd, bd, wc, bc, wo, bo, dilation)
