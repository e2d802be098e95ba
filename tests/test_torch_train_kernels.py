"""PyTorch port, backward kernels K4 and K5: their plain versions and the
autograd Functions that pair them with K1 and K3 (what runs on a CPU
tensor), against ``jax.vjp`` of the JAX package's kernels and reference
paths, and ``torch.autograd.gradcheck`` in float64.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each of them against these plain versions there. The Pallas block runs
here in interpret mode, as the JAX package's own tests run it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_editing_tpu.modules.transformer import NEG_INF
from speech_editing_tpu.modules.wavenet import DiffNetResidualBlock as JBlock
from speech_editing_tpu.ops.pallas.diffnet_block import fused_diffnet_block
from speech_editing_tpu_torch.ops.cuda.diffnet_block import (diffnet_block,
                                                             diffnet_block_bwd,
                                                             diffnet_block_bwd_plain,
                                                             diffnet_block_plain,
                                                             diffnet_block_train)
from speech_editing_tpu_torch.ops.flash_attention import (attention_bwd_plain,
                                                          attention_lse_plain,
                                                          attention_plain, flash_mha,
                                                          flash_mha_bwd,
                                                          flash_mha_train)
from speech_editing_tpu_torch.utils.convert_jax_params import _linear

PALLAS_TOL = dict(atol=5e-4, rtol=5e-4)   # tests/test_pallas_diffnet.py's bar
TOL = dict(atol=1e-4, rtol=1e-4)


def _block_inputs(rs, b=2, t=37, c=32, hdim=24):
    f = lambda *s, scale=1.0: (rs.randn(*s) * scale).astype(np.float32)
    return (f(b, t, c), f(b, t, hdim, scale=0.5), f(b, c, scale=0.3),
            f(3 * c, 2 * c, scale=0.1), f(2 * c, scale=0.1),
            f(hdim, 2 * c, scale=0.1), f(2 * c, scale=0.1),
            f(c, 2 * c, scale=0.1), f(2 * c, scale=0.1))


@functools.lru_cache(maxsize=1)
def _pallas_vjp():
    """Inputs, output cotangents and ``jax.vjp`` of the Pallas block
    (interpret mode): one trace shared by the tests below."""
    rs = np.random.RandomState(0)
    args = _block_inputs(rs)
    dxo, dsk = (rs.randn(*args[0].shape).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(fused_diffnet_block, *(jnp.asarray(a) for a in args))
    grads = [np.asarray(g) for g in vjp((jnp.asarray(dxo), jnp.asarray(dsk)))]
    return args, dxo, dsk, grads


def test_k5_plain_matches_pallas_backward():
    """diffnet_block_bwd_plain's dx, with the weight and input grads the
    Function builds from it, against the Pallas VJP (unmasked, dilation 1)."""
    args, dxo, dsk, grads = _pallas_vjp()
    t = [torch.tensor(a) for a in args]
    _, _, h = diffnet_block_plain(t[0], t[1], t[2], None, *t[3:], return_h=True)
    dx, _, _ = diffnet_block_bwd_plain(h, torch.tensor(dxo), torch.tensor(dsk),
                                       None, t[3], t[7])
    np.testing.assert_allclose(dx.numpy(), grads[0], **PALLAS_TOL)


def test_k5_function_grads_match_pallas_vjp():
    args, dxo, dsk, grads = _pallas_vjp()
    t = [torch.tensor(a, requires_grad=True) for a in args]
    xo, sk = diffnet_block_train(t[0], t[1], t[2], None, *t[3:])
    got = torch.autograd.grad((xo, sk), t, (torch.tensor(dxo), torch.tensor(dsk)))
    names = ("x", "cond", "step", "wd", "bd", "wc", "bc", "wo", "bo")
    for name, g, ref in zip(names, got, grads):
        np.testing.assert_allclose(g.numpy(), ref, **PALLAS_TOL, err_msg=name)


@pytest.mark.parametrize("dilation", [1, 2])
def test_k5_function_grads_match_masked_flax_block(rng, dilation):
    """With the nonpadding mask and a dilation: ``jax.vjp`` of the plain
    branch of the flax DiffNetResidualBlock (the default denoiser path)."""
    b, t, c, hdim = 2, 29, 16, 24
    x = rng.randn(b, t, c).astype(np.float32)
    cond = (rng.randn(b, t, hdim) * 0.5).astype(np.float32)
    step_emb = rng.randn(b, c).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[1, 20:] = 0.0
    dxo, dsk = (rng.randn(b, t, c).astype(np.float32) for _ in range(2))
    block = JBlock(c, dilation)
    jargs = (jnp.asarray(x), jnp.asarray(cond), jnp.asarray(step_emb),
             jnp.asarray(mask)[..., None])
    params = block.init(jax.random.PRNGKey(0), *jargs)["params"]
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(np.float32), params)
    _, vjp = jax.vjp(lambda p, x_, c_, s_: block.apply({"params": p}, x_, c_, s_,
                                                       jargs[3]),
                     params, *jargs[:3])
    gp, gx, gcond, gstep = vjp((jnp.asarray(dxo), jnp.asarray(dsk)))

    sd = {}
    _linear(sd, "proj", params["diffusion_projection"])
    leaf = lambda a: torch.tensor(np.asarray(a), requires_grad=True)
    tx, tcond, tstep_emb = leaf(x), leaf(cond), leaf(step_emb)
    proj_w, proj_b = leaf(sd["proj.weight"]), leaf(sd["proj.bias"])
    kern = {n: leaf(params[n]["kernel"]) for n in
            ("dilated_conv", "conditioner_projection", "output_projection")}
    bias = {n: leaf(params[n]["bias"]) for n in kern}
    w = [m for n in kern for m in (kern[n].reshape(-1, 2 * c), bias[n])]
    xo, sk = diffnet_block_train(tx, tcond, tstep_emb @ proj_w.T + proj_b,
                                 torch.tensor(mask), *w, dilation=dilation)
    leaves = [tx, tcond, tstep_emb, proj_w, proj_b, *kern.values(), *bias.values()]
    got = torch.autograd.grad((xo, sk), leaves, (torch.tensor(dxo), torch.tensor(dsk)))
    gpn = lambda n, k: np.asarray(gp[n][k])
    refs = [gx, gcond, gstep, gpn("diffusion_projection", "kernel").T,
            gpn("diffusion_projection", "bias"),
            *(gpn(n, "kernel") for n in kern), *(gpn(n, "bias") for n in kern)]
    for i, (g, ref) in enumerate(zip(got, refs)):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), **TOL, err_msg=str(i))


def test_k5_shift_scatter_respects_dilation_and_mask(rng):
    """dx at a masked row carries only the residual path dx'/sqrt(2)."""
    args = [torch.tensor(a) for a in _block_inputs(rng, b=1, t=12)]
    mask = torch.ones(1, 12)
    mask[0, 9:] = 0
    _, _, h = diffnet_block_plain(args[0], args[1], args[2], mask, *args[3:],
                                  dilation=3, return_h=True)
    dxo, dsk = torch.randn(1, 12, 32), torch.randn(1, 12, 32)
    dx, _, _ = diffnet_block_bwd(h, dxo, dsk, mask, args[3], args[7], 3)
    torch.testing.assert_close(dx[0, 9:], dxo[0, 9:] / 2 ** 0.5)


def _float64(*shapes, rs):
    return [torch.tensor(rs.randn(*s) * 0.5, dtype=torch.float64, requires_grad=True)
            for s in shapes]


@pytest.mark.parametrize("dilation,masked", [(1, False), (1, True), (2, True)])
def test_k5_function_gradcheck_float64(dilation, masked):
    rs = np.random.RandomState(dilation)
    b, t, c, hdim = 2, 7, 4, 3
    ins = _float64((b, t, c), (b, t, hdim), (b, c), (3 * c, 2 * c), (2 * c,),
                   (hdim, 2 * c), (2 * c,), (c, 2 * c), (2 * c,), rs=rs)
    mask = None
    if masked:
        mask = torch.ones(b, t, dtype=torch.float64)
        mask[1, 5:] = 0
    fn = lambda *a: diffnet_block_train(a[0], a[1], a[2], mask, *a[3:],
                                        dilation=dilation)
    assert torch.autograd.gradcheck(fn, ins)


def _jax_attention(q, k, v, pad):
    """The einsum path of the flax MultiheadAttention, after projections."""
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k)
    logits = logits + jnp.where(pad, NEG_INF, 0.0)[:, None, None, :]
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(logits, axis=-1), v)


def _train_lengths(b: int, t: int) -> list:
    """Valid tokens of each row as the flagship train batch draws them: 24
    up to t, the first row full."""
    n = np.random.RandomState(0).randint(24, t + 1, b)
    n[0] = t
    return list(n)


@pytest.mark.parametrize("b,t,lengths", [(2, 13, [13, 6]), (3, 40, [40, 36, 20]),
                                         (6, 48, _train_lengths(6, 48))],
                         ids=["2-13", "3-40", "flagship-48"])
def test_k4_plain_matches_jax_einsum_vjp(rng, b, t, lengths):
    """At the flagship head shape (h=2, d=96), the last case also at its
    token length with rows padded as in the train batch: the plain K3 and
    K4, which the card is held to, against jax.vjp of the einsum path."""
    h, d = 2, 96
    q, k, v, do = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(4))
    q *= d ** -0.5
    pad = np.arange(t)[None, :] >= np.array(lengths)[:, None]
    _, vjp = jax.vjp(lambda *a: _jax_attention(*a, jnp.asarray(pad)),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp(jnp.asarray(do))
    tq, tk, tv, tpad = (torch.tensor(a) for a in (q, k, v, pad))
    o, lse = flash_mha(tq, tk, tv, tpad, return_lse=True)
    got = attention_bwd_plain(tq, tk, tv, o, lse, torch.tensor(do), tpad)
    for name, g, ref in zip("qkv", got, refs):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5,
                                   err_msg=f"d{name}")
    assert (got[1][tpad] == 0).all() and (got[2][tpad] == 0).all()


def test_k4_row_with_no_valid_key_gets_zero_dq(rng):
    q, k, v, do = (torch.tensor(rng.randn(2, 6, 2, 8).astype(np.float32))
                   for _ in range(4))
    pad = torch.zeros(2, 6, dtype=torch.bool)
    pad[1] = True
    lse = attention_lse_plain(q, k, pad)
    assert torch.isinf(lse[1]).all() and torch.isfinite(lse[0]).all()
    o = attention_plain(q, k, v, pad)
    dq, dk, dv = flash_mha_bwd(q, k, v, o, lse, do, pad)
    assert torch.isfinite(dq).all() and (dq[1] == 0).all()
    assert (dk[1] == 0).all() and (dv[1] == 0).all()


def test_k4_function_gradcheck_float64():
    rs = np.random.RandomState(3)
    q, k, v = _float64((2, 5, 2, 3), (2, 5, 2, 3), (2, 5, 2, 3), rs=rs)
    pad = torch.zeros(2, 5, dtype=torch.bool)
    pad[1, 3:] = True
    assert torch.autograd.gradcheck(lambda *a: flash_mha_train(*a, pad), (q, k, v))


@pytest.mark.parametrize("d", [96, 129])
def test_attention_wrappers_refuse_other_devices(d):
    """A tensor neither on the CPU nor on a GPU is refused at any head width,
    129 (past the kernels' 128) included."""
    q = torch.zeros(1, 4, 2, d, device="meta")
    lse = torch.zeros(1, 2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_mha(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_mha_bwd(q, q, q, q, lse, q)


def test_backward_wrappers_reject_unsupported_devices():
    x = torch.zeros(1, 4, 32, device="meta")
    with pytest.raises(ValueError):
        diffnet_block_bwd(torch.zeros(1, 4, 64, device="meta"), x, x, None,
                          torch.zeros(96, 64, device="meta"),
                          torch.zeros(32, 64, device="meta"))
    q = x[..., None]
    with pytest.raises(ValueError):
        flash_mha_bwd(q, q, q, q, torch.zeros(1, 1, 4, device="meta"), q)
    with pytest.raises(ValueError):
        diffnet_block(x, x, x[:, 0], None, x, x, x, x, x, x, return_h=True)
