"""PyTorch port, the bf16 forms of kernels K3 and K4 (softmax attention and
its backward) on the CPU: their plain versions, which ``chip_smoke.py``
holds the card's kernels to, against JAX's bundled Pallas flash attention
itself in interpret mode, in bf16, at a small ragged shape, at rows long
enough for the Pallas kernel to run two of its 512-key blocks, and with a
key mask that has holes (pad keys inside rows, a whole 64-key tile of
them); ``FlashAttentionFunction`` in bf16 against autograd of the plain
forward; and the envelope predicate.

The Pallas backward lowers after ``_flash_bhtd``'s own interpret context
has closed, so the VJP is taken inside
``jax.experimental.pallas.tpu.force_tpu_interpret_mode()`` here (the JAX
package is not changed for it).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from speech_editing_tpu.ops.flash_attention import flash_mha as j_flash_mha
from speech_editing_tpu_torch.ops.flash_attention import (attention_bwd_plain,
                                                          attention_lse_plain,
                                                          attention_plain, flash_mha,
                                                          flash_mha_takes,
                                                          flash_mha_train)
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

BF = torch.bfloat16
B, T, H, D = 2, 100, 2, 96
LENGTHS = (100, 61)
# (T, key padding [B, T]) of each case: "short" is the B=2 x T=100 one above;
# "long" pads to 1024 keys, two of the Pallas kernel's 512-key blocks
# (speech_editing_tpu/ops/flash_attention.py::_flash_bhtd); "holes" pads
# about one key in five inside both rows and keys 64-127 of row 0, a whole
# 64-key tile of the card's kernels, which they skip
CASES = ("short", "long", "holes")
# the long and holes cases: one bf16 ulp of an element as large as the
# largest, 2^-7 of it at most. A stored output whose f32 value lies near a
# rounding boundary rounds either way when the sums run in another order.
# Measured: long 1.7e-3 (K3), 2.6e-3 (K4); holes 4.4e-3 (K3: one element of
# 0.68 one ulp apart, against a largest of 0.89), 1.6e-3 (K4)
ULP_BAR = 2.0 ** -7


def _padding(case):
    if case == "short":
        return T, np.arange(T)[None, :] >= np.array(LENGTHS)[:, None]
    if case == "long":
        t = 1000
        return t, np.arange(t)[None, :] >= np.array([1000, 300])[:, None]
    t = 256
    pad = np.random.RandomState(1).rand(B, t) < 0.2
    pad[0, 64:128] = True
    pad[1, 200:] = True
    return t, pad
# within 2^-8 of each output's largest element: half a bf16 ulp of it, the
# rounding the f32 sums' order may flip
BAR = 2.0 ** -8


def _np(x):
    """bf16 (torch or JAX) -> float32 numpy, exactly."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _err(got, ref):
    """The largest difference over the largest element of ``ref``."""
    got, ref = _np(got), _np(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def _pallas(case="short"):
    """bf16 inputs (q pre-scaled), the key padding, the output cotangent,
    and the Pallas kernel's output and (dq, dk, dv) in interpret mode."""
    rs = np.random.RandomState(0)
    t, pad = _padding(case)
    q, k, v, do = (rs.randn(B, t, H, D).astype(np.float32) for _ in range(4))
    q *= D ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda *a: j_flash_mha(*a, jnp.asarray(pad), interpret=True),
                           jq, jk, jv)
        grads = vjp(jdo)
    tensors = [torch.tensor(_np(a)).to(BF) for a in (jq, jk, jv, jdo)]
    return tensors, torch.tensor(pad), out, grads


def test_k3_bf16_plain_matches_pallas_interpret():
    """Measured: 3.7e-3 of the largest element. s = q.k is summed in
    another order than XLA's, and p = exp(s - m) rounds to bf16 on either
    side of a tie by that; each such p moves its output row by a bf16 ulp of
    p v / l."""
    (q, k, v, _), pad, out, _ = _pallas()
    got = attention_plain(q, k, v, pad)
    assert got.dtype == BF
    assert _err(got, out) <= BAR, _err(got, out)


def test_k4_bf16_plain_matches_pallas_interpret():
    """dq, dk, dv from the Pallas forward's own output, with the plain
    logsumexp. Measured: 9.2e-4, 6.8e-4 and 0.0 of the largest element."""
    (q, k, v, do), pad, out, grads = _pallas()
    o = torch.tensor(_np(out)).to(BF)
    lse = attention_lse_plain(q, k, pad)
    assert lse.dtype == torch.float32
    got = attention_bwd_plain(q, k, v, o, lse, do, pad)
    for name, g, ref in zip(("dq", "dk", "dv"), got, grads):
        assert g.dtype == BF, name
        assert _err(g, ref) <= BAR, (name, _err(g, ref))
    assert (got[1][1, LENGTHS[1]:] == 0).all() and (got[2][1, LENGTHS[1]:] == 0).all()


def test_flash_attention_function_bf16_matches_autograd_of_the_plain_forward():
    """K3 + K4 as one autograd Function in bf16 against autograd through
    the bf16 plain forward (which rounds p to bf16 in its own graph): within
    2^-5 of each gradient's largest element, the bar chip_smoke holds the
    card to (measured: 3.7e-3, 5.5e-3, 5.3e-3)."""
    (q, k, v, do), pad, _, _ = _pallas()
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    out = flash_mha_train(*leaves, pad)
    assert out.dtype == BF
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    ref = torch.autograd.grad(attention_plain(*ref_leaves, pad), ref_leaves, do)
    for name, g, r in zip("qkv", got, ref):
        assert g.dtype == BF, name
        assert _err(g, r) <= 2.0 ** -5, (name, _err(g, r))
    assert _err(out, flash_mha(q, k, v, pad)) == 0.0


@pytest.mark.parametrize("case", CASES[1:])
def test_k3_bf16_plain_matches_pallas_interpret_at(case):
    """The long rows and the mask with holes, within ULP_BAR."""
    (q, k, v, _), pad, out, _ = _pallas(case)
    got = attention_plain(q, k, v, pad)
    assert _err(got, out) <= ULP_BAR, _err(got, out)


@pytest.mark.parametrize("case", CASES[1:])
def test_k4_bf16_plain_matches_pallas_interpret_at(case):
    (q, k, v, do), pad, out, grads = _pallas(case)
    o = torch.tensor(_np(out)).to(BF)
    got = attention_bwd_plain(q, k, v, o, attention_lse_plain(q, k, pad), do, pad)
    for name, g, ref in zip(("dq", "dk", "dv"), got, grads):
        assert _err(g, ref) <= ULP_BAR, (case, name, _err(g, ref))
    assert (got[1][pad] == 0).all() and (got[2][pad] == 0).all()


@pytest.mark.parametrize("case", CASES[1:])
def test_flash_attention_function_bf16_matches_autograd_at(case):
    (q, k, v, do), pad, _, _ = _pallas(case)
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    got = torch.autograd.grad(flash_mha_train(*leaves, pad), leaves, do)
    ref_leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    ref = torch.autograd.grad(attention_plain(*ref_leaves, pad), ref_leaves, do)
    for name, g, r in zip("qkv", got, ref):
        assert _err(g, r) <= 2.0 ** -5, (case, name, _err(g, r))


def test_a_row_with_no_valid_key_gives_zeros_in_bf16():
    (q, k, v, do), _, _, _ = _pallas()
    pad = torch.zeros(B, T, dtype=torch.bool)
    pad[1] = True
    out, lse = flash_mha(q, k, v, pad, return_lse=True)
    assert (out[1] == 0).all() and torch.isinf(lse[1]).all()
    dq, dk, dv = attention_bwd_plain(q, k, v, out, lse, do, pad)
    assert (dq[1] == 0).all() and (dk[1] == 0).all() and (dv[1] == 0).all()


def test_envelope_takes_bf16_up_to_128_and_nothing_else():
    for d in (1, 36, 96, 128):
        assert flash_mha_takes(d, torch.bfloat16) and flash_mha_takes(d, torch.float32)
    assert not flash_mha_takes(129, torch.bfloat16)
    assert not flash_mha_takes(160, torch.float32)
    for dtype in (torch.float16, torch.float64):
        assert not flash_mha_takes(96, dtype)
