"""PyTorch port, kernels K1 and K5: the arithmetic of their tensor-core tile
products and the tile plan of their wrapper, on the CPU.

K1 and K5 run float32-accurate products as 3xTF32 (``csrc/tf32x3.cuh``):
each operand is split as a = hi + lo with hi = tf32(a) rounded to nearest,
ties away from zero (the rounding of ``cvt.rna.tf32.f32``, done on the
integer bits), and lo = a - hi, which the tensor core reads as TF32 by
dropping its 13 low mantissa bits; the product is hi*hi + hi*lo + lo*hi,
summed one ring chunk (32 steps of K) at a time into float32. The emulation
here does the same on int32 views and shows, at the flagship widths and the
input scales of ``chip_smoke.py``, why the split is needed (a single TF32
product misses the 1e-4 tolerance) and why the tolerances need not move
(3xTF32 lands within 1e-5 of a float64 product). The kernels themselves
run only on the card, where ``chip_smoke.py`` holds them against their
plain versions.
"""

import math

import numpy as np
import pytest
import torch

from speech_editing_tpu_torch.ops.cuda.diffnet_block import (_MIN_GRID, _check_aligned,
                                                             _tile_plan)
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

C, H = 256, 192      # the flagship DiffNet widths the kernels are compiled for
CHUNK = 32           # steps of K a chunk sums before joining the float32 sum


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """To nearest TF32, ties away from zero, on the int32 view (the kernel's
    to_tf32)."""
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncate(a: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 operand: its 13 low mantissa
    bits dropped."""
    return (a.view(torch.int32) & -0x2000).view(torch.float32)


def split(a: torch.Tensor):
    hi = tf32_round(a)
    return hi, tf32_truncate(a - hi)


def product_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] as the kernels compute it: per chunk of K, the
    three TF32 products (exact, as the tensor core forms them) summed, then
    added to the float32 running sum."""
    (ah, al), (bh, bl) = split(a), split(b)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], CHUNK):
        s = slice(k, k + CHUNK)
        part = (al[:, s].double() @ bh[s].double() + ah[:, s].double() @ bl[s].double()
                + ah[:, s].double() @ bh[s].double())
        acc = acc + part.float()
    return acc


def product_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product, float32 result."""
    return (tf32_round(a).double() @ tf32_round(b).double()).float()


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref).abs().max() / ref.abs().max())


def test_tf32_round_is_nearest_ties_away():
    """The integer form equals rounding the significand to 11 bits, to
    nearest with ties away from zero, for random values over many binades
    and for exact ties."""
    rs = np.random.RandomState(0)
    x = (rs.randn(20000) * np.exp2(rs.randint(-30, 30, 20000))).astype(np.float32)
    ties = ((np.arange(1, 2001) * 2 + 1) * np.exp2(-12.0)).astype(np.float32)  # m + 1/2 ulp
    x = np.concatenate([x, ties, -ties, [0.0, -0.0, 1.0, -1.0]]).astype(np.float32)
    mant, exp = np.frexp(x.astype(np.float64))
    q = mant * 2.0 ** 11
    want = np.sign(q) * np.floor(np.abs(q) + 0.5) * np.exp2(exp - 11.0)
    got = tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_split_is_exact():
    """hi + lo is a exactly, hi has no bits below TF32, and lo as the
    tensor core reads it is within 2^-21 of a."""
    a = torch.from_numpy(np.random.RandomState(1).randn(4096).astype(np.float32))
    hi = tf32_round(a)
    lo = a - hi
    assert torch.equal(hi + lo, a)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((hi + tf32_truncate(lo)) - a).abs().div(a.abs()).max()) <= 2.0 ** -21


def _k1_operands(rs, m=256):
    """K1's products stacked: [y(t-d) | y(t) | y(t+d) | cond | g] against
    [Wd; Wc; Wo], K = 3C + H + C = 1216, at chip_smoke.py's scales."""
    y = rs.randn(m, 3 * C) + rs.randn(1, 3 * C) * 0.3
    a = np.concatenate([y, rs.randn(m, H) * 0.5, np.tanh(rs.randn(m, C))], axis=1)
    return a, rs.randn(3 * C + H + C, 2 * C) * 0.05


def _k5_operands(rs, m=256):
    """K5's first product: do = [dx'/sqrt(2) | dskip] against Wo^T, K = 2C."""
    a = np.concatenate([rs.randn(m, C) / math.sqrt(2.0), rs.randn(m, C)], axis=1)
    return a, rs.randn(2 * C, C) * 0.05


@pytest.mark.parametrize("operands", [_k1_operands, _k5_operands], ids=["k1216", "k512"])
def test_3xtf32_is_float32_accurate(operands):
    """At the flagship widths 3xTF32 lands within 1e-5 of a float64 product
    (relative to its largest magnitude), while one TF32 product misses the
    kernels' 1e-4 tolerance."""
    a, b = (torch.from_numpy(v.astype(np.float32)) for v in operands(np.random.RandomState(2)))
    ref = a.double() @ b.double()
    assert rel_err(product_3xtf32(a, b), ref) <= 1e-5
    assert rel_err(product_tf32(a, b), ref) > 1e-4


SHAPES = [(78, 512), (4, 512), (2, 512), (1, 300), (1, 512), (1, 700)]


def _rows_once(t: int, m: int) -> bool:
    """Every one of t rows falls in exactly one tile of m rows."""
    hits = np.zeros(t, int)
    for i in range(-(-t // m)):
        hits[i * m:(i + 1) * m] += 1
    return bool((hits == 1).all())


@pytest.mark.parametrize("b,t", SHAPES)
def test_tile_plan(b, t):
    """Every row falls in exactly one tile; the grid has at least _MIN_GRID
    CTAs, except at 1 x 300, where 19 tiles of 16 rows take the largest
    cluster split. 64-row tiles at the train shape; at B=2 (the train
    step's CPU re-run) 64 tiles of 16 rows take a cluster of 2."""
    m, cluster = _tile_plan(b, t)
    tiles = -(-t // m)
    assert _rows_once(t, m)
    assert m in (16, 64) and cluster in (1, 2, 4)
    assert cluster == 1 or m == 16
    if (b, t) == (1, 300):
        assert (m, cluster, b * tiles) == (16, 4, 19)
    else:
        assert b * tiles * cluster >= _MIN_GRID
    if (b, t) == (78, 512):
        assert (m, cluster) == (64, 1)
    if (b, t) == (2, 512):
        assert (m, cluster, b * tiles) == (16, 2, 64)


@pytest.mark.parametrize("b,t", SHAPES + [(16, 512)])
def test_tile_plan_without_room_for_64_rows(b, t):
    """Where 64-row tiles do not fit in shared memory (a wide dilation's
    halo, as the kernel's library reports it) the plan takes 16-row tiles,
    with the same row cover and a cluster only where those leave the card
    short."""
    m, cluster = _tile_plan(b, t, fits64=False)
    tiles = b * -(-t // 16)
    assert m == 16 and _rows_once(t, m)
    assert cluster == next((k for k in (1, 2, 4) if tiles * k >= _MIN_GRID), 4)


@pytest.mark.parametrize("b,t", SHAPES)
def test_tile_plan_at_128_channels(b, t):
    """At C=128 a cluster of 16-row tiles holds at most 2 CTAs, so that each
    keeps a whole chunk of 64 gate columns; 64-row tiles as at C=256."""
    m, cluster = _tile_plan(b, t, c=128)
    m256, cluster256 = _tile_plan(b, t)
    assert m == m256 and cluster == min(cluster256, 2)
    assert 128 // cluster % 64 == 0


def test_unaligned_tensor_is_refused():
    """The kernels move 16-byte vectors, so a view off that alignment is
    refused before any launch."""
    x = torch.zeros(65)
    _check_aligned(x=x[4:])
    with pytest.raises(ValueError, match="x: not 16-byte aligned"):
        _check_aligned(x=x[1:])
