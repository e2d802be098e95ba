"""PyTorch port, kernels K1 and K5 in bf16: the tile arithmetic of their
CUDA sources (``csrc/diffnet_block{,_bwd}.cu``, namespace ``bf16_form``;
``csrc/diffnet_bf16.cuh``), emulated on the CPU.

Both kernels run their products as wgmma pairs with A from registers and
B from a ring of weight tiles that TMA fills: 64-byte-swizzled 32-element
atoms, MN-major for K1's Wd, Wc and Wo ([K, 2C], N contiguous: 64 k rows
an atom), K-major for K5's Wo^T and Wd^T (read from Wo and Wd, k
contiguous: N rows an atom). The emulation writes a weight stage the way
the producer's TMA boxes do (box coordinates, destination offsets, the
swizzle applied to the address) and reads it back the way the wgmma
descriptors do (PTX ISA canonical layouts), and shows that each k16 step
multiplies exactly the weights the pair needs. It rebuilds the A fragments
that ``load_a`` (ldmatrix.x4) loads from the padded activation rows at the
conv taps' row offsets, and shows that they come out whole and that each
matrix's eight row reads fall on distinct banks. It then replays both
kernels' tile loops (64-row tiles, 64-row ring stages in order, the
split cluster's exchange of g, the shared cluster's padding CTAs, K5's
whole or per-tap dh window), in float32 with the kernels' bf16 roundings,
against the bf16 plain versions. The kernels themselves run only on the
card, where ``chip_smoke.py`` holds them against those plain versions.
"""

import math

import numpy as np
import pytest
import torch

from speech_editing_tpu_torch.ops.cuda.diffnet_block import (_MIN_GRID, _plain_bf16,
                                                             _tile_plan_bf16,
                                                             diffnet_block_bwd_plain)
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

BF = torch.bfloat16
BF16_TOL = 2.0 ** -6       # chip_smoke.py's bar: two bf16 ulps of the largest element
BK, ROWS = 64, 64          # k rows of a ring stage; time rows of a tile
RSQRT2 = 1.0 / math.sqrt(2.0)
LANE = np.arange(32)
G, T4 = LANE >> 2, LANE & 3


# -- weight tiles: TMA boxes in, wgmma descriptors out ---------------------------

def swizzle64(addr):
    """The 64-byte swizzle of TMA's SWIZZLE_64B and the descriptors' layout
    type 2: address bits 4-5 XOR bits 7-8 (tiles 1024-byte aligned)."""
    return addr ^ (((addr >> 7) & 3) << 4)


def tma_box(smem, dst, w, c0, c1, box_rows):
    """A box of 32 columns by box_rows rows of the row-major matrix w at
    (column c0, row c1), landed at byte dst: row r at dst + 64 r, element
    c two bytes apiece, swizzled. smem holds one value per two bytes."""
    r, c = np.meshgrid(np.arange(box_rows), np.arange(32), indexing="ij")
    addr = swizzle64(dst + 64 * r + 2 * c)
    assert np.isnan(smem[addr // 2]).all(), "a box overwrote another's bytes"
    smem[addr // 2] = w[c1 + r, c0 + c]


def mnmajor(start, k, n, lbo=4096, sbo=512):
    """Where wgmma reads element (k, n) of an MN-major B (k < 16 of one
    step): ((8, 4, m), (8, 2)) : ((2 B, 16 B, LBO), (64 B, SBO))."""
    return swizzle64(start + n % 8 * 2 + n % 32 // 8 * 16 + n // 32 * lbo + k % 8 * 64 + k // 8 * sbo)


def kmajor(start, n, k, sbo=512):
    """Where wgmma reads element (n, k) of a K-major B: ((8, m), (8, 2)) :
    ((64 B, SBO), (2 B, 16 B))."""
    return swizzle64(start + n // 8 * sbo + n % 8 * 64 + k // 8 * 16 + k % 8 * 2)


def k1_stage(w, k0, col0, c, nc):
    """A K1 ring stage as the producer fills it: box j = 2 halves x nc / 32
    atoms, columns half * C + col0 + 32 atom of rows [k0, k0 + 64), at
    half * (nc * 128) + 4096 atom."""
    atoms, tile = nc // 32, nc * 128
    smem = np.full(2 * tile // 2, np.nan)
    for j in range(2 * atoms):
        tma_box(smem, j // atoms * tile + j % atoms * 4096, w, j // atoms * c + col0 + j % atoms * 32,
                k0, BK)
    return smem, tile


def k5_stage(w, k0, row0, n_rows):
    """A K5 ring stage: box j = 2 halves x 2 atoms, k columns k0 + 32 atom
    of rows row0 + half * N, at half * (N * 128) + atom * (N * 64)."""
    tile = n_rows * 128
    smem = np.full(2 * tile // 2, np.nan)
    for j in range(4):
        tma_box(smem, j // 2 * tile + j % 2 * n_rows * 64, w, k0 + j % 2 * 32,
                row0 + j // 2 * n_rows, n_rows)
    return smem, tile


@pytest.mark.parametrize("c, h, nc, split", [(256, 192, 128, 1), (256, 192, 64, 4),
                                             (256, 256, 128, 2), (128, 192, 128, 1),
                                             (128, 256, 64, 2)])
def test_k1_descriptors_read_the_pairs_weights(c, h, nc, split):
    """Every stage of K1's both products, as TMA fills it (Wd, Wc, Wo
    MN-major, each CTA of a split its columns), read through desc_mn (row
    16 s, LBO 4096, SBO 512) gives the lo tile W[k0 + k, n] and the hi tile
    W[k0 + k, C + n] over the CTA's chunk of gate columns."""
    rs = np.random.RandomState(c + h + nc)
    wd, wc, wo = (rs.randn(k, 2 * c) for k in (3 * c, h, c))
    k, n = np.meshgrid(np.arange(16), np.arange(nc), indexing="ij")
    cq = c // split
    for crank in {0, split - 1}:
        for chunk in range(cq // nc):
            col0 = crank * cq + chunk * nc
            stages = [(wd, k0) for k0 in range(0, 3 * c, BK)] + [(wc, k0) for k0 in range(0, h, BK)]
            stages += [(wo, k0) for k0 in range(0, c, BK)]
            for w, k0 in stages:
                smem, tile = k1_stage(w, k0, col0, c, nc)
                assert not np.isnan(smem).any()
                for half in (0, 1):
                    for s in range(BK // 16):
                        got = smem[mnmajor(half * tile + 1024 * s, k, n) // 2]
                        want = w[k0 + 16 * s + k, half * c + col0 + n]
                        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", [128, 256])
def test_k5_descriptors_read_the_transposed_weights(c):
    """K5's stages, Wo's and Wd's rows as K-major tiles of N = C/2 rows
    (atoms N * 64 bytes apart), read through desc_k (atom s / 2, 32 (s % 2)
    bytes in, SBO 512) give B[k, n] = W[row0 + n, k0 + k] for both halves
    of the pair: dg = do @ Wo^T and each tap's dh @ Wd[tap C + n]^T."""
    rs = np.random.RandomState(c)
    wo, wd = rs.randn(c, 2 * c), rs.randn(3 * c, 2 * c)
    n_rows = c // 2
    n, k = np.meshgrid(np.arange(n_rows), np.arange(16), indexing="ij")
    stages = [(wo, k0, 0) for k0 in range(0, 2 * c, BK)]
    stages += [(wd, k0, tap * c) for tap in range(3) for k0 in range(0, 2 * c, BK)]
    for w, k0, row0 in stages:
        smem, tile = k5_stage(w, k0, row0, n_rows)
        assert not np.isnan(smem).any()
        for half in (0, 1):
            for s in range(BK // 16):
                start = half * tile + s // 2 * n_rows * 64 + s % 2 * 32
                got = smem[kmajor(start, n, k) // 2]
                np.testing.assert_array_equal(got, w[row0 + half * n_rows + n, k0 + 16 * s + k])


# -- A fragments: ldmatrix.x4 at a row offset ------------------------------------

def ldmatrix_a(ld, base):
    """load_a: lane l addresses row (l / 8 % 2) * 8 + l % 8, column (l / 16)
    * 8 from element `base`; register j of lane 4g + t holds row g, columns
    2t, 2t + 1 of matrix j. Returns each lane's four registers' element
    offsets [32, 4, 2] and each matrix's row addresses [4, 8]."""
    m = LANE >> 3
    rows = base + ((m & 1) * 8 + (LANE & 7)) * ld + (m >> 1) * 8
    regs = np.stack([np.stack([rows[8 * j + G] + 2 * T4, rows[8 * j + G] + 2 * T4 + 1], 1)
                     for j in range(4)], 1)
    return regs, rows.reshape(4, 8)


@pytest.mark.parametrize("ld", [128 + 8, 192 + 8, 256 + 8, 2 * 128 + 8, 2 * 256 + 8])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_a_fragments_at_the_taps_row_offsets(ld, d):
    """For each warp of the warpgroup and each tap's row offset (0, d, 2d;
    K1's y window, cond and g, K5's do and dh window), the registers load_a
    fills are the wgmma A fragment of the 16 x 16 step (a0: row g, k 2t; a1:
    g + 8; a2: k + 8; a3: both), every element once; and each matrix's
    eight row reads of 16 bytes fall in eight distinct bank groups."""
    for warp in range(4):
        for offset in (0, d, 2 * d):
            for k0 in (0, 16, ld - 8 - 16):
                base = (offset + 16 * warp) * ld + k0
                regs, rows = ldmatrix_a(ld, base)
                r0 = offset + 16 * warp
                want_row = np.stack([G, G + 8, G, G + 8], 1)[..., None] + r0
                want_col = np.stack([2 * T4, 2 * T4, 2 * T4 + 8, 2 * T4 + 8], 1)[..., None] + k0
                want = want_row * ld + want_col + np.arange(2)
                np.testing.assert_array_equal(regs, want)
                assert len(np.unique(regs)) == 256
                for matrix in rows:
                    assert len({a * 2 // 16 % 8 for a in matrix}) == 8


def quad_gather(regs):
    """diffnet_bf16.cuh::quad_gather on every lane: regs [32, 4], lane 4g +
    t's r[k]. At step s lane t reads, from lane (t + s) % 4 of its quad, that
    lane's r[(its t - s) % 4], into o[(t + s) % 4]."""
    out = np.zeros_like(regs)
    for s in range(4):
        sent = regs[LANE, (T4 - s) % 4]
        src = (LANE & ~3) | ((T4 + s) % 4)
        out[LANE, (T4 + s) % 4] = sent[src]
    return out


def test_quad_gather_gives_each_lane_eight_consecutive_columns():
    """The epilogues' stores: lane t of each quad holds, in r[k], the pair
    of columns 8k + 2t of four accumulator tiles (as column numbers here);
    after the exchange its four registers are columns 8t .. 8t + 7 in
    order, one 16-byte store, and the quad's stores cover the 32 columns."""
    cols = np.stack([8 * k + 2 * T4 for k in range(4)], 1)      # each pair's first column
    got = quad_gather(cols)
    np.testing.assert_array_equal(got, 8 * T4[:, None] + 2 * np.arange(4)[None])
    for g in range(8):
        assert sorted(got[4 * g:4 * g + 4].ravel()) == list(range(0, 32, 2))


# -- the tile loops --------------------------------------------------------------

def window_time(w, t0, d, m=ROWS):
    """tf32x3.cuh::window_time: the time of window row w."""
    return t0 - d + w if d <= m else t0 + (w // m - 1) * d + w % m


def rows_at(x, b, times):
    """x[b, t] where 0 <= t < T, zero elsewhere ([len(times), ...])."""
    t_len = x.shape[1]
    out = torch.zeros(len(times), *x.shape[2:])
    for i, t in enumerate(times):
        if 0 <= t < t_len:
            out[i] = x[b, t].float()
    return out


def bf(v):
    return v.to(BF).float()


def k1_replay(x, cond, step, mask, wd, bd, wc, bc, wo, bo, d, split, share, nc):
    """K1's bf16 form over its grid: 64-row tiles, the first product's
    stages (three taps of the y window, then cond) and the second's, each
    a pair of nc columns summed stage by stage in f32; a split cluster's
    CTAs each a C / split share of g, exchanged before the second product;
    a shared cluster's padding CTAs (past the last tile) write nothing.
    Returns x', skip, h (bf16) and how often each row was written."""
    b_n, t_len, c = x.shape
    h_n = cond.shape[-1]
    per_b = -(-t_len // ROWS)
    tiles = b_n * per_b
    grid = tiles * split if split > 1 else -(-tiles // share) * share
    span = min(d, ROWS)
    outs = [torch.zeros(b_n, t_len, c, dtype=BF), torch.zeros(b_n, t_len, c, dtype=BF),
            torch.zeros(b_n, t_len, 2 * c, dtype=BF)]
    writes = torch.zeros(b_n, t_len, dtype=torch.int64)
    wdf, wcf, wof = wd.float(), wc.float(), wo.float()
    bias = (bd + bc).float()
    cq = c // split
    for tile in range(grid // split):
        if tile >= tiles:
            continue          # a padding CTA: its loads and releases only
        b, t0 = tile // per_b, tile % per_b * ROWS
        times = [window_time(w, t0, d) for w in range(ROWS + 2 * span)]
        y = rows_at(x, b, times) + step[b].float()
        m = rows_at(mask[..., None], b, times)
        y = bf(y) * m          # masked rows are zero; rows outside [0, T) too
        y[[not 0 <= t < t_len for t in times]] = 0
        cs = rows_at(cond, b, range(t0, t0 + ROWS))
        live = torch.tensor([t0 + r < t_len for r in range(ROWS)])
        g = torch.zeros(ROWS, c)
        for crank in range(split):
            for n0 in range(crank * cq, crank * cq + cq, nc):
                cols = torch.arange(n0, n0 + nc)
                lo, hi = torch.zeros(ROWS, nc), torch.zeros(ROWS, nc)
                for k0 in range(0, 3 * c + h_n, BK):
                    if k0 < 3 * c:
                        tap = k0 // c
                        a = y[tap * span:tap * span + ROWS, k0 - tap * c:k0 - tap * c + BK]
                        w = wdf[k0:k0 + BK]
                    else:
                        a, w = cs[:, k0 - 3 * c:k0 - 3 * c + BK], wcf[k0 - 3 * c:k0 - 3 * c + BK]
                    lo += a @ w[:, cols]
                    hi += a @ w[:, c + cols]
                ha, hb = lo + bias[cols], hi + bias[c + cols]
                g[:, cols] = bf(torch.sigmoid(ha) * torch.tanh(hb))
                rows = torch.arange(t0, t0 + ROWS)[live]
                outs[2][b, rows[:, None], cols] = ha[live].to(BF)
                outs[2][b, rows[:, None], c + cols] = hb[live].to(BF)
        # the split's exchange: every CTA now holds all of g
        for crank in range(split):
            for n0 in range(crank * cq, crank * cq + cq, nc):
                cols = torch.arange(n0, n0 + nc)
                lo, hi = torch.zeros(ROWS, nc), torch.zeros(ROWS, nc)
                for k0 in range(0, c, BK):
                    lo += g[:, k0:k0 + BK] @ wof[k0:k0 + BK, cols]
                    hi += g[:, k0:k0 + BK] @ wof[k0:k0 + BK, c + cols]
                rows = torch.arange(t0, t0 + ROWS)[live]
                xv = x[b, rows].float()[:, cols]
                outs[0][b, rows[:, None], cols] = ((xv + (lo[live] + bo[cols].float()))
                                                   * RSQRT2).to(BF)
                outs[1][b, rows[:, None], cols] = (hi[live] + bo[c + cols].float()).to(BF)
        writes[b, t0:t0 + ROWS] += 1
    return (*outs, writes)


def block_inputs(seed, b, t, c, h, lengths):
    rs = np.random.RandomState(seed)
    r = lambda *s, scale=1.0: torch.tensor(rs.randn(*s) * scale, dtype=torch.float32).to(BF)
    mask = torch.tensor(np.arange(t)[None] < np.array(lengths)[:, None], dtype=BF)
    return (r(b, t, c), r(b, t, h, scale=0.5), r(b, c, scale=0.3), mask,
            r(3 * c, 2 * c, scale=0.05), r(2 * c, scale=0.1), r(h, 2 * c, scale=0.05),
            r(2 * c, scale=0.1), r(c, 2 * c, scale=0.05), r(2 * c, scale=0.1))


def rel(got, ref):
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


K1_CASES = {   # name: (B, T, lengths, dilation, split, share, C, nc)
    "shared": (3, 130, [130, 100, 71], 1, 1, 4, 128, 128),    # 9 tiles, 3 padding CTAs
    "split 2": (1, 90, [90], 2, 2, 1, 128, 64),
    "split 4": (2, 70, [70, 33], 3, 4, 1, 256, 64),
    "wide dilation": (2, 100, [100, 64], 70, 1, 2, 128, 64),  # three 64-row blocks
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_tile_loop_matches_the_plain_version(case):
    """K1's tiles, stages, cluster split or padding give _plain_bf16 within
    BF16_TOL of each output's largest element, every row written once."""
    b, t, lengths, d, split, share, c, nc = K1_CASES[case]
    h = 192
    args = block_inputs(b + t + d, b, t, c, h, lengths)
    *got, writes = k1_replay(*args, d, split, share, nc)
    ref = _plain_bf16(*args, d, True)
    assert (writes == 1).all()
    for name, g, r in zip(("x'", "skip", "h"), got, ref):
        assert rel(g, r) <= BF16_TOL, name


def k5_replay(h, dxo, dsk, mask, wd, wo, d, share, whole):
    """K5's bf16 form: the gate pass (do = [bf16(dx' / sqrt 2) | dskip],
    one pair over Wo's rows, 8 stages) writing dh and g, then the scatter
    pass (24 stages, tap-major; A from the dh window at the tap's row
    offset when ``whole``, else from the 64 rows each tap restages); a
    shared cluster's padding CTAs write nothing. Returns dx, dh, g and the
    rows written by each pass."""
    b_n, t_len, c = dxo.shape
    n_half = c // 2
    per_b = -(-t_len // ROWS)
    tiles = b_n * per_b
    span = min(d, ROWS)
    dx, g = torch.zeros(b_n, t_len, c, dtype=BF), torch.zeros(b_n, t_len, c, dtype=BF)
    dh = torch.zeros(b_n, t_len, 2 * c, dtype=BF)
    writes = torch.zeros(2, b_n, t_len, dtype=torch.int64)
    wof, wdf = wo.float(), wd.float()
    for tile in range(-(-tiles // share) * share):
        if tile >= tiles:
            continue
        b, t0 = tile // per_b, tile % per_b * ROWS
        rows = [t for t in range(t0, t0 + ROWS) if t < t_len]
        do = torch.cat([bf(rows_at(dxo, b, range(t0, t0 + ROWS)) * RSQRT2),
                        rows_at(dsk, b, range(t0, t0 + ROWS))], 1)
        lo, hi = torch.zeros(ROWS, n_half), torch.zeros(ROWS, n_half)
        for k0 in range(0, 2 * c, BK):
            lo += do[:, k0:k0 + BK] @ wof[:n_half, k0:k0 + BK].T
            hi += do[:, k0:k0 + BK] @ wof[n_half:, k0:k0 + BK].T
        dg = torch.cat([lo, hi], 1)[:len(rows)]
        hf = h[b, rows].float()
        s, th = torch.sigmoid(hf[:, :c]), torch.tanh(hf[:, c:])
        g[b, rows] = (s * th).to(BF)
        dh[b, rows] = torch.cat([dg * th * s * (1 - s), dg * s * (1 - th * th)], 1).to(BF)
        writes[0, b, rows] += 1
    for tile in range(-(-tiles // share) * share):
        if tile >= tiles:
            continue
        b, t0 = tile // per_b, tile % per_b * ROWS
        rows = [t for t in range(t0, t0 + ROWS) if t < t_len]
        if whole:
            win = rows_at(dh, b, [window_time(w, t0, d) for w in range(ROWS + 2 * span)])
        lo, hi = torch.zeros(ROWS, n_half), torch.zeros(ROWS, n_half)
        for tap in range(3):
            a_all = (win[(2 - tap) * span:(2 - tap) * span + ROWS] if whole
                     else rows_at(dh, b, range(t0 + (1 - tap) * d, t0 + (1 - tap) * d + ROWS)))
            for k0 in range(0, 2 * c, BK):
                a = a_all[:, k0:k0 + BK]
                lo += a @ wdf[tap * c:tap * c + n_half, k0:k0 + BK].T
                hi += a @ wdf[tap * c + n_half:tap * c + c, k0:k0 + BK].T
        dy = torch.cat([lo, hi], 1)[:len(rows)]
        keep = mask[b, rows].float()[:, None]
        dx[b, rows] = (dy * keep + dxo[b, rows].float() * RSQRT2).to(BF)
        writes[1, b, rows] += 1
    return dx, dh, g, writes


K5_CASES = {   # name: (B, T, lengths, dilation, share)
    "one tile": (1, 50, [50], 1, 1),
    "shared": (3, 130, [130, 100, 71], 2, 4),
    "wide dilation": (2, 100, [100, 64], 70, 2),
}


@pytest.mark.parametrize("whole", [True, False])
@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_k5_tile_loops_match_the_plain_backward(case, whole):
    """K5's two passes, with the dh window staged whole or a tap at a time,
    give diffnet_block_bwd_plain within BF16_TOL of each output's largest
    element, every row written once by each pass."""
    b, t, lengths, d, share = K5_CASES[case]
    c = 128
    x, cond, step, mask, wd, bd, wc, bc, wo, bo = block_inputs(b + t + d, b, t, c, 192, lengths)
    h = _plain_bf16(x, cond, step, mask, wd, bd, wc, bc, wo, bo, d, True)[2]
    rs = np.random.RandomState(t)
    dxo, dsk = (torch.tensor(rs.randn(b, t, c), dtype=torch.float32).to(BF) for _ in range(2))
    *got, writes = k5_replay(h, dxo, dsk, mask, wd, wo, d, share, whole)
    ref = diffnet_block_bwd_plain(h, dxo, dsk, mask, wd, wo, d)
    assert (writes == 1).all()
    for name, g, r in zip(("dx", "dh", "g"), got, ref):
        assert rel(g, r) <= BF16_TOL, name


@pytest.mark.parametrize("b, t, c, split_ok, plan", [
    (16, 446, 256, True, (1, 4)),      # the bf16 run step: 112 tiles share weights
    (78, 512, 256, True, (1, 2)),      # the bf16 flagship step: more than a wave
    (1, 512, 256, True, (4, 1)),       # the edit's lengths: 8 tiles, a split of 4
    (1, 300, 128, True, (2, 1)),       # at C=128 at most two CTAs of 64 columns
    (2, 446, 256, True, (4, 1)),       # the card-vs-CPU steps
    (4, 509, 256, True, (4, 1)),
    (4, 509, 256, False, (1, 4)),      # K5: shares only
    (1, 50, 256, False, (1, 1)),
    (1, 100, 256, False, (1, 2)),
])
def test_bf16_tile_plan(b, t, c, split_ok, plan):
    """_tile_plan_bf16: shared clusters from _MIN_GRID / 2 tiles up (and
    always for K5), 4 CTAs within one wave and 2 past it; else K1 splits
    its gate columns until the grid reaches _MIN_GRID or each CTA holds 64
    of them."""
    assert _tile_plan_bf16(b, t, c, split_ok) == plan
    split, share = plan
    tiles = b * -(-t // 64)
    assert split == 1 or (tiles < _MIN_GRID // 2 and c // split >= 64)
