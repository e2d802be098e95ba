"""PyTorch port, kernels K3 and K4: the tile arithmetic of their CUDA
sources, emulated on the CPU. The float32 forms first, then the bf16 forms
(``wgmma``, ``csrc/wgmma.cuh``).

Both kernels run their products as mma.sync m16n8k8 fragments
(``csrc/tf32x3.cuh``); K3 feeds P from accumulator registers to P V, and K4
reads transposed operands from shared memory, both through fragments whose
k index is permuted within each k8 step. The emulation here rebuilds the
fragments lane by lane with the header's index formulas and the PTX layout
of the instruction, and shows that the products come out whole and that
the loads the design relies on hit 32 distinct banks at the row strides the
kernels use. It then replays, in float64, K3's per-warp online softmax and
merge and K4's split into key-tile and query-tile CTAs, with the same tile
sizes, against the plain versions. The kernels themselves run only on the
card, where ``chip_smoke.py`` holds them against those plain versions.

The bf16 forms read their operands from 64-byte-swizzled shared-memory
tiles through wgmma descriptors. The emulation computes where the
descriptors' canonical layouts (PTX ISA: K-major ((8,m),(8,2)) and MN-major
((8,4,m),(8,2)) in bf16 elements) put each element of each k16 step, with
the hardware's swizzle applied to the address, and shows that it is where
``Tile<DP>::chunk`` stored it. It then replays the bf16 kernels' tile
loops, all-pad key tiles skipped, in float32 with their bf16 roundings,
against the bf16 plain versions.
"""

import numpy as np
import pytest
import torch

from speech_editing_tpu_torch.ops.flash_attention import (attention_bwd_plain,
                                                          attention_lse_plain, attention_plain)
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

LANE = np.arange(32)
G, T4 = LANE >> 2, LANE & 3      # lane = 4 g + t
LDP = 68                         # K4's P and dS row stride (TILE + 4)


def row_ld(ndt: int) -> int:
    """Both kernels' row stride for a [rows][8 ndt] tile."""
    return (ndt * 8 + 31) // 32 * 32 + 4


def mma(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """mma.sync.m16n8k8 on fragments (PTX ISA layout): a [32, 4], b [32, 2]
    per lane -> the accumulator fragment c [32, 4]."""
    am, bm = np.zeros((16, 8)), np.zeros((8, 8))
    am[G, T4], am[G + 8, T4], am[G, T4 + 4], am[G + 8, T4 + 4] = a.T
    bm[T4, G], bm[T4 + 4, G] = b.T
    c = am @ bm
    return np.stack([c[G, 2 * T4], c[G, 2 * T4 + 1], c[G + 8, 2 * T4], c[G + 8, 2 * T4 + 1]], 1)


# the header's fragment loads: word offsets of each lane's registers
def load_a(ld):          # row-major A
    return np.stack([G * ld + T4, (G + 8) * ld + T4, G * ld + T4 + 4, (G + 8) * ld + T4 + 4], 1)


def load_b_nmajor(ld):   # load_b<false>: b[n * ld + k]
    return np.stack([G * ld + T4, G * ld + T4 + 4], 1)


def load_a_kp(ld):       # row-major A, k permuted
    return np.stack([G * ld + 2 * T4, (G + 8) * ld + 2 * T4, G * ld + 2 * T4 + 1,
                     (G + 8) * ld + 2 * T4 + 1], 1)


def load_at_kp(ld):      # A stored k-major, k permuted
    return np.stack([2 * T4 * ld + G, 2 * T4 * ld + G + 8, (2 * T4 + 1) * ld + G,
                     (2 * T4 + 1) * ld + G + 8], 1)


def load_b_kp(ld):       # B stored k-major, k permuted
    return np.stack([2 * T4 * ld + G, (2 * T4 + 1) * ld + G], 1)


def a_from_acc(c):
    return c[:, [0, 2, 1, 3]]


def smem(mat: np.ndarray, ld: int) -> np.ndarray:
    """mat [rows, cols] laid out with row stride ld, as a flat array."""
    out = np.zeros(mat.shape[0] * ld)
    for r in range(mat.shape[0]):
        out[r * ld:r * ld + mat.shape[1]] = mat[r]
    return out


def product(a_buf, a_load, a_step, b_buf, b_load, b_step, k: int, lda, ldb) -> np.ndarray:
    """An m16 x n8 tile summed over k8 steps; a_step/b_step: the word offset
    of step kk in each buffer."""
    acc = np.zeros((32, 4))
    for kk in range(0, k, 8):
        acc += mma(a_buf[a_step(kk) + a_load(lda)], b_buf[b_step(kk) + b_load(ldb)])
    return acc


def tile(c: np.ndarray) -> np.ndarray:
    """The m16 x n8 matrix an accumulator fragment holds."""
    out = np.zeros((16, 8))
    out[G, 2 * T4], out[G, 2 * T4 + 1], out[G + 8, 2 * T4], out[G + 8, 2 * T4 + 1] = c.T
    return out


@pytest.mark.parametrize("ndt", [4, 12])
def test_k_permuted_fragments_give_the_product(ndt):
    """Row-major A (dQ = dS K's dS) and transposed A (dV = P^T dO's P) with
    k-major B, all k-permuted, give A B; so does the plain pair of S = Q K^T
    (row-major A, n-major B)."""
    rs = np.random.RandomState(ndt)
    ld, k = row_ld(ndt), 8 * ndt
    a, b = rs.randn(16, k), rs.randn(k, 8)
    got = product(smem(a, ld), load_a_kp, lambda kk: kk, smem(b, ld), load_b_kp,
                  lambda kk: kk * ld, k, ld, ld)
    np.testing.assert_allclose(tile(got), a @ b, rtol=1e-12)
    got = product(smem(a.T, LDP), load_at_kp, lambda kk: kk * LDP, smem(b, ld), load_b_kp,
                  lambda kk: kk * ld, k, LDP, ld)
    np.testing.assert_allclose(tile(got), a @ b, rtol=1e-12)
    got = product(smem(a, ld), load_a, lambda kk: kk, smem(b.T, ld), load_b_nmajor,
                  lambda kk: kk, k, ld, ld)
    np.testing.assert_allclose(tile(got), a @ b, rtol=1e-12)


def test_accumulator_feeds_the_next_product():
    """K3: the fragments of S = Q K^T over an n8 key tile, reordered by
    a_from_acc, are the A operand of P V against V's k-permuted rows."""
    rs = np.random.RandomState(1)
    ld = row_ld(12)
    q, k, v = rs.randn(16, 96), rs.randn(8, 96), rs.randn(8, 96)
    s = product(smem(q, ld), load_a, lambda kk: kk, smem(k, ld), load_b_nmajor,
                lambda kk: kk, 96, ld, ld)
    v_buf = smem(v, ld)
    for nt in range(12):   # the output's n8 column tiles
        o = mma(a_from_acc(s), v_buf[nt * 8 + load_b_kp(ld)])
        np.testing.assert_allclose(tile(o), (q @ k.T) @ v[:, nt * 8:nt * 8 + 8], rtol=1e-10)


@pytest.mark.parametrize("ndt", [4, 8, 12, 16])
def test_fragment_loads_hit_distinct_banks(ndt):
    """Every register of every lane's fragment load falls on its own bank
    (word offset mod 32) at the staged tiles' stride, 4 mod 32, and at P and
    dS's 68: load_a and the n-major load_b (S, dP), the k-permuted k-major
    load_b (P V, dV, dK, dQ), and the transposed A of dV and dK."""
    ld = row_ld(ndt)
    assert ld % 32 == 4 and ld >= 8 * ndt
    for offsets in (load_a(ld), load_b_nmajor(ld), load_b_kp(ld), load_at_kp(LDP)):
        for reg in offsets.T:
            assert len(set(reg % 32)) == 32


def _attention_inputs(rs, tq, tk, d, lengths):
    q = rs.randn(len(lengths), tq, 1, d) * d ** -0.5
    k, v = rs.randn(len(lengths), tk, 1, d), rs.randn(len(lengths), tk, 1, d)
    pad = np.arange(tk)[None, :] >= np.array(lengths)[:, None]
    return q, k, v, pad


def k3_cta(q, k, v, valid, nwarps=4, ktile=64):
    """K3's algorithm for one CTA (16 query rows): warp w runs an online
    softmax over n8 key tiles w and w + 4 of every 64-key tile, then the
    warps' (m, l, O) are merged. Returns out [16, d] and lse [16]."""
    tk, d = k.shape
    m = np.full((nwarps, 16), -np.inf)
    l, o = np.zeros((nwarps, 16)), np.zeros((nwarps, 16, d))
    with np.errstate(invalid="ignore", divide="ignore"):
        for k0 in range(0, tk, ktile):
            for w in range(nwarps):
                cols = [c for u in (0, 1) for c in range(k0 + 8 * (w + nwarps * u),
                                                        k0 + 8 * (w + nwarps * u) + 8)
                        if c < min(tk, k0 + ktile)]
                if not cols:
                    continue
                s = q @ k[cols].T
                s[:, ~valid[cols]] = -np.inf
                m_new = np.maximum(m[w], s.max(1))
                mu = np.where(m_new == -np.inf, 0.0, m_new)
                alpha = np.exp(m[w] - mu)
                p = np.exp(s - mu[:, None])
                l[w] = l[w] * alpha + p.sum(1)
                o[w] = o[w] * alpha[:, None] + p @ v[cols]
                m[w] = m_new
        mm = m.max(0)
        sc = np.where(mm == -np.inf, 0.0, np.exp(m - mm))
        total = (l * sc).sum(0)
        inv = np.where(total > 0, 1.0 / total, 0.0)
        out = (sc[..., None] * o).sum(0) * inv[:, None]
        lse = np.where(total > 0, mm + np.log(total), -np.inf)
    return out, lse


@pytest.mark.parametrize("tk,lengths", [(48, [48, 31, 0]), (130, [130, 100, 71]),
                                        (5, [5, 2, 0])])
def test_k3_warp_split_softmax_matches_attention(tk, lengths):
    """Per-warp online softmax and the merge give the plain attention and
    its logsumexp; a row with no valid key gives 0 and -inf."""
    rs = np.random.RandomState(tk)
    q, k, v, pad = _attention_inputs(rs, 16, tk, 36, lengths)
    ref = attention_plain(*(torch.tensor(a) for a in (q, k, v, pad))).numpy()
    for i, n in enumerate(lengths):
        out, lse = k3_cta(q[i, :, 0], k[i, :, 0], v[i, :, 0], ~pad[i])
        if n == 0:
            assert (out == 0).all() and (lse == -np.inf).all()
            continue
        np.testing.assert_allclose(out, ref[i, :, 0], rtol=1e-10, atol=1e-12)
        s = q[i, :, 0] @ k[i, :n, 0].T
        np.testing.assert_allclose(lse, np.log(np.exp(s).sum(1)), rtol=1e-12)


def _live_rows(valid: np.ndarray) -> int:
    """K4's live_rows: through the tile's last valid key, in m16 tiles."""
    last = np.nonzero(valid)[0]
    return 0 if last.size == 0 else -(-(int(last[-1]) + 1) // 16) * 16


def k4_grid(q, k, v, o, lse, do, valid, tile=64):
    """K4's split of one (b, h) into CTAs: one per key tile over every query
    tile (dK, dV; dQ too when there is one key tile), else one more per query
    tile over every key tile (dQ); each key tile's products stop at its last
    valid key. Returns dq, dk, dv and how often each element was written."""
    tq, tk = q.shape[0], k.shape[0]
    n_kv = -(-tk // tile) if tk > tile else 1
    n_q = 0 if n_kv == 1 else max(1, -(-tq // tile))
    out = {name: np.full(x.shape, np.nan) for name, x in (("dq", q), ("dk", k), ("dv", v))}
    writes = {name: np.zeros(x.shape[0], int) for name, x in (("dq", q), ("dk", k), ("dv", v))}
    di = (o * do).sum(1)

    def p_ds(i0, j0):
        qs, ks = slice(i0, min(i0 + tile, tq)), slice(j0, min(j0 + tile, tk))
        kl = _live_rows(valid[ks])
        keys = slice(j0, min(j0 + kl, tk))
        live = np.isfinite(lse[qs])[:, None] & valid[keys][None, :]
        with np.errstate(invalid="ignore"):
            p = np.where(live, np.exp(q[qs] @ k[keys].T - lse[qs][:, None]), 0.0)
        return qs, ks, keys, p, p * (do[qs] @ v[keys].T - di[qs][:, None])

    for j in range(n_kv):
        j0 = j * tile
        rows = min(tile, tk - j0)
        dk, dv = np.zeros((rows, k.shape[1])), np.zeros((rows, k.shape[1]))
        for i0 in range(0, max(tq, 1), tile):
            qs, ks, keys, p, ds = p_ds(i0, j0)
            n = keys.stop - keys.start
            dv[:n] += p.T @ do[qs]
            dk[:n] += ds.T @ q[qs]
            if n_kv == 1:
                out["dq"][qs] = ds @ k[keys]
                writes["dq"][qs] += 1
        out["dk"][j0:j0 + len(dk)], out["dv"][j0:j0 + len(dv)] = dk, dv
        writes["dk"][j0:j0 + len(dk)] += 1
        writes["dv"][j0:j0 + len(dv)] += 1
    for i in range(n_q):
        i0 = i * tile
        dq = np.zeros((min(tile, tq - i0), q.shape[1]))
        for j0 in range(0, tk, tile):
            _, _, keys, _, ds = p_ds(i0, j0)
            dq += ds @ k[keys]
        out["dq"][i0:i0 + len(dq)] = dq
        writes["dq"][i0:i0 + len(dq)] += 1
    return out, writes


@pytest.mark.parametrize("t,lengths", [(48, [48, 29, 0]), (130, [130, 100, 71, 40]),
                                       (70, [70, 65, 64])])
def test_k4_tile_split_matches_plain_backward(t, lengths):
    """Single-tile (T <= 64) and tiled (key-tile and dQ CTAs) forms, with
    products cut at each tile's last valid key: every output element is
    written once and dq, dk, dv equal the plain version's, zero for pad keys
    and for a row with no valid key."""
    rs = np.random.RandomState(t)
    q, k, v, pad = _attention_inputs(rs, t, t, 36, lengths)
    do = rs.randn(*q.shape)
    tq, tk, tv, tpad, tdo = (torch.tensor(a) for a in (q, k, v, pad, do))
    o = attention_plain(tq, tk, tv, tpad)
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk).masked_fill(tpad[:, None, None], float("-inf"))
    lse = torch.logsumexp(s, -1)
    ref = attention_bwd_plain(tq, tk, tv, o, lse, tdo, tpad)
    for i in range(len(lengths)):
        got, writes = k4_grid(q[i, :, 0], k[i, :, 0], v[i, :, 0], o[i, :, 0].numpy(),
                              lse[i, 0].numpy(), do[i, :, 0], ~pad[i])
        for name, r in zip(("dq", "dk", "dv"), ref):
            assert (writes[name] == 1).all(), name
            np.testing.assert_allclose(got[name], r[i, :, 0].numpy(), rtol=1e-10, atol=1e-12,
                                       err_msg=name)
        assert (got["dk"][pad[i]] == 0).all() and (got["dv"][pad[i]] == 0).all()


# -- the bf16 forms: wgmma tiles -----------------------------------------------

BF = torch.bfloat16
ROW_BYTES, BLOCK_BYTES = 64, 4096    # a row of a 32-column block; a 64-row block
LOG2E = 1.4426950408889634


def chunk(r: int, c: int) -> int:
    """wgmma.cuh's Tile<DP>::chunk: the byte offset of the 16 bytes holding
    columns c..c+7 (c % 8 == 0) of row r of a [64][DP] bf16 tile."""
    return (c >> 5) * BLOCK_BYTES + r * ROW_BYTES + ((((c >> 3) & 3) ^ ((r >> 1) & 3)) << 4)


def element(r: int, c: int) -> int:
    return chunk(r, c & ~7) + (c & 7) * 2


def swizzle64(addr: int) -> int:
    """The 64-byte swizzle (descriptor layout type 2): address bits 4-5 XOR
    bits 7-8, on an address whose tile starts 1024-byte aligned."""
    return addr ^ (((addr >> 7) & 3) << 4)


def kmajor(start: int, sbo: int, row: int, k: int) -> int:
    """Where wgmma reads element (row, k) of a K-major operand, k < 16 of
    one k16 step: ((8, m), (8, 2)) : ((64 B, SBO), (2 B, 16 B))."""
    return swizzle64(start + row // 8 * sbo + row % 8 * 64 + k // 8 * 16 + k % 8 * 2)


def mnmajor(start: int, lbo: int, sbo: int, k: int, n: int) -> int:
    """Where wgmma reads element (k, n) of an MN-major operand:
    ((8, 4, m), (8, 2)) : ((2 B, 16 B, LBO), (64 B, SBO))."""
    return swizzle64(start + n % 8 * 2 + n % 32 // 8 * 16 + n // 32 * lbo
                     + k % 8 * 64 + k // 8 * sbo)


@pytest.mark.parametrize("dp", [32, 64, 96, 128])
def test_wgmma_descriptors_read_what_the_tiles_hold(dp):
    """Every element of a [64][DP] tile has its own two bytes; the K-major
    descriptors of desc_k (k16 step s: block s / 2, 32 (s % 2) bytes in,
    SBO 512) and the MN-major ones of desc_mn (row 16 s, LBO 4096, SBO 512)
    address exactly the elements each step multiplies; and eight rows'
    16-byte chunks of one column fall in eight distinct bank groups."""
    offsets = {element(r, c) for r in range(64) for c in range(dp)}
    assert len(offsets) == 64 * dp and max(offsets) < 64 * dp * 2
    for s in range(dp // 16):          # Q K^T, K Q^T, dO V^T, V dO^T: the k16 steps over d
        start = s // 2 * BLOCK_BYTES + s % 2 * 32
        for row in range(64):
            for k in range(16):
                assert kmajor(start, 512, row, k) == element(row, 16 * s + k)
    for s in range(64 // 16):          # P V, P^T dO, dS^T Q, dS K: the k16 steps over rows
        for k in range(16):
            for n in range(dp):
                assert mnmajor(1024 * s, BLOCK_BYTES, 512, k, n) == element(16 * s + k, n)
    for c in range(0, dp, 8):
        assert len({chunk(r, c) % 128 // 16 for r in range(8)}) == 8


def _bf16_inputs(seed, tq, tk, d, pad):
    rs = np.random.RandomState(seed)
    q = torch.tensor(rs.randn(1, tq, 1, d) * d ** -0.5, dtype=torch.float32).to(BF)
    k, v = (torch.tensor(rs.randn(1, tk, 1, d), dtype=torch.float32).to(BF) for _ in range(2))
    return q, k, v, torch.tensor(pad)[None]


def _tile_masks(valid: torch.Tensor, j0: int, n: int) -> list:
    """attention_bf16.cuh::tile_masks: key tile j's valid keys, as a bool row."""
    tk = valid.shape[0]
    return [valid[64 * (j0 + i):min(tk, 64 * (j0 + i + 1))] for i in range(n)]


def _live_tiles(tk: int, valid: torch.Tensor, mask_tiles: int):
    """The key tiles a kernel computes, in order: those with a valid key,
    their masks read mask_tiles at a time."""
    n_tiles = -(-tk // 64)
    for c0 in range(0, n_tiles, mask_tiles):
        masks = _tile_masks(valid, c0, min(mask_tiles, n_tiles - c0))
        for i, m in enumerate(masks):
            if m.any():
                yield c0 + i, m


def k3_bf16(q, k, v, valid, mask_tiles=256):
    """K3's bf16 form for one (b, h) [T, d]: every query row runs the same
    online softmax over the live key tiles (a warpgroup's 64 rows at a time
    on the card); s in f32 from the bf16 operands, p = 2^(s log2e - m log2e)
    in f32, rounded to bf16 for P V, l summed from the f32 p; out = O / l
    rounded once. Returns out, lse and the tiles computed."""
    tq, tk = q.shape[0], k.shape[0]
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((tq,), float("-inf"))
    l, o, done = torch.zeros(tq), torch.zeros(tq, q.shape[1]), []
    for j, tile_valid in _live_tiles(tk, valid, mask_tiles):
        keys = slice(64 * j, 64 * j + len(tile_valid))
        s = (qf @ kf[keys].T).masked_fill(~tile_valid[None], float("-inf"))
        m_new = torch.maximum(m, s.amax(1))
        mu = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new * LOG2E)
        alpha = torch.exp2(m * LOG2E - mu)
        p = torch.exp2(s * LOG2E - mu[:, None])
        l = l * alpha + p.sum(1)
        o = o * alpha[:, None] + p.to(BF).float() @ vf[keys]
        m = m_new
        done.append(j)
    inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, float("-inf")))
    return (o * inv[:, None]).to(BF), lse, done


def _holes(t: int, dead: tuple, length: int, seed: int = 3) -> np.ndarray:
    pad = np.random.RandomState(seed).rand(t) < 0.2
    pad[dead[0]:dead[1]] = True
    pad[length:] = True
    return pad


BF16_CASES = {   # name: (Tq, Tk, key padding [Tk])
    "single": (48, 48, np.arange(48) >= 31),
    "ragged": (130, 130, np.arange(130) >= 100),
    "holes": (300, 300, _holes(300, (64, 128), 250)),
    "no valid key": (70, 130, np.ones(130, bool)),
    "cross": (100, 200, _holes(200, (128, 192), 200)),
}


@pytest.mark.parametrize("case", sorted(BF16_CASES))
@pytest.mark.parametrize("mask_tiles", [256, 2])
def test_k3_bf16_tiles_match_the_plain_version(case, mask_tiles):
    """The live tiles (in chunks of mask_tiles masks) and the online
    softmax give the bf16 plain version within BF16_TOL (2^-6) of its
    largest element (p rounds against the running, not the final, max);
    only tiles with a valid key are computed; a row with no valid key gives
    0 and lse -inf."""
    tq, tk, pad = BF16_CASES[case]
    q, k, v, tpad = _bf16_inputs(tq + tk, tq, tk, 36, pad)
    valid = ~tpad[0]
    out, lse, done = k3_bf16(q[0, :, 0], k[0, :, 0], v[0, :, 0], valid, mask_tiles)
    assert done == [j for j in range(-(-tk // 64)) if valid[64 * j:64 * j + 64].any()]
    if not valid.any():
        assert (out == 0).all() and torch.isinf(lse).all()
        return
    ref = attention_plain(q, k, v, tpad)[0, :, 0].float()
    assert float((out.float() - ref).abs().max() / ref.abs().max()) <= 2.0 ** -6
    torch.testing.assert_close(lse, attention_lse_plain(q, k, tpad)[0, 0], rtol=1e-5, atol=1e-5)


def k4_bf16(q, k, v, o, lse, do, valid):
    """K4's bf16 form for one (b, h): key CTAs (64 keys over every 64-row
    query tile: P^T, dS^T in f32, rounded to bf16 for dV += P^T dO and dK +=
    dS^T Q; a CTA of only pad keys writes zeros) and dQ CTAs (64 query rows
    over the live key tiles, dQ += dS K with dS rounded); with one key tile
    (Tk <= 64) the key CTA forms dQ from its rounded dS^T and there are no
    dQ CTAs. Returns dq, dk, dv (bf16) and how often each row was written."""
    tq, tk = q.shape[0], k.shape[0]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    di = (o.float() * dof).sum(1)
    grads = {"dq": torch.zeros(tq, q.shape[1]), "dk": torch.zeros(tk, q.shape[1]),
             "dv": torch.zeros(tk, q.shape[1])}
    writes = {name: torch.zeros(len(g), dtype=torch.int64) for name, g in grads.items()}
    with_dq = 0 < tk <= 64

    def p_ds(qs, keys, key_ok):
        live = torch.isfinite(lse[qs])[:, None] & key_ok[None]
        s = qf[qs] @ kf[keys].T
        p = torch.where(live, torch.exp2(s * LOG2E - (lse[qs] * LOG2E)[:, None]),
                        torch.zeros_like(s))
        ds = torch.where(live, p * (dof[qs] @ vf[keys].T - di[qs][:, None]), torch.zeros_like(s))
        return p.to(BF).float(), ds.to(BF).float()

    for j in range(-(-tk // 64)):
        keys = slice(64 * j, min(tk, 64 * j + 64))
        key_ok = valid[keys]
        dk, dv = torch.zeros(len(key_ok), q.shape[1]), torch.zeros(len(key_ok), q.shape[1])
        for i0 in range(0, tq, 64) if key_ok.any() else ():
            qs = slice(i0, min(tq, i0 + 64))
            p, ds = p_ds(qs, keys, key_ok)
            dv += p.T @ dof[qs]
            dk += ds.T @ qf[qs]
            if with_dq:
                grads["dq"][qs] = ds @ kf[keys]
                writes["dq"][qs] += 1
        if with_dq and not key_ok.any():
            writes["dq"] += 1   # only pad keys: dq = 0
        grads["dk"][keys], grads["dv"][keys] = dk, dv
        writes["dk"][keys] += 1
        writes["dv"][keys] += 1
    for i0 in range(0, tq, 64) if not with_dq else ():
        qs = slice(i0, min(tq, i0 + 64))
        for j, key_ok in _live_tiles(tk, valid, 256):
            _, ds = p_ds(qs, slice(64 * j, 64 * j + len(key_ok)), key_ok)
            grads["dq"][qs] += ds @ kf[64 * j:64 * j + len(key_ok)]
        writes["dq"][qs] += 1
    return {name: g.to(BF) for name, g in grads.items()}, writes


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_k4_bf16_ctas_match_the_plain_backward(case):
    """Key CTAs and dQ CTAs (or key CTAs that form dQ, Tk <= 64): every row
    of dq, dk, dv written once, within BF16_TOL of the bf16 plain version's
    largest element, exactly 0 for pad keys and rows with no valid key."""
    tq, tk, pad = BF16_CASES[case]
    q, k, v, tpad = _bf16_inputs(tq + 2 * tk, tq, tk, 36, pad)
    do = torch.tensor(np.random.RandomState(tq).randn(*q.shape), dtype=torch.float32).to(BF)
    o, lse = attention_plain(q, k, v, tpad), attention_lse_plain(q, k, tpad)
    grads, writes = k4_bf16(q[0, :, 0], k[0, :, 0], v[0, :, 0], o[0, :, 0], lse[0, 0],
                            do[0, :, 0], ~tpad[0])
    ref = attention_bwd_plain(q, k, v, o, lse, do, tpad)
    for name, r in zip(("dq", "dk", "dv"), ref):
        assert (writes[name] == 1).all(), name
        r = r[0, :, 0].float()
        if r.abs().max() > 0:
            assert float((grads[name].float() - r).abs().max() / r.abs().max()) <= 2.0 ** -6, name
        else:
            assert (grads[name] == 0).all(), name
    assert (grads["dk"][tpad[0]] == 0).all() and (grads["dv"][tpad[0]] == 0).all()
