"""PyTorch port, kernels K3 and K4: the tile arithmetic of their CUDA
sources, emulated on the CPU.

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
"""

import numpy as np
import pytest
import torch

from speech_editing_tpu_torch.ops.flash_attention import attention_bwd_plain, attention_plain

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
