"""Operations and bytes of the port's kernels and of the vocoder the
configurations share, from shapes alone, and the peaks they are held to
(``peaks.json``). Each configuration's own model counts its products in its
oracle (``oracles/<config>.py``: ``edit_flops``, ``train_flops``).

A kernel's least time is the larger of its operations over the peak rate of
its products and its bytes over the memory's peak, each input byte read once
and each output byte written once, over the rows that are live: a request's
real frames, not the bucket's padding.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def k1(frames: int, c: int, h: int, with_h: bool = False) -> tuple[float, float]:
    """K1 (the DiffNet block forward) over ``frames`` live frames: the
    dilated conv (3C -> 2C), the condition (H -> 2C) and the output
    projection (C -> 2C); bytes of x, cond, x', skip (and h [2C] when
    written) and of the weights."""
    flops = 2.0 * frames * 2 * c * (3 * c + h + c)
    per_frame = c + h + 2 * c + (2 * c if with_h else 0) + 1      # + the mask
    weights = 3 * c * 2 * c + h * 2 * c + c * 2 * c + 3 * 2 * c
    return flops, 4.0 * (frames * per_frame + weights)


def k5(frames: int, c: int) -> tuple[float, float]:
    """K5 (the block's backward: dg = do Wo^T, dy = dh Wd^T, the gate's
    backward, the shift's scatter): 16 C^2 a frame; bytes of h, dx', dskip
    in and dx, dh, g out, and of Wo, Wd."""
    flops = 16.0 * frames * c * c
    return flops, 4.0 * (frames * (2 * c + c + c + c + 2 * c + c + 1) + 2 * c * c + 3 * c * 2 * c)


def attention(h: int, d: int, q_rows: int, keys: int, backward: bool = False) -> float:
    """K3 (q k^T and p v: 4 h d a query row and valid key) or K4 (five
    products: 10 h d), over ``q_rows`` query rows against ``keys`` valid
    keys each (the sum over rows of rows x valid keys is ``q_rows * keys``
    where every row sees the same keys)."""
    return (10.0 if backward else 4.0) * h * d * q_rows * keys


def bound_s(flops: float, n_bytes: float, dtype: str = "float32") -> float:
    rate = PEAKS["bf16_flops"] if dtype == "bf16" else PEAKS["tf32_flops"]
    return max(flops / rate, n_bytes / PEAKS["hbm_bytes_per_s"])


def peak_flops(dtype: str = "float32") -> float:
    return PEAKS["bf16_flops"] if dtype == "bf16" else PEAKS["tf32_flops"]


# -- model FLOPs (products only, two a multiply-add) --------------------------------


def hifigan_frame(v: dict) -> float:
    """HiFi-GAN V1's generator over one mel frame (256 samples)."""
    c = v["upsample_initial_channel"]
    flops, rate = 2 * 7 * 80 * c, 1
    ch = c
    for u, k in zip(v["upsample_rates"], v["upsample_kernel_sizes"]):
        rate *= u
        out = ch // 2
        flops += 2 * ch * out * k / u * rate            # each output sample: ch k / u taps
        for rk, dil in zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"]):
            flops += 2 * len(dil) * 2 * rk * out * out * rate
        ch = out
    return flops + 2 * 7 * ch * rate
