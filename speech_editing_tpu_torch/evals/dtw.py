"""Dynamic time warping (numpy).

Parity role: ``utils/metrics/dtw.py`` + the ``fastdtw`` dependency used by
the MCD evaluators. Exact O(T^2) DP (segment lengths here are short — edit
regions of a few hundred frames — so exactness beats fastdtw's approximation).

The port's copy of the JAX package's ``evals/dtw.py``.
"""

from __future__ import annotations

import numpy as np


def dtw_path(x: np.ndarray, y: np.ndarray):
    """x [Tx, D], y [Ty, D] -> (total_cost, path list[(i, j)]) with
    euclidean local distance."""
    tx, ty = len(x), len(y)
    dist = np.sqrt(
        np.maximum(
            (x ** 2).sum(-1)[:, None] + (y ** 2).sum(-1)[None, :]
            - 2.0 * x @ y.T, 0.0))
    acc = np.full((tx + 1, ty + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, tx + 1):
        m = np.minimum(acc[i - 1, :-1], acc[i - 1, 1:])
        # roll over j sequentially (dependency on acc[i, j-1])
        row = np.empty(ty)
        prev = np.inf
        for j in range(ty):
            best = min(m[j], prev)
            prev = dist[i - 1, j] + best
            row[j] = prev
        acc[i, 1:] = row
    # backtrack
    path = []
    i, j = tx, ty
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        steps = [(i - 1, j - 1), (i - 1, j), (i, j - 1)]
        i, j = min(steps, key=lambda s: acc[s[0], s[1]])
    path.reverse()
    return float(acc[tx, ty]), path
