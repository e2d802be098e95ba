"""Spectrogram figures for TensorBoard and the test loop's ``plot/``: a mel
heatmap with duration ticks and f0 curves. matplotlib is imported when a
figure is drawn, with the headless Agg backend; :func:`have_matplotlib`
says whether it is installed (the logging is a no-op without it)."""

from __future__ import annotations

import importlib.util
from typing import Optional

import numpy as np


def have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def spec_to_figure(spec: np.ndarray, vmin: Optional[float] = None,
                   vmax: Optional[float] = None, title: str = "",
                   f0s: Optional[dict] = None, dur_info: Optional[dict] = None):
    """mel [T, M] -> a figure: the heatmap, a tick at each token's last frame
    (``dur_info``: ``dur_gt`` and optionally ``txt`` labels) and each f0
    curve of ``f0s`` in Hz / 10."""
    plt = _plt()
    spec = np.asarray(spec)
    fig = plt.figure(figsize=(12, 6))
    plt.title(title)
    plt.pcolor(spec.T, vmin=vmin, vmax=vmax)
    if dur_info is not None:
        frames = np.cumsum(np.asarray(dur_info["dur_gt"]))
        for i, x in enumerate(frames):
            plt.vlines(x, 0, spec.shape[1], colors="b", linewidth=0.4, alpha=0.6)
            if "txt" in dur_info and i < len(dur_info["txt"]):
                plt.text((frames[i - 1] if i > 0 else 0), spec.shape[1] - 3,
                         dur_info["txt"][i], fontsize=6)
    if f0s is not None:
        if not isinstance(f0s, dict):
            f0s = {"f0": f0s}
        for name, f0 in f0s.items():
            plt.plot(np.asarray(f0) / 10.0, label=name, linewidth=1)
        # a fixed corner: matplotlib's "best" scores every heatmap cell
        # against the curves, a second or more a figure
        plt.legend(loc="upper right")
    plt.tight_layout()
    return fig


def figure_to_image(fig) -> np.ndarray:
    """A figure rendered to an HWC uint8 array; closes the figure."""
    plt = _plt()
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf
