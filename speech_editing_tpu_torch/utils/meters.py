"""Meters, timers, a profiler context and a terminal tee: the port of the
JAX package's ``utils/meters.py``. ``Timer`` synchronises the card around
its region; ``profile_trace`` records a ``torch.profiler`` trace (the
card's activity too when there is one) for TensorBoard's profiler."""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Optional

import torch


class AvgrageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.avg = 0.0
        self.sum = 0.0
        self.cnt = 0

    def update(self, val, n: int = 1):
        self.sum += val * n
        self.cnt += n
        self.avg = self.sum / self.cnt


def _device_sync() -> None:
    """Wait for the work queued on the card, if there is one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Adds the seconds of each enabled region to ``timer_map[name]`` and
    prints the running total."""

    timer_map: dict = {}

    def __init__(self, name: str, enable: bool = False):
        Timer.timer_map.setdefault(name, 0.0)
        self.name, self.enable = name, enable

    def __enter__(self):
        if self.enable:
            _device_sync()
            self.t = time.time()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if self.enable:
            _device_sync()
            Timer.timer_map[self.name] += time.time() - self.t
            print(f"[Timer] {self.name}: {Timer.timer_map[self.name]:.4f}s")


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Record the enclosed region with ``torch.profiler`` into ``log_dir``
    (TensorBoard's trace format); a no-op if ``log_dir`` is empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class Tee:
    """Mirror ``sys.stdout`` into the file ``fn`` until :meth:`close`."""

    def __init__(self, fn: str, mode: str = "a"):
        self.file = open(fn, mode)
        self.stdout = sys.stdout
        sys.stdout = self

    def close(self):
        sys.stdout = self.stdout
        self.file.close()

    def write(self, data):
        self.file.write(data)
        self.stdout.write(data)
        self.flush()

    def flush(self):
        self.file.flush()
        self.stdout.flush()
