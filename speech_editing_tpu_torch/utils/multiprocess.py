"""A fire-and-forget pool for the test loop's file writes: the port's
``ResultSaverPool`` (``add_job`` / ``drain``) of the JAX package's
``utils/multiprocess.py``."""

from __future__ import annotations

import os
import traceback
from typing import Callable, Optional


class ResultSaverPool:
    """Runs ``fn(*args)`` jobs in ``num_workers`` spawned processes (the
    parent holds CUDA, which ``fork`` would copy into a broken child), so
    wav writes overlap inference; ``num_workers <= 1`` runs each job at
    once in this process. ``None`` means ``N_PROC`` or the CPU count less
    one. A job that raises prints its traceback and gives ``None``."""

    def __init__(self, num_workers: Optional[int] = None):
        if num_workers is None:
            num_workers = int(os.getenv("N_PROC", max(1, (os.cpu_count() or 2) - 1)))
        self.num_workers = int(num_workers)
        self._results: list = []
        self._futures: list = []
        self._pool = None
        if self.num_workers > 1:
            import multiprocessing as mp

            self._pool = mp.get_context("spawn").Pool(self.num_workers)

    def add_job(self, fn: Callable, args: tuple = ()):
        """``fn`` must be a module-level (picklable) function."""
        if self._pool is None:
            try:
                self._results.append(fn(*args))
            except Exception:
                traceback.print_exc()
                self._results.append(None)
        else:
            self._futures.append(self._pool.apply_async(fn, args))

    def drain(self) -> list:
        """Wait for every job; returns their results in order of submission."""
        for f in self._futures:
            try:
                self._results.append(f.get())
            except Exception:
                traceback.print_exc()
                self._results.append(None)
        self._futures = []
        if self._pool is not None:
            self._pool.close()
            self._pool.join()
            self._pool = None
        out, self._results = self._results, []
        return out
