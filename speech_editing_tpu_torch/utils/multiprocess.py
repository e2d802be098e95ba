"""Process pools of the host tooling: ``multiprocess_run_tqdm``, the
ordered map of the offline data pipeline, and ``ResultSaverPool``, the
fire-and-forget pool of the test loop's file writes (``add_job`` /
``drain``). The port's copy of the JAX package's ``utils/multiprocess.py``;
its workers are spawned, never forked (a parent that holds CUDA or
threads would be copied into a broken child)."""

from __future__ import annotations

import os
import traceback
from typing import Callable, Iterable, Iterator, Optional

_WORKER_CTX: dict = {}
_WORKER_FN: Optional[Callable] = None


def _worker_init(fn: Callable, init_ctx_func: Optional[Callable]) -> None:
    global _WORKER_FN, _WORKER_CTX
    _WORKER_FN = fn
    if init_ctx_func is not None:
        _WORKER_CTX = init_ctx_func(os.getpid()) or {}


def _worker_run(payload: tuple) -> tuple:
    idx, kwargs = payload
    try:
        if _WORKER_CTX:
            kwargs = dict(kwargs, ctx=_WORKER_CTX)
        return idx, _WORKER_FN(**kwargs)
    except Exception:
        traceback.print_exc()
        return idx, None


def _progress(it, **kw):
    try:
        from tqdm import tqdm
    except ImportError:
        return it
    return tqdm(it, **kw)


def multiprocess_run_tqdm(fn: Callable, args: Iterable[dict],
                          num_workers: Optional[int] = None, desc: str = "",
                          init_ctx_func: Optional[Callable] = None) -> Iterator[tuple]:
    """Yields ``(i, fn(**args[i]))`` in the order of ``args`` from
    ``num_workers`` spawned processes
    (``None``: ``N_PROC`` or half the CPU count). ``fn`` must be picklable
    (a module-level function or a class's method). ``init_ctx_func(pid)``
    runs once in each worker and its non-empty result reaches ``fn`` as
    ``ctx``. One worker, or one job, runs in this process. A job that
    raises prints its traceback and gives ``None``."""
    args = list(args)
    if num_workers is None:
        num_workers = int(os.getenv("N_PROC", max(1, (os.cpu_count() or 2) // 2)))
    if num_workers <= 1 or len(args) <= 1:
        ctx = init_ctx_func(0) if init_ctx_func is not None else None
        for i, kw in enumerate(_progress(args, desc=desc)):
            try:
                yield i, fn(**(dict(kw, ctx=ctx) if ctx else kw))
            except Exception:
                traceback.print_exc()
                yield i, None
        return

    import multiprocessing as mp

    with mp.get_context("spawn").Pool(num_workers, initializer=_worker_init,
                                      initargs=(fn, init_ctx_func)) as pool:
        yield from _progress(pool.imap(_worker_run, list(enumerate(args))), total=len(args),
                             desc=desc)


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
