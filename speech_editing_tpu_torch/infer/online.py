"""Arrival-aware online serving: continuous batching with deadlines. The
port of the JAX package's ``infer/online.py``.

``OnlineEditServer`` turns the batch server of ``infer/serving.py`` into
an actual server: clients ``submit()`` individual edit requests and get a
future; a scheduler loop groups queued requests by (stage, token bucket,
frame bucket), launches a device chunk when a group reaches its budgeted
batch size, and flushes partial chunks when the OLDEST queued request has
waited ``max_wait_ms`` — so batching never costs more than the deadline,
and a lone request on an idle server departs after at most one deadline
per pipeline stage.

Cross-bucket packing: when a deadline flush (or drain) would launch a
partial chunk, the scheduler pulls co-queued requests from OTHER token
buckets at the same stage + frame bucket into the same launch, running
the merged chunk at the members' max token bucket (token-bucket padding
is numerically inert for the diffusion family, asserted in
``tests/test_torch_serving.py``). This is the mixed-traffic fill lever:
without it, tails of different token buckets never share a chunk.

The device runs one program at a time, so overlap comes from batching;
``workers`` scheduler threads overlap one chunk's host work with
another's device work. Host preprocessing (g2p, f0, spk embedding) runs
in the SUBMITTING thread, overlapping the device work of other requests.

Determinism: identical to the wrapped server's contract. With
``adaptive_tail`` and ``merge_token_tails`` both off, every chunk runs at
the bucket's budgeted batch with replicate padding, so a request's result
is bit-identical to ``edit_many`` regardless of arrival pattern (asserted
in ``tests/test_torch_serving.py``). Either flag trades that for the
rounding of a kernel run at another batch size.

Testability: the clock is injectable and the scheduler thread optional —
``poll_once(now)`` forms and runs at most one due chunk, so a CPU unit
test drives the whole policy under a virtual clock.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from speech_editing_tpu_torch.infer.serving import _pow2ceil


class EditFuture:
    """Result handle for a submitted edit request."""

    def __init__(self) -> None:
        self._ev = threading.Event()
        self._result: Optional[dict] = None
        self._exc: Optional[BaseException] = None
        #: filled when the result is set: seconds from submit to completion
        self.latency_s: Optional[float] = None

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> dict:
        if not self._ev.wait(timeout):
            raise TimeoutError("edit request not complete")
        if self._exc is not None:
            raise self._exc
        return self._result  # type: ignore[return-value]

    def _set(self, result: dict, latency_s: float) -> None:
        self._result = result
        self.latency_s = latency_s
        self._ev.set()

    def _set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._ev.set()


class _Entry:
    __slots__ = ("req", "future", "t_submit")

    def __init__(self, req, future: EditFuture, t_submit: float):
        self.req = req
        self.future = future
        self.t_submit = t_submit


class OnlineEditServer:
    """Deadline scheduler over a batch server's chunk pipeline.

    Parameters
    ----------
    server:
        A ``BatchedEditServer`` (anything providing ``online_prepare`` /
        ``online_run`` / ``_mb`` and the ``adaptive_tail`` /
        ``merge_token_tails`` flags).
    max_wait_ms:
        Per-request queueing deadline: a partial chunk is flushed once its
        oldest member has waited this long (per pipeline TOTAL — stage
        deadlines are measured from submit time, so a request that paid
        the wait once is not re-delayed at the next stage).
    clock:
        Monotonic-seconds callable; injectable for virtual-time tests.
    start:
        Launch the background scheduler thread(s). With ``start=False``
        the caller drives ``poll_once`` / ``drain`` manually.
    merge_token_tails:
        Override the server's cross-token-bucket packing flag for
        scheduler launches (None = inherit).
    workers:
        Number of scheduler threads. The device runs one program at a
        time, but a chunk's wall time also holds host work (padding
        stacks, splicing, eager launches) and the device->host result
        fetch. With ``workers=2`` the second thread issues the next chunk
        while the first blocks on its fetch, so host time overlaps device
        work. Chunk picking stays serialized under the lock and each
        request draws its own noise, so results are unchanged — only
        completion ORDER can interleave.
    """

    def __init__(self, server, max_wait_ms: float = 50.0,
                 clock: Optional[Callable[[], float]] = None,
                 start: bool = True,
                 merge_token_tails: Optional[bool] = None,
                 workers: int = 1):
        self.server = server
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.clock = clock or time.monotonic
        self.workers = max(1, int(workers))
        self.merge_token_tails = (server.merge_token_tails
                                  if merge_token_tails is None
                                  else bool(merge_token_tails))
        self._cv = threading.Condition()
        #: per-launch accounting (stage, s_b, t_b, n_real, b_eff, n_merged)
        #: — n_merged counts members pulled in from other token buckets
        self.launches: List[Tuple[str, int, int, int, int, int]] = []
        #: (stage, s_b, t_b) -> FIFO of _Entry
        self._queues: Dict[Tuple[str, int, int], List[_Entry]] = {}
        self._n_queued = 0
        self._stopping = False
        self._threads: List[threading.Thread] = []
        if start:
            self.start()

    # -- client API -----------------------------------------------------------
    def submit(self, inp: dict, seed: Optional[int] = None) -> EditFuture:
        """Enqueue one edit request; host preprocessing runs here (in the
        caller's thread), device work is batched by the scheduler."""
        future = EditFuture()
        t_submit = self.clock()
        try:
            req = self.server.online_prepare(inp, seed)
        except BaseException as e:  # preprocessing errors surface on the future
            future._set_exception(e)
            return future
        with self._cv:
            if self._stopping:
                future._set_exception(RuntimeError("server is closed"))
                return future
            key = (req.stage, *req.group)
            self._queues.setdefault(key, []).append(
                _Entry(req, future, t_submit))
            self._n_queued += 1
            self._cv.notify_all()
        return future

    def warmup(self, **kw) -> int:
        """Run every bucket program once ahead of traffic (serving.warmup)."""
        return self.server.warmup(**kw)

    # -- scheduler ------------------------------------------------------------
    def _pick_chunk(self, now: float, force: bool):
        """Select the due group with the oldest head request and pop its
        chunk (plus cross-bucket merge fill). Returns
        (stage, s_b, t_b, entries, b_eff) or None. Caller holds the lock."""
        best_key = None
        best_t = None
        for key, q in self._queues.items():
            if not q:
                continue
            mb = self.server._mb(key[2])
            # deadline comparison uses the SAME float expression as
            # _next_deadline (t_submit + max_wait): a sleeper that wakes
            # exactly at the reported deadline must find the group due
            # ((now - t) >= w can be false at now == t + w in floats,
            # which spun the virtual-clock event loop forever)
            due = force or len(q) >= mb or now >= (q[0].t_submit
                                                   + self.max_wait_s)
            if due and (best_t is None or q[0].t_submit < best_t):
                best_key, best_t = key, q[0].t_submit
        if best_key is None:
            return None
        stage, s_b, t_b = best_key
        mb = self.server._mb(t_b)
        q = self._queues[best_key]
        entries = q[:mb]
        del q[:mb]
        n_own = len(entries)
        if len(entries) < mb and self.merge_token_tails:
            # pull oldest co-queued requests from other token buckets at
            # the same (stage, frame bucket); the merged chunk runs at the
            # members' max token bucket
            donors = sorted(
                (k for k, dq in self._queues.items()
                 if dq and k[0] == stage and k[2] == t_b and k != best_key),
                key=lambda k: self._queues[k][0].t_submit)
            for k in donors:
                dq = self._queues[k]
                take = min(mb - len(entries), len(dq))
                entries.extend(dq[:take])
                del dq[:take]
                s_b = max(s_b, k[1])
                if len(entries) == mb:
                    break
        self._n_queued -= len(entries)
        b_eff = (_pow2ceil(len(entries))
                 if self.server.adaptive_tail and len(entries) < mb else mb)
        self.launches.append((stage, s_b, t_b, len(entries), b_eff,
                              len(entries) - n_own))
        return stage, s_b, t_b, entries, b_eff

    def poll_once(self, now: Optional[float] = None,
                  force: bool = False) -> bool:
        """Form and run at most ONE due chunk; returns whether one ran.
        ``force=True`` treats every nonempty group as due (drain)."""
        now = self.clock() if now is None else now
        with self._cv:
            picked = self._pick_chunk(now, force)
        if picked is None:
            return False
        stage, s_b, t_b, entries, b_eff = picked
        reqs = [e.req for e in entries]
        try:
            self.server.online_run(stage, s_b, t_b, reqs, b_eff)
        except BaseException as e:
            for entry in entries:
                entry.future._set_exception(e)
            return True
        done_t = self.clock()
        requeue = []
        for entry in entries:
            if entry.req.result is not None:
                entry.future._set(entry.req.result,
                                  done_t - entry.t_submit)
            else:
                requeue.append(entry)
        if requeue:
            with self._cv:
                for entry in requeue:
                    key = (entry.req.stage, *entry.req.group)
                    # deadline stays anchored at submit time: a request
                    # that already waited max_wait flushes the next stage
                    # immediately
                    self._queues.setdefault(key, []).append(entry)
                    self._n_queued += 1
                self._cv.notify_all()
        return True

    def _next_deadline(self) -> Optional[float]:
        """Earliest (t_submit + max_wait) over queued heads; lock held."""
        t = None
        for q in self._queues.values():
            if q and (t is None or q[0].t_submit < t):
                t = q[0].t_submit
        return None if t is None else t + self.max_wait_s

    def _loop(self) -> None:
        while True:
            with self._cv:
                stopping = self._stopping
            ran = self.poll_once(force=stopping)  # stopping => drain mode
            with self._cv:
                if self._stopping and self._n_queued == 0:
                    return
                if ran:
                    continue
                if self._n_queued == 0:
                    self._cv.wait(timeout=1.0)
                    continue
                # partial groups queued: sleep until the earliest deadline
                # (or a submit notifies us sooner)
                deadline = self._next_deadline()
                wait = (0.0 if deadline is None
                        else max(deadline - self.clock(), 0.0))
                if wait:
                    self._cv.wait(timeout=min(wait, 1.0))

    def start(self) -> None:
        if not self._threads:
            for i in range(self.workers):
                th = threading.Thread(
                    target=self._drain_safe_loop,
                    name=f"online-edit-scheduler-{i}", daemon=True)
                th.start()
                self._threads.append(th)

    def _drain_safe_loop(self) -> None:
        self._loop()
        # stopping: force-flush whatever remains
        while self.poll_once(force=True):
            pass

    def drain(self) -> None:
        """Run queued work to completion in the CALLING thread (manual
        mode — with the scheduler thread running, use close())."""
        while self.poll_once(force=True):
            pass

    def close(self, drain: bool = True) -> None:
        """Stop the scheduler; by default drains queued requests first
        (undrained futures fail with 'server is closed')."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        for th in self._threads:
            th.join()
        self._threads = []
        if drain:
            self.drain()
        else:
            with self._cv:
                leftovers = [e for q in self._queues.values() for e in q]
                self._queues.clear()
                self._n_queued = 0
            for e in leftovers:
                e.future._set_exception(RuntimeError("server is closed"))

    def __enter__(self) -> "OnlineEditServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
