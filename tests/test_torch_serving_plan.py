"""PyTorch port, the serving host machinery against the JAX package's: the
bucketing and chunk planning of ``infer/serving.py`` and the deadline
scheduler of ``infer/online.py`` are copies, so on the same inputs they
must give equal plans, and the same launches under the same arrival script
(a stub pipeline, a virtual clock)."""

import itertools

import numpy as np
import pytest

import speech_editing_tpu.infer.online as jonline
import speech_editing_tpu.infer.serving as jserving
import speech_editing_tpu_torch.infer.online as ponline
import speech_editing_tpu_torch.infer.serving as pserving
from tests.test_torch_threads import one_thread  # noqa: F401  (autouse fixture)

BUCKET_SETS = [((128, 256, 512), 1), ((100, 200), 16), ((128,), 1),
               ((128, 256, 512, 1024, 1536), 4), ((32, 64, 128, 256), 1)]


@pytest.mark.parametrize("buckets,multiple", BUCKET_SETS)
def test_bucket_equals_jax(buckets, multiple):
    for n in list(range(0, 70)) + list(range(70, 4000, 37)):
        assert pserving._bucket(n, buckets, multiple) == jserving._bucket(n, buckets, multiple)
    for n in range(0, 70):
        assert pserving._pow2ceil(n) == jserving._pow2ceil(n)


def test_pad_to_equals_jax():
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    for length in (3, 6, 9):
        np.testing.assert_array_equal(pserving._pad_to(a, length), jserving._pad_to(a, length))


def _planners(**kw):
    """The port's and JAX's planning machinery on one configuration."""
    out = []
    for mod in (pserving, jserving):
        srv = object.__new__(mod._ServerBase)
        srv._init_config(dict(kw.get("hp", {})), kw.get("max_batch", 4), (128, 256), (32, 64),
                         kw.get("budget"), kw.get("adaptive"), kw.get("merge"))
        out.append(srv)
    return out


CONFIGS = [dict(max_batch=b, budget=budget, adaptive=adaptive, merge=merge)
           for b, budget, adaptive, merge in itertools.product(
               (1, 4, 16), (None, 0, 16384, 3000), (False, True), (False, True))]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_planner_equals_jax(cfg):
    port, ref = _planners(**cfg)
    for t_b in (128, 256, 512, 1024, 1536, 2048):
        assert port._mb(t_b) == ref._mb(t_b)
        assert port._warm_batches(t_b) == ref._warm_batches(t_b)
        for n in (1, 3, 4, 11, 16, 17, 40):
            assert list(port._chunks(list(range(n)), t_b)) == list(ref._chunks(list(range(n)), t_b))
    rs = np.random.RandomState(cfg["max_batch"])
    for _ in range(5):
        groups = {}
        for i in range(int(rs.randint(1, 60))):
            key = (int(rs.choice([32, 64, 128])), int(rs.choice([128, 256, 1536])))
            groups.setdefault(key, []).append(f"r{i}")
        assert port._plan_chunks(groups) == ref._plan_chunks(groups)


def test_hp_knobs_equal_jax():
    hp = {"frames_multiple": 4, "serve_frames_batch_budget": 4096,
          "serve_adaptive_tail": True, "serve_merge_token_tails": True}
    port, ref = _planners(hp=hp, max_batch=16)
    for key in ("fm", "frames_batch_budget", "adaptive_tail", "merge_token_tails",
                "wav_int16", "fetch_mel"):
        assert getattr(port, key) == getattr(ref, key), key
    assert port._fb(130) == ref._fb(130) == 256


# -- the deadline scheduler: one arrival script through both -----------------

class StubServer:
    """A pipeline that records every launch and does no device work;
    requests named "bad" fail their chunk, "badprep" their preparation."""

    def __init__(self, request_cls, max_batch=4, stages=("fwd",), adaptive_tail=False,
                 merge_token_tails=False):
        self.request_cls = request_cls
        self.max_batch = max_batch
        self.STAGES = tuple(stages)
        self.adaptive_tail = adaptive_tail
        self.merge_token_tails = merge_token_tails
        self.calls = []

    def _mb(self, t_b):
        return self.max_batch

    def online_prepare(self, inp, seed):
        if inp["name"] == "badprep":
            raise ValueError("bad request")
        r = self.request_cls(inp)
        r.stage = self.STAGES[0]
        r.group = (inp["s_b"], inp["t_b"])
        return r

    def online_run(self, stage, s_b, t_b, reqs, b_eff):
        if any(r.inp["name"] == "bad" for r in reqs):
            raise RuntimeError("boom")
        self.calls.append((stage, s_b, t_b, [r.inp["name"] for r in reqs], b_eff))
        nxt = dict(zip(self.STAGES, self.STAGES[1:]))
        for r in reqs:
            if stage in nxt:
                r.stage = nxt[stage]
            else:
                r.result = {"name": r.inp["name"], "b_eff": b_eff}


def _sub(name, s_b=32, t_b=128):
    return ("submit", name, s_b, t_b)


# each script: (stub settings, server settings, operations); the cases of
# the JAX package's tests/test_serving_online.py
SCRIPTS = {
    "full_batch": (dict(max_batch=2), {}, [_sub("a"), _sub("b"), ("poll",)]),
    "deadline": (dict(max_batch=4), dict(max_wait_ms=50),
                 [_sub("a"), ("poll",), ("t", 0.049), ("poll",), ("t", 0.051), ("poll",)]),
    "adaptive_tail": (dict(max_batch=8, adaptive_tail=True), {},
                      [_sub("a"), _sub("b"), _sub("c"), ("t", 1.0), ("poll",)]),
    "merge": (dict(max_batch=4, merge_token_tails=True), {},
              [_sub("a", 32), ("t", 0.01), _sub("b", 64), _sub("c", 64, 256), ("t", 0.07),
               ("poll",), ("poll",)]),
    "merge_override": (dict(max_batch=4), dict(merge_token_tails=True),
                       [_sub("a", 32), _sub("b", 64), ("t", 0.06), ("poll",), ("poll",)]),
    "no_merge": (dict(max_batch=4), {},
                 [_sub("a", 32), _sub("b", 64), ("t", 0.06), ("poll",), ("poll",)]),
    "two_stages": (dict(max_batch=4, stages=("dur", "diff")), dict(max_wait_ms=50),
                   [_sub("a"), ("t", 0.06), ("poll",), ("poll",), ("poll",)]),
    "oldest_first": (dict(max_batch=4), {},
                     [_sub("late", 32, 256), ("t", 0.01), _sub("early"), ("t", 0.06),
                      ("poll",)]),
    "burst": (dict(max_batch=2), {},
              [_sub(f"r{i}") for i in range(5)] + [("poll",), ("poll",), ("poll",), ("drain",)]),
    "close_drains": (dict(max_batch=8), dict(max_wait_ms=10_000),
                     [_sub("a"), ("close", True)]),
    "close_abandons": (dict(max_batch=8), dict(max_wait_ms=10_000),
                       [_sub("a"), _sub("b", 64), ("close", False)]),
    "failure": (dict(max_batch=1), {}, [_sub("bad"), _sub("ok"), ("drain",)]),
    "submit_after_close": (dict(max_batch=4), {}, [("close", True), _sub("late")]),
    "preprocess_failure": (dict(max_batch=4), {}, [_sub("badprep"), _sub("x"), ("drain",)]),
}


def _run_script(online, request_cls, stub_kw, srv_kw, ops):
    """The launches, stub calls, poll results and each future's outcome."""
    clock = {"t": 0.0}
    stub = StubServer(request_cls, **stub_kw)
    srv = online.OnlineEditServer(stub, clock=lambda: clock["t"], start=False,
                                  **{"max_wait_ms": 50.0, **srv_kw})
    futures, polls = {}, []
    for op in ops:
        if op[0] == "t":
            clock["t"] = op[1]
        elif op[0] == "submit":
            futures[op[1]] = srv.submit({"name": op[1], "s_b": op[2], "t_b": op[3]})
        elif op[0] == "poll":
            polls.append(srv.poll_once())
        elif op[0] == "drain":
            srv.drain()
        elif op[0] == "close":
            srv.close(drain=op[1])
    outcome = {}
    for name, f in futures.items():
        if not f.done():
            outcome[name] = "pending"
            continue
        try:
            outcome[name] = (f.result(0), f.latency_s)
        except Exception as e:
            outcome[name] = (type(e).__name__, str(e))
    return srv.launches, stub.calls, polls, outcome


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scheduler_equals_jax(name):
    stub_kw, srv_kw, ops = SCRIPTS[name]
    got = _run_script(ponline, pserving.Request, stub_kw, srv_kw, ops)
    ref = _run_script(jonline, jserving.Request, stub_kw, srv_kw, ops)
    assert got == ref
    assert got[0] or name in ("submit_after_close", "close_abandons")


def test_threaded_scheduler_serves_every_request():
    """Two scheduler threads over a slow stub: every future resolves with
    its own request's result, and close() drains what is left."""
    import time

    class Slow(StubServer):
        def online_run(self, *args):
            time.sleep(0.01)
            super().online_run(*args)

    stub = Slow(pserving.Request, max_batch=2)
    srv = ponline.OnlineEditServer(stub, max_wait_ms=5, workers=2)
    try:
        fs = [srv.submit({"name": f"w{i}", "s_b": 32, "t_b": 128 + i % 2}) for i in range(12)]
        for i, f in enumerate(fs):
            assert f.result(timeout=10)["name"] == f"w{i}"
    finally:
        srv.close()
    assert sorted(n for c in stub.calls for n in c[3]) == sorted(f"w{i}" for i in range(12))
    late = srv.submit({"name": "late", "s_b": 32, "t_b": 128})
    with pytest.raises(RuntimeError, match="closed"):
        late.result(0)
