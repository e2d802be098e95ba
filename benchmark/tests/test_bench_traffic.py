"""The generator: the same seed gives the same inputs, every seed the same
sizes in another order, at the stated distributions."""

import os
import tempfile

import numpy as np

from benchmark.traffic.generate import (due_times, edit_requests, exponential_gaps, load_mix,
                                        lognormal_quantiles, write_corpus)
from benchmark.reference.frontend import text_to_phones

HP = {"audio_sample_rate": 22050, "hop_size": 256, "max_frames": 1548}


def small_mix():
    mix = load_mix("online-poisson")
    mix["sources"] = dict(mix["sources"], count=6)
    return mix


def test_requests_deterministic_per_seed():
    mix = small_mix()
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        ra, rb = edit_requests(mix, HP, 7, a, 10), edit_requests(mix, HP, 7, b, 10)
        strip = lambda rows: [{k: v for k, v in r.items() if k not in ("wav_fn_orig",
                                                                        "mfa_textgrid")}
                              for r in rows]
        assert strip(ra) == strip(rb)
        wa = open(ra[0]["wav_fn_orig"], "rb").read()
        assert wa == open(rb[0]["wav_fn_orig"], "rb").read()
        rc = edit_requests(mix, HP, 8, b + "/c", 10)
        assert strip(rc) != strip(ra)


def test_every_seed_the_same_lengths_in_another_order():
    mix = small_mix()
    with tempfile.TemporaryDirectory() as a:
        la = sorted(r["source_s"] for r in edit_requests(mix, HP, 1, a + "/1", 6))
        lb = sorted(r["source_s"] for r in edit_requests(mix, HP, 2, a + "/2", 6))
    assert np.allclose(la, lb)


def test_lengths_follow_the_lognormal():
    q = lognormal_quantiles(1001, 5.0, 0.5, 1.5, 15.0)
    assert abs(np.median(q) - 5.0) < 1e-6
    assert q.min() >= 1.5 and q.max() <= 15.0
    # the quartiles of a log-normal with sigma 0.5: median x exp(-+0.6745 sigma)
    assert abs(np.quantile(q, 0.25) - 5.0 * np.exp(-0.6745 * 0.5)) < 0.02
    assert abs(np.quantile(q, 0.75) - 5.0 * np.exp(0.6745 * 0.5)) < 0.02


def test_edits_replace_words_in_the_first_two_thirds():
    mix = small_mix()
    with tempfile.TemporaryDirectory() as a:
        rows = edit_requests(mix, HP, 3, a, 40)
    for r in rows:
        words, edited = r["text"].split(), r["edited_text"].split()
        w0, w1 = map(int, r["region"].strip("[]").split(","))
        c0, c1 = map(int, r["edited_region"].strip("[]").split(","))
        assert 1 <= w0 <= max(1, int(len(words) * 0.6667)) and 0 <= w1 - w0 <= 2
        assert c0 == w0 and 0 <= c1 - c0 <= 2
        assert edited[:w0 - 1] == words[:w0 - 1] and edited[c1:] == words[w1:]
        assert text_to_phones(r["edited_text"])[0].startswith("<BOS>")


def test_open_loop_arrivals():
    mix = load_mix("online-poisson")
    rate = mix["arrival"]["rate_per_s"]
    due = due_times(mix, 11, 30.0)
    assert (due < 30.0).sum() == round(rate * 30.0)
    assert np.all(np.diff(due[due < 30.0]) >= 0)
    gaps = exponential_gaps(2000, rate, np.random.RandomState(0))
    assert abs(gaps.mean() - 1 / rate) / (1 / rate) < 0.01
    a = exponential_gaps(50, rate, np.random.RandomState(1))
    b = exponential_gaps(50, rate, np.random.RandomState(2))
    assert np.allclose(np.sort(a), np.sort(b)) and not np.allclose(a, b)


def test_corpus_deterministic_and_sized():
    mix = load_mix("train-corpus")
    mix["corpus"] = dict(mix["corpus"], count=32)
    with tempfile.TemporaryDirectory() as a:
        ia = write_corpus(mix, HP, 5, os.path.join(a, "x"))
        ib = write_corpus(mix, HP, 5, os.path.join(a, "y"))
        lengths = np.load(os.path.join(a, "x", "train_lengths.npy"))
    assert list(ia) == list(ib)
    assert all(np.array_equal(ia[n]["mel"], ib[n]["mel"]) for n in ia)
    fps = 22050 / 256
    assert lengths.min() >= round(1.0 * fps) and lengths.max() <= round(10.0 * fps)
    for it in ia.values():
        t = len(it["mel"])
        assert it["mel2ph"][0] == 1 and it["mel2ph"][-1] == len(it["ph_token"])
        assert np.all(np.diff(it["mel2ph"]) >= 0) and len(it["mel2ph"]) == t
