"""Percentiles over every request, rates over the whole window, a
failed request counted as missing."""

import pytest

from benchmark.harness import stats
from benchmark.harness.serving import summarize
from benchmark.harness.traffic import Request
import numpy as np


def _req(i, due, times, error=None):
    r = Request(i, due, np.zeros(4, np.int32), 8)
    r.due, r.sent, r.times, r.error = due, due, list(times), error
    return r


def test_percentile_is_linear_between_ranks():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    assert stats.percentile([3.0], 95) == 3.0


def test_ttft_counts_every_request_and_a_missing_one_as_the_wait():
    reqs = [_req(i, 10.0 + i, [10.0 + i + 0.1]) for i in range(19)]
    reqs.append(_req(19, 29.0, [], error="OverloadedError"))
    sm = summarize(reqs, 10.0, 20.0, t_wait=100.0)
    assert sm["ttft_samples"] == 20 and sm["failed"] == 1
    # 19 answers of 0.1 s and one missing of 71 s: p95 interpolates
    # between the 19th and 20th of the sorted times.
    expect = np.percentile([0.1] * 19 + [71.0], 95) * 1e3
    assert sm["ttft_p95_ms"] == pytest.approx(expect)


def test_rate_and_gaps_are_over_the_whole_window():
    # Two requests: tokens every 0.5 s; the window is [0, 10].
    a = _req(0, 0.0, [0.5 * k for k in range(1, 30)])   # to 14.5 s
    b = _req(1, 5.0, [5.0 + 0.25 * k for k in range(1, 5)])
    sm = summarize([a, b], 0.0, 10.0, t_wait=20.0)
    inside = sum(1 for t in a.times + b.times if t <= 10.0)
    assert sm["serve_tokens_per_s"] == pytest.approx(inside / 10.0)
    # Gaps that end after the window do not count.
    assert sm["itl_samples"] == (20 - 1) + 3
    assert sm["failed"] == 0
