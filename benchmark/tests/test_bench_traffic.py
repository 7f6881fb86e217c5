"""The traffic generator: a seed repeats, seeds differ only in order."""

import numpy as np
import pytest
import torch

from benchmark.harness import spec
from benchmark.harness.traffic import (arrival_gaps, mix_seed, quantiles,
                                       residents, serve_schedule,
                                       train_batch)

CHAT = spec.load_cell("mistral-7b.chat").traffic


def _key(reqs):
    return [(r.due_s, r.max_new_tokens, r.prompt.tolist()) for r in reqs]


def test_same_seed_same_schedule():
    a = serve_schedule(CHAT, 20, 2**40 + 17, 32768)
    b = serve_schedule(CHAT, 20, 2**40 + 17, 32768)
    assert _key(a) == _key(b)


def test_order_seed_fixes_the_schedule_and_seeds_draw_tokens():
    a = serve_schedule(CHAT, 20, 1, 32768)
    b = serve_schedule(CHAT, 20, 2**33 + 5, 32768)
    assert [(r.due_s, len(r.prompt), r.max_new_tokens) for r in a] == [
        (r.due_s, len(r.prompt), r.max_new_tokens) for r in b]
    assert all(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    ra, rb = residents(CHAT, 1, 32768), residents(CHAT, 7, 32768)
    assert [(len(r.prompt), r.max_new_tokens) for r in ra] == [
        (len(r.prompt), r.max_new_tokens) for r in rb]


def test_order_seeds_share_sizes_and_gaps_in_another_order():
    a = serve_schedule(CHAT, 20, 1, 32768)
    b = serve_schedule(dict(CHAT, order_seed=2), 20, 1, 32768)
    assert _key(a) != _key(b)
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt)
                                                      for r in b)
    assert sorted(r.max_new_tokens for r in a) == sorted(r.max_new_tokens
                                                         for r in b)
    # The first request is due half its gap in, the last at the sum of
    # all gaps less that half: first + last is the sum, the same set.
    assert a[0].due_s + a[-1].due_s == pytest.approx(
        b[0].due_s + b[-1].due_s)
    assert [r.due_s for r in a] != [r.due_s for r in b]


def test_shared_prefix_documents_start_their_prompts():
    mix = dict(CHAT, shared_prefix={
        "documents": 3,
        "tokens": {"dist": "fixed", "value": 100}})
    reqs = serve_schedule(mix, 20, 5, 32768)
    heads = {tuple(r.prompt[:100].tolist()) for r in reqs}
    assert len(heads) == 3
    assert all(len(r.prompt) >= 100 + 64 for r in reqs)


def test_every_request_is_due_in_the_window():
    for seconds in (5, 20, 51):
        reqs = serve_schedule(CHAT, seconds, 3, 32768)
        assert len(reqs) == int(CHAT["arrivals"]["rate_per_s"] * seconds)
        assert all(0 < r.due_s < seconds for r in reqs)
        assert all(64 <= len(r.prompt) <= 4096 for r in reqs)
        assert all(8 <= r.max_new_tokens <= 512 for r in reqs)


def test_residents_fill_little_s_law_part_way_through():
    reqs = residents(CHAT, 3, 32768)
    rate = CHAT["arrivals"]["rate_per_s"]
    assert len(reqs) == round(rate * CHAT["residents"]["seconds"])
    assert all(r.max_new_tokens >= 1 for r in reqs)
    assert all(len(r.prompt) + r.max_new_tokens <= 4096 + 512 for r in reqs)


def test_sizes_follow_the_distribution():
    q = quantiles({"dist": "lognormal", "median": 1024, "sigma": 0.8,
                   "min": 64, "max": 4096}, 1001)
    assert q[500] == 1024 and q.min() >= 64 and q.max() <= 4096
    assert abs(arrival_gaps(3.0, 200).mean() - 1 / 3.0) < 1e-12


def test_train_batches_repeat_and_rows_differ():
    mix = {"batch": {"rows": 4, "seq_len": 32}}
    a = train_batch(mix, 2**35 + 1, 0, 1000, "cpu")
    assert torch.equal(a, train_batch(mix, 2**35 + 1, 0, 1000, "cpu"))
    assert not torch.equal(a, train_batch(mix, 2**35 + 1, 1, 1000, "cpu"))
    assert len({tuple(r.tolist()) for r in a}) == 4
    assert a.shape == (4, 33)


def test_seed_mix_takes_large_seeds():
    assert mix_seed(2**40, 1) != mix_seed(2**40 + 1, 1)
    assert 0 <= mix_seed(2**62 + 12345, 3) < 2**63
