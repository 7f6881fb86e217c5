"""A run whose timed path is broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run at the debug size on the CPU (with the limits `tiny` gives), once sound
and once for each fault the cell can have: a step that returns its state
unchanged, half of the batch left out, a token or an answer altered
where it is produced. (No cell spans chips, so none can lose the
exchange between them.)"""

import time

import pytest
import torch

from benchmark.drivers import engine, train_step
from benchmark.tests import tiny

SEED = 2**36 + 11


def _correct(driver, cell, seconds):
    res, checks, _ = driver.run(cell, SEED, seconds, False, "cpu",
                                time.monotonic())
    return res["correct"], checks


# ------------------------------------------------------------------ serving


def _token_altered(monkeypatch, ld):
    orig = ld.sample_batch

    def altered(logits, *a, **k):
        return (orig(logits, *a, **k) + 1) % logits.shape[-1]

    monkeypatch.setattr(ld, "sample_batch", altered)


def _half_batch(monkeypatch, ld):
    orig = ld.paged_decode_step

    def half(params, pool, bt, lengths, tokens, cfg):
        logits, pool, out = orig(params, pool, bt, lengths, tokens, cfg)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0.0
        return logits, pool, out

    monkeypatch.setattr(ld, "paged_decode_step", half)


def _state_unchanged(monkeypatch, ld):
    orig = ld.paged_decode_step

    def stuck(params, pool, bt, lengths, tokens, cfg):
        logits, pool, _ = orig(params, pool, bt, lengths, tokens, cfg)
        return logits, pool, lengths.clone()

    monkeypatch.setattr(ld, "paged_decode_step", stuck)


@pytest.mark.parametrize("fault", [None, _token_altered, _half_batch,
                                   _state_unchanged])
def test_serving_fault_is_not_correct(fault, monkeypatch):
    from ray_tpu_torch.models import llama_decode as ld

    if fault is not None:
        fault(monkeypatch, ld)
    ok, checks = _correct(engine, tiny.chat_cell(), 3.0)
    assert ok is (fault is None), checks


# ----------------------------------------------------------------- training


def _no_update(monkeypatch):
    from ray_tpu_torch.ops.optim import AdamW

    monkeypatch.setattr(AdamW, "update",
                        lambda self, grads, state, params: state)


def _half_rows(monkeypatch):
    from ray_tpu_torch.models import llama

    orig = llama.loss_fn
    monkeypatch.setattr(llama, "loss_fn", lambda p, b, c: orig(
        p, {k: v[::2] for k, v in b.items()}, c))


def _loss_altered(monkeypatch):
    from ray_tpu_torch.models import llama

    orig = llama.loss_fn
    monkeypatch.setattr(llama, "loss_fn",
                        lambda p, b, c: orig(p, b, c) * 1.01)


@pytest.mark.parametrize("fault", [None, _no_update, _half_rows,
                                   _loss_altered])
def test_training_fault_is_not_correct(fault, monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    torch.manual_seed(0)
    ok, checks = _correct(train_step, tiny.train_cell(), 1.0)
    assert ok is (fault is None), checks
