"""The control (the plain reference in float8 in the program's place)
must come out not correct where the program comes out correct.

At the debug size on the CPU its readings must lie well above the
program's; at the cell's own size on a card (``-m cuda``) it must fail
the cell's limits."""

import time

import pytest

from benchmark.drivers import engine, train_step
from benchmark.harness import spec
from benchmark.tests import tiny

NUMBERS = ("loss_gap", "grad_norm_gap", "change_norm_gap")


def _run(driver, cell, seed, seconds, device="cpu"):
    res, checks, _ = driver.run(cell, seed, seconds, False, device,
                                time.monotonic(), control=True)
    return {name: value for name, value, _ in checks}, res["info"]


@pytest.mark.parametrize("seed", [2**35 + 1, 2**40 + 2])
def test_serving_control_reads_far_above_the_program(seed):
    prog, info = _run(engine, tiny.chat_cell(), seed, 3.0)
    assert info["control_logit_gap"] > max(3 * prog["logit_gap"], 0.1)


@pytest.mark.parametrize("seed", [2**35 + 1, 2**40 + 2])
def test_training_control_reads_far_above_the_program(seed):
    prog, info = _run(train_step, tiny.train_cell(), seed, 1.0)
    assert any(info["control"][k] >= 3 * prog[k] for k in NUMBERS)
    assert any(info["half_batch"][k] >= 10 * prog[k] for k in NUMBERS)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,driver", [
    ("mistral-7b.chat", engine), ("internlm2-1.8b.train4k", train_step)])
def test_control_fails_the_cell_limits(card, cell, driver):
    c = spec.load_cell(cell)
    prog, info = _run(driver, c, 2**33 + 7, 20.0, card)
    print(cell, "program", prog, "control", info.get(
        "control_logit_gap", info.get("control")), "half batch",
        info.get("half_batch"))
    assert all(v <= c.limits[k] for k, v in prog.items() if k in c.limits)
    if "control_logit_gap" in info:
        assert info["control_logit_gap"] > c.limits["logit_gap"]
    else:
        assert any(info["control"][k] > c.limits[k] for k in NUMBERS)
