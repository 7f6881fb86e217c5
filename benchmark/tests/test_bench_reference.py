"""The plain reference agrees with the port at the debug size, both in
float32 (on the CPU, where the port runs its plain paths)."""

from dataclasses import replace

import pytest
import torch

from benchmark.drivers.common import llama_config
from benchmark.harness import weights
from benchmark.reference import llama as ref
from benchmark.tests.tiny import DEBUG

SEED = 2**41 + 3


def _port_cfg(seq):
    return replace(llama_config(DEBUG, {"dtype": "float32",
                                        "attention_impl": "xla"}, seq),
                   remat=False)


def test_forward_logits_agree():
    from ray_tpu_torch.models import llama

    tree = weights.make(DEBUG, SEED, torch.float32, "cpu")
    tokens = torch.randint(0, DEBUG["vocab_size"], (1, 40),
                           generator=torch.Generator().manual_seed(1))
    port = llama.forward(tree, tokens, _port_cfg(64))[0]
    mine = ref.logits_at(tree, tokens[0], DEBUG, range(40))
    torch.testing.assert_close(mine, port, rtol=1e-4, atol=1e-4)


def test_loss_gradients_and_one_adamw_step_agree():
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.optim import adamw
    from ray_tpu_torch.parallel import train_step

    cfg = _port_cfg(32)
    batch = torch.randint(0, DEBUG["vocab_size"], (2, 33),
                          generator=torch.Generator().manual_seed(2))
    opt = {"learning_rate": 1e-3, "weight_decay": 0.1}
    mine = ref.train(DEBUG, SEED, [batch], opt, "cpu")
    params = weights.make(DEBUG, SEED, torch.float32, "cpu")
    o = adamw(1e-3, weight_decay=0.1)
    state = train_step.init_optimizer_state(o, params)
    step = train_step.build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), o)
    params, state, m = step(params, state, {"tokens": batch})
    assert float(m["loss"]) == pytest.approx(mine["losses"][0], rel=1e-5)
    for path, mu in weights.flat(state.mu).items():
        assert float(mu.norm()) / 0.1 == pytest.approx(
            mine["grad_norms"][path], rel=1e-4), path
    for path, p in weights.flat(params).items():
        moved = float((p - weights.draw(DEBUG, SEED, path, torch.float32,
                                        "cpu")).norm())
        assert moved == pytest.approx(mine["change_norms"][path],
                                      rel=1e-4), path


def test_control_rounds_to_float8():
    x = torch.linspace(-3, 3, 101)
    q = ref._round(x, torch.float8_e4m3fn, 448.0)
    assert not torch.equal(q, x)
    assert (q - x).abs().max() <= 3 * 2 ** -4
