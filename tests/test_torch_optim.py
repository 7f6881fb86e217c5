"""The port's AdamW vs ``ray_tpu.ops.optim.adamw``: five updates of the
same params under the same gradients (numpy, from a seed), then params,
mu, nu and the count compared.

float32 compares at rtol = atol = 1e-6 (the same elementwise math; the
bias corrections are computed in float64 on the host here and in float32
by JAX, a relative difference of ~1e-7). A bf16 mu compares at one bf16
ulp (rtol = atol = 1e-2): it is rounded to bf16 after every update on both
sides."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.ops import optim as joptim
from ray_tpu_torch.ops import optim as toptim

F32 = dict(rtol=1e-6, atol=1e-6)


def _tree(rng):
    return {"w": rng.normal(size=(4, 6)).astype(np.float32),
            "layers": {"a": rng.normal(size=(2, 3, 5)).astype(np.float32),
                       "norm": rng.normal(size=(7,)).astype(np.float32)}}


def _run(steps=5, **kw):
    """Params, state of both sides after ``steps`` updates."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(steps)]
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("mu_dtype") == "bf16":
        jkw["mu_dtype"], tkw["mu_dtype"] = jnp.bfloat16, torch.bfloat16
    jopt, topt = joptim.adamw(**jkw), toptim.adamw(**tkw)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = toptim.tree_map(lambda x: torch.from_numpy(x.copy()), params)
    ts = topt.init(tp)
    for g in grads:
        upd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = topt.update(toptim.tree_map(torch.from_numpy, g), ts, tp)
    return jp, js, tp, ts


def _pairs(jtree, ttree):
    jl = jax.tree.leaves(jtree)       # sorted keys, as tree_leaves
    tl = toptim.tree_leaves(ttree)
    assert len(jl) == len(tl)
    return [(np.asarray(a.astype(jnp.float32)), b.float().numpy())
            for a, b in zip(jl, tl)]


@pytest.mark.parametrize("kw", [
    dict(learning_rate=1e-2),
    dict(learning_rate=1e-2, weight_decay=0.1),
    dict(learning_rate=3e-3, b1=0.8, b2=0.95, eps=1e-6, weight_decay=0.05),
    dict(learning_rate=lambda count: 1e-2 / count),
], ids=["plain", "weight_decay", "betas_eps", "schedule"])
def test_adamw_matches_jax(kw):
    jp, js, tp, ts = _run(**kw)
    assert ts.count == int(js.count) == 5
    for a, b in _pairs(jp, tp):
        np.testing.assert_allclose(b, a, **F32)
    for a, b in _pairs(js.mu, ts.mu) + _pairs(js.nu, ts.nu):
        np.testing.assert_allclose(b, a, **F32)


def test_adamw_bf16_mu_matches_jax():
    jp, js, tp, ts = _run(learning_rate=1e-2, weight_decay=0.1,
                          mu_dtype="bf16")
    assert all(m.dtype == torch.bfloat16 for m in toptim.tree_leaves(ts.mu))
    assert all(v.dtype == torch.float32 for v in toptim.tree_leaves(ts.nu))
    for a, b in _pairs(js.mu, ts.mu):
        np.testing.assert_allclose(b, a, rtol=1e-2, atol=1e-2)
    for a, b in _pairs(jp, tp) + _pairs(js.nu, ts.nu):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


def test_adamw_updates_in_place():
    """The port's update writes params, mu and nu in place (the JAX
    package's donation): the caller's tensors are the updated ones."""
    p = {"w": torch.ones(3)}
    opt = toptim.adamw(0.1)
    state = opt.init(p)
    w, mu = p["w"], state.mu["w"]
    state = opt.update({"w": torch.ones(3)}, state, p)
    assert p["w"] is w and state.mu["w"] is mu
    torch.testing.assert_close(w, torch.full((3,), 0.9))
