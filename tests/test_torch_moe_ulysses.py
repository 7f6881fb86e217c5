"""The port's MoE and Ulysses against the JAX package's.

- ``router_topk``: dispatch and combine exactly equal (k = 1, 2, 3, with
  tied logits and dropped tokens), same capacity arithmetic;
- ``moe_ffn``: output, aux loss and every gradient of
  ``sum(out * w) + aux`` on the same weights, float32 at rtol 1e-5 /
  atol 1e-6 for values and 1e-4 of each gradient's max |value|;
- ``ulysses_attention`` on 2 gloo ranks (``torch_dist``) against the JAX
  one on a ``seq=2`` mesh: each rank's output and q/k/v gradient shards at
  atol = rtol = 2e-5 / 5e-4 (its ``impl="flash"`` is the plain attention
  on the CPU on both sides), and the heads-divisibility error;
- the debug MoE Llama trained 4 steps on a 2-rank ``expert`` mesh against
  the JAX ``build_train_step`` on the same mesh shape, AdamW(1e-3, wd
  1e-4) on both: the loss curve at rtol 1e-4 (float32; the routing is
  exact, the sums run in another order), and falling."""

from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.ops import moe as jmoe
from ray_tpu.ops import optim as joptim
from ray_tpu.parallel import train_step as jts
from ray_tpu.parallel.mesh import MeshSpec
from ray_tpu.parallel.ulysses import ulysses_attention
from ray_tpu_torch.ops import moe as tmoe
import torch_dist


@pytest.mark.parametrize("k,capacity", [(1, 3), (2, 4), (2, 16), (3, 5)])
def test_router_topk_matches_jax(k, capacity):
    rng = np.random.default_rng(k * 10 + capacity)
    logits = rng.standard_normal((16, 4)).astype(np.float32)
    logits[3] = 0.5            # a row of ties: lower index first
    logits[7, 1:3] = logits[7, 0]
    jd, jc = jmoe.router_topk(jnp.asarray(logits), k, capacity)
    td, tc = tmoe.router_topk(torch.from_numpy(logits), k, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)


def _moe_inputs(seed=0, b=2, s=8, d=16, m=32, e=4):
    params = jax.tree.map(np.asarray, jmoe.init_moe_params(
        jax.random.key(seed), d, m, e))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((b, s, d)).astype(np.float32)
    return x, w, params


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_and_gradients_match_jax(top_k):
    x, w, params = _moe_inputs()

    def jf(x, p):
        out, aux = jmoe.moe_ffn(x, p, top_k=top_k)
        return jnp.sum(out * w) + aux, (out, aux)

    (_, (jout, jaux)), (jgx, jgp) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x), params)
    tx = torch.from_numpy(x).requires_grad_()
    tp = {k_: torch.from_numpy(v.copy()).requires_grad_()
          for k_, v in params.items()}
    out, aux = tmoe.moe_ffn(tx, tp, top_k=top_k)
    ((out * torch.from_numpy(w)).sum() + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    for name, got, want in [("x", tx.grad, jgx)] + [
            (k_, tp[k_].grad, jgp[k_]) for k_ in params]:
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)


def test_moe_param_axes_match_jax():
    assert tmoe.moe_param_axes() == jmoe.moe_param_axes()
    tp = tmoe.init_moe_params(16, 32, 4, device="cpu")
    jp = jmoe.init_moe_params(jax.random.key(0), 16, 32, 4)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: v.shape for k, v in jp.items()}


ATTN = dict(b=2, s=64, h=4, d=16)


def _attn_inputs():
    rng = np.random.default_rng(1)
    shape = (ATTN["b"], ATTN["s"], ATTN["h"], ATTN["d"])
    return {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("q", "k", "v", "w")}


def _moe_cfgs():
    kw = dict(moe_experts=4, moe_top_k=2)
    jcfg = replace(jl.PRESETS["debug"], **kw)
    tkw = {k: v for k, v in asdict(jcfg).items() if k != "dtype"}
    tkw["dtype"] = torch.float32
    return replace(jcfg, dtype=jnp.float32), tkw


@pytest.fixture(scope="module")
def moe_setup():
    jcfg, tkw = _moe_cfgs()
    params = jl.init_params(jcfg, jax.random.key(0))
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (4, 65)).astype(np.int32)
    return jcfg, tkw, params, tokens


@pytest.fixture(scope="module")
def ranks(moe_setup, tmp_path_factory):
    _, tkw, params, tokens = moe_setup
    payload = {"attn": _attn_inputs(), "moe_cfg": tkw,
               "moe_params": jax.tree.map(np.asarray, params),
               "moe_tokens": tokens}
    return torch_dist.run_ranks(torch_dist.moe_ulysses_cases, 2, payload,
                                tmp_path_factory.mktemp("moe"))


def test_ulysses_matches_jax_on_every_rank(ranks):
    x = _attn_inputs()
    mesh = MeshSpec(seq=2, fsdp=1).build(jax.devices()[:2])

    def f(q, k, v):
        out = ulysses_attention(q, k, v, mesh, causal=True)
        return jnp.sum(out * x["w"]), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(x["q"], x["k"], x["v"])
    want = {"out": np.asarray(out),
            **{n: np.asarray(g) for n, g in zip(("dq", "dk", "dv"),
                                                grads)}}
    half = ATTN["s"] // 2
    for rank, res in enumerate(ranks):
        sl = slice(rank * half, (rank + 1) * half)
        got = res["ulysses"]
        np.testing.assert_allclose(got["out"], want["out"][:, sl],
                                   atol=2e-5, rtol=2e-5)
        for g in ("dq", "dk", "dv"):
            np.testing.assert_allclose(got[g], want[g][:, sl], atol=5e-4,
                                       rtol=5e-4, err_msg=f"{g} rank {rank}")
        assert "heads divisible by the seq axis" in res["heads_error"]


def test_moe_llama_on_expert_mesh_matches_jax(ranks, moe_setup):
    jcfg, _, params, tokens = moe_setup
    mesh = MeshSpec(expert=2, fsdp=1).build(jax.devices()[:2])
    params = jts.init_sharded_params(
        lambda k: jl.init_params(jcfg, k), jl.param_axes(jcfg), mesh,
        jax.random.key(0))
    opt = joptim.adamw(1e-3, weight_decay=1e-4)
    opt_state = jts.init_optimizer_state(opt, params)
    step = jts.build_train_step(lambda p, b: jl.loss_fn(p, b, jcfg), opt,
                                mesh)
    batch = jts.shard_batch({"tokens": jnp.asarray(tokens)}, mesh)
    want = []
    for _ in range(4):
        params, opt_state, m = step(params, opt_state, batch)
        want.append(float(m["loss"]))
    for res in ranks:
        assert res["expert_local_shape"] == (2, 2, 64, 128)
        np.testing.assert_allclose(res["moe_losses"], want, rtol=1e-4)
        assert res["moe_losses"][-1] < res["moe_losses"][0]
