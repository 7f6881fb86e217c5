"""The port's ``ring_attention`` against the JAX package's on the same numpy
inputs, at 2 and 4 gloo ranks (``torch_dist``) against the JAX ring on a
``seq`` mesh of the same size over the virtual CPU devices.

Both impls, causal and not, at head_dim 16 so the flash impl's zero pad
to 128 runs (the flash hops are the plain ``flash_attention_stats`` on
the CPU), 4 query heads on 2 kv heads. Each rank's output shard and its
q/k/v gradient shards of ``sum(out * w)`` are checked against the JAX
values' slice for that rank (the K/V gradients arrive one rotation late,
through the reverse ring). The JAX flash ring runs its Pallas kernel in
interpret mode, so it is taken at seq=2 only; at 4 ranks the flash impl
is held to the JAX xla ring (the same function).

Tolerances (float32): outputs atol = rtol = 2e-5, gradients 5e-4, as the
JAX package's own flash tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.parallel.mesh import MeshSpec
from ray_tpu.parallel.ring_attention import ring_attention
import torch_dist

B, S, H, HKV, D = 2, 64, 4, 2, 16


def _inputs():
    rng = np.random.default_rng(0)
    shapes = dict(q=(B, S, H, D), k=(B, S, HKV, D), v=(B, S, HKV, D),
                  w=(B, S, H, D))
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}


def _jax_ring(x, n, impl, causal):
    mesh = MeshSpec(seq=n, fsdp=1).build(jax.devices()[:n])

    def f(q, k, v):
        out = ring_attention(q, k, v, mesh, causal=causal, impl=impl)
        return jnp.sum(out * x["w"]), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(x["q"], x["k"], x["v"])
    return {"out": np.asarray(out),
            **{n_: np.asarray(g) for n_, g in zip(("dq", "dk", "dv"),
                                                  grads)}}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_refs(inputs):
    refs = {}
    for n in (2, 4):
        for causal in (True, False):
            refs[(n, "xla", causal)] = _jax_ring(inputs, n, "xla", causal)
            refs[(n, "flash", causal)] = (
                _jax_ring(inputs, 2, "flash", causal) if n == 2
                else refs[(n, "xla", causal)])
    return refs


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    return {n: torch_dist.run_ranks(torch_dist.ring_cases, n, inputs, tmp)
            for n in (2, 4)}


def _shard(a, rank, n):
    s = a.shape[1] // n
    return a[:, rank * s:(rank + 1) * s]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_on_every_rank(port, jax_refs, n, impl, causal):
    want = jax_refs[(n, impl, causal)]
    for rank, res in enumerate(port[n]):
        got = res[(impl, causal)]
        np.testing.assert_allclose(got["out"], _shard(want["out"], rank, n),
                                   atol=2e-5, rtol=2e-5)
        for g in ("dq", "dk", "dv"):
            np.testing.assert_allclose(got[g], _shard(want[g], rank, n),
                                       atol=5e-4, rtol=5e-4,
                                       err_msg=f"{g} on rank {rank}")


@pytest.mark.parametrize("n", [2, 4])
def test_ring_plain_tensors_in_and_out(port, jax_refs, n):
    """Full plain tensors on every rank: the output and the gradients come
    back whole on each rank."""
    want = jax_refs[(n, "flash", True)]
    for res in port[n]:
        np.testing.assert_allclose(res["plain"]["out"], want["out"],
                                   atol=2e-5, rtol=2e-5)
        for g in ("dq", "dk", "dv"):
            np.testing.assert_allclose(res["plain"][g], want[g], atol=5e-4,
                                       rtol=5e-4)


def test_ring_flash_block_error_matches_jax(port):
    """A shard that does not divide the flash blocks raises the JAX
    package's ValueError."""
    for res in port[2]:
        assert "must divide flash blocks" in res["block_error"]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("n", [2, 4])
def test_flash_ring_body_over_an_indexing_rotation(inputs, jax_refs, n,
                                                   causal):
    """``ring_flash_attention_local`` for every rank of an n-ring in one
    process (its ``ring`` argument: K/V rotated by indexing, as the card's
    loopback check runs it): the whole output and q/k/v gradients against
    the JAX ring's."""
    q, k, v = (torch.from_numpy(inputs[x]).requires_grad_()
               for x in ("q", "k", "v"))
    out = torch_dist.loopback_ring(q, k, v, n, causal)
    (out * torch.from_numpy(inputs["w"])).sum().backward()
    want = jax_refs[(n, "flash", causal)]
    np.testing.assert_allclose(out.detach().numpy(), want["out"],
                               atol=2e-5, rtol=2e-5)
    for g, t in zip(("dq", "dk", "dv"), (q, k, v)):
        np.testing.assert_allclose(t.grad.numpy(), want[g], atol=5e-4,
                                   rtol=5e-4, err_msg=g)
