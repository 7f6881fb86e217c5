"""The train plane as a whole against the JAX package on the CPU: the debug
Llama (float32, the JAX package's weights through ``params_from_numpy``)
trains through ``TorchTrainer`` with 2 gloo workers on
``MeshSpec(fsdp=-1)``, and its 2-step loss and gradient-norm curve is held
against ``ray_tpu``'s ``build_train_step`` on a 2-device virtual CPU mesh
with the same weights and tokens at ``tests/test_torch_mesh_train.py``'s
tolerance (rtol 1e-5). The workers then save the DTensor params and AdamW
state through ``torch.distributed.checkpoint``, take a third step, restore
onto the same placements and take the third step again: the two losses
are equal (the counterpart of the skipped ``tests/test_multihost.py:150``).
The plain-tensor checkpoint format round-trips on its own."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_program as prog
from ray_tpu.models import llama as jl
from ray_tpu.ops import optim as joptim
from ray_tpu.parallel import train_step as jts
from ray_tpu.parallel.mesh import MeshSpec
from ray_tpu.parallel.sharding import tree_shardings

CFG = replace(jl.PRESETS["debug"], dtype=jnp.float32)
RTOL = 1e-5


def _tokens():
    return np.random.default_rng(1).integers(
        0, CFG.vocab_size, (8, 33)).astype(np.int32)


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, jl.init_params(CFG, jax.random.key(0)))


@pytest.fixture(scope="module")
def jax_curve(params):
    mesh = MeshSpec(fsdp=-1).build(jax.devices()[:2])
    placed = jax.tree.map(lambda x, s: jax.device_put(np.array(x), s),
                          params, tree_shardings(mesh, jl.param_axes(CFG)))
    opt = joptim.adamw(1e-3, weight_decay=0.1)
    state = jts.init_optimizer_state(opt, placed)
    step = jts.build_train_step(lambda p, b: jl.loss_fn(p, b, CFG), opt,
                                mesh)
    batch = jts.shard_batch({"tokens": jnp.asarray(_tokens())}, mesh)
    losses, norms = [], []
    for _ in range(3):
        placed, state, m = step(placed, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms


@pytest.fixture(scope="module")
def trained(params, tmp_path_factory):
    import ray_tpu_torch as rt
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.torch_backend import TorchConfig

    tmp = tmp_path_factory.mktemp("parity")
    rt.init(num_cpus=2)
    try:
        result = TorchTrainer(
            prog.llama_mesh_loop,
            train_loop_config={"params": params, "tokens": _tokens(),
                               "ckpt_dir": str(tmp / "ckpt")},
            scaling_config=ScalingConfig(
                num_workers=2, torch_config=TorchConfig(
                    distributed=True, device_type="cpu")),
            run_config=RunConfig(storage_path=str(tmp / "storage"))).fit()
    finally:
        rt.shutdown()
    assert result.error is None, result.error
    return result.metrics, tmp / "ckpt"


def test_two_worker_curve_matches_jax(trained, jax_curve):
    got, _ = trained
    losses, norms = jax_curve
    assert got["world"] == 2
    np.testing.assert_allclose(got["losses"], losses[:2], rtol=RTOL)
    np.testing.assert_allclose(got["norms"], norms[:2], rtol=RTOL)
    np.testing.assert_allclose(got["loss3"], losses[2], rtol=RTOL)
    # The params live sharded over the fsdp axis, not replicated.
    assert any("Shard" in p for pl in got["placements"] for p in pl)


def test_restored_step_equals_the_uninterrupted_one(trained):
    got, ckpt = trained
    assert got["loss3_restored"] == got["loss3"]
    assert got["same_placements"] and got["count_restored"] == 2
    assert got["meta_step"] == 2
    # Every rank wrote its own shards through torch.distributed.checkpoint.
    state = ckpt / "state"
    assert (state / ".metadata").exists()
    assert sorted(p.name for p in state.glob("*.distcp")) == [
        "__0_0.distcp", "__1_0.distcp"]


def test_plain_checkpoint_round_trip(tmp_path):
    """A tree of plain tensors (params and AdamW state as the single-card
    step keeps them): each leaf lands on the target's dtype and device,
    the NamedTuple comes back as itself, ``state/`` is replaced on a
    second save, and a shape that disagrees with the target raises."""
    from ray_tpu_torch.ops.optim import adamw
    from ray_tpu_torch.train import restore_pytree, save_pytree

    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 3, generator=g),
              "b": {"x": torch.randn(5, generator=g).to(torch.bfloat16)}}
    state = adamw(1e-3).init(params)._replace(count=7)
    tree = {"params": params, "opt": state}
    ckpt = save_pytree(str(tmp_path / "c"), tree, {"note": "x"}, step=3)
    save_pytree(str(tmp_path / "c"), tree, {"note": "x"}, step=3)
    assert sorted(p.name for p in (tmp_path / "c" / "state").iterdir()) == [
        "tree.pt"]
    target = {"params": {"w": torch.zeros(4, 3, dtype=torch.float64),
                         "b": {"x": torch.zeros(5, dtype=torch.bfloat16)}},
              "opt": state._replace(count=0)}
    got, meta = restore_pytree(ckpt, target)
    assert meta == {"step": 3, "note": "x"}
    assert got["params"]["w"].dtype == torch.float64
    torch.testing.assert_close(got["params"]["w"].float(), params["w"],
                               rtol=0, atol=0)
    assert torch.equal(got["params"]["b"]["x"], params["b"]["x"])
    assert type(got["opt"]).__name__ == "AdamWState"
    assert got["opt"].count == 7
    assert torch.equal(got["opt"].mu["w"], state.mu["w"])
    assert got["params"]["w"] is not target["params"]["w"]
    untyped, _ = restore_pytree(ckpt)
    assert untyped["opt"]["count"] == 7
    assert torch.equal(untyped["params"]["w"], params["w"])
    with pytest.raises(ValueError, match="params/w"):
        restore_pytree(ckpt, {**target, "params": {
            **target["params"], "w": torch.zeros(3, 4)}})
