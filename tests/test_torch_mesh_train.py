"""The port's mesh train step against the JAX package's ``build_train_step``
on the same mesh shapes, at 2 and 4 gloo ranks (``torch_dist``) against
the virtual CPU devices.

The debug Llama in float32 (fp32 masters, AdamW(1e-3, wd 0.1) on both
sides, the same weights and tokens): 2-step loss and gradient-norm
curves on ``data=2, tensor=2`` and ``fsdp=4`` (4 ranks) and on
``data=2`` and ``fsdp=2`` with ``accum_steps=2`` (2 ranks), at rtol 1e-5
(accum: 1e-4, its microbatches differentiate bf16 copies of the params),
and the updated LM head within 2e-4 (2e-3 with accum) of the JAX one;
``attention_impl="ring"`` on ``seq=2`` against the dense loss (rtol
1e-5); ZeRO-1 on ``data=2`` (per-rank state bytes at most 0.6 of the
plain step's, params replicated, the loss curve equal to the plain
step's on the same mesh at rtol 1e-6); the model-table ``ValueError``;
the ViT sharded loss on ``data=2, tensor=2`` against the dense JAX loss
at rtol 2e-3 (``tests/test_vit.py``'s bound); and
``device_prefetch(mesh=...)`` landing ``shard_batch``'s placements."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import llama as jl
from ray_tpu.models import vit as jvit
from ray_tpu.ops import optim as joptim
from ray_tpu.parallel import train_step as jts
from ray_tpu.parallel import sharding as jsh
from ray_tpu.parallel.mesh import MeshSpec
from ray_tpu.parallel.sharding import tree_shardings
from ray_tpu_torch.parallel import sharding as tsh
from ray_tpu_torch.parallel import train_step as tts
import torch_dist

CFG = replace(jl.PRESETS["debug"], dtype=jnp.float32)
MESHES = {2: [("data2", dict(data=2, fsdp=1), 1),
              ("fsdp2_accum2", dict(fsdp=2), 2)],
          4: [("data2_tensor2", dict(data=2, tensor=2, fsdp=1), 1),
              ("fsdp4", dict(fsdp=4), 1)]}


def _tokens(seed=1, shape=(8, 33)):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, shape).astype(np.int32)


def _vit_batch(cfg, n=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"images": rng.normal(size=(n, cfg.image_size, cfg.image_size,
                                       cfg.channels)).astype(np.float32),
            "labels": rng.integers(0, cfg.num_classes, n).astype(np.int64)}


@pytest.fixture(scope="module")
def setup():
    params = jl.init_params(CFG, jax.random.key(0))
    vcfg = jvit.PRESETS["debug"]
    vparams = jvit.init_params(vcfg, jax.random.key(0))
    return params, vparams


def _jax_curve(spec, accum, params, n_dev):
    mesh = MeshSpec(**spec).build(jax.devices()[:n_dev])
    placed = jax.tree.map(lambda x, s: jax.device_put(np.array(x), s),
                          params, tree_shardings(mesh, jl.param_axes(CFG)))
    opt = joptim.adamw(1e-3, weight_decay=0.1)
    state = jts.init_optimizer_state(opt, placed)
    step = jts.build_train_step(lambda p, b: jl.loss_fn(p, b, CFG), opt,
                                mesh, accum_steps=accum)
    batch = jts.shard_batch({"tokens": jnp.asarray(_tokens())}, mesh)
    losses, norms = [], []
    for _ in range(2):
        placed, state, m = step(placed, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, np.asarray(placed["lm_head"])


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    params, vparams = setup
    base = {"params": jax.tree.map(np.asarray, params),
            "tokens": _tokens()}
    tmp = tmp_path_factory.mktemp("train")
    return {
        2: torch_dist.run_ranks(torch_dist.train_cases, 2, {
            **base, "meshes": MESHES[2], "seq": _tokens(2, (2, 65)),
            "zero1": True}, tmp),
        4: torch_dist.run_ranks(torch_dist.train_cases, 4, {
            **base, "meshes": MESHES[4],
            "vit": {"params": jax.tree.map(np.asarray, vparams),
                    "batch": _vit_batch(jvit.PRESETS["debug"])}}, tmp)}


@pytest.mark.parametrize("n,name,spec,accum",
                         [(n, *m) for n in (2, 4) for m in MESHES[n]],
                         ids=lambda v: v if isinstance(v, str) else None)
def test_sharded_llama_curve_matches_jax(ranks, setup, n, name, spec,
                                         accum):
    losses, norms, lm_head = _jax_curve(spec, accum, setup[0], n)
    tol = 1e-4 if accum > 1 else 1e-5
    for res in ranks[n]:
        got = res[name]
        np.testing.assert_allclose(got["losses"], losses, rtol=tol)
        np.testing.assert_allclose(got["norms"], norms, rtol=tol)
        assert np.abs(got["lm_head"] - lm_head).max() <= (
            2e-3 if accum > 1 else 2e-4)


def test_ring_llama_loss_matches_dense(ranks, setup):
    toks = _tokens(2, (2, 65))
    dense = float(jl.loss_fn(setup[0], {"inputs": toks[:, :-1],
                                        "targets": toks[:, 1:]}, CFG))
    for res in ranks[2]:
        np.testing.assert_allclose(res["ring_loss"], dense, rtol=1e-5)


def test_zero1_state_bytes_and_parity(ranks):
    for res in ranks[2]:
        plain, z1 = res["zero1_bytes"]
        assert z1 <= 0.6 * plain, (z1, plain)
        assert res["zero1"]["params_placements"] == [
            ("Replicate",) * 5]
        np.testing.assert_allclose(res["zero1"]["losses"],
                                   res["data2"]["losses"], rtol=1e-6)
        np.testing.assert_allclose(res["zero1"]["norms"],
                                   res["data2"]["norms"], rtol=1e-6)
        np.testing.assert_allclose(res["zero1"]["lm_head"],
                                   res["data2"]["lm_head"], atol=1e-6)


def test_zero1_rejects_a_model_rules_table():
    with pytest.raises(ValueError, match="zero1_shard"):
        tts.zero1_state_shardings({"data": 2}, {}, tsh.DEFAULT_RULES)
    with pytest.raises(ValueError, match="zero1_shard"):
        jts.zero1_state_shardings(
            MeshSpec(data=2, fsdp=1).build(jax.devices()[:2]), {},
            jsh.DEFAULT_RULES)


def test_vit_sharded_loss_matches_dense(ranks, setup):
    vcfg = jvit.PRESETS["debug"]
    dense = float(jvit.loss_fn(setup[1], {
        k: jnp.asarray(v) for k, v in _vit_batch(vcfg).items()}, vcfg)[0])
    for res in ranks[4]:
        np.testing.assert_allclose(res["vit_loss"], dense, rtol=2e-3)


@pytest.mark.parametrize("n", [2, 4])
def test_device_prefetch_lands_shard_batch_placements(ranks, n):
    for rank, res in enumerate(ranks[n]):
        got = res["prefetch"]
        assert got["placements"] == got["want"]
        assert got["spec"] == tuple(jsh.spec_for(("batch", "length")))
        for i, labels in enumerate(got["local"]):
            rows = 4 // n
            np.testing.assert_array_equal(
                labels, (np.arange(4) + i)[rank * rows:(rank + 1) * rows])
