"""The port's meshes and sharding rules against the JAX package's:
``MeshSpec`` sizes and errors, ``spec_for`` over every rule table,
``decode_rules``, ``preset_for``; and on a 2-rank gloo mesh
(``torch_dist``): the mesh's names, ``constrain`` as a no-op outside
``axis_rules`` and replicating an indivisible dim inside, and each rank's
shards of the debug Llama's params against the JAX shards on the same
mesh shape. Exact comparisons throughout (no arithmetic)."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jsh
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsh
import torch_dist
from torch_parity import world_of_one  # noqa: F401

SPECS = [dict(), dict(data=2), dict(data=2, fsdp=-1), dict(tensor=4),
         dict(data=2, tensor=2, fsdp=-1), dict(seq=8, fsdp=1),
         dict(expert=4, data=-1, fsdp=1), dict(dcn_data=2),
         dict(dcn_data=2, tensor=2), dict(data=3), dict(data=-1, fsdp=-1),
         dict(dcn_data=3), dict(data=2, fsdp=2, tensor=4)]


def _sizes(mod, spec, n):
    try:
        return mod.MeshSpec(**spec).sizes(n)
    except ValueError as e:
        return ("ValueError", type(e).__name__)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_mesh_spec_sizes_match_jax(spec, n):
    assert _sizes(tmesh, spec, n) == _sizes(jmesh, spec, n)


def test_axes_and_presets_match_jax():
    assert tmesh.AXES == jmesh.AXES
    assert tmesh.DECODE_AXES == jmesh.DECODE_AXES
    for n in (1, 4, 8, 16):
        for params in (0, 6_000_000_000, 30_000_000_000):
            assert vars(tmesh.preset_for(n, params)) == vars(
                jmesh.preset_for(n, params))


@pytest.mark.parametrize("table", ["DEFAULT_RULES", "DECODE_RULES",
                                   "ZERO1_STATE_RULES"])
def test_rule_tables_and_spec_for_match_jax(table):
    trules, jrules = getattr(tsh, table), getattr(jsh, table)
    assert trules == jrules
    names = sorted(jrules)
    cases = [None, (), (None,), (None, None)] + [(a,) for a in names] + [
        (a, None, b) for a in names[:4] for b in names[-4:]] + [
        (None, a, None) for a in names]
    for axes in cases:
        assert tsh.spec_for(axes, trules) == tuple(
            jsh.spec_for(axes, jrules)), axes
    with pytest.raises(KeyError):
        tsh.spec_for(("no_such_axis",), trules)
    with pytest.raises(KeyError):
        jsh.spec_for(("no_such_axis",), jrules)


def test_param_axes_specs_match_jax():
    for cfg_t, cfg_j in ((tl.PRESETS["1b"], jl.PRESETS["1b"]),
                         (None, None)):
        ta, ja = tl.param_axes(cfg_t), jl.param_axes(cfg_j)
        assert ta == ja
        for path, axes in _walk(ja):
            assert tsh.spec_for(axes) == tuple(jsh.spec_for(axes)), path


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("model", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("preset", ["debug", "1b", "7b"])
def test_decode_rules_match_jax(preset, model):
    jm = jmesh.decode_mesh((1, model), jax.devices()[:model])
    want = jsh.decode_rules(jl.PRESETS[preset], jm)
    assert tsh.decode_rules(tl.PRESETS[preset],
                            {"batch": 1, "model": model}) == want


def test_decode_mesh_shape_errors_match_jax():
    for shape in ((0, 1), (1, -1)):
        with pytest.raises(ValueError):
            jmesh.decode_mesh(shape)
        with pytest.raises(ValueError):
            tmesh.decode_mesh(shape, device_type="cpu")


def test_batch_sharding_and_replicated_match_jax(world_of_one):
    jm = jmesh.MeshSpec(fsdp=-1).build(jax.devices()[:1])
    tm = tmesh.single_device_mesh(device_type="cpu")
    assert tuple(tm.shape) == (1, 1, 1, 1, 1)
    assert tsh.batch_sharding(tm).spec == tuple(jsh.batch_sharding(jm).spec)
    assert tsh.replicated(tm).spec == tuple(jsh.replicated(jm).spec)
    rules = dict(tsh.DEFAULT_RULES, length=None)
    assert tsh.batch_sharding(tm, rules).spec == tuple(
        jsh.batch_sharding(jm, rules).spec)


def test_constrain_is_a_no_op_outside_axis_rules():
    x = torch.ones(4, 8)
    assert tsh.constrain(x, ("batch", "length")) is x
    assert tsh.current_mesh() is None


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_build_raises_without_a_card_unless_cpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.MeshSpec().build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.decode_mesh((1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.init_distributed(0, 1)
    assert tmesh.backend_for("cpu") == "gloo"


@pytest.fixture(scope="module")
def jax_params():
    return jl.init_params(jl.PRESETS["debug"], jax.random.key(0))


@pytest.fixture(scope="module")
def ranks(jax_params, tmp_path_factory):
    payload = {"params": jax.tree.map(np.asarray, jax_params)}
    return torch_dist.run_ranks(torch_dist.mesh_cases, 2, payload,
                                tmp_path_factory.mktemp("mesh"))


def test_mesh_names_and_decode_mesh(ranks):
    for res in ranks:
        assert res["names"] == jmesh.AXES
        assert res["shape"] == (1, 2, 1, 1, 1)
        assert res["decode_names"] == jmesh.DECODE_AXES


def test_constrain_on_a_mesh(ranks):
    """Outside ``axis_rules`` a DTensor is returned as is; inside, a batch
    dim of 3 on a 2-way fsdp axis replicates (the JAX rule) and a dim of
    4 shards."""
    for rank, res in enumerate(ranks):
        assert res["noop_outside_rules"]
        assert res["indivisible_placements"] == ("Replicate",)
        assert res["divisible_placements"] == ("Shard0",)
        np.testing.assert_array_equal(
            res["divisible_local"],
            np.arange(16.0).reshape(4, 4)[2 * rank:2 * rank + 2])


def test_param_shards_match_jax(ranks, jax_params):
    """``shard_tree`` of the debug Llama's params on ``fsdp=2``: each rank's
    local shard equals the JAX shard on the matching device of the same
    mesh shape, value for value."""
    mesh = jmesh.MeshSpec(fsdp=2).build(jax.devices()[:2])
    placed = jax.tree.map(jax.device_put, jax_params,
                          jsh.tree_shardings(mesh, jl.param_axes()))
    want = dict(_walk(placed))
    for rank, res in enumerate(ranks):
        dev = mesh.devices.flat[rank]
        assert sorted(res["local_values"]) == sorted(
            k.lstrip("/") for k in want)
        for path, arr in want.items():
            shard = next(s for s in arr.addressable_shards
                         if s.device == dev)
            got = res["local_values"][path.lstrip("/")]
            assert got.shape == shard.data.shape, path
            np.testing.assert_array_equal(got, np.asarray(shard.data))
