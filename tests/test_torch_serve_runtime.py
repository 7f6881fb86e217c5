"""The port's serve plane (controller, router, replica actors, HTTP proxy)
held against the JAX package's on the CPU.

One module-scoped run of each package, in turn (init, use, shutdown,
never both initialised): the plain deployment program of
``torch_runtime_program.serve_program`` (status keys, overload, deadlines,
a cancelled stream, a handle retry across a replica death, delete) must
give equal outcomes; a tiny Llama (vocab 61, dim 32, 2 layers, 4/2 heads,
MLP 64) served through ``serve.run`` answers the unary call, the handle
stream and the HTTP chunked stream equally, token for token, and equal to
the port's in-process ``DecodeEngine`` on the same seed; the JAX package's
weights served by both packages agree under the margin rule; and the
disaggregated splice through the router equals the colocated engine."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_runtime_program as prog
from torch_parity import TINY, assert_greedy_agrees, greedy_with_margins

TOL = 1e-4
NEW = 6
PROMPTS = [[5, 9, 2], [11, 3, 4, 8, 1, 2, 7, 30, 41, 5, 17, 2, 9, 60,
                       13, 22, 8, 3, 50, 1]]


def _llama_outputs(serve, name: str, addr):
    """Unary, handle-stream and HTTP-stream tokens of each prompt."""
    h = serve.get_deployment_handle(name)
    out = {"unary": [], "stream": [], "http": []}
    for p in PROMPTS:
        req = {"tokens": p, "max_new_tokens": NEW}
        out["unary"].append(h.remote(req).result(timeout=120)["tokens"])
        out["stream"].append(list(h.stream({**req, "stream": True})))
        code, _, lines = prog.post(addr, name, {**req, "stream": True},
                                   headers={"X-Serve-Stream": "1"})
        assert code == 200, lines
        out["http"].append([json.loads(x) for x in lines])
    return out


def _live_workers(node_hex: str):
    """Pids of processes whose command line names this node."""
    pids = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if node_hex.encode() in f.read():
                    pids.append(int(pid))
        except OSError:
            continue
    return pids


def _jax_side(marker, jcfg):
    import ray_tpu
    from ray_tpu import serve
    from ray_tpu.serve.decode import LlamaDecodeDeployment

    ray_tpu.init(num_cpus=4)
    try:
        out = {"plain": prog.serve_program("ray_tpu", marker)}
        serve.run(serve.deployment(LlamaDecodeDeployment).options(
            max_concurrency=4).bind(config=jcfg, slots=2, capacity=64),
            name="llm")
        out["llm"] = _llama_outputs(serve, "llm", serve.start_http())
        serve.shutdown()
    finally:
        ray_tpu.shutdown()
    return out


def _port_side(marker, tcfg, np_params):
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.node import shm_store_path
    from ray_tpu_torch.core.runtime import get_core_worker
    from ray_tpu_torch.serve.decode import LlamaDecodeDeployment
    from ray_tpu_torch.serve.deployment import _Router

    from torch_serve_apps import NumpyWeightsLlama

    rt.init(num_cpus=4)
    core = get_core_worker()
    node_hex, store = core.node_id.hex(), shm_store_path(core.node_id)
    try:
        out = {"plain": prog.serve_program("ray_tpu_torch", marker)}
        dep = serve.deployment(LlamaDecodeDeployment).options(
            max_concurrency=4)
        serve.run(dep.bind(config=tcfg, slots=2, capacity=64, seed=0,
                           device="cpu"), name="llm")
        serve.run(serve.deployment(NumpyWeightsLlama).options(
            max_concurrency=4).bind(np_params, tcfg, 2, 64), name="llm-np")
        paged = dict(config=tcfg, slots=2, capacity=128, seed=0,
                     kv_page_tokens=16, device="cpu")
        serve.run(serve.deployment(LlamaDecodeDeployment, role="decode")
                  .options(max_concurrency=4).bind(**paged),
                  name="dg-decode")
        serve.run(serve.deployment(LlamaDecodeDeployment, role="prefill",
                                   decode_deployment="dg-decode")
                  .options(max_concurrency=4).bind(**paged),
                  name="dg-prefill")
        addr = serve.start_http()
        # The router splices only once it sees the decode fleet: warm the
        # driver's view of it (a proxy's first request may still go the
        # colocated way, with the same answer).
        _Router.get("dg-decode").wait_ready(60)
        out["llm"] = _llama_outputs(serve, "llm", addr)
        out["llm-np"] = _llama_outputs(serve, "llm-np", addr)
        out["spliced"] = _llama_outputs(serve, "dg-prefill", addr)
        metrics = serve.get_deployment_handle("dg-prefill").options(
            method_name="replica_metrics")
        out["prefill_metrics"] = prog._poll(
            lambda: metrics.remote().result(timeout=30)["handoffs_live"], 0)
        out["prefill_published"] = metrics.remote().result(
            timeout=30)["handoffs_published"]
        out["store_bytes_while_up"] = os.path.exists(store)
        serve.shutdown()
    finally:
        rt.shutdown()
    out["store_left"] = os.path.exists(store)
    out["workers_left"] = prog._poll(lambda: _live_workers(node_hex), [],
                                     10)
    return out


def _solo(params, tcfg, prompts, **kw):
    from ray_tpu_torch.serve.decode import DecodeEngine

    eng = DecodeEngine(params, tcfg, device="cpu", **kw)
    reqs = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    for _ in range(500):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    eng.shutdown()
    return [r.output for r in reqs]


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    from ray_tpu.models import llama as jl
    from ray_tpu_torch.models import llama as tl

    jcfg = jl.LlamaConfig(dtype=jnp.float32, **TINY)
    tcfg = tl.LlamaConfig(dtype=torch.float32, **TINY)
    np_params = jax.tree.map(np.asarray, jl.init_params(
        jcfg, jax.random.key(0)))
    d = tmp_path_factory.mktemp("serve_runtime")
    jax_out = _jax_side(str(d / "jax-marker"), jcfg)
    port_out = _port_side(str(d / "port-marker"), tcfg, np_params)
    return {"jax": jax_out, "port": port_out, "tcfg": tcfg,
            "np_params": np_params}


# ------------------------------------------- the plain deployment program


def test_plain_status_keys_and_echo(sides):
    j, t = sides["jax"]["plain"], sides["port"]["plain"]
    assert t["status_keys"] == j["status_keys"]
    for key in ("replicas", "replica_ids", "slo", "shed", "load"):
        assert key in t["status_keys"], key
    assert t["echo"] == j["echo"] == {"x": 42}
    assert t["http_echo"] == j["http_echo"] == (200, [{"x": 8}])


def test_overload_sheds_with_retry_after(sides):
    j, t = sides["jax"]["plain"], sides["port"]["plain"]
    assert t["handle_overload"] == j["handle_overload"] == "OverloadedError"
    assert t["http_overload"] == j["http_overload"] == (503, "3")


def test_deadline_typed_through_handle_and_504(sides):
    j, t = sides["jax"]["plain"], sides["port"]["plain"]
    assert (t["handle_deadline"] == j["handle_deadline"]
            == "DeadlineExceededError")
    assert t["http_deadline"] == j["http_deadline"] == 504


def test_closed_stream_cancels_once(sides):
    j, t = sides["jax"]["plain"], sides["port"]["plain"]
    assert t["stream_head"] == j["stream_head"] == [0, 1, 2]
    assert t["stream_cancelled"] == j["stream_cancelled"] == 1


def test_handle_retries_across_replica_death_and_heals(sides):
    j, t = sides["jax"]["plain"], sides["port"]["plain"]
    assert t["retry"] == j["retry"] == {"survived": True}
    assert t["healed_replicas"] == j["healed_replicas"] == 2


def test_delete_removes_deployment(sides):
    j, t = sides["jax"]["plain"], sides["port"]["plain"]
    assert t["listed_after_delete"] is j["listed_after_delete"] is False


# ------------------------------------------------------- the tiny Llama


def test_llama_paths_equal_and_match_engine(sides):
    """Unary, handle stream and HTTP chunked stream of the port's replica
    equal each other and a solo run of the in-process engine on the same
    seed, token for token."""
    from ray_tpu_torch.models import llama as tl

    tcfg = sides["tcfg"]
    got = sides["port"]["llm"]
    want = [_solo(tl.init_params(tcfg, device="cpu", seed=0), tcfg, [p],
                  slots=2, capacity=64)[0] for p in PROMPTS]
    assert got["unary"] == got["stream"] == got["http"] == want
    assert all(len(w) == NEW for w in want)


def test_llama_served_matches_jax_served(sides):
    """The JAX package's weights served by both packages: greedy tokens
    agree under the margin rule."""
    from ray_tpu_torch.models import llama as tl

    tcfg = sides["tcfg"]
    tp = tl.params_from_numpy(sides["np_params"], tcfg, device="cpu")
    jgot, tgot = sides["jax"]["llm"], sides["port"]["llm-np"]
    assert tgot["unary"] == tgot["stream"] == tgot["http"]
    assert jgot["unary"] == jgot["stream"] == jgot["http"]
    for p, tt, jt in zip(PROMPTS, tgot["unary"], jgot["unary"]):
        _, margins = greedy_with_margins(tcfg, tp, p, NEW)
        assert_greedy_agrees(tt, jt, margins, TOL)


def test_disagg_splice_equals_colocated(sides):
    """Requests to the prefill fleet are spliced by the router onto the
    decode fleet over the object store, and come back equal to the
    colocated paged engine on the same seed; every lease is
    discharged."""
    from ray_tpu_torch.models import llama as tl

    tcfg, t = sides["tcfg"], sides["port"]
    want = [_solo(tl.init_params(tcfg, device="cpu", seed=0), tcfg, [p],
                  slots=2, capacity=128, page_tokens=16)[0]
            for p in PROMPTS]
    got = t["spliced"]
    assert got["unary"] == got["stream"] == got["http"] == want
    # Every handle call splices; HTTP calls do once the proxy's router
    # sees the decode fleet.
    assert 2 * len(PROMPTS) <= t["prefill_published"] <= 3 * len(PROMPTS)
    assert t["prefill_metrics"] == 0


def test_teardown_leaves_no_worker_or_store_file(sides):
    t = sides["port"]
    assert t["store_bytes_while_up"] is True
    assert t["store_left"] is False
    assert t["workers_left"] == []


def test_mesh_deployment_of_two_ranks_serves(monkeypatch):
    """On a virtual 2x4 slice, ``serve.run`` of a deployment with
    ``mesh_shape=(2, 1)`` spawns one replica of two rank processes on a
    two-chip sub-slice (the deployment gets the mesh shape bound into its
    init kwargs) and serves; ``serve.delete`` releases the sub-slice. A
    ``(1, 1)`` mesh is placed on a one-chip sub-slice and serves."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    from torch_serve_apps import MeshEcho

    monkeypatch.setenv("RAY_TPU_VIRTUAL_SLICE", "2x4")
    rt.init(num_cpus=3)
    try:
        handle = serve.run(serve.deployment(MeshEcho,
                                            mesh_shape=(2, 1)).bind(),
                           name="mesh2", ready_timeout_s=60)
        assert handle.remote({"x": 3}).result(timeout=30) == {
            "mesh_shape": [2, 1], "x": 3}
        (owner,) = rt.cluster_topology()["owners"].items()
        assert owner[1].startswith("mesh2#")
        (slice_state,) = rt.cluster_topology()["slices"].values()
        assert slice_state["chips_free"] == 6
        serve.delete("mesh2")
        assert rt.cluster_topology()["owners"] == {}
        handle = serve.run(serve.deployment(MeshEcho,
                                            mesh_shape=(1, 1)).bind(),
                           name="mesh1", ready_timeout_s=60)
        assert handle.remote({"x": 3}).result(timeout=30) == {
            "mesh_shape": [1, 1], "x": 3}
        assert len(rt.cluster_topology()["owners"]) == 1
        serve.shutdown()
    finally:
        rt.shutdown()
