"""The mesh replica on the port's serve plane: a deployment with a
``mesh_shape`` gets replicas that span a sub-slice, one process a rank
(rank 0 a ``ReplicaActor`` the router sees, ranks 1.. ``MeshRankActor``
followers in lockstep over a gloo group on the CPU).

Carried from ``tests/test_sharded_decode.py`` under the same names:
``test_router_prefers_ici_local_replica`` (on the port's router) and
``test_mesh_replica_serves_end_to_end`` at (2, 4) on 8 ranks, ``slow`` and
``timeout_s(420)`` as the reference. Tier-1 adds (1, 2) and (2, 1) on two
ranks of a ``1x2`` virtual slice at the debug preset: the handle's and the
HTTP proxy's streams equal the single-device engine's, ``status()``
reports two chips, killing rank 1 replaces the replica whose streams are
then equal again, and a second two-chip deployment is refused placement
until ``serve.delete`` frees the slice."""

import json
import os
import time
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve

PROMPTS = [[5, 9, 2], [7, 3, 11, 4, 8]]
NEW = 5


def _single_device(config, prompts, n_tok, slots=4, capacity=64):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.decode import DecodeEngine

    eng = DecodeEngine(llama.init_params(config, device="cpu", seed=0),
                       config, slots=slots, capacity=capacity,
                       device="cpu")
    reqs = [eng.submit(list(p), max_new_tokens=n_tok) for p in prompts]
    for _ in range(200):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    assert all(r.done.is_set() for r in reqs)
    return [r.output for r in reqs]


def _deploy(name, mesh_shape, ready_timeout_s=180, **kw):
    from ray_tpu_torch.serve.decode import LlamaDecodeDeployment

    kw.setdefault("preset", "debug")
    return serve.run(
        serve.deployment(LlamaDecodeDeployment, name=name).options(
            max_concurrency=4).bind(slots=4, capacity=64, seed=0,
                                    mesh_shape=mesh_shape, device="cpu",
                                    **kw),
        name=name, ready_timeout_s=ready_timeout_s)


def _streams(name, prompts, n_tok):
    """(unary, handle stream, HTTP stream) outputs for every prompt."""
    handle = serve.get_deployment_handle(name)
    unary = [handle.remote({"tokens": p, "max_new_tokens": n_tok}
                           ).result(timeout=180)["tokens"] for p in prompts]
    stream = [list(handle.stream({"tokens": p, "max_new_tokens": n_tok,
                                  "stream": True})) for p in prompts]
    host, port = serve.start_http()
    http = []
    for p in prompts:
        req = urllib.request.Request(
            f"http://{host}:{port}/{name}",
            data=json.dumps({"tokens": p, "max_new_tokens": n_tok,
                             "stream": True}).encode(),
            headers={"X-Serve-Stream": "1"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            http.append([json.loads(ln)
                         for ln in resp.read().splitlines() if ln])
    return unary, stream, http


def _topology(name, timeout=30.0):
    deadline = time.monotonic() + timeout
    while True:
        st = serve.status()[name]
        topo = st["replica_topology"]
        if (topo and topo[0]["mesh_shape"]) or time.monotonic() > deadline:
            return st
        time.sleep(0.2)


def _rank_actors():
    from ray_tpu_torch.core.runtime import get_core_worker

    return [a for a in get_core_worker().controller.call("list_actors")
            if a["state"] == "ALIVE"
            and "MeshRankActor" in str(a["info"].get("class_name", ""))]


@pytest.fixture(scope="module")
def slice_1x2():
    old = os.environ.get("RAY_TPU_VIRTUAL_SLICE")
    os.environ["RAY_TPU_VIRTUAL_SLICE"] = "1x2"
    rt.init(num_cpus=6)
    try:
        yield
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
            if old is None:
                os.environ.pop("RAY_TPU_VIRTUAL_SLICE", None)
            else:
                os.environ["RAY_TPU_VIRTUAL_SLICE"] = old


@pytest.fixture(scope="module")
def debug_ref():
    from ray_tpu_torch.models import llama

    return _single_device(llama.PRESETS["debug"], PROMPTS, NEW)


# ------------------------------------------------------- router slice


def test_router_prefers_ici_local_replica(monkeypatch):
    """With two unsaturated replicas on different slices, the router
    picks the one on the caller's own slice (controller snapshots carry
    slice ids; locality never overrides saturation)."""
    import importlib
    import threading

    # ray_tpu_torch.serve re-exports the @deployment decorator under the
    # same name as the module; import the module itself.
    dep_mod = importlib.import_module("ray_tpu_torch.serve.deployment")

    router = dep_mod._Router.__new__(dep_mod._Router)
    router.name = "t"
    router._lock = threading.Lock()
    router._inflight = {}
    router._version = 1
    router._max_ongoing = 2
    router._deleted = False
    router._replicas = [
        {"handle": object(), "id": "a", "models": set(),
         "prefixes": set(), "slice_id": "far"},
        {"handle": object(), "id": "b", "models": set(),
         "prefixes": set(), "slice_id": "here"},
    ]
    monkeypatch.setattr(dep_mod, "_local_slice_cache", ["here"])
    for _ in range(8):
        chosen = router._pick("")
        assert chosen["id"] == "b"
        router._release(chosen)
    # saturated local replica: load escapes locality
    router._inflight["b"] = 2
    assert router._pick("")["id"] == "a"


# --------------------------------------------- eight ranks, slow
# (first: its own cluster is up and down before the module's starts)


@pytest.fixture
def mesh_serve_cluster(monkeypatch):
    monkeypatch.setenv("RAY_TPU_VIRTUAL_SLICE", "2x4")
    core = rt.init(num_cpus=10)
    yield core
    try:
        serve.shutdown()
    except Exception:
        pass
    rt.shutdown()


@pytest.mark.timeout_s(420)
@pytest.mark.slow  # eight rank processes; the two-rank cases above stay
# in tier-1, as the reference keeps its engine-level parity there
def test_mesh_replica_serves_end_to_end(mesh_serve_cluster):
    """Acceptance: a deployment with mesh_shape=(2, 4) spawns ONE
    replica spanning all 8 virtual devices, one process a rank, streams
    through proxy -> router -> replica, its outputs equal the single-chip
    engine at equal capacity, status reports the topology, and a second
    8-chip deployment is refused placement until the slice frees."""
    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab_size=64, dim=32, n_layers=2, n_heads=8,
                            n_kv_heads=8, mlp_dim=64, max_seq_len=128)
    ref = _single_device(cfg, [[5, 9, 2]], 5)[0]

    _deploy("llm", (2, 4), config=cfg, preset=None)
    unary, stream, http = _streams("llm", [[5, 9, 2]], 5)
    assert unary == stream == http == [ref]

    # one replica spans the whole slice, and status says where it lives
    st = _topology("llm")
    assert st["replicas"] == 1
    assert st["chips_in_use"] == 8
    topo = st["replica_topology"][0]
    assert topo["mesh_shape"] == [2, 4] and topo["chips"] == 8
    assert topo["slice_id"].startswith("virtual-")
    assert topo["sub_slice"] == {"origin": [0, 0], "shape": [2, 4]}
    assert len(_rank_actors()) == 7

    # the slice is fully reserved: a second 8-chip replica is refused —
    # the deployment stays at 0 replicas (queued), it is never placed
    # on a fragment
    _deploy("llm2", (2, 4), config=cfg, preset=None, ready_timeout_s=15)
    time.sleep(1.5)
    st2 = serve.status()["llm2"]
    assert st2["replicas"] == 0 and st2["chips_in_use"] == 0
    slice_state = list(rt.cluster_topology()["slices"].values())[0]
    assert slice_state["chips_free"] == 0
    assert len(slice_state["reservations"]) == 1

    # freeing the slice lets the queued deployment place (reconcile)
    serve.delete("llm")
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        st2 = serve.status().get("llm2", {})
        if st2.get("replicas"):
            break
        time.sleep(0.5)
    assert st2.get("replicas") == 1
    assert st2.get("chips_in_use") == 8


# ---------------------------------------------- two ranks, tier-1


@pytest.mark.timeout_s(300)
@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 1)],
                         ids=["1x2", "2x1"])
def test_mesh_replica_of_two_ranks_serves_and_heals(slice_1x2, debug_ref,
                                                    mesh_shape):
    name = f"mesh{mesh_shape[0]}{mesh_shape[1]}"
    _deploy(name, mesh_shape)
    assert _streams(name, PROMPTS, NEW) == (debug_ref,) * 3
    st = _topology(name)
    assert st["replicas"] == 1 and st["chips_in_use"] == 2
    topo = st["replica_topology"][0]
    assert topo["chips"] == 2 and topo["mesh_shape"] == list(mesh_shape)
    # The whole 1x2 grid (a 2x1 mesh takes it turned).
    assert topo["sub_slice"]["origin"] == [0, 0]
    assert sorted(topo["sub_slice"]["shape"]) == [1, 2]
    first = topo["replica_id"]

    # Rank 1 dies: the replica goes as one unit and is replaced.
    from ray_tpu_torch.core.actor import ActorHandle
    from ray_tpu_torch.core.ids import ActorID

    ranks = _rank_actors()
    assert len(ranks) == 1
    rt.kill(ActorHandle(ActorID(ranks[0]["actor_id"])))
    deadline = time.monotonic() + 120
    while True:
        st = serve.status()[name]
        topo = st["replica_topology"]
        if (st["replicas"] == 1 and topo[0]["replica_id"] != first
                and topo[0]["mesh_shape"]):
            break
        assert time.monotonic() < deadline, st
        time.sleep(0.3)
    assert _streams(name, PROMPTS, NEW) == (debug_ref,) * 3
    assert len(_rank_actors()) == 1
    serve.delete(name)
    assert _rank_actors() == []
    slice_state = list(rt.cluster_topology()["slices"].values())[0]
    assert slice_state["chips_free"] == 2


@pytest.mark.timeout_s(300)
def test_second_mesh_deployment_waits_for_the_slice(slice_1x2, debug_ref):
    """The slice is fully reserved: a second two-chip deployment stays at
    0 replicas (never placed on a fragment) until ``serve.delete`` frees
    the slice, then places and serves."""
    _deploy("held", (1, 2))
    _deploy("queued", (2, 1), ready_timeout_s=15)
    time.sleep(1.5)
    st2 = serve.status()["queued"]
    assert st2["replicas"] == 0 and st2["chips_in_use"] == 0
    slice_state = list(rt.cluster_topology()["slices"].values())[0]
    assert slice_state["chips_free"] == 0
    assert len(slice_state["reservations"]) == 1

    serve.delete("held")
    deadline = time.monotonic() + 120
    while not serve.status().get("queued", {}).get("replicas"):
        assert time.monotonic() < deadline
        time.sleep(0.3)
    assert serve.status()["queued"]["chips_in_use"] == 2
    unary, stream, _http = _streams("queued", PROMPTS[:1], NEW)
    assert unary == stream == debug_ref[:1]
    serve.delete("queued")
