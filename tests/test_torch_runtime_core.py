"""The port's runtime core (tasks, actors, objects on the shared-memory
store, GPU leases) held against the JAX package's on the CPU.

One user program (``torch_runtime_program.core_program``: tasks with
nested refs and a raised error, put / get / wait with a timeout / free,
named actors with kill and a restart, a streaming return, the resource
books around a lease) runs on ``ray_tpu`` and then on ``ray_tpu_torch``,
each in a cluster of its own (init, run, shutdown; never both up), with
``GPU: 1`` declared so the GPU lease path runs without a card. Results and
error classes (by name) must be equal. The port's own rules beside that:
a CPU-leased worker sees ``CUDA_VISIBLE_DEVICES=""``, a GPU lease gets a
freshly spawned worker that keeps the node's value, and no process of the
cluster creates a CUDA context."""

import pytest
import torch

import torch_runtime_program as prog

RUNS = ("ray_tpu", "ray_tpu_torch")


@pytest.fixture(scope="module")
def results():
    import importlib

    out = {}
    for pkg in RUNS:
        rt = importlib.import_module(pkg)
        rt.init(num_cpus=4, resources={"GPU": 1})
        try:
            out[pkg] = prog.core_program(pkg)
        finally:
            rt.shutdown()
    return out


@pytest.mark.parametrize("key", ["chain", "nested", "task_error"])
def test_tasks_match(results, key):
    assert results["ray_tpu_torch"][key] == results["ray_tpu"][key]


def test_task_values(results):
    got = results["ray_tpu_torch"]
    assert got["chain"] == 13 and got["nested"] == 10
    assert got["task_error"] == ("TaskError", "ValueError", True)


@pytest.mark.parametrize("key", ["put_get", "wait", "wait_timeout",
                                 "get_timeout", "slow", "freed"])
def test_objects_match(results, key):
    assert results["ray_tpu_torch"][key] == results["ray_tpu"][key]


def test_object_values(results):
    got = results["ray_tpu_torch"]
    assert got["put_get"] == (True, "float32")
    assert got["freed"] == "ObjectFreedError"
    assert got["slow"] == 3.0


@pytest.mark.parametrize("key", ["named", "killed", "restart"])
def test_actors_match(results, key):
    assert results["ray_tpu_torch"][key] == results["ray_tpu"][key]


def test_actor_values(results):
    got = results["ray_tpu_torch"]
    assert got["named"] == 6 and got["killed"] == "ActorDiedError"
    assert got["restart"] == (1, 1)  # a restart starts from fresh state


def test_streaming_return_matches(results):
    got = results["ray_tpu_torch"]["stream"]
    assert got == results["ray_tpu"]["stream"]
    assert got == ("ObjectRefGenerator", [0, 10, 20, 30])


def test_resource_books_match(results):
    got = results["ray_tpu_torch"]["books"]
    assert got == results["ray_tpu"]["books"]
    assert got == {"CPU": (4.0, 2.0, 4.0), "GPU": (1.0, 0.0, 1.0)}
    for key in ("CPU", "GPU"):
        assert (results["ray_tpu_torch"]["cluster_resources"][key]
                == results["ray_tpu"]["cluster_resources"][key])


def test_gpu_lease_and_cpu_workers_off_the_card(results):
    """CPU-leased workers (forked from the node's template) see no card;
    the GPU lease gets a worker the node spawned itself (its parent is the
    driver's process, which hosts the node), with the node's value of the
    variable; no process created a CUDA context."""
    got = results["ray_tpu_torch"]
    cpu, gpu = got["cpu_env"], got["gpu_env"]
    assert cpu["cuda_visible"] == ""
    assert gpu["cuda_visible"] != ""
    assert gpu["ppid"] == got["driver_pid"] != cpu["ppid"]
    assert not cpu["cuda_initialized"] and not gpu["cuda_initialized"]
    assert not torch.cuda.is_initialized()


def test_node_advertises_its_gpus_as_a_slice(results):
    """A node with a ``GPU`` resource advertises one slice of that many
    chips (the topology view's input), as a TPU node does its pod
    slice."""
    res = results["ray_tpu_torch"]["cluster_resources"]
    assert res["chips"] == 1.0
    assert [k for k in res if k.startswith("slice:gpu-1-")]


def test_gpu_detection_without_a_context(monkeypatch):
    """``detect_gpus`` counts cards with ``nvidia-smi -L`` (no CUDA call in
    this process) and honours ``CUDA_VISIBLE_DEVICES``."""
    import subprocess

    from ray_tpu_torch.core import api

    listing = ("GPU 0: NVIDIA H100 80GB HBM3 (UUID: GPU-a)\n"
               "GPU 1: NVIDIA H100 80GB HBM3 (UUID: GPU-b)\n")
    monkeypatch.setattr(subprocess, "run", lambda *a, **k:
                        subprocess.CompletedProcess(a, 0, listing, ""))
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert api.detect_gpus() == (2, "NVIDIA H100 80GB HBM3")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    assert api.detect_gpus() == (1, "NVIDIA H100 80GB HBM3")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert api.detect_gpus() == (0, None)
    res, labels = {}, {}
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    api._autodetect_gpu(res, labels)
    assert res == {"GPU": 2.0} and labels == {"gpu_name":
                                              "NVIDIA H100 80GB HBM3"}
    assert not torch.cuda.is_initialized()


def test_not_ported_surfaces_raise():
    """``num_tpus`` still refuses; ``cluster_utils.Cluster``, the CLI,
    client mode and a non-empty runtime_env work: a two-node cluster,
    ``python -m ray_tpu_torch status`` against it, a thin client on it,
    and a spec normalized as the JAX package's."""
    import subprocess
    import sys

    import ray_tpu_torch as rt
    from ray_tpu import runtime_env as jre
    from ray_tpu_torch import client as client_mod
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.remote_function import (_normalized_env,
                                                    _resources_from_options)

    spec = {"env_vars": {"A": 1}, "working_dir": "/w"}
    assert _normalized_env({"runtime_env": spec}) == jre.normalize(spec) == {
        "env_vars": {"A": "1"}, "working_dir": "/w"}
    cluster = Cluster(initialize_head=False)
    try:
        cluster.add_node(num_cpus=1)
        cluster.add_node(num_cpus=1, resources={"GPU": 1})
        cluster.wait_for_nodes()
        rt.init(address=cluster.address)
        host, port = cluster.address
        cli = subprocess.run([sys.executable, "-m", "ray_tpu_torch",
                              "--address", f"{host}:{port}", "status"],
                             capture_output=True, text=True, timeout=60)
        assert cli.returncode == 0, cli.stderr
        assert "nodes: 2 alive / 2 total" in cli.stdout
        assert "'GPU': 1.0" in cli.stdout
        server = client_mod.ClientServer(host="127.0.0.1")
        try:
            client = rt.init(address=f"ray-tpu://{server.address[0]}:"
                                     f"{server.address[1]}")
            assert client_mod.current_client() is client
            res = rt.cluster_resources()
            assert (res["CPU"], res["GPU"], res["chips"]) == (2.0, 1.0, 1.0)
            assert rt.get(rt.put(3)) == 3
            rt.shutdown()  # disconnects the client only
            assert client_mod.current_client() is None
            assert rt.is_initialized()
        finally:
            server.stop()
    finally:
        rt.shutdown()
        cluster.shutdown()
    with pytest.raises(ValueError, match="num_gpus"):
        _resources_from_options({"num_tpus": 1})
    assert _resources_from_options({"num_gpus": 1}) == {"CPU": 1.0,
                                                         "GPU": 1.0}


def test_top_level_exports_version_and_host_group():
    """``ray_tpu_torch`` exports what ``ray_tpu`` does at the top level:
    the same ``__version__`` (the port's own copy) and ``HostGroup``, the
    gang class of ``core/multihost.py``, which checks its arguments as the
    JAX one does."""
    import ray_tpu
    import ray_tpu_torch
    from ray_tpu_torch.core.multihost import HostGroup, HostWorker

    assert ray_tpu_torch.__version__ == ray_tpu.__version__
    assert ray_tpu_torch.HostGroup is HostGroup
    g = ray_tpu_torch.HostGroup(2, name="g")
    assert (g.group_id, g.num_hosts, g.state, g.members) == ("g", 2, "NEW",
                                                             [])
    for bad, err in ((dict(num_hosts=0), ValueError),
                     (dict(num_hosts=1, worker_cls=dict), TypeError)):
        for pkg in (ray_tpu, ray_tpu_torch):
            with pytest.raises(err):
                pkg.HostGroup(**bad)

    class Member(HostWorker):
        pass

    assert HostGroup(1, worker_cls=Member)._worker_cls is Member
