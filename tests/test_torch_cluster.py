"""The port's multi-node-in-one-machine cluster
(``ray_tpu_torch.cluster_utils.Cluster``) on the CPU: the cases of
``tests/test_cluster.py`` (scheduling across nodes, custom resources,
placement groups, node death, worker chaos, labels, network chaos) and
``tests/test_ft_subsystems.py``'s two head-restart cases, each with the
port in place of the JAX package. A node given a ``GPU`` resource is the
port's card-holding node: its ``GPU`` leases spawn a worker that keeps the
node's ``CUDA_VISIBLE_DEVICES``, CPU leases hide the card."""

import os
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core.node import node_card_ids


@pytest.fixture
def torch_cluster():
    """``tests/conftest.py::ray_start_cluster`` for the port: an empty
    cluster (no head node) torn down after the test."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=False)
    yield cluster
    if rt.is_initialized():
        rt.shutdown()
    cluster.shutdown()


@rt.remote
def whoami():
    from ray_tpu_torch.core.runtime import get_core_worker

    return get_core_worker().node_id.hex()


@rt.remote(num_cpus=0, resources={"special": 1})
def needs_special():
    return "special"


def test_two_nodes_spread(torch_cluster):
    cluster = torch_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes()
    rt.init(address=cluster.address)

    refs = [whoami.options(scheduling_strategy="spread").remote()
            for _ in range(8)]
    node_ids = set(rt.get(refs))
    assert len(node_ids) == 2, f"expected both nodes used, got {node_ids}"


def test_custom_resource_routing(torch_cluster):
    cluster = torch_cluster
    cluster.add_node(num_cpus=2)
    special = cluster.add_node(num_cpus=1, resources={"special": 2})
    cluster.wait_for_nodes()
    rt.init(address=cluster.address)

    result_node = rt.get(
        whoami.options(num_cpus=0, resources={"special": 1}).remote())
    assert result_node == special.node_id.hex()


def test_gpu_node_leases_see_the_card_cpu_leases_do_not(torch_cluster):
    """The port's card-holding node: ``num_gpus=1`` lands on the node
    ``add_node`` gave ``GPU``, in a spawned worker whose
    ``CUDA_VISIBLE_DEVICES`` names the one card its lease holds (the
    driver's first card, or index 0 where the driver names none); a CPU
    task there sees it empty."""
    cluster = torch_cluster
    cluster.add_node(num_cpus=2)
    gpu = cluster.add_node(num_cpus=2, resources={"GPU": 1},
                           labels={"gpu_name": "test card"})
    cluster.wait_for_nodes()
    rt.init(address=cluster.address)

    @rt.remote
    def seen():
        from ray_tpu_torch.core.runtime import get_core_worker

        return (get_core_worker().node_id.hex(),
                os.environ.get("CUDA_VISIBLE_DEVICES"))

    node, visible = rt.get(seen.options(num_gpus=1).remote(), timeout=120)
    assert node == gpu.node_id.hex()
    assert visible == node_card_ids(1)[0]
    on_gpu_node = rt.get([seen.options(
        scheduling_strategy={"kind": "node_label",
                             "labels": {"gpu_name": "test card"}}).remote()
        for _ in range(2)], timeout=120)
    assert {v for _, v in on_gpu_node} == {""}
    assert {n for n, _ in on_gpu_node} == {gpu.node_id.hex()}
    assert rt.cluster_resources()["GPU"] == 1.0


def test_infeasible_task_errors(torch_cluster):
    cluster = torch_cluster
    cluster.add_node(num_cpus=1)
    cluster.wait_for_nodes()
    rt.init(address=cluster.address,
            _system_config={"worker_lease_timeout_s": 2.0})
    with pytest.raises((rt.RayTpuError, rt.TaskError)):
        rt.get(needs_special.remote(), timeout=30)


def test_placement_group_strict_spread(torch_cluster):
    cluster = torch_cluster
    for _ in range(3):
        cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes()
    rt.init(address=cluster.address)

    pg = rt.placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
    assert pg.ready(timeout=10)
    nodes = {pg.bundle_node(i)[0] for i in range(3)}
    assert len(nodes) == 3

    # Tasks pinned to bundles land on the bundles' nodes.
    results = rt.get([
        whoami.options(
            scheduling_strategy=rt.PlacementGroupSchedulingStrategy(
                placement_group=pg, placement_group_bundle_index=i)
        ).remote()
        for i in range(3)
    ])
    assert set(bytes.fromhex(r) for r in results) == {
        pg.bundle_node(i)[0] for i in range(3)}

    rt.remove_placement_group(pg)


def test_placement_group_strict_pack(torch_cluster):
    cluster = torch_cluster
    cluster.add_node(num_cpus=4)
    cluster.add_node(num_cpus=4)
    cluster.wait_for_nodes()
    rt.init(address=cluster.address)

    pg = rt.placement_group([{"CPU": 2}, {"CPU": 2}], strategy="STRICT_PACK")
    assert pg.ready(timeout=10)
    assert pg.bundle_node(0)[0] == pg.bundle_node(1)[0]


def test_placement_group_infeasible_stays_pending(torch_cluster):
    cluster = torch_cluster
    cluster.add_node(num_cpus=1)
    cluster.wait_for_nodes()
    rt.init(address=cluster.address)

    pg = rt.placement_group([{"CPU": 8}], strategy="PACK")
    assert not pg.ready(timeout=1.0)


def test_actor_on_placement_group(torch_cluster):
    cluster = torch_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes()
    rt.init(address=cluster.address)

    pg = rt.placement_group([{"CPU": 2}], strategy="STRICT_PACK")
    assert pg.ready(timeout=10)

    @rt.remote
    class NodeReporter:
        def node(self):
            from ray_tpu_torch.core.runtime import get_core_worker

            return get_core_worker().node_id.hex()

    actor = NodeReporter.options(
        num_cpus=1,
        scheduling_strategy=rt.PlacementGroupSchedulingStrategy(
            placement_group=pg)
    ).remote()
    reported = rt.get(actor.node.remote())
    assert bytes.fromhex(reported) == pg.bundle_node(0)[0]


def test_node_death_detection(torch_cluster):
    cluster = torch_cluster
    cluster.add_node(num_cpus=2)
    doomed = cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes()
    rt.init(address=cluster.address,
            _system_config={"heartbeat_period_s": 0.2,
                            "health_check_failure_threshold": 3})

    cluster.remove_node(doomed)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        alive = [n for n in rt.nodes() if n["alive"]]
        if len(alive) == 1:
            break
        time.sleep(0.2)
    assert len([n for n in rt.nodes() if n["alive"]]) == 1


@pytest.mark.timeout_s(300)
def test_chaos_worker_kills_tasks_still_complete(torch_cluster):
    """Chaos: SIGKILL pooled workers mid-storm; owner-side retries must
    land every task (reference: chaos cluster tests, conftest.py:900)."""
    from ray_tpu_torch.cluster_utils import WorkerKiller

    cluster = torch_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes()
    rt.init(address=cluster.address,
            _system_config={"worker_lease_timeout_s": 60.0})

    @rt.remote(max_retries=12)
    def work(i):
        import time as t

        t.sleep(0.05)
        return i * i

    killer = WorkerKiller(cluster.nodes, period_s=1.0).start()
    try:
        refs = [work.remote(i) for i in range(120)]
        results = rt.get(refs, timeout=240)
    finally:
        killer.stop()
    assert results == [i * i for i in range(120)]
    assert killer.kills > 0, "chaos never killed anything"


def test_node_label_scheduling_strategy(torch_cluster):
    """Label policy: hard labels pin to matching nodes (reference:
    node_label_scheduling_policy.cc); an unsatisfiable one fails the
    lease."""
    from ray_tpu_torch.core.config import config

    cluster = torch_cluster
    cluster.add_node(num_cpus=2, labels={"zone": "a", "tier": "hot"})
    cluster.add_node(num_cpus=2, labels={"zone": "b"})
    rt.init(address=cluster.address)

    zone_b = [n["node_id"] for n in rt.nodes()
              if n["labels"].get("zone") == "b"]
    got = rt.get(
        [whoami.options(scheduling_strategy={
            "kind": "node_label", "labels": {"zone": "b"}}).remote()
         for _ in range(4)], timeout=60)
    assert set(got) == set(zone_b)

    old = config.snapshot()["worker_lease_timeout_s"]
    config.update({"worker_lease_timeout_s": 3.0})
    try:
        with pytest.raises(Exception, match="no feasible|lease"):
            rt.get(whoami.options(scheduling_strategy={
                "kind": "node_label", "labels": {"zone": "nope"}}).remote(),
                timeout=40)
    finally:
        config.update({"worker_lease_timeout_s": old})


def test_random_scheduling_strategy(torch_cluster):
    cluster = torch_cluster
    cluster.add_node(num_cpus=4)
    cluster.add_node(num_cpus=4)
    rt.init(address=cluster.address)

    got = rt.get(
        [whoami.options(scheduling_strategy={"kind": "random"}).remote()
         for _ in range(16)], timeout=120)
    assert len(set(got)) == 2  # scatter reaches both nodes


def test_network_chaos_latency_and_loss(torch_cluster):
    """Tasks, actors and heartbeats keep working over a slow, lossy,
    bandwidth-limited 'network', injected at the RPC send path."""
    import numpy as np

    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.core.rpc import set_network_chaos
    from ray_tpu_torch.core.runtime import get_core_worker

    cluster = torch_cluster
    for _ in range(2):
        cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes(30)
    rt.init(address=cluster.address)

    @rt.remote
    def square(x):
        return x * x

    @rt.remote
    class Acc:
        def __init__(self):
            self.total = 0

        def add(self, v):
            self.total += v
            return self.total

    assert rt.get([square.remote(i) for i in range(8)],
                  timeout=120) == [i * i for i in range(8)]
    acc = Acc.remote()
    assert rt.get(acc.add.remote(1), timeout=60) == 1

    old_lease = config.worker_lease_timeout_s
    config.worker_lease_timeout_s = 90.0  # chaos stretches every RPC
    set_network_chaos(delay_ms=25.0, jitter_ms=15.0, drop_prob=0.01,
                      bandwidth_mbps=200.0, seed=11)
    try:
        blob = np.ones(128 * 1024, np.float64)

        @rt.remote
        def total(a):
            return float(a.sum())

        outs = rt.get([total.remote(blob) for _ in range(12)]
                      + [square.remote(i) for i in range(24)], timeout=300)
        assert outs[:12] == [float(blob.sum())] * 12
        assert outs[12:] == [i * i for i in range(24)]
        got = []
        for _ in range(2, 12):
            try:
                got.append(rt.get(acc.add.remote(1), timeout=60))
            except Exception:
                pass  # a dropped in-flight call may be lost; order holds
        assert got == sorted(got) and len(got) >= 5, got
        nodes = get_core_worker().controller.call("list_nodes")
        assert all(n["alive"] for n in nodes), nodes
    finally:
        set_network_chaos()  # off
        config.worker_lease_timeout_s = old_lease


@pytest.mark.timeout_s(170)
def test_head_restart_with_live_raylets(tmp_path):
    """Kill + restart the controller mid-run: live nodes re-register via
    heartbeats, the restored named-actor record keeps serving calls, and
    new submissions schedule on the re-registered nodes."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(
        initialize_head=False,
        controller_kwargs={"persist_path": str(tmp_path / "gcs.snap")})
    try:
        cluster.add_node(num_cpus=2)
        cluster.add_node(num_cpus=2)
        cluster.wait_for_nodes(30)
        rt.init(address=cluster.address)

        @rt.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def inc(self):
                self.n += 1
                return self.n

        counter = Counter.options(name="survivor").remote()
        assert rt.get(counter.inc.remote(), timeout=60) == 1

        @rt.remote
        def plus(x):
            return x + 1

        assert rt.get(plus.remote(1), timeout=60) == 2

        cluster.controller.save_state()
        cluster.crash_controller()
        time.sleep(1.0)
        ctrl = cluster.restart_controller()

        deadline = time.monotonic() + 30
        while sum(n["alive"] for n in ctrl.list_nodes()) < 2:
            assert time.monotonic() < deadline, ctrl.list_nodes()
            time.sleep(0.2)

        found = rt.get_actor("survivor")
        assert rt.get(found.inc.remote(), timeout=60) == 2
        assert rt.get(counter.inc.remote(), timeout=60) == 3
        assert rt.get([plus.remote(i) for i in range(20)],
                      timeout=120) == [i + 1 for i in range(20)]
    finally:
        if rt.is_initialized():
            rt.shutdown()
        cluster.shutdown()


@pytest.mark.timeout_s(170)
def test_serve_survives_head_restart(tmp_path):
    """A serve deployment keeps answering across a controller crash +
    restart: the existing handle routes from its cached snapshot, a handle
    made after the restart heals through the serve controller's
    republish, and the old handle sees a later redeploy."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(
        initialize_head=False,
        controller_kwargs={"persist_path": str(tmp_path / "gcs.snap")})
    try:
        cluster.add_node(num_cpus=4)
        cluster.wait_for_nodes(30)
        rt.init(address=cluster.address)

        @serve.deployment
        class Echo:
            def __call__(self, x):
                return x

        handle = serve.run(Echo.bind(), name="echo")
        assert handle.remote("pre").result(timeout=60) == "pre"

        cluster.controller.save_state()
        cluster.crash_controller()
        time.sleep(1.0)
        ctrl = cluster.restart_controller()
        deadline = time.monotonic() + 30
        while not any(n["alive"] for n in ctrl.list_nodes()):
            assert time.monotonic() < deadline
            time.sleep(0.2)

        assert handle.remote("during").result(timeout=60) == "during"
        deadline = time.monotonic() + 30
        while True:
            try:
                fresh = serve.get_deployment_handle("echo")
                assert fresh.remote("post").result(timeout=10) == "post"
                break
            except Exception:
                assert time.monotonic() < deadline
                time.sleep(0.5)

        @serve.deployment
        class Echo2:
            def __call__(self, x):
                return ("v2", x)

        serve.run(Echo2.bind(), name="echo")
        deadline = time.monotonic() + 30
        while True:
            try:
                if handle.remote("x").result(timeout=10) == ("v2", "x"):
                    break
            except Exception:
                pass
            assert time.monotonic() < deadline, \
                "pre-restart router never saw the post-restart redeploy"
            time.sleep(0.5)
    finally:
        try:
            serve.shutdown()
        except Exception:
            pass
        if rt.is_initialized():
            rt.shutdown()
        cluster.shutdown()
