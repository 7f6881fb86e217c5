"""The port's CLI, state API, dashboard and usage report
(``ray_tpu_torch/{scripts,util/state,dashboard,usage}.py``) on the port's
runtime: the four cases of ``tests/test_cli_start.py``, ``test_state_cli``,
``test_dashboard_endpoints`` and ``test_dashboard_logs_history_drilldown``
of ``tests/test_jobs_and_envs.py`` and ``test_util_state_api`` of
``tests/test_core_api.py``, under the same names and settings. The live
cases share one module-scoped ``init(num_cpus=4)`` (the references start
one a test); the two that bring up their own cluster run first.

Plus what the port adds: ``up`` and ``down`` of a dry-run gpu_vm YAML,
``autopilot --status`` and ``submit`` against a fake_multinode cluster
that ``up`` parks in a process of its own, which ``down`` stops; ``status``,
``list``, ``memory``, ``stacks`` and ``doctor`` leave torch and JAX out of
``sys.modules``, and a driver's ``shutdown()`` empties its metric series
(run before the shared cluster starts); ``usage.collect()`` equals the
JAX package's, times and paths aside."""

import io
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest

import ray_tpu_torch as rt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn_daemon(argv, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch"] + argv,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": REPO, **(env or {})})


def _read_until(proc, marker, timeout=60):
    lines = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            time.sleep(0.1)
            continue
        lines.append(line)
        if marker in line:
            return line, lines
    raise TimeoutError(f"{marker!r} not seen in {lines}")


def _cli(argv):
    from ray_tpu_torch.scripts import main

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


# ------------------------------------- tests/test_cli_start.py (own cluster)


@pytest.mark.timeout_s(180)
def test_start_head_and_worker_daemons():
    """``start --head`` in one process + a worker joining from another: a
    third process connects as a driver and schedules onto both nodes."""
    head = worker = None
    try:
        head = _spawn_daemon(["start", "--head", "--num-cpus", "2"])
        line, _ = _read_until(head, "controller:")
        addr = line.split()[-1]
        _read_until(head, "to connect:")

        worker = _spawn_daemon(["start", "--address", addr,
                                "--num-cpus", "2",
                                "--resources", '{"spot": 1}'])
        _read_until(worker, "node ")

        host, _, port = addr.partition(":")
        rt.init(address=(host, int(port)))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            alive = [n for n in rt.nodes() if n["alive"]]
            if len(alive) == 2:
                break
            time.sleep(0.2)
        assert len(alive) == 2, alive

        @rt.remote(resources={"spot": 0.1})
        def on_worker_node():
            from ray_tpu_torch.core.runtime import get_core_worker

            return get_core_worker().node_id.hex()

        @rt.remote
        def anywhere(x):
            return x * 2

        spot_node = rt.get(on_worker_node.remote(), timeout=60)
        worker_nodes = [n["node_id"] for n in alive
                        if n["resources"].get("spot")]
        assert spot_node in worker_nodes
        assert rt.get([anywhere.remote(i) for i in range(8)],
                      timeout=60) == [i * 2 for i in range(8)]
    finally:
        if rt.is_initialized():
            rt.shutdown()
        for proc in (worker, head):
            if proc is not None:
                proc.send_signal(signal.SIGTERM)
        for proc in (worker, head):
            if proc is not None:
                try:
                    proc.wait(timeout=20)
                except subprocess.TimeoutExpired:
                    proc.kill()


def test_spillback_rejects_deep_queue():
    """A backlogged node bounces new leases so submitters re-pick; the
    burst still completes by settling into queues on later attempts."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.config import config

    cluster = Cluster(initialize_head=False)
    old = config.snapshot()["lease_spillback_queue_depth"]
    try:
        cluster.add_node(num_cpus=1)
        cluster.add_node(num_cpus=1)
        rt.init(address=cluster.address)
        config.update({"lease_spillback_queue_depth": 2})

        @rt.remote
        def slowish(i):
            time.sleep(0.3)
            from ray_tpu_torch.core.runtime import get_core_worker

            return get_core_worker().node_id.hex()

        # 12 tasks over 2 single-CPU nodes: queues go deep; spillback
        # must not deadlock or fail the burst, and both nodes serve.
        nodes = rt.get([slowish.remote(i) for i in range(12)], timeout=120)
        assert len(nodes) == 12
        assert len(set(nodes)) == 2, set(nodes)
    finally:
        config.update({"lease_spillback_queue_depth": old})
        if rt.is_initialized():
            rt.shutdown()
        cluster.shutdown()


def test_shutdown_empties_the_drivers_metric_series():
    """What a driver recorded for one cluster never reaches the next one
    it joins: ``shutdown()`` empties its registry's series (the path by
    which ``serve_*`` series of an earlier session reached a cluster that
    serves nothing, and made ``doctor`` load torch)."""
    from ray_tpu_torch.core.runtime import get_core_worker
    from ray_tpu_torch.util.metrics import Counter, _Registry

    def _probes(series):
        return [m for m in series if m["name"] == "serve_probe_total"]

    rt.init(num_cpus=1)
    try:
        Counter("serve_probe_total", "probe", tag_keys=("deployment",)).inc(
            tags={"deployment": "earlier"})
        assert _probes(_Registry.get().snapshot(run_collectors=False))
    finally:
        rt.shutdown()
    assert not _probes(_Registry.get().snapshot(run_collectors=False))
    rt.init(num_cpus=1)
    try:
        assert _Registry.get().flush_now()
        pushed = get_core_worker().controller.call("list_metrics")
        assert not any(_probes(ms) for ms in pushed.values())
    finally:
        rt.shutdown()


# --------------------------------------- the launcher and autopilot family


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """``up`` on a fake_multinode YAML, parked in a process of its own (as
    an operator runs it); ``down`` on the same YAML stops it."""
    import yaml

    tmp = tmp_path_factory.mktemp("launch")
    fake = tmp / "fake.yaml"
    fake.write_text(yaml.safe_dump({
        "cluster_name": f"cli-fake-{os.getpid()}",
        "provider": {"type": "fake_multinode"},
        "min_workers": 0, "max_workers": 0,
        "head": {"resources": {"CPU": 2}}}))
    dry = tmp / "dry.yaml"
    dry.write_text(yaml.safe_dump({
        "cluster_name": "cli-dry",
        "provider": {"type": "gpu_vm", "project_id": "p", "zone": "z"},
        "dry_run": True}))
    proc = _spawn_daemon(["up", str(fake)])
    try:
        line, _ = _read_until(proc, "cluster up; controller at")
        _read_until(proc, "autoscaling")
        yield {"proc": proc, "fake": str(fake), "dry": str(dry),
               "address": line.split()[-1]}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=20)


def _cli_process(argv, env=None):
    return subprocess.run([sys.executable, "-m", "ray_tpu_torch"] + argv,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO,
                               **(env or {})})


@pytest.mark.timeout_s(180)
@pytest.mark.parametrize("case", ["up", "down", "autopilot", "submit"])
def test_launcher_and_autopilot_family(launched, case):
    """``up`` and ``down`` of a dry-run gpu_vm YAML record what they would
    do; ``autopilot --status`` and ``submit`` (no ``--address``: a
    fake_multinode YAML falls back to the local discovery, here
    ``RAY_TPU_ADDRESS``) run against the cluster ``up`` launched."""
    if case in ("up", "down"):
        proc = _cli_process([case, launched["dry"]])
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert ("dry run" if case == "up" else "cluster down") \
            in proc.stdout
        return
    env = {"RAY_TPU_ADDRESS": launched["address"]}
    if case == "autopilot":
        proc = _cli_process(["autopilot", "--status"], env)
        assert proc.returncode == 0, proc.stderr[-2000:]
        status = json.loads(proc.stdout)
        assert status["enabled"] is False and status["audit"] == []
        assert status["taints"] == {}
        return
    proc = _cli_process(["submit", launched["fake"], "echo from-a-job"],
                        env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "from-a-job" in proc.stdout
    assert "SUCCEEDED" in proc.stdout


@pytest.mark.timeout_s(180)
def test_down_stops_a_parked_fake_multinode_up(launched):
    proc = _cli_process(["down", launched["fake"]])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"terminated up process {launched['proc'].pid}" in proc.stdout
    assert launched["proc"].wait(timeout=30) == 0


def test_resolve_address_order(tmp_path, monkeypatch):
    """``--address``, then ``RAY_TPU_ADDRESS``, then the discovery file
    (the port's own, in the temp directory)."""
    import tempfile

    from ray_tpu_torch import scripts

    assert scripts.DISCOVERY_PATH == os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch", "cluster_latest.json")
    path = tmp_path / "latest.json"
    path.write_text(json.dumps({"address": ["10.0.0.3", 7000]}))
    monkeypatch.setattr(scripts, "DISCOVERY_PATH", str(path))
    monkeypatch.setenv("RAY_TPU_ADDRESS", "10.0.0.2:6000")
    assert scripts.resolve_address("10.0.0.1:5000") == ("10.0.0.1", 5000)
    assert scripts.resolve_address(None) == ("10.0.0.2", 6000)
    monkeypatch.delenv("RAY_TPU_ADDRESS")
    assert tuple(scripts.resolve_address(None)) == ("10.0.0.3", 7000)
    path.unlink()
    with pytest.raises(SystemExit, match="no cluster address"):
        scripts.resolve_address(None)


# ------------------------------------------- one module-scoped cluster


@pytest.fixture(scope="module")
def core():
    c = rt.init(num_cpus=4)
    yield c
    rt.shutdown()


def _addr(core):
    host, port = core.controller_addr
    return f"{host}:{port}"


@pytest.mark.timeout_s(180)
def test_job_cli_submit_and_logs(core):
    rc, out = _cli(["--address", _addr(core), "job", "submit",
                    f"{sys.executable} -c \"print('job-output-42')\"",
                    "--wait"])
    assert rc == 0, out
    assert "job-output-42" in out
    assert "SUCCEEDED" in out


def test_memory_cli_and_usage_report(core):
    from ray_tpu_torch import usage

    # Put something sizable so store usage is visible.
    ref = rt.put(np.ones(500_000))
    rc, out = _cli(["--address", _addr(core), "memory"])
    assert rc == 0
    assert "store_used" in out and "MB" in out

    usage.record_feature("test.feature")
    path = usage.write_report()
    assert path
    assert path.startswith(os.path.join(
        __import__("tempfile").gettempdir(), "ray_tpu_torch_usage_"))
    with open(path) as f:
        report = json.load(f)
    assert "test.feature" in report["features"]
    assert report["nodes"] == 1
    del ref


def test_state_cli(core, tmp_path):
    @rt.remote
    class Named:
        def ping(self):
            return "pong"

    a = Named.options(name="cli_probe").remote()
    rt.get(a.ping.remote(), timeout=60)
    addr = _addr(core)
    out = "".join(_cli(["--address", addr] + argv)[1] for argv in
                  (["status"], ["list", "nodes"], ["list", "actors"]))
    assert "cluster resources" in out
    assert "cli_probe" in out

    time.sleep(1.5)  # task events flush period
    tl = tmp_path / "timeline.json"
    _cli(["--address", addr, "timeline", "-o", str(tl)])
    trace = json.loads(tl.read_text())
    assert isinstance(trace, list)
    rt.kill(a)


def test_dashboard_endpoints(core):
    from ray_tpu_torch import dashboard

    @rt.remote
    class Probe:
        def ping(self):
            return "pong"

    a = Probe.options(name="dash_probe").remote()
    rt.get(a.ping.remote(), timeout=60)

    server, (host, port) = dashboard.start(core.controller_addr)
    try:
        base = f"http://{host}:{port}"
        nodes = json.loads(urllib.request.urlopen(
            f"{base}/api/nodes", timeout=10).read())
        assert any(n["alive"] for n in nodes)
        actors = json.loads(urllib.request.urlopen(
            f"{base}/api/actors", timeout=10).read())
        assert any(x["info"].get("name") == "dash_probe" for x in actors)
        html = urllib.request.urlopen(base + "/", timeout=10).read().decode()
        assert "dash_probe" in html and "nodes" in html
        assert "<title>ray_tpu_torch dashboard</title>" in html
        metrics = urllib.request.urlopen(
            f"{base}/metrics", timeout=10).read().decode()
        assert isinstance(metrics, str)
        mem = json.loads(urllib.request.urlopen(
            f"{base}/api/memory", timeout=10).read())
        assert mem and mem[0]["store_capacity_bytes"] > 0
        assert "object store" in html
        # Core-plane panel: same core_summary read path as the CLI.
        from ray_tpu_torch.util.metrics import _Registry

        assert _Registry.get().flush_now()
        core_view = json.loads(urllib.request.urlopen(
            f"{base}/api/core", timeout=10).read())
        assert {"rpc", "objects", "pubsub", "control"} <= set(core_view)
        assert core_view["rpc"]["tx_frames"] > 0
        html = urllib.request.urlopen(base + "/", timeout=10).read().decode()
        assert "core planes" in html
    finally:
        server._history.stop()
        server.shutdown()
        rt.kill(a)


def test_dashboard_logs_history_drilldown(core):
    """During a workload the dashboard serves live worker logs,
    task/actor drill-down pages, and metric history sparklines."""
    from ray_tpu_torch import dashboard
    from ray_tpu_torch.util.metrics import Gauge

    server, (host, port) = dashboard.start(core.controller_addr)
    base = f"http://{host}:{port}"
    try:
        @rt.remote
        def chatty(i):
            print(f"chatty-line-{i}")
            return i

        @rt.remote
        class Watched:
            def ping(self):
                return "pong"

        actor = Watched.options(name="watched").remote()
        rt.get(actor.ping.remote(), timeout=60)
        rt.get([chatty.remote(i) for i in range(8)], timeout=120)
        gauge = Gauge("train_loss", "probe gauge")
        gauge.set(1.25)

        # Live logs reach the dashboard via the pubsub windows.
        deadline = time.monotonic() + 60
        while True:
            logs = json.loads(urllib.request.urlopen(
                f"{base}/api/logs", timeout=10).read())
            lines = [ln for d in logs.values() for _t, ln in d["lines"]]
            if any("chatty-line-" in ln for ln in lines):
                break
            assert time.monotonic() < deadline, logs
            time.sleep(0.5)
        page = urllib.request.urlopen(f"{base}/logs",
                                      timeout=10).read().decode()
        assert "chatty-line-" in page

        # Task drill-down: pick a finished task id from the events.
        events = json.loads(urllib.request.urlopen(
            f"{base}/api/tasks?limit=100", timeout=10).read())
        done = next(e for e in events if e.get("state") == "FINISHED"
                    and "chatty" in e.get("desc", ""))
        tpage = urllib.request.urlopen(
            f"{base}/task/{done['task_id']}", timeout=10).read().decode()
        assert "chatty" in tpage and "sched_latency" in tpage

        # Actor drill-down.
        actors = json.loads(urllib.request.urlopen(
            f"{base}/api/actors", timeout=10).read())
        rec = next(a for a in actors if a["info"].get("name") == "watched")
        apage = urllib.request.urlopen(
            f"{base}/actor/{rec['actor_id']}", timeout=10).read().decode()
        assert "watched" in apage and "ALIVE" in apage

        # History: the sampler has ticked and the gauge flows through.
        deadline = time.monotonic() + 60
        while True:
            server._history.sample_once()
            hist = json.loads(urllib.request.urlopen(
                f"{base}/api/history", timeout=10).read())
            if ("nodes_alive" in hist and len(hist["nodes_alive"]) >= 2
                    and "metric:train_loss" in hist):
                break
            assert time.monotonic() < deadline, list(hist)
            time.sleep(1.0)
        front = urllib.request.urlopen(base + "/",
                                       timeout=10).read().decode()
        assert "svg" in front and "history" in front
        rt.kill(actor)
    finally:
        server._history.stop()
        server.shutdown()


def test_util_state_api(core):
    """Python state surface (reference: ray.util.state api.py)."""
    from ray_tpu_torch.util import state

    @rt.remote
    def touch():
        return 1

    assert rt.get(touch.remote()) == 1
    nodes = state.list_nodes()
    assert len(nodes) == 1 and nodes[0]["alive"]
    objs = state.list_objects()
    assert objs and objs[0]["store_capacity_bytes"] > 0
    assert state.cluster_resources()["CPU"] == 4.0
    assert state.available_resources()["CPU"] <= 4.0
    # Task events land asynchronously; summarize sees them eventually.
    deadline = time.monotonic() + 30
    total = 0
    while total == 0 and time.monotonic() < deadline:
        total = state.summarize_tasks()["total"]
        time.sleep(0.2)
    assert total >= 1


_LIGHT = """
import sys

from ray_tpu_torch.scripts import main

addr = sys.argv[1]
for argv in (["status"], ["list", "nodes"], ["list", "actors"],
             ["memory"], ["stacks"], ["doctor", "--interval", "0.2"]):
    assert main(["--address", addr] + argv) == 0, argv
print("LOADED", "torch" in sys.modules, "jax" in sys.modules)
"""


def test_light_subcommands_import_neither_torch_nor_jax(core, tmp_path):
    script = tmp_path / "light.py"
    script.write_text(_LIGHT)
    proc = subprocess.run([sys.executable, str(script), _addr(core)],
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "nodes: 1 alive / 1 total" in proc.stdout
    assert proc.stdout.strip().splitlines()[-1] == "LOADED False False"
