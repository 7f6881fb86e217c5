"""Cluster launcher: ``python -m ray_tpu_torch up / down / submit`` against
a cluster YAML.

Analogue of the reference's ``ray up`` path (``scripts.py:571`` ->
``autoscaler/_private/commands.py`` ``create_or_update_cluster`` ->
``updater.py`` node bootstrap): load + validate the YAML
(:mod:`ray_tpu_torch.cluster_config`), boot the head (controller + head node +
autoscaler), and let demand-driven provisioning bring workers up through
the provider.

Two providers, one flow:

* ``fake_multinode`` — everything in-process: a real controller, a real
  head node, and an autoscaler launching real in-process raylets. This is
  the end-to-end path CI drives (reference: ``fake_multi_node`` provider).
* ``gpu_vm`` — a head instance and worker host groups of GPU instances
  through the Compute Engine REST API (:mod:`ray_tpu_torch.gpu_vm_api`),
  bootstrapped over SSH with
  :class:`ray_tpu_torch.command_runner.HostGroupCommandRunner` (every host
  of a group runs setup + ``python -m ray_tpu_torch start``).
  ``dry_run: true`` records every API request and SSH argv without
  egress.

The port's copy of ``ray_tpu/cluster_launcher.py``, with ``gpu_vm`` where
the JAX file has ``tpu_vm``; its ``down`` also stops a fake_multinode
cluster, by signalling the ``up`` process that holds it.
"""

from __future__ import annotations

import shlex
from typing import Any, Dict, List, Optional

from ray_tpu_torch.cluster_config import ClusterConfig, load_config


class LaunchedCluster:
    """Handle for a running launch: the head's controller address plus the
    pieces ``down`` must stop. For dry-run gpu_vm launches, ``actions``
    records what would have happened."""

    def __init__(self, config: ClusterConfig):
        self.config = config
        self.address = None            # controller (host, port)
        self.controller = None         # in-process head (fake provider)
        self.head_node = None
        self.autoscaler = None
        self.provider = None
        self.head_path = None          # gpu_vm: head instance name
        self.api_client = None         # gpu_vm: GpuVmClient (head teardown)
        self.actions: List[str] = []   # human-readable launch log

    def shutdown(self) -> None:
        """Stop autoscaler -> workers -> head (reverse launch order). The
        gpu_vm provider only lists THIS cluster's workers (label filter),
        so the head instance is deleted explicitly here."""
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.provider is not None:
            for pid in list(self.provider.non_terminated_nodes()):
                try:
                    self.provider.terminate_node(pid)
                except Exception:  # graftlint: disable=swallowed-exception (best-effort cloud teardown; each node logged via actions)
                    pass
        if self.api_client is not None and self.head_path is not None:
            try:
                self.api_client.delete_instance(self.head_path)
                self.actions.append(
                    f"deleted head instance {self.head_path}")
            except Exception:  # graftlint: disable=swallowed-exception (best-effort cloud teardown)
                pass
        if self.head_node is not None:
            self.head_node.stop()
        if self.controller is not None:
            self.controller.stop()


def up(config_or_path, block: bool = False) -> LaunchedCluster:
    cfg = (config_or_path if isinstance(config_or_path, ClusterConfig)
           else load_config(config_or_path))
    if cfg.provider.type == "fake_multinode":
        cluster = _up_fake(cfg)
    else:
        cluster = _up_gpu_vm(cfg)
    if block:
        block_until_signal(cluster)
    return cluster


def block_until_signal(cluster: LaunchedCluster) -> None:
    """Park until SIGINT/SIGTERM, then shut the launch down (shared by
    ``up(block=True)`` and the ``python -m ray_tpu_torch up`` CLI). A
    fake_multinode launch records this process, so that ``down`` can stop
    it."""
    import json as _json
    import os
    import signal
    import threading

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    record = None
    if cluster.config.provider.type == "fake_multinode":
        record = _launch_record(cluster.config.cluster_name)
        os.makedirs(os.path.dirname(record), exist_ok=True)
        with open(record, "w") as f:
            _json.dump({"pid": os.getpid(),
                        "address": list(cluster.address or ())}, f)
    try:
        while not stop.wait(1.0):
            pass
    finally:
        cluster.shutdown()
        if record is not None:
            try:
                os.unlink(record)
            except FileNotFoundError:
                pass


def _up_fake(cfg: ClusterConfig) -> LaunchedCluster:
    from ray_tpu_torch.autoscaler import (FakeMultiNodeProvider,
                                          StandardAutoscaler)
    from ray_tpu_torch.command_runner import SubprocessCommandRunner
    from ray_tpu_torch.core.controller import Controller
    from ray_tpu_torch.core.node import Node

    cluster = LaunchedCluster(cfg)
    cluster.controller = Controller()
    cluster.address = cluster.controller.address
    cluster.actions.append(f"controller at {cluster.address}")
    runner = SubprocessCommandRunner()
    for cmd in cfg.setup_commands:
        runner.run(cmd)
        cluster.actions.append(f"setup: {cmd}")
    head_res = dict(cfg.head.resources) or {"CPU": 1.0}
    cluster.head_node = Node(cluster.address, head_res,
                             {**cfg.head.labels, "node_type": "head"})
    cluster.actions.append(f"head node {cluster.head_node.node_id.hex()[:8]}")
    cluster.provider = FakeMultiNodeProvider(cluster.address)
    worker_res = dict(cfg.worker.resources) or {"CPU": 1.0}
    cluster.autoscaler = StandardAutoscaler(
        cluster.controller, cluster.provider, worker_res,
        min_nodes=cfg.min_workers, max_nodes=cfg.max_workers,
        idle_timeout_s=cfg.idle_timeout_minutes * 60.0,
        node_labels={**cfg.worker.labels, "node_type": "worker"})
    cluster.autoscaler.start()
    cluster.actions.append(
        f"autoscaler: {cfg.min_workers}..{cfg.max_workers} workers x "
        f"{worker_res}")
    return cluster


HEAD_PORT = 6379  # fixed controller port on gpu_vm heads (workers join it)


def _start_command(head: bool, address: Optional[str],
                   resources: Dict[str, float],
                   labels: Optional[Dict[str, str]] = None) -> str:
    import json as _json

    base = "python -m ray_tpu_torch start"
    parts = [base]
    if head:
        # The port must be FIXED: workers and the launcher's remote
        # autoscaler dial <head-host>:HEAD_PORT (cmd_start defaults to an
        # ephemeral port otherwise).
        parts.append(f"--head --host 0.0.0.0 --port {HEAD_PORT}")
    else:
        parts.append(f"--address {address}")
    if resources:
        parts.append(f"--resources {shlex.quote(_json.dumps(resources))}")
    if labels:
        # provider_node_id rides along: the autoscaler maps registered
        # nodes back to provider instances through it (idle teardown and
        # the provisioning count both key on the label).
        parts.append(f"--labels {shlex.quote(_json.dumps(labels))}")
    # `start` parks in the foreground until SIGTERM; over SSH it must
    # daemonize or the runner (and `up`) would hang until timeout.
    role = "head" if head else "worker"
    return (f"nohup {' '.join(parts)} > /tmp/ray_tpu_torch_{role}.log 2>&1 "
            f"< /dev/null &")


def _up_gpu_vm(cfg: ClusterConfig) -> LaunchedCluster:
    """Provision the head instance, bootstrap it over SSH, then hand
    worker provisioning to the autoscaler (driven remotely against the
    head's controller)."""
    from ray_tpu_torch.autoscaler import GPUVMNodeProvider, StandardAutoscaler
    from ray_tpu_torch.command_runner import HostGroupCommandRunner
    from ray_tpu_torch.core.rpc import RpcClient
    from ray_tpu_torch.gpu_vm_api import GpuVmClient

    cluster = LaunchedCluster(cfg)
    client = GpuVmClient(cfg.provider.project_id, cfg.provider.zone,
                         dry_run=cfg.dry_run)
    cluster.api_client = client
    head_name = f"{cfg.cluster_name}-head"
    cluster.head_path = head_name
    op = client.create_instance(
        head_name, cfg.provider.machine_type,
        labels={**cfg.head.labels, "ray-cluster": cfg.cluster_name,
                "ray-node-type": "head"})
    client.wait_operation(op)
    cluster.actions.append(f"created head instance {head_name}")
    head = client.get_instance(head_name)
    hosts = [GpuVmClient.instance_host(head) or "<head-host>"]
    runner = HostGroupCommandRunner(hosts, cfg.auth.ssh_user,
                                    cfg.auth.ssh_private_key,
                                    dry_run=cfg.dry_run)
    for cmd in cfg.setup_commands:
        runner.run(cmd)
        cluster.actions.append(f"setup on {len(hosts)} hosts: {cmd}")
    runner.run(_start_command(True, None, cfg.head.resources,
                              {**cfg.head.labels, "node_type": "head"}))
    cluster.actions.append(f"started head on {hosts[0]}:{HEAD_PORT}")
    head_addr = f"{hosts[0]}:{HEAD_PORT}"
    cluster.address = (hosts[0], HEAD_PORT)

    def bootstrap(node: dict, labels: Dict[str, str]) -> None:
        w_hosts = node.get("hosts") or ["<worker-host>"]
        w_runner = HostGroupCommandRunner(w_hosts, cfg.auth.ssh_user,
                                          cfg.auth.ssh_private_key,
                                          dry_run=cfg.dry_run)
        for cmd in cfg.setup_commands:
            w_runner.run(cmd)
        w_runner.run(_start_command(False, head_addr, cfg.worker.resources,
                                    labels))
        cluster.actions.append(
            f"bootstrapped worker host group on {len(w_hosts)} hosts")

    cluster.provider = GPUVMNodeProvider(
        client=client,
        accelerator_type=cfg.provider.accelerator_type,
        machine_type=cfg.provider.machine_type,
        bootstrap=bootstrap,
        name_prefix=f"{cfg.cluster_name}-worker",
        # Scope every list/terminate to THIS cluster's workers: the head
        # (ray-node-type=head) and other clusters in the zone are not the
        # autoscaler's to reap.
        filter_labels={"ray-cluster": cfg.cluster_name,
                       "ray-node-type": "worker"})
    if not cfg.dry_run:
        controller_client = RpcClient(cluster.address, connect_timeout=120.0)
    else:
        class _NullState:
            def autoscaler_state(self):
                return {"nodes": [], "pending_demand": []}

        controller_client = _NullState()
    cluster.autoscaler = StandardAutoscaler(
        controller_client, cluster.provider,
        dict(cfg.worker.resources) or {"CPU": 1.0},
        min_nodes=cfg.min_workers, max_nodes=cfg.max_workers,
        idle_timeout_s=cfg.idle_timeout_minutes * 60.0,
        node_labels={**cfg.worker.labels, "ray-cluster": cfg.cluster_name})
    cluster.autoscaler.start()
    cluster.actions.append(
        f"autoscaler: {cfg.min_workers}..{cfg.max_workers} worker host "
        f"groups")
    return cluster


def _launch_record(cluster_name: str) -> str:
    """Where a parked ``up`` of a fake_multinode cluster records its pid,
    so that ``down`` can stop it."""
    import os
    import tempfile

    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch",
                        f"launch-{cluster_name}.json")


def _running(pid: int) -> bool:
    """Whether ``pid`` still runs (an exited child that its parent has not
    reaped yet does not)."""
    import os

    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return True


def _stop_parked_up(cluster_name: str, timeout_s: float = 60.0) -> List[str]:
    """SIGTERM the ``up`` process that holds a fake_multinode cluster and
    wait for it to shut the cluster down."""
    import json as _json
    import os
    import signal
    import time

    path = _launch_record(cluster_name)
    try:
        with open(path) as f:
            pid = int(_json.load(f)["pid"])
    except (OSError, ValueError, KeyError):
        return []
    try:
        os.kill(pid, signal.SIGTERM)
    except ProcessLookupError:
        pass
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if not _running(pid):
            break
        time.sleep(0.1)
    else:
        raise TimeoutError(f"up process {pid} of cluster {cluster_name!r} "
                           f"still running {timeout_s:.0f} s after SIGTERM")
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
    return [f"up process {pid} of cluster {cluster_name}"]


def down(config_or_path) -> List[str]:
    """Terminate every provider node of the named cluster (reference:
    ``ray down`` -> ``teardown_cluster``). For gpu_vm, lists instances by
    the ``ray-cluster`` label and deletes head + workers. A fake_multinode
    cluster lives in the process that launched it: ``down`` stops the
    ``up`` process parked on it (the JAX ``down`` leaves it running)."""
    cfg = (config_or_path if isinstance(config_or_path, ClusterConfig)
           else load_config(config_or_path))
    if cfg.provider.type == "fake_multinode":
        return _stop_parked_up(cfg.cluster_name)
    from ray_tpu_torch.gpu_vm_api import GpuVmClient

    client = GpuVmClient(cfg.provider.project_id, cfg.provider.zone,
                         dry_run=cfg.dry_run)
    killed = []
    for inst in client.list_instances({"ray-cluster": cfg.cluster_name}):
        if inst.get("labels", {}).get("ray-cluster") == cfg.cluster_name \
                or cfg.dry_run:
            name = inst.get("name", "<dry-run>")
            client.delete_instance(name)
            killed.append(name)
    if cfg.dry_run and not killed:
        # Nothing listed (no egress): still record the delete intents.
        killed = [f"{cfg.cluster_name}-head"]
        client.delete_instance(killed[0])
    return killed
