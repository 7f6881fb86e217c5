"""Autoscaler: demand-driven node provisioning.

Analogue of the reference's ``StandardAutoscaler``
(``autoscaler/_private/autoscaler.py:172,374``): a control loop reads the
cluster's load (alive nodes' availability + queue depth, plus the demand
the scheduler could not place), bin-packs the unmet demand onto candidate
node types, launches nodes through a pluggable ``NodeProvider``, and
terminates nodes idle past a timeout.

Providers:

* ``FakeMultiNodeProvider`` — launches real in-process ``Node`` supervisors
  (the reference's ``fake_multi_node/node_provider.py`` trick: autoscaler
  logic runs against real raylets on one machine).
* ``GPUVMNodeProvider`` — the cloud provider (reference: the GCP provider,
  ``gcp/node_provider.py``): creates a node's whole host group of GPU
  instances as an atomic gang (the JAX package's ``TPUVMNodeProvider``
  creates a TPU pod slice). This image has zero egress, so the Compute
  API calls are delegated to an injected transport; the provisioning
  logic (group sizing, gang atomicity with rollback, idle teardown) is
  real and tested via the fake transport.

The demand signal rides the controller: ``pick_node`` failures record the
unplaceable resource shapes, exposed via the ``autoscaler_state`` RPC
(reference: ``GcsAutoscalerStateManager`` over ``autoscaler.proto``).

The port's copy of ``ray_tpu/autoscaler.py``. One difference in the
planner: a node type with ``GPU`` cards also counts them as ``chips``,
the accelerator count that a node with cards advertises beside them
(``core/topology.py::detect_slice``), so a refused sub-slice
reservation (a mesh replica's ``{chips: n}`` demand) launches a GPU node.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.core import resources as resmath


class NodeProvider:
    """Pluggable provisioning backend (reference: ``node_provider.py``)."""

    def create_node(self, resources: Dict[str, float],
                    labels: Dict[str, str]) -> str:
        raise NotImplementedError

    def terminate_node(self, provider_node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError


class FakeMultiNodeProvider(NodeProvider):
    """Launches real in-process node supervisors against the given
    controller — the reference's fake-multi-node testing trick."""

    def __init__(self, controller_addr):
        self._controller_addr = controller_addr
        self._nodes: Dict[str, Any] = {}
        self._counter = 0

    def create_node(self, resources, labels) -> str:
        from ray_tpu_torch.core.node import Node

        self._counter += 1
        pid = f"fake-{self._counter}"
        node = Node(self._controller_addr, dict(resources),
                    {**labels, "provider_node_id": pid})
        self._nodes[pid] = node
        return pid

    def terminate_node(self, provider_node_id: str) -> None:
        node = self._nodes.pop(provider_node_id, None)
        if node is not None:
            node.stop()

    def non_terminated_nodes(self) -> List[str]:
        return list(self._nodes)

    def node_id_of(self, provider_node_id: str) -> Optional[str]:
        node = self._nodes.get(provider_node_id)
        return node.node_id.hex() if node else None


class GPUVMNodeProvider(NodeProvider):
    """GPU host groups as atomic gangs over the Compute Engine client
    (:class:`ray_tpu_torch.gpu_vm_api.GpuVmClient`; the counterpart of the
    JAX package's ``TPUVMNodeProvider``; reference: the GCP provider,
    ``gcp/node_provider.py``). One "node" is a group of
    ``gpu.pod_slice_hosts(accelerator_type)`` instances of
    ``machine_type``, created as one gang: if any insert fails, the
    instances already created are deleted and the error propagates, so a
    node is never half a group. Each instance carries the group's
    ``provider_node_id`` label (and its ``ray-host-index``), so the
    autoscaler maps cluster nodes back to groups.

    ``bootstrap(node_dict, labels)`` — when given — runs once every
    instance of the group is up, with ``node_dict = {"name", "hosts",
    "instances"}`` (the launcher SSHes ``start`` onto every host through
    :class:`HostGroupCommandRunner`); tests and dry-run skip it.
    ``transport`` builds a client over a fake HTTP layer for tests."""

    def __init__(self, transport=None, project: str = "", zone: str = "",
                 accelerator_type: str = "h100-8",
                 machine_type: str = "a3-highgpu-8g",
                 client=None,
                 bootstrap: "Optional[Callable[[dict, Dict], None]]" = None,
                 name_prefix: str = "ray-gpu-group",
                 filter_labels: "Optional[Dict[str, str]]" = None):
        if client is None:
            from ray_tpu_torch.gpu_vm_api import GpuVmClient

            if transport is not None:
                client = GpuVmClient(project, zone, token_fn=lambda: "",
                                     transport=transport)
            else:
                # Real HTTP: default auth (GCE metadata-server token).
                client = GpuVmClient(project, zone)
        self._client = client
        self._accelerator_type = accelerator_type
        self._machine_type = machine_type
        self._bootstrap = bootstrap
        self._name_prefix = name_prefix
        # Only instances carrying ALL these labels belong to this
        # provider: the project/zone is shared real estate — without the
        # filter, idle teardown and shutdown would delete the head and
        # other clusters' hosts, and the provisioning count would see
        # phantoms.
        self._filter_labels = dict(filter_labels or {})
        self._counter = 0

    def hosts_per_node(self) -> int:
        from ray_tpu_torch.gpu import pod_slice_hosts

        return pod_slice_hosts(self._accelerator_type)

    def create_node(self, resources, labels) -> str:
        import json as _json

        self._counter += 1
        # provider_node_id is the SHORT group name: GCP label values are
        # [a-z0-9_-] and <= 63 chars.
        name = f"{self._name_prefix}-{self._counter}"
        created: List[str] = []
        try:
            for i in range(self.hosts_per_node()):
                host = f"{name}-{i}"
                op = self._client.create_instance(
                    host, self._machine_type,
                    labels={**self._filter_labels, **labels,
                            "provider_node_id": name,
                            "ray-host-index": str(i)},
                    metadata={"ray_resources": _json.dumps(dict(resources))})
                created.append(host)
                self._client.wait_operation(op)
        except Exception:
            # Gang atomicity: a group missing a host is no node at all.
            for host in created:
                try:
                    self._client.delete_instance(host)
                except Exception:  # graftlint: disable=swallowed-exception (best-effort rollback; the insert's error propagates)
                    pass
            raise
        if self._bootstrap is not None:
            from ray_tpu_torch.gpu_vm_api import GpuVmClient

            instances = [self._client.get_instance(h) for h in created]
            self._bootstrap(
                {"name": name, "instances": instances,
                 "hosts": [GpuVmClient.instance_host(x) for x in instances]},
                {**labels, "provider_node_id": name})
        return name

    def _instances(self) -> List[dict]:
        return [x for x in self._client.list_instances(self._filter_labels)
                if x.get("status") not in ("STOPPING", "TERMINATED")
                and all(x.get("labels", {}).get(k) == v
                        for k, v in self._filter_labels.items())]

    def terminate_node(self, provider_node_id: str) -> None:
        for x in self._instances():
            if x.get("labels", {}).get("provider_node_id") == \
                    provider_node_id:
                self._client.delete_instance(x["name"])

    def non_terminated_nodes(self) -> List[str]:
        out: List[str] = []
        for x in self._instances():
            pid = x.get("labels", {}).get("provider_node_id")
            if pid and pid not in out:
                out.append(pid)
        return out


class _RemoteController:
    """Adapter: drive the autoscaler against a cluster's controller RPC
    endpoint instead of an in-process Controller object."""

    def __init__(self, client):
        self._client = client

    def autoscaler_state(self):
        return self._client.call("autoscaler_state")


class StandardAutoscaler:
    """The reference's update() loop shape: observe -> plan -> act."""

    def __init__(self, controller, provider: NodeProvider,
                 node_resources: Dict[str, float],
                 min_nodes: int = 0, max_nodes: int = 8,
                 idle_timeout_s: float = 60.0,
                 update_interval_s: float = 1.0,
                 node_labels: "Optional[Dict[str, str]]" = None,
                 instance_manager=None):
        if hasattr(controller, "call") and not hasattr(
                controller, "autoscaler_state"):
            controller = _RemoteController(controller)
        self._controller = controller
        self._provider = provider
        # Optional lifecycle layer (reference: autoscaler/v2
        # instance_manager + updater.py's retry/backoff setup): when
        # present, the planner requests/terminates THROUGH it and it owns
        # allocation retries, setup backoff, and stuck-instance
        # replacement.
        self._im = instance_manager
        self._node_resources = dict(node_resources)
        # What a launched node will advertise: its cards also as chips.
        self._advertised = dict(node_resources)
        if node_resources.get("GPU", 0) > 0:
            self._advertised.setdefault(resmath.CHIPS,
                                        float(node_resources["GPU"]))
        self._node_labels = dict(node_labels or {})
        self._min_nodes = min_nodes
        self._max_nodes = max_nodes
        self._idle_timeout_s = idle_timeout_s
        self._update_interval_s = update_interval_s
        self._idle_since: Dict[str, float] = {}  # node hex -> ts
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.num_launches = 0
        self.num_terminations = 0

    # ------------------------------------------------------------ control

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop,
                                        name="autoscaler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        import sys

        warned = False
        while not self._stop.wait(self._update_interval_s):
            try:
                self.update()
                warned = False
            except Exception as e:  # noqa: BLE001
                if not warned:  # a dead autoscaler must not be silent
                    print(f"autoscaler: update failing: {e!r}",
                          file=sys.stderr)
                    warned = True

    # ------------------------------------------------------------- update

    def update(self) -> None:
        """One reconcile pass (reference: StandardAutoscaler.update,
        autoscaler.py:374)."""
        state = self._controller.autoscaler_state()
        nodes = [n for n in state["nodes"] if n["alive"]]
        # Hosts the autopilot demoted from placement (heartbeat-RTT
        # outliers etc.): still alive, but their free capacity must not
        # absorb pending demand below — otherwise the demand looks met
        # and no healthy replacement ever launches. They still count
        # against max_nodes and still scale down when idle.
        tainted = set(state.get("tainted", ()))
        # Demand entries: {"resources": ..., "labels": ...} (labels from
        # node_label-blocked tasks). A label-constrained demand only counts
        # against this autoscaler's node type if the template labels
        # satisfy it — otherwise launching would never help — and, below,
        # only label-satisfying nodes' capacity can absorb it (a label-less
        # head node's free CPUs must not mark {pool: tpu} demand as met).
        def label_ok(node_labels, want):
            return not want or all(node_labels.get(k) == v
                                   for k, v in want.items())

        demand = []  # (resources, labels-or-None)
        for entry in state["pending_demand"]:
            if isinstance(entry, dict) and "resources" in entry:
                labels = entry.get("labels")
                if not label_ok(self._node_labels, labels):
                    continue
                demand.append((entry["resources"], labels))
            else:  # legacy plain resource dict
                demand.append((entry, None))
        provider_ids = set(self._provider.non_terminated_nodes())
        registered = {n["labels"].get("provider_node_id")
                      for n in nodes}
        if self._im is not None:
            self._im.reconcile(registered)

        # Plan scale-up: bin-pack unmet demand onto hypothetical new nodes.
        # Launched-but-not-yet-registered nodes count as capacity so slow
        # provisioning (minutes for a TPU slice) doesn't relaunch the same
        # demand every tick (with an instance manager, REQUESTED-but-not-
        # yet-allocated instances count too).
        # Provider-visible-but-unregistered nodes count even with an
        # instance manager: its state is in-memory, so after a restart it
        # would not know about a TPU slice still provisioning — and a
        # duplicate launch for the same demand is the expensive mistake.
        provisioning = len(provider_ids - registered)
        if self._im is not None:
            provisioning += self._im.requested_count()
        unmet: List[tuple] = []
        capacity = ([(n.get("labels", {}), dict(n["available"]))
                     for n in nodes if n["node_id"] not in tainted]
                    + [(self._node_labels, dict(self._advertised))
                       for _ in range(provisioning)])
        for shape, want in demand:
            if not any(label_ok(lbls, want) and resmath.fits(c, shape)
                       and resmath.take(c, shape)
                       for lbls, c in capacity):
                unmet.append((shape, want))
        to_launch = 0
        new_node = dict(self._advertised)
        pool: Dict[str, float] = {}
        for shape, _want in unmet:  # template labels already vetted above
            if not resmath.fits(new_node, shape):
                continue  # this node type can never satisfy it
            if not (pool and resmath.take(pool, shape)):
                to_launch += 1
                pool = dict(new_node)
                resmath.take(pool, shape)
        def current_count() -> int:
            live = len(self._provider.non_terminated_nodes())
            if self._im is not None:
                # Provider view + not-yet-allocated requests.
                return live + self._im.requested_count()
            return live

        def launch_one() -> None:
            if self._im is not None:
                self._im.request_node(self._node_resources,
                                      dict(self._node_labels))
            else:
                self._provider.create_node(self._node_resources,
                                           dict(self._node_labels))
            self.num_launches += 1

        launchable = max(0, min(to_launch,
                                self._max_nodes - current_count()))
        for _ in range(launchable):
            launch_one()

        # Ensure the floor.
        for _ in range(max(0, self._min_nodes - current_count())):
            launch_one()

        # Plan scale-down: terminate nodes idle past the timeout. Any
        # provider works: nodes carry their provider instance id as the
        # "provider_node_id" label.
        now = time.monotonic()
        remaining = len(nodes)
        for n in list(nodes):
            busy = (n["queue_len"] > 0
                    or any(n["available"].get(k, 0) < v
                           for k, v in n["resources"].items()))
            if busy:
                self._idle_since.pop(n["node_id"], None)
                continue
            pid = n["labels"].get("provider_node_id")
            first_idle = self._idle_since.setdefault(n["node_id"], now)
            if (now - first_idle > self._idle_timeout_s
                    and remaining > self._min_nodes
                    and pid in provider_ids):
                # Count the DECISION before executing it: terminate_node
                # can take seconds (socket teardown, thread joins) while
                # the provider's list already shows the node gone —
                # observers polling (provider empty, counter) must never
                # see the torn intermediate state.
                self._idle_since.pop(n["node_id"], None)
                self.num_terminations += 1
                remaining -= 1
                if self._im is not None:
                    self._im.terminate(pid)
                else:
                    self._provider.terminate_node(pid)
