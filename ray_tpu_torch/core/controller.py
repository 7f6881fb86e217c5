"""Controller: the cluster control plane (GCS equivalent).

Analogue of the reference's Global Control Service
(``src/ray/gcs/gcs_server/gcs_server.h:223-289``): one logical process holding
cluster-level metadata — node membership + health (``GcsNodeManager``,
``GcsHealthCheckManager``), the actor directory and lifecycle state machine
*including scheduling and restarts* (``GcsActorManager`` +
``GcsActorScheduler``: actors are scheduled by the control plane, not by the
creating client, so restarts survive the creator), placement groups with
two-phase bundle reservation (``GcsPlacementGroupManager/Scheduler``), jobs
(``GcsJobManager``), a KV store used for the function table and named actors
(``GcsInternalKVManager``), and cluster-level node selection for tasks (the
cluster half of the reference's two-level scheduler,
``cluster_resource_scheduler.h``).

The data plane stays decentralized exactly as in the reference: object values
live with their owners; the controller never sees them.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import resources as resmath
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.ids import ActorID, NodeID, PlacementGroupID
from ray_tpu_torch.core.pubsub import (DEAD_HOLDERS_CHANNEL, DEAD_HOLDERS_KEY,
                                       Pubsub)
from ray_tpu_torch.core.rpc import ClientPool, RpcServer
from ray_tpu_torch.core.rpc_stubs import CoreWorkerStub, NodeStub
from ray_tpu_torch.util.ratelimit import log_every

logger = logging.getLogger(__name__)

Addr = Tuple[str, int]

# Actor lifecycle states (reference: gcs.proto ActorTableData.ActorState).
DEPENDENCIES_UNREADY = "DEPENDENCIES_UNREADY"
PENDING_CREATION = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"


class NodeRecord:
    def __init__(self, node_id: NodeID, addr: Addr, resources: Dict[str, float],
                 labels: Dict[str, str],
                 slice_info: Optional[Dict[str, Any]] = None):
        self.node_id = node_id
        self.addr = tuple(addr)
        self.total = dict(resources)
        self.available = dict(resources)
        self.labels = dict(labels)
        # Advertised pod-slice membership (topology.SliceInfo.to_dict()):
        # feeds the controller's TopologyView for mesh-aware placement.
        self.slice_info = dict(slice_info) if slice_info else None
        self.queue_len = 0
        self.last_heartbeat = time.monotonic()
        self.alive = True
        # Last applied heartbeat seq; -1 = none yet. Re-registration resets
        # it so a restarted sender's fresh counter is accepted.
        self.sync_seq = -1

    def summary(self) -> Dict[str, Any]:
        return {
            "node_id": self.node_id.hex(),
            "addr": self.addr,
            "resources": dict(self.total),
            "available": dict(self.available),
            "labels": dict(self.labels),
            "slice": self.slice_info,
            "alive": self.alive,
            "queue_len": self.queue_len,
        }


class ActorRecord:
    def __init__(self, actor_id: ActorID, info: Dict[str, Any],
                 spec: Dict[str, Any], opts: Dict[str, Any]):
        self.actor_id = actor_id
        self.state = PENDING_CREATION
        self.addr: Optional[Tuple] = None  # (worker_addr, worker_id, node_addr)
        self.node_id: Optional[NodeID] = None
        self.info = info      # name, class_name, resources, max_restarts, ...
        self.spec = spec      # start_actor payload (cls_key, args_blob, ...)
        self.opts = opts      # scheduling options (resources, strategy, pg)
        self.num_restarts = 0
        self.incarnation = 0
        self.death_cause: Optional[str] = None


class PlacementGroupRecord:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]],
                 strategy: str):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.state = "PENDING"  # PENDING -> CREATING -> CREATED
        # bundle index -> (node_id, node addr)
        self.placement: Dict[int, Tuple[NodeID, Addr]] = {}


def _utilization(rec: NodeRecord) -> float:
    """Max fractional utilization across resource kinds (0 = idle)."""
    utils = []
    for k, tot in rec.total.items():
        if tot > 0:
            utils.append(1.0 - rec.available.get(k, 0.0) / tot)
    return max(utils) if utils else 0.0



class Controller:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 persist_path: Optional[str] = None):
        """``persist_path`` enables control-plane fault tolerance: cluster
        metadata (KV, jobs, named actors, actor/PG records) snapshots to
        disk and a restarted controller rebuilds from it (reference: GCS
        Redis persistence, ``redis_store_client.h:33`` + ``gcs_init_data.cc``
        — the durable store here is a local file, this image has no Redis).
        Node membership is NOT persisted: nodes re-register via their
        heartbeats, exactly like raylets reconnecting to a restarted GCS."""
        self._persist_path = persist_path
        self._save_lock = threading.Lock()
        self._lock = threading.RLock()
        self._nodes: Dict[NodeID, NodeRecord] = {}
        self._actors: Dict[ActorID, ActorRecord] = {}
        self._named_actors: Dict[str, ActorID] = {}
        self._kv: Dict[str, bytes] = {}
        self._jobs: Dict[str, Dict[str, Any]] = {}
        self._pgs: Dict[PlacementGroupID, PlacementGroupRecord] = {}
        self._metrics: Dict[str, List[Dict[str, Any]]] = {}
        self._metrics_ts: Dict[str, float] = {}
        # Control-plane instrumentation: plain counters bumped on the
        # handler paths (heartbeat is INLINE on the reactor — it must
        # never touch the registry lock), published by the snapshot-time
        # collector below.
        self._m_heartbeats = 0
        self._m_node_deaths = 0
        from ray_tpu_torch.util.metrics import CounterDeltas

        self._m_deltas = CounterDeltas()
        self._task_events: List[Dict[str, Any]] = []
        # Unmet-demand signal for the autoscaler (reference:
        # GcsAutoscalerStateManager's pending resource requests): deduped
        # by shape, expiring shortly after failures stop, cleared when a
        # placement of that shape succeeds — waiting submitters retry, so
        # live demand keeps itself fresh and satisfied demand evaporates
        # (no scale-up/down oscillation from stale history).
        # shape key -> (resources, ts, labels-or-None): unmet scheduling
        # demand, labels carried so the autoscaler can match node types.
        self._pending_demand: Dict[tuple, tuple] = {}
        # Pod-slice topology view: nodes advertise their slice at
        # registration; mesh-parallel serve replicas reserve ICI-
        # contiguous sub-slices through it (never a fragment straddling
        # two slices). Internally locked — accessed outside self._lock.
        from ray_tpu_torch.core.topology import TopologyView

        self._topology = TopologyView()
        # Worker processes (host, port, pid) each node reported started
        # and not yet gone, and the newest notices of gone ones published
        # on the dead-holder channel (``report_workers``).
        self._node_workers: Dict[NodeID, set] = {}
        self._dead_holders: deque = deque(maxlen=1024)
        self._dead_stamp = 0
        self._clients = ClientPool()
        self._stopped = threading.Event()
        # Long-poll notification hub (reference: src/ray/pubsub/publisher.h
        # + serve's LongPollHost): actor/job/PG state transitions and KV
        # writes publish here so clients wait on pushes, not poll loops.
        self.pubsub = Pubsub()
        # Multi-host gang registry (core/multihost.py): group epochs,
        # rendezvous barriers (program-hash checks park handler threads
        # here exactly like the pubsub long-polls), fenced group KV and
        # membership beats. Internally locked — accessed off self._lock.
        from ray_tpu_torch.core.multihost import GroupRegistry

        self.multihost = GroupRegistry()
        # Pipeline-parallel training registry (core/pipereg.py): epoch-
        # fenced per-pipeline progress records (the resume point a
        # re-formed stage gang asks for). Internally locked — accessed
        # off self._lock.
        from ray_tpu_torch.core.pipereg import PipelineRegistry

        self.pipelines = PipelineRegistry()
        self._server = RpcServer(
            handlers={
                "register_node": self.register_node,
                "unregister_node": self.unregister_node,
                "heartbeat": self.heartbeat,
                "list_nodes": self.list_nodes,
                "pick_node": self.pick_node,
                "register_actor": self.register_actor,
                "get_actor": self.get_actor,
                "list_actors": self.list_actors,
                "get_named_actor": self.get_named_actor,
                "report_actor_failure": self.report_actor_failure,
                "report_workers": self.report_workers,
                "kill_actor": self.kill_actor,
                "kv_put": self.kv_put,
                "kv_get": self.kv_get,
                "kv_put_fenced": self.kv_put_fenced,
                "epoch_bump": self.epoch_bump,
                # kv_del gained an in-package caller in PR 12
                # (serve.shutdown drops the serve-controller
                # checkpoint); kv_keys remains external-tooling-only.
                "kv_del": self.kv_del,
                # graftlint: disable=rpc-dead-endpoint
                "kv_keys": self.kv_keys,
                "register_job": self.register_job,
                "finish_job": self.finish_job,
                "list_jobs": self.list_jobs,
                "create_placement_group": self.create_placement_group,
                "get_placement_group": self.get_placement_group,
                "remove_placement_group": self.remove_placement_group,
                "cluster_resources": self.cluster_resources,
                "reserve_subslice": self.reserve_subslice,
                "release_subslice": self.release_subslice,
                "topology_state": self.topology_state,
                "taint_host": self.taint_host,
                "untaint_host": self.untaint_host,
                "taint_state": self.taint_state,
                "mh_register_group": self.multihost.register_group,
                "mh_drop_group": self.multihost.drop_group,
                "mh_barrier": self.multihost.barrier,
                "mh_member_beat": self.multihost.member_beat,
                "mh_group_put": self.multihost.group_put,
                "mh_group_get": self.multihost.group_get,
                "mh_group_state": self.multihost.group_state,
                "pipe_register": self.pipelines.register,
                "pipe_drop": self.pipelines.drop,
                "pipe_step_complete": self.pipelines.step_complete,
                "pipe_state": self.pipelines.state,
                "fr_dump": self.fr_dump,
                "autoscaler_state": self.autoscaler_state,
                "push_metrics": self.push_metrics,
                "list_metrics": self.list_metrics,
                "metrics_text": self.metrics_text,
                "push_task_events": self.push_task_events,
                "list_task_events": self.list_task_events,
                "psub_poll": self.pubsub.poll,
                "psub_poll_many": self.pubsub.poll_many,
                "psub_publish": self.pubsub.publish,
                # Publishers that own a key drop it at teardown so the
                # hub never pins their payload (the RL weight fan-out
                # publishes object-plane refs: a leaked key is a leaked
                # ObjectRef handle in the controller process).
                "psub_drop": self.pubsub.drop,
                "psub_snapshot": self.pubsub.snapshot,
                "psub_keys": self.pubsub.keys,
                "ping": lambda: "pong",
            },
            host=host,
            port=port,
            name="controller",
            max_workers=256,  # long-polls park handler threads
            # The reactor write path queues replies (non-blocking sendmsg
            # flush), so inline handlers can answer slow peers without
            # stalling other connections — heartbeats and pings must make
            # progress even when the pool is saturated with long-polls.
            inline_methods={"heartbeat", "ping"},
        )
        if persist_path:
            self._restore_state()
            self._persist_thread = threading.Thread(
                target=self._persist_loop, name="controller-persist",
                daemon=True)
            self._persist_thread.start()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="controller-health", daemon=True)
        self._health_thread.start()
        from ray_tpu_torch.util import metrics as um

        um.add_collector(self._collect_metrics)
        # Optional controller-side Prometheus endpoint: the whole
        # cluster's aggregated metrics as exposition text, scrapeable
        # without the dashboard (config.controller_metrics_http_port).
        self.metrics_http_addr: Optional[Addr] = None
        self._metrics_http = None
        if config.controller_metrics_http_port >= 0:
            self._start_metrics_http(host,
                                     config.controller_metrics_http_port)
        # Discovery file for the state CLI (`python -m ray_tpu status`).
        from ray_tpu_torch.scripts import write_discovery

        write_discovery(self.address)

    def _collect_metrics(self) -> None:
        from ray_tpu_torch.core import coremetrics as cm

        if not config.core_metrics_enabled:
            return
        with self._lock:
            pending = len(self._pending_demand)
        cm.CTRL_PENDING_DEMAND.set(float(pending))
        self._m_deltas.inc_to(cm.CTRL_HEARTBEATS, "hb", self._m_heartbeats)
        self._m_deltas.inc_to(cm.CTRL_NODE_DEATHS, "deaths",
                              self._m_node_deaths)

    def _start_metrics_http(self, host: str, port: int) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        controller = self

        class _MetricsHandler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                if self.path.split("?")[0] != "/metrics":
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    payload = controller.metrics_text().encode()
                except Exception as e:  # noqa: BLE001
                    payload = f"# metrics unavailable: {e!r}\n".encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *args):  # silence
                pass

        try:
            self._metrics_http = ThreadingHTTPServer((host, port),
                                                     _MetricsHandler)
        except OSError as e:
            logger.warning("controller /metrics endpoint failed to bind "
                           "%s:%s: %s", host, port, e)
            return
        self.metrics_http_addr = self._metrics_http.server_address
        threading.Thread(target=self._metrics_http.serve_forever,
                         name="controller-metrics-http",
                         daemon=True).start()

    # ------------------------------------------------------- persistence

    def _snapshot_state(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "kv": dict(self._kv),
                "jobs": {j: dict(info) for j, info in self._jobs.items()},
                "named_actors": {n: a.binary()
                                 for n, a in self._named_actors.items()},
                "actors": [
                    {"actor_id": rec.actor_id.binary(), "state": rec.state,
                     "addr": rec.addr,
                     "node_id": (rec.node_id.binary()
                                 if rec.node_id else None),
                     "info": dict(rec.info), "spec": dict(rec.spec),
                     "opts": dict(rec.opts),
                     "num_restarts": rec.num_restarts,
                     "incarnation": rec.incarnation,
                     "death_cause": rec.death_cause}
                    for rec in self._actors.values()],
                "pgs": [
                    {"pg_id": rec.pg_id.binary(), "bundles": rec.bundles,
                     "strategy": rec.strategy, "state": rec.state}
                    for rec in self._pgs.values()],
            }

    def save_state(self) -> None:
        if not self._persist_path:
            return
        import os
        import pickle

        # _snapshot_state copies every mutable container under the lock
        # (jobs/info/spec/opts are dict()-copied; remaining values are
        # immutable), so pickling outside the lock sees a consistent view.
        # _save_lock serializes writers (stop() racing the persist loop on
        # the shared .tmp path would corrupt the snapshot).
        with self._save_lock:
            blob = pickle.dumps(self._snapshot_state())
            if "://" in self._persist_path:
                # External store (reference: GCS-on-Redis FT,
                # redis_store_client.h:33 — here any pyarrow filesystem:
                # s3://, gs://, mock://; survives head-HOST loss, not just
                # head-process loss). Same atomic discipline as the local
                # path: write a temp object, then move — a crash mid-write
                # must never truncate the only snapshot.
                fs, path = self._external_fs()
                tmp = f"{path}.tmp-{os.getpid()}"
                with fs.open_output_stream(tmp) as f:
                    f.write(blob)
                fs.move(tmp, path)
                return
            tmp = self._persist_path + ".tmp"
            os.makedirs(os.path.dirname(self._persist_path) or ".",
                        exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, self._persist_path)

    def _external_fs(self):
        from pyarrow import fs as pafs

        return pafs.FileSystem.from_uri(self._persist_path)

    def _restore_state(self) -> None:
        import os
        import pickle

        if "://" in self._persist_path:
            import sys

            from pyarrow.lib import ArrowIOError

            try:
                fs, path = self._external_fs()
                with fs.open_input_stream(path) as f:
                    state = pickle.loads(f.read())
            except (ArrowIOError, OSError):
                return  # no snapshot yet
            except (pickle.UnpicklingError, EOFError, ValueError) as e:
                # A corrupt snapshot must not brick the replacement head:
                # starting empty (nodes re-register) beats not starting.
                print(f"controller: ignoring corrupt snapshot "
                      f"{self._persist_path}: {e!r}", file=sys.stderr)
                return
            self._apply_restored(state)
            return
        if not os.path.exists(self._persist_path):
            return
        with open(self._persist_path, "rb") as f:
            state = pickle.load(f)
        self._apply_restored(state)

    def _apply_restored(self, state: Dict[str, Any]) -> None:
        with self._lock:
            self._kv = dict(state.get("kv", {}))
            self._jobs = dict(state.get("jobs", {}))
            self._named_actors = {
                n: ActorID(b)
                for n, b in state.get("named_actors", {}).items()}
            reschedule = []
            for a in state.get("actors", []):
                rec = ActorRecord(ActorID(a["actor_id"]), a["info"],
                                  a["spec"], a["opts"])
                rec.state = a["state"]
                rec.addr = a["addr"]
                if a.get("node_id"):
                    rec.node_id = NodeID(a["node_id"])
                rec.num_restarts = a["num_restarts"]
                rec.incarnation = a["incarnation"]
                rec.death_cause = a["death_cause"]
                self._actors[rec.actor_id] = rec
                # In-flight creations/restarts lost their scheduler thread
                # with the old process: respawn it. ALIVE records keep
                # their address; if the worker died meanwhile, the first
                # caller's failure report drives the normal restart path.
                if rec.state in (PENDING_CREATION, RESTARTING):
                    reschedule.append(rec.actor_id)
            for p in state.get("pgs", []):
                pg_rec = PlacementGroupRecord(
                    PlacementGroupID(p["pg_id"]), p["bundles"],
                    p["strategy"])
                # Bundle placements referenced dead nodes; PGs return to
                # PENDING and re-reserve on the next create call (idempotent
                # 2PC), as the reference re-schedules PGs after GCS restart.
                pg_rec.state = "PENDING"
                self._pgs[pg_rec.pg_id] = pg_rec
        for actor_id in reschedule:
            threading.Thread(target=self._schedule_actor, args=(actor_id,),
                             name="actor-schedule", daemon=True).start()

    def _persist_loop(self) -> None:
        import sys

        warned = False
        while not self._stopped.wait(2.0):
            try:
                self.save_state()
                warned = False
            except Exception as e:  # noqa: BLE001
                if not warned:  # fault tolerance degrading is not silent
                    print(f"controller: state persistence failing: {e!r}",
                          file=sys.stderr)
                    warned = True

    @property
    def address(self) -> Addr:
        return self._server.addr

    # ------------------------------------------------------------- nodes

    def register_node(self, node_id_bytes: bytes, addr: Addr,
                      resources: Dict[str, float],
                      labels: Dict[str, str],
                      slice_info: Optional[Dict[str, Any]] = None) -> None:
        node_id = NodeID(node_id_bytes)
        with self._lock:
            self._nodes[node_id] = NodeRecord(node_id, addr, resources,
                                              labels, slice_info)
        if slice_info:
            from ray_tpu_torch.core.topology import SliceInfo

            self._topology.register(node_id.hex(),
                                    SliceInfo.from_dict(slice_info))

    def unregister_node(self, node_id_bytes: bytes) -> None:
        node_id = NodeID(node_id_bytes)
        with self._lock:
            rec = self._nodes.get(node_id)
            if rec:
                rec.alive = False
        self._on_node_dead(node_id)

    def heartbeat(self, node_id_bytes: bytes,
                  available: Optional[Dict[str, float]],
                  queue_len: int, seq: Optional[int] = None) -> Dict[str, bool]:
        """Returns ``known=False`` when this controller has no record of the
        node — the signal for a live raylet to re-register after a head
        restart (node membership is not persisted; reference: raylets
        re-registering with a restarted GCS, conftest.py:532).

        ``available=None`` is a liveness-only delta beat (the node's view
        is unchanged); the record keeps its last payload (reference:
        RaySyncer's versioned delta stream vs full snapshots).

        ``seq`` is the node's monotonic sync version (reference: versioned
        NodeState snapshots, ray_syncer.h:88). A beat whose seq is not
        newer than the last applied one is dropped — a delayed full beat
        racing a newer delta can no longer regress availability until the
        periodic refresh. Beats still count for liveness either way;
        ``seq=None`` (unversioned caller) always applies."""
        with self._lock:
            self._m_heartbeats += 1  # registry-free: runs on the reactor
            rec = self._nodes.get(NodeID(node_id_bytes))
            if rec is None:
                return {"known": False}
            rec.last_heartbeat = time.monotonic()
            rec.alive = True
            if seq is not None and seq <= rec.sync_seq:
                return {"known": True, "applied": False}
            if seq is not None:
                rec.sync_seq = seq
            if available is not None:
                rec.available = dict(available)
            rec.queue_len = queue_len
            return {"known": True, "applied": True}

    def list_nodes(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [r.summary() for r in self._nodes.values()]

    def cluster_resources(self) -> Dict[str, float]:
        with self._lock:
            total: Dict[str, float] = {}
            for rec in self._nodes.values():
                if rec.alive:
                    resmath.credit(total, rec.total)
            return total

    # ------------------------------------------------- pod-slice topology

    def reserve_subslice(self, owner: str, chips: int,
                         shape: Optional[List[int]] = None
                         ) -> Optional[Dict[str, Any]]:
        """Reserve an ICI-contiguous sub-slice for ``owner`` (a replica
        id). ``shape`` pins the chip-grid rectangle (a replica's mesh
        shape); bare ``chips`` folds to the most-square block. Returns
        the assignment (slice, origin, shape, hosting nodes) or None
        when no SINGLE slice can host it contiguously — a request that
        would straddle two slices is refused, never fragmented.

        This reserves the GRID only (which chips, contiguously). The
        scalar accounting rides the normal lease path: the actor that
        spans the sub-slice requests ``chips`` / ``slice:<id>``
        resources (resources.chip_resources), which the hosting node's
        own availability tracks — controller-side scalar deduction here
        would just be overwritten by the node's next heartbeat."""
        sub = self._topology.reserve(
            owner, chips=chips,
            shape=tuple(shape) if shape else None)
        if sub is None:
            # Unmet topology demand feeds the same autoscaler signal as
            # unplaceable tasks: a provider that can add slices sees it.
            shape_key = ((resmath.CHIPS, float(chips)),)
            with self._lock:
                self._pending_demand[shape_key] = (
                    {resmath.CHIPS: float(chips)}, time.monotonic(), None)
            return None
        return sub

    def release_subslice(self, reservation_id: str) -> bool:
        """Release a sub-slice reservation (idempotent)."""
        return self._topology.release(reservation_id)

    def topology_state(self) -> Dict[str, Any]:
        """Operator view: every advertised slice's grid, free chips,
        fragmentation, and live reservations."""
        return self._topology.state()

    def taint_host(self, node_hex: str,
                   ttl_s: Optional[float] = None) -> Dict[str, Any]:
        """Demote a host from new gang/replica placement (autopilot's
        taint-host action, or an operator). Placement preference, not
        exclusion: reservations still succeed when only tainted
        capacity remains. The taint lapses after ``ttl_s`` (default
        ``config.autopilot_taint_ttl_s``) — but the health loop keeps
        re-arming it while the host fails the re-admission probe."""
        ttl = (float(ttl_s) if ttl_s is not None
               else config.autopilot_taint_ttl_s)
        self._topology.taint(node_hex, ttl)
        return {"node": node_hex, "ttl_s": ttl}

    def untaint_host(self, node_hex: str, probe: bool = True
                     ) -> Dict[str, Any]:
        """Lift a host taint early. With ``probe`` (default) the host is
        re-admitted only if its heartbeats look healthy; a host that
        fails the probe keeps its taint for another TTL."""
        if probe and not self._node_probe_ok(node_hex):
            self._topology.taint(node_hex, config.autopilot_taint_ttl_s)
            return {"node": node_hex, "untainted": False,
                    "reason": "probe-failed"}
        return {"node": node_hex,
                "untainted": self._topology.untaint(node_hex)}

    def taint_state(self) -> Dict[str, float]:
        """Live host taints: node hex -> remaining seconds."""
        return self._topology.tainted()

    def _node_probe_ok(self, node_hex: str) -> bool:
        """Re-admission probe: alive with a heartbeat fresher than the
        health-check threshold. An unknown node fails (it can't be
        placed on anyway, and re-admitting a ghost proves nothing)."""
        threshold = (config.health_check_failure_threshold
                     * config.heartbeat_period_s)
        now = time.monotonic()
        with self._lock:
            for rec in self._nodes.values():
                if rec.node_id.hex() == node_hex:
                    return (rec.alive
                            and now - rec.last_heartbeat <= threshold)
        return False

    def _health_loop(self) -> None:
        period = config.heartbeat_period_s
        threshold = config.health_check_failure_threshold * period
        while not self._stopped.wait(period):
            now = time.monotonic()
            dead_nodes = []
            with self._lock:
                for rec in self._nodes.values():
                    if rec.alive and now - rec.last_heartbeat > threshold:
                        rec.alive = False
                        dead_nodes.append(rec.node_id)
            for node_id in dead_nodes:
                self._on_node_dead(node_id)
            self._reap_dead_actors()
            # Probe-gated taint expiry: a taint about to lapse on a host
            # that still fails the re-admission probe re-arms for
            # another TTL — TTLs re-admit recovered hosts, not sick ones.
            for node_hex, left in self._topology.tainted().items():
                if left <= period and not self._node_probe_ok(node_hex):
                    self._topology.taint(
                        node_hex, config.autopilot_taint_ttl_s)

    def _reap_dead_actors(self) -> None:
        """Bound the DEAD-actor cache (records + pubsub entries) so a
        long-lived cluster churning actors doesn't grow without limit
        (reference: maximum_gcs_destroyed_actor_cached_count)."""
        cap = config.dead_actor_cache_count
        with self._lock:
            dead = [a for a, r in self._actors.items() if r.state == DEAD]
            if len(dead) <= cap:
                return
            victims = dead[:len(dead) - cap]  # dict order = oldest first
            for actor_id in victims:
                rec = self._actors.pop(actor_id)
                name = rec.info.get("name")
                if name and self._named_actors.get(name) == actor_id:
                    del self._named_actors[name]
        for actor_id in victims:
            self.pubsub.drop("actors", actor_id.hex())

    def report_workers(self, node_id_bytes: bytes, started: List,
                       dead: List) -> None:
        """A node's reaper reports the worker processes it started and the
        ones it found gone; the gone ones are published so that every
        owner drops the handle counts they held (reference: the owner
        dropping a dead borrower's references on its death notice)."""
        node_id = NodeID(node_id_bytes)
        with self._lock:
            live = self._node_workers.setdefault(node_id, set())
            live.update(tuple(w) for w in started)
            live.difference_update(tuple(w) for w in dead)
        self._publish_dead_holders(dead)

    def _publish_dead_holders(self, holders) -> None:
        if not holders:
            return
        now_us = int(time.time() * 1e6)
        with self._lock:
            for h in holders:
                self._dead_stamp = max(self._dead_stamp + 1, now_us)
                self._dead_holders.append((self._dead_stamp, tuple(h)))
            notices = list(self._dead_holders)
        # A wall-clock floor keeps the owners' version clocks monotonic
        # across a controller restart.
        self.pubsub.publish(DEAD_HOLDERS_CHANNEL, DEAD_HOLDERS_KEY, notices,
                            min_version=now_us // 1000)

    def _on_node_dead(self, node_id: NodeID) -> None:
        """Fail (and maybe restart) actors on a dead node (reference:
        GcsActorManager node-death handling, gcs_actor_manager.h:88).
        Its worker processes died with it: they are published as dead
        holders."""
        with self._lock:
            gone = self._node_workers.pop(node_id, set())
        self._publish_dead_holders(sorted(gone))
        # Topology: a slice whose last live host died drops from the
        # view with its sub-slice reservations (the replicas holding
        # them died with the hosts; serve's reconcile re-reserves).
        self._topology.node_dead(node_id.hex())
        # Metric series from the dead node's processes stop meaning
        # anything (their counters died with them): drop them so the
        # cluster view reflects live producers only. A restarted node
        # registers a fresh id and pushes fresh cumulative snapshots —
        # never a double count.
        prefix = node_id.hex()[:8] + "/"
        with self._lock:
            self._m_node_deaths += 1
            for key in [k for k in self._metrics if k.startswith(prefix)]:
                del self._metrics[key]
                self._metrics_ts.pop(key, None)
            affected = [rec.actor_id for rec in self._actors.values()
                        if rec.node_id == node_id and rec.state == ALIVE]
        for actor_id in affected:
            self.report_actor_failure(actor_id.binary(),
                                      f"node {node_id.hex()} died")

    # ------------------------------------------------- cluster scheduling

    def pick_node(
        self,
        resources: Dict[str, float],
        strategy: Optional[Dict[str, Any]] = None,
        caller_node_id: Optional[bytes] = None,
        excluded: Optional[List[bytes]] = None,
    ) -> Optional[Dict[str, Any]]:
        """Cluster-level node selection.

        Default is the reference's hybrid policy
        (``src/ray/raylet/scheduling/policy/hybrid_scheduling_policy.cc``):
        prefer the caller's node while its utilization is below
        ``scheduler_spread_threshold``, otherwise pick the feasible node with
        the lowest utilization (ties broken deterministically). ``spread``
        picks the least-utilized feasible node regardless of locality;
        ``node_affinity`` pins (hard) or prefers (soft) a node. Returns
        {node_id, addr} or None if infeasible.
        """
        strategy = strategy or {}
        excluded_ids = {NodeID(b) for b in (excluded or [])}
        demand_labels = (strategy.get("labels")
                         if strategy.get("kind") == "node_label" else None)
        with self._lock:
            alive = [r for r in self._nodes.values()
                     if r.alive and r.node_id not in excluded_ids]
            feasible = [r for r in alive if resmath.fits(r.total, resources)]
            shape_key = (tuple(sorted(resources.items())),
                         tuple(sorted((demand_labels or {}).items())))
            if not feasible:
                self._pending_demand[shape_key] = (
                    dict(resources), time.monotonic(), demand_labels)
                return None
            self._pending_demand.pop(shape_key, None)

            def rank(r):
                return (_utilization(r), r.queue_len, r.node_id.binary())

            def prefer_room(pool):
                with_room = [r for r in pool
                             if resmath.fits(r.available, resources)]
                return with_room or pool

            kind = strategy.get("kind", "hybrid")
            if kind == "node_affinity":
                target = NodeID.from_hex(strategy["node_id"])
                for r in feasible:
                    if r.node_id == target:
                        return self._grant(r, resources)
                if not strategy.get("soft", False):
                    return None
            elif kind == "spread":
                return self._grant(min(feasible, key=rank), resources)
            elif kind == "node_label":
                # Label policy (reference:
                # node_label_scheduling_policy.cc): hard constraints must
                # all match; soft labels prefer matching nodes but fall
                # back to any hard-matching node. Nodes with room now beat
                # lower-utilization nodes that are currently full.
                hard = strategy.get("labels") or {}
                soft = strategy.get("soft_labels") or {}
                matching = [r for r in feasible
                            if all(r.labels.get(k) == v
                                   for k, v in hard.items())]
                if not matching:
                    # Label-blocked: keep the demand visible to operators
                    # and the autoscaler, WITH its labels, so the bin-pack
                    # only counts it against label-satisfying node types.
                    self._pending_demand[shape_key] = (
                        dict(resources), time.monotonic(), demand_labels)
                    return None
                preferred = [r for r in matching
                             if all(r.labels.get(k) == v
                                    for k, v in soft.items())]
                # Having room outranks soft-label preference: a full
                # soft-match must not beat an idle hard-match.
                with_room = [r for r in matching
                             if resmath.fits(r.available, resources)]
                pool = ([r for r in preferred if r in with_room]
                        or with_room or preferred or matching)
                return self._grant(min(pool, key=rank), resources)
            elif kind == "random":
                # Random policy (reference: random_scheduling_policy.cc):
                # uniform over feasible nodes with room (load-oblivious
                # scatter for e.g. monitoring tasks).
                import random as _random

                return self._grant(_random.choice(prefer_room(feasible)),
                                   resources)

            # Hybrid: local-first below the spread threshold.
            if caller_node_id is not None:
                local = NodeID(caller_node_id)
                for r in feasible:
                    if (r.node_id == local
                            and _utilization(r) < config.scheduler_spread_threshold
                            and resmath.fits(r.available, resources)):
                        return self._grant(r, resources)
            pool = prefer_room(feasible)
            pool = sorted(pool, key=rank)
            return self._grant(pool[0], resources)

    def _grant(self, rec: NodeRecord, resources: Dict[str, float]):
        # Optimistic decrement until the next heartbeat refreshes truth.
        resmath.deduct(rec.available, resources)
        return {"node_id": rec.node_id.binary(), "addr": rec.addr}

    # ------------------------------------------------------------ actors
    #
    # The controller owns the whole actor lifecycle: REGISTER ->
    # PENDING_CREATION -> (scheduled on a node, __init__ pushed) -> ALIVE;
    # on failure, RESTARTING (num_restarts < max_restarts) -> re-scheduled,
    # else DEAD. Mirrors GcsActorManager + GcsActorScheduler.

    def register_actor(self, actor_id_bytes: bytes, info: Dict[str, Any],
                       spec: Dict[str, Any], opts: Dict[str, Any]) -> None:
        actor_id = ActorID(actor_id_bytes)
        with self._lock:
            # Idempotent per actor id: the creator's client retries through
            # controller restarts (ReconnectingClient), so a re-delivered
            # registration must not spawn a second scheduler thread or
            # trip the name-conflict check against itself.
            if actor_id in self._actors:
                return
            name = info.get("name")
            if name:
                existing = self._named_actors.get(name)
                if existing is not None and existing != actor_id:
                    rec = self._actors.get(existing)
                    if rec is not None and rec.state != DEAD:
                        raise ValueError(
                            f"Actor with name {name!r} already exists")
                self._named_actors[name] = actor_id
            rec = ActorRecord(actor_id, info, spec, opts)
            self._actors[actor_id] = rec
            self._publish_actor(rec)
        threading.Thread(target=self._schedule_actor, args=(actor_id,),
                         name="actor-schedule", daemon=True).start()

    def _schedule_actor(self, actor_id: ActorID) -> None:
        """Place the actor on a node, lease a dedicated worker, push
        ``__init__`` (reference: GcsActorScheduler lease-based scheduling)."""
        with self._lock:
            rec = self._actors.get(actor_id)
            if rec is None or rec.state == DEAD:
                return
            opts = rec.opts
            spec = dict(rec.spec)
            incarnation = rec.incarnation
        t_sched = time.perf_counter()
        try:
            deadline = time.monotonic() + config.worker_lease_timeout_s
            excluded: List[bytes] = []
            while True:
                placement = opts.get("placement")
                picked_node_id = None
                if placement is not None:
                    pg = self.get_placement_group(placement[0])
                    if pg is None or placement[1] not in pg["placement"]:
                        raise RuntimeError(
                            f"placement group bundle {placement} not ready")
                    node_id_bytes, node_addr = pg["placement"][placement[1]]
                    bundle = (placement[0], placement[1])
                else:
                    pick = self.pick_node(
                        opts.get("resources", {"CPU": 1.0}),
                        opts.get("scheduling_strategy"), None, excluded)
                    if pick is None:
                        if time.monotonic() > deadline:
                            raise RuntimeError(
                                f"no feasible node for actor resources "
                                f"{opts.get('resources')}")
                        time.sleep(0.2)
                        excluded = []
                        continue
                    node_addr, node_id_bytes = pick["addr"], pick["node_id"]
                    picked_node_id = node_id_bytes
                    bundle = None
                try:
                    lease = NodeStub(
                        self._clients.get(tuple(node_addr))
                    ).create_actor_worker(
                        opts.get("resources", {"CPU": 1.0}), bundle, None,
                        opts.get("runtime_env"),
                        timeout=config.worker_lease_timeout_s + 10.0)
                except Exception as e:
                    self._clients.invalidate(tuple(node_addr))
                    lease = {"error": f"node unreachable: {e}"}
                if "error" in lease:
                    if picked_node_id is not None:
                        excluded.append(picked_node_id)
                    if lease.get("permanent") or time.monotonic() > deadline:
                        raise RuntimeError(
                            f"actor worker lease failed: {lease['error']}")
                    # PG-bundle leases skip pick_node, so back off here too —
                    # otherwise this loop busy-spins RPCs at a busy node.
                    time.sleep(0.2)
                    continue
                worker_addr = tuple(lease["addr"])
                reply = CoreWorkerStub(
                    self._clients.get(worker_addr)).start_actor(
                        spec, timeout=None)
                if reply["ok"]:
                    raced = False
                    with self._lock:
                        rec = self._actors.get(actor_id)
                        if rec is None or rec.incarnation != incarnation \
                                or rec.state == DEAD:
                            # Raced with kill/another restart: release
                            # the worker — but OUTSIDE self._lock. The
                            # kill_worker RPC has no timeout, and _lock
                            # guards ALL controller state: a slow node
                            # here would stall every heartbeat/lease/
                            # kill in the control plane behind this one
                            # cleanup (graftlint: lock-held-blocking).
                            raced = True
                        else:
                            rec.state = ALIVE
                            rec.addr = (worker_addr, lease["worker_id"],
                                        tuple(node_addr))
                            rec.node_id = NodeID(node_id_bytes)
                            self._publish_actor(rec)
                    if raced:
                        NodeStub(self._clients.get(
                            tuple(node_addr))).kill_worker(
                                lease["worker_id"], True)
                    elif config.core_metrics_enabled:
                        from ray_tpu_torch.core import coremetrics as cm

                        # Lease-grant latency pick -> ALIVE (scheduler
                        # thread, not the reactor).
                        cm.CTRL_SCHEDULE_S.observe(
                            time.perf_counter() - t_sched)
                    return
                # __init__ raised: permanent failure, no restart (parity with
                # the reference: creation-task errors kill the actor).
                import pickle

                err_desc = "__init__ failed"
                try:
                    from ray_tpu_torch.core import serialization

                    err = serialization.deserialize(reply["error_frame"])
                    err_desc = f"__init__ failed: {getattr(err, 'tb', err)}"
                except Exception:  # graftlint: disable=swallowed-exception
                    # Undeserializable error frame: the generic err_desc
                    # above already tells the caller WHAT failed.
                    pass
                self._mark_dead_locked_safe(actor_id, err_desc)
                return
        except BaseException as e:  # noqa: BLE001
            self._mark_dead_locked_safe(actor_id, f"creation failed: {e!r}")

    def _mark_dead_locked_safe(self, actor_id: ActorID, reason: str) -> None:
        with self._lock:
            rec = self._actors.get(actor_id)
            if rec is not None:
                rec.state = DEAD
                rec.death_cause = reason
                self._record_actor_death(rec, reason, restarting=False)
                self._publish_actor(rec)

    @staticmethod
    def _record_actor_death(rec: ActorRecord, reason: str,
                            restarting: bool) -> None:
        """Flight-recorder witness of an actor death: the post-mortem's
        'who died, why, was it restarted' evidence (a SIGKILLed actor's
        own recorder can say nothing past its last flush)."""
        from ray_tpu_torch.util import flightrec

        # Actor ids are the evidence here, not a label cardinality
        # hazard: the recorder is a bounded ring, not a registry.
        # graftlint: disable=metrics-label-cardinality
        flightrec.record("actor.death", actor=rec.actor_id.hex()[:8],
                         cls=str(rec.info.get("class_name", "")),
                         name=str(rec.info.get("name") or ""),
                         cause=reason, restarting=restarting)

    def report_actor_failure(self, actor_id_bytes: bytes,
                             reason: str = "") -> Dict[str, Any]:
        """A caller (or node-death handling) observed the actor's worker gone.
        Restart if budget remains (reference: max_restarts state machine,
        gcs_actor_manager.h:88); returns the resulting record."""
        actor_id = ActorID(actor_id_bytes)
        should_schedule = False
        with self._lock:
            rec = self._actors.get(actor_id)
            if rec is None:
                return None
            if rec.state in (DEAD, RESTARTING, PENDING_CREATION):
                return self._actor_summary(rec)
            max_restarts = rec.info.get("max_restarts", 0)
            if max_restarts == -1 or rec.num_restarts < max_restarts:
                rec.state = RESTARTING
                rec.num_restarts += 1
                rec.incarnation += 1
                rec.addr = None
                should_schedule = True
            else:
                rec.state = DEAD
                rec.death_cause = reason
            self._record_actor_death(rec, reason,
                                     restarting=should_schedule)
            self._publish_actor(rec)
            summary = self._actor_summary(rec)
        if should_schedule:
            def _delayed():
                time.sleep(config.actor_restart_delay_ms / 1000.0)
                self._schedule_actor(actor_id)

            threading.Thread(target=_delayed, name="actor-restart",
                             daemon=True).start()
        return summary

    def kill_actor(self, actor_id_bytes: bytes, no_restart: bool = True) -> None:
        actor_id = ActorID(actor_id_bytes)
        with self._lock:
            rec = self._actors.get(actor_id)
            if rec is None or rec.state == DEAD:
                return
            addr = rec.addr
            if no_restart:
                rec.state = DEAD
                rec.death_cause = "killed via kill()"
                self._record_actor_death(rec, rec.death_cause,
                                         restarting=False)
                self._publish_actor(rec)
        if addr is not None:
            worker_addr, worker_id, node_addr = addr
            try:
                NodeStub(self._clients.get(
                    tuple(node_addr))).kill_worker(
                        worker_id, True, timeout=5.0)
            except Exception:
                # The node may already be dead (its reaper got the
                # worker); a live node failing kills leaks workers.
                log_every("controller.kill_worker", 10.0, logger,
                          "kill_worker for actor kill failed",
                          exc_info=True)
        if not no_restart:
            self.report_actor_failure(actor_id_bytes, "killed (restartable)")

    def _publish_actor(self, rec: ActorRecord) -> None:
        """Push the actor's new state to long-poll subscribers (reference:
        GCS actor channel, pubsub.proto GCS_ACTOR_CHANNEL)."""
        self.pubsub.publish("actors", rec.actor_id.hex(),
                            self._actor_summary(rec))

    def _actor_summary(self, rec: ActorRecord) -> Dict[str, Any]:
        return {
            "actor_id": rec.actor_id.binary(),
            "state": rec.state,
            "addr": rec.addr,
            "node_id": rec.node_id.binary() if rec.node_id else None,
            "info": rec.info,
            "num_restarts": rec.num_restarts,
            "incarnation": rec.incarnation,
            "death_cause": rec.death_cause,
        }

    def get_actor(self, actor_id_bytes: bytes) -> Optional[Dict[str, Any]]:
        with self._lock:
            rec = self._actors.get(ActorID(actor_id_bytes))
            return None if rec is None else self._actor_summary(rec)

    def list_actors(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [self._actor_summary(r) for r in self._actors.values()]

    def get_named_actor(self, name: str) -> Optional[bytes]:
        with self._lock:
            actor_id = self._named_actors.get(name)
            return actor_id.binary() if actor_id else None

    # ---------------------------------------------------------------- kv

    def kv_put(self, key: str, value: bytes, overwrite: bool = True) -> bool:
        with self._lock:
            if not overwrite and key in self._kv:
                return False
            self._kv[key] = value
        self.pubsub.publish("kv", key, None)
        return True

    def kv_get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._kv.get(key)

    def kv_del(self, key: str) -> bool:
        with self._lock:
            return self._kv.pop(key, None) is not None

    # Epoch leases: named monotonic counters living IN the KV (so they
    # persist with it and a replacement head keeps fencing honest).
    # ``epoch_bump`` is the lease acquisition a process takes when it
    # claims a singleton role (the serve controller on every (re)start);
    # ``kv_put_fenced`` is the write path that role's state goes through
    # — a writer whose epoch is no longer the newest is a ZOMBIE (its
    # replacement already bumped) and its write is rejected, not applied
    # (reference: GCS leader fencing; Serve's controller checkpoint has
    # exactly one legitimate writer at a time).

    @staticmethod
    def _epoch_key(name: str) -> str:
        return f"__epoch__:{name}"

    def epoch_bump(self, name: str) -> int:
        """Atomically increment and return the named epoch counter."""
        key = self._epoch_key(name)
        with self._lock:
            epoch = int(self._kv.get(key, b"0")) + 1
            self._kv[key] = str(epoch).encode()
        self.pubsub.publish("kv", key, None)
        return epoch

    def kv_put_fenced(self, key: str, value: bytes, epoch: int,
                      epoch_name: str) -> bool:
        """``kv_put`` gated on ``epoch`` still being the NEWEST bump of
        ``epoch_name``: returns False (no write) for a stale writer —
        the signal to self-fence and stop mutating."""
        with self._lock:
            current = int(self._kv.get(self._epoch_key(epoch_name), b"0"))
            if epoch < current:
                return False
            self._kv[key] = value
        self.pubsub.publish("kv", key, None)
        return True

    def kv_keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return [k for k in self._kv if k.startswith(prefix)]

    # -------------------------------------------------------------- jobs

    def register_job(self, job_id: str, info: Dict[str, Any]) -> None:
        with self._lock:
            self._jobs[job_id] = {"state": "RUNNING", **info}
        self.pubsub.publish("jobs", job_id, {"state": "RUNNING", **info})

    def finish_job(self, job_id: str, state: str = "SUCCEEDED") -> None:
        with self._lock:
            if job_id in self._jobs:
                self._jobs[job_id]["state"] = state
                info = dict(self._jobs[job_id])
            else:
                info = None
        if info is not None:
            self.pubsub.publish("jobs", job_id, info)

    def list_jobs(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return dict(self._jobs)

    # -------------------------------------------- placement groups (2PC)

    def create_placement_group(
        self,
        pg_id_bytes: bytes,
        bundles: List[Dict[str, float]],
        strategy: str,
    ) -> Dict[str, Any]:
        """Reserve all bundles atomically across nodes; idempotent.

        Two-phase commit as in the reference
        (``gcs_placement_group_scheduler.h`` + raylet
        ``placement_group_resource_manager.h``): phase 1 reserves each bundle
        on its chosen node (node-side reservation is idempotent per
        (pg, bundle)); if any reservation fails, prior reservations are rolled
        back and the PG returns to PENDING (caller may retry). Concurrent
        calls for the same PG observe CREATING and back off.
        """
        pg_id = PlacementGroupID(pg_id_bytes)
        with self._lock:
            rec = self._pgs.get(pg_id)
            if rec is None:
                rec = PlacementGroupRecord(pg_id, bundles, strategy)
                self._pgs[pg_id] = rec
            if rec.state == "CREATED":
                return self._pg_summary(rec)
            if rec.state == "CREATING":
                return {"state": "PENDING", "reason": "creation in progress"}
            rec.state = "CREATING"
            plan = self._plan_bundles(rec.bundles, rec.strategy)
        if plan is None:
            with self._lock:
                rec.state = "PENDING"
            return {"state": "PENDING", "reason": "infeasible"}
        reserved: List[Tuple[int, NodeRecord]] = []
        ok = True
        for idx, node_rec in plan:
            try:
                granted = NodeStub(
                    self._clients.get(node_rec.addr)).reserve_bundle(
                        pg_id_bytes, idx, rec.bundles[idx])
            except Exception:
                granted = False
            if granted:
                reserved.append((idx, node_rec))
            else:
                ok = False
                break
        if not ok:
            for idx, node_rec in reserved:
                try:
                    NodeStub(
                        self._clients.get(node_rec.addr)).release_bundle(
                            pg_id_bytes, idx)
                except Exception:
                    # A failed rollback strands the bundle's resources
                    # until the node re-registers — worth a trail.
                    log_every("controller.release_bundle", 10.0, logger,
                              "placement-group bundle rollback failed",
                              exc_info=True)
            with self._lock:
                rec.state = "PENDING"
            return {"state": "PENDING", "reason": "reservation_failed"}
        with self._lock:
            rec.state = "CREATED"
            for idx, node_rec in reserved:
                rec.placement[idx] = (node_rec.node_id, node_rec.addr)
                resmath.deduct(node_rec.available, rec.bundles[idx])
            summary = self._pg_summary(rec)
        self.pubsub.publish("placement_groups", rec.pg_id.hex(), summary)
        return summary

    def _plan_bundles(self, bundles, strategy):
        """Choose a node per bundle honoring PACK/SPREAD/STRICT_PACK/
        STRICT_SPREAD (reference: common.proto:937-944)."""
        alive = [r for r in self._nodes.values() if r.alive]
        if not alive:
            return None
        remaining = {r.node_id: dict(r.available) for r in alive}
        plan: List[Tuple[int, NodeRecord]] = []

        if strategy in ("STRICT_PACK", "PACK"):
            order = sorted(alive, key=lambda r: (-_utilization(r),
                                                 r.node_id.binary()))
            if strategy == "STRICT_PACK":
                for r in order:
                    rem = dict(r.available)
                    if all(resmath.take(rem, b) for b in bundles):
                        return [(i, r) for i in range(len(bundles))]
                return None
            for i, b in enumerate(bundles):
                placed = False
                for r in order:
                    if resmath.take(remaining[r.node_id], b):
                        plan.append((i, r))
                        placed = True
                        break
                if not placed:
                    return None
            return plan

        # SPREAD / STRICT_SPREAD: round-robin distinct nodes.
        order = sorted(alive, key=lambda r: (_utilization(r),
                                             r.node_id.binary()))
        used_nodes = set()
        for i, b in enumerate(bundles):
            placed = False
            candidates = [r for r in order if r.node_id not in used_nodes]
            if strategy == "SPREAD":
                candidates = candidates + [r for r in order
                                           if r.node_id in used_nodes]
            for r in candidates:
                if resmath.take(remaining[r.node_id], b):
                    plan.append((i, r))
                    used_nodes.add(r.node_id)
                    placed = True
                    break
            if not placed:
                return None
        return plan

    def _pg_summary(self, rec: PlacementGroupRecord) -> Dict[str, Any]:
        return {
            "pg_id": rec.pg_id.binary(),
            "state": rec.state,
            "strategy": rec.strategy,
            "bundles": rec.bundles,
            "placement": {i: (nid.binary(), addr)
                          for i, (nid, addr) in rec.placement.items()},
        }

    def get_placement_group(self, pg_id_bytes: bytes) -> Optional[Dict[str, Any]]:
        with self._lock:
            rec = self._pgs.get(PlacementGroupID(pg_id_bytes))
            return self._pg_summary(rec) if rec else None

    def remove_placement_group(self, pg_id_bytes: bytes) -> None:
        with self._lock:
            rec = self._pgs.pop(PlacementGroupID(pg_id_bytes), None)
        if rec is None:
            return
        for idx, (node_id, addr) in rec.placement.items():
            try:
                NodeStub(self._clients.get(addr)).release_bundle(
                    pg_id_bytes, idx)
            except Exception:
                log_every("controller.release_bundle", 10.0, logger,
                          "placement-group bundle release failed",
                          exc_info=True)
            with self._lock:
                node_rec = self._nodes.get(node_id)
                if node_rec is not None:
                    resmath.credit(node_rec.available, rec.bundles[idx])

    def autoscaler_state(self) -> Dict[str, Any]:
        """Load view for the autoscaler (reference: autoscaler.proto
        GetClusterResourceState): alive nodes + live unmet demand (entries expire 10s after failures stop)."""
        cutoff = time.monotonic() - 10.0
        with self._lock:
            self._pending_demand = {
                k: entry for k, entry in self._pending_demand.items()
                if entry[1] > cutoff}
            return {
                "nodes": [r.summary() for r in self._nodes.values()],
                "pending_demand": [
                    {"resources": s, "labels": labels}
                    for s, _ts, labels in self._pending_demand.values()],
                # Autopilot-demoted hosts: the autoscaler must not let a
                # demoted host's free capacity mark demand as met (it
                # should launch a healthy replacement instead).
                "tainted": sorted(self._topology.tainted()),
            }

    # ------------------------------------------- metrics + task events
    #
    # Observability floor (reference: src/ray/stats/metric_defs.cc export
    # pipeline + GcsTaskManager's bounded task-event store,
    # gcs_task_manager.h:80). Workers push; the controller aggregates and
    # serves the state API / Prometheus text / timeline dump.

    def push_metrics(self, source: Dict[str, Any],
                     snapshot: List[Dict[str, Any]]) -> None:
        """Latest CUMULATIVE snapshot per source process, keyed
        "<node8>/<role>/pid<N>" (node prefix lets node death drop the
        series; role lets Prometheus queries split control/data plane).
        Replacement — never accumulation — is what makes restarts and
        missed pushes safe."""
        key = (f"{NodeID(source['node_id']).hex()[:8]}/"
               f"{source.get('role', 'worker')}/"
               f"pid{source.get('pid', 0)}")
        with self._lock:
            self._metrics[key] = snapshot
            self._metrics_ts[key] = time.monotonic()

    def list_metrics(self) -> Dict[str, List[Dict[str, Any]]]:
        with self._lock:
            return {k: list(v) for k, v in self._metrics.items()}

    def metrics_text(self) -> str:
        from ray_tpu_torch.util.metrics import prometheus_text

        return prometheus_text(self.list_metrics())

    def push_task_events(self, events: List[Dict[str, Any]]) -> None:
        cap = config.event_buffer_max
        with self._lock:
            self._task_events.extend(events)
            if len(self._task_events) > cap:
                # Bounded, priority to the newest (gcs_task_manager evicts
                # oldest first the same way).
                del self._task_events[:len(self._task_events) - cap]

    def list_task_events(self, limit: int = 1000) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._task_events[-limit:])

    def fr_dump(self, max_age_s: float = 0.0) -> Dict[str, Any]:
        """Merged flight-recorder dumps from every process on this host
        (util/flightrec.py): the controller flushes its own ring, then
        reads each persisted fr-<pid>.json under flightrec_dir —
        including files left by processes that are already dead, which
        is the whole point (`ray_tpu doctor --post-mortem` reads this).
        ``max_age_s`` > 0 drops files whose last flush is older (stale
        sessions on a shared dir)."""
        from ray_tpu_torch.util import flightrec

        flightrec.flush_now()
        return flightrec.dump_all(
            max_age_s=max_age_s if max_age_s > 0 else None)

    # ----------------------------------------------------------- control

    def stop(self) -> None:
        self._stopped.set()
        if self._metrics_http is not None:
            try:
                self._metrics_http.shutdown()
                self._metrics_http.server_close()
            except Exception:  # graftlint: disable=swallowed-exception
                # Teardown-only: the daemon thread dies with the process.
                pass
        try:
            self.save_state()
        except Exception:
            # Failing to persist at shutdown means the next head start
            # comes up empty — never silent.
            logger.warning("controller state save on stop failed",
                           exc_info=True)
        self._clients.close_all()
        self._server.stop()
