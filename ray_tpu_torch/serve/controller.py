"""ServeController: the serving control plane, as a named actor.

Analogue of the reference's ``ServeController`` actor
(``serve/_private/controller.py:86``; ``deploy_application`` :719,
``deployment_state.py`` reconciliation): it owns deployment configs and
replica actors, heals dead replicas, autoscales on replica-reported load
(``autoscaling_policy.py:12``), and pushes routing snapshots to every
handle via the cluster pubsub hub (the reference's ``LongPollHost``,
``long_poll.py:173``). Because it is an actor — not driver state — the
serving plane survives the deploying driver's exit; any process can pick
up a ``DeploymentHandle`` by name.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.rpc_stubs import ControllerStub
from ray_tpu_torch.util import faultinject
from ray_tpu_torch.util.ratelimit import log_every

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "_ray_tpu_serve_controller"
SNAPSHOT_CHANNEL = "serve_routes"
# Control-plane FT (mirrors core/controller.py save_state/_restore_state,
# through the core KV instead of a file): every mutating op checkpoints
# under STATE_KEY, fenced by the EPOCH_NAME epoch lease — a restarted
# controller bumps the epoch, restores the checkpoint, and ADOPTS the
# replicas that survived; a deposed zombie's writes are rejected.
STATE_KEY = "serve:controller:state"
EPOCH_NAME = "serve_controller"


def autoscale_load(stats: Dict[str, Any]) -> float:
    """One replica's autoscaler load signal from its reported stats.

    Base signal: ``max(ongoing, load)`` — HTTP concurrency vs the
    engine's own backlog (slots + queue + prefill backlog), whichever
    is worse.

    Speculative replicas would OVER-report headroom from that alone: a
    spec engine's slots complete requests ``(1 + accept_rate * k)``
    tokens per step instead of 1, so the same backlog clears faster at
    high acceptance — but at LOW acceptance each slot still pays the
    (k+1)-token verify forward per emitted token, and a draft pool
    under pressure keeps new seats draftless (no speedup at full spec
    cost). Scale the signal by the spec slowdown factor
    ``(k + 1) / (1 + accept_rate * k)`` (1.0 at perfect acceptance =
    the engine really does have spec-sized headroom; (k+1) at zero
    acceptance = every slot is doing verify work for nothing), plus a
    draft-pool-pressure bump when the pool is nearly exhausted."""
    load = float(max(stats.get("ongoing", 0) or 0,
                     stats.get("load", 0) or 0))
    spec = stats.get("spec")
    if not isinstance(spec, dict):
        return load
    k = float(spec.get("k", 0) or 0)
    if k <= 0:
        return load
    accept = spec.get("accept_rate")
    accept = 0.0 if accept is None else min(1.0, max(0.0, float(accept)))
    load *= (k + 1.0) / (1.0 + accept * k)
    total = float(spec.get("draft_pages_total", 0) or 0)
    if total > 0:
        occupancy = 1.0 - float(spec.get("draft_pages_free", 0)) / total
        if occupancy > 0.75:
            # Draft pool nearly dry: new admissions seat draftless and
            # decode at 1 token/step while paying spec overheads.
            load *= 1.0 + (occupancy - 0.75)
    return load


class ReplicaRecord:
    def __init__(self, handle, replica_id: str,
                 sub_slice: Optional[Dict[str, Any]] = None,
                 ranks: Optional[List[Any]] = None):
        self.handle = handle
        self.replica_id = replica_id
        # Ranks 1.. of a mesh replica (one process a rank; ``handle`` is
        # rank 0, the one the router sees). The replica lives and dies as
        # one unit with them.
        self.ranks: List[Any] = list(ranks or [])
        self.last_stats: Dict[str, Any] = {}
        # Sub-slice assignment a mesh-parallel replica spans (controller
        # ``reserve_subslice`` result): released when the replica dies.
        self.sub_slice = sub_slice
        self.created = time.monotonic()


class DeploymentRecord:
    def __init__(self, name: str, cls_blob: bytes, init_args, init_kwargs,
                 cfg: Dict[str, Any]):
        self.name = name
        self.cls_blob = cls_blob
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.cfg = cfg
        self.replicas: List[ReplicaRecord] = []
        self.next_replica_ord = 0
        self.last_scale = time.monotonic()
        self.deleting = False
        self.pub_version = 0      # last version _publish saw on the hub
        self.last_pub_check = 0.0  # hub-version heal throttle
        # Serializes structural changes (deploy's settle vs reconcile) so
        # two threads can't both observe len < target and double-add.
        self.lock = threading.Lock()


class ProxyRecord:
    def __init__(self, node_hex: str, handle):
        self.node_hex = node_hex
        self.handle = handle
        self.addr: Optional[tuple] = None
        self.failures = 0  # consecutive health-check failures


class ServeController:
    """Runs as a named actor; all methods are invoked via actor calls."""

    def __init__(self):
        faultinject.check("serve.controller.init")
        self._deployments: Dict[str, DeploymentRecord] = {}
        self._last_models: Dict[str, Any] = {}
        self._routes: Dict[str, str] = {}  # HTTP route prefix -> app name
        # HTTP data plane (reference: proxy_state.py): desired config +
        # one ProxyActor per alive node, reconciled below.
        self._http_cfg: Optional[Dict[str, Any]] = None
        self._proxies: Dict[str, ProxyRecord] = {}  # node hex -> record
        # Sub-slice reservation ids whose release RPC failed (head
        # briefly unreachable): retried every reconcile tick — a
        # silently dropped release would strand the chips until the
        # hosting node dies. Guarded by _lock; PERSISTED in the
        # checkpoint (a controller death with a queued release must not
        # leak the chips until node death).
        self._pending_releases: List[str] = []
        self._lock = threading.Lock()
        # Serializes checkpoint writers (a slow save interleaving with a
        # fresh one would let the stale snapshot win the KV write).
        self._save_mutex = threading.Lock()
        self._stop = threading.Event()
        # Epoch lease (reference: GCS leader fencing): bumped on every
        # controller (re)start, stamped into every snapshot, replica
        # assignment, and fenced KV write. 0 = not yet acquired (head
        # unreachable at start; the reconcile loop keeps trying).
        self._epoch = 0
        self._fenced = False
        self._acquire_epoch()
        # Rebuild from the last checkpoint BEFORE the reconcile threads
        # start: adoption must finish deciding which replicas live so
        # the first reconcile tick heals instead of double-spawning.
        self._restore_state()
        from ray_tpu_torch.util import metrics as um

        um.add_collector(self._collect_metrics)
        self._reconciler = threading.Thread(
            target=self._reconcile_loop, name="serve-reconcile", daemon=True)
        self._reconciler.start()
        # Proxies reconcile on their OWN thread: serial 5 s health probes
        # of a hung proxy must not delay replica healing/autoscaling.
        self._proxy_reconciler = threading.Thread(
            target=self._proxy_loop, name="serve-proxy-reconcile",
            daemon=True)
        self._proxy_reconciler.start()
        # Record the adoption outcome under the new epoch immediately:
        # dying again before the first mutation must not replay the
        # previous incarnation's view of the world.
        self._save_state()

    # ------------------------------------------------- durable state (FT)

    def _acquire_epoch(self) -> None:
        from ray_tpu_torch.core.runtime import get_core_worker

        try:
            self._epoch = ControllerStub(
                get_core_worker().controller).epoch_bump(
                    EPOCH_NAME, timeout=config.ctrl_call_timeout_s)
        except Exception:
            # Head unreachable at start: run epoch-less for now —
            # publishes go out unfenced and checkpoints are skipped —
            # and the reconcile loop keeps retrying the lease.
            log_every("serve.epoch", 10.0, logger,
                      "serve controller epoch lease unavailable; "
                      "running unfenced until the head answers",
                      exc_info=True)

    def _snapshot_state(self) -> Dict[str, Any]:
        """Copy every durable field. rec.replicas is read WITHOUT
        rec.lock on purpose: _save_state runs on paths that already
        hold rec.lock (_add_replica's spawn-failure release under
        _settle), so taking it here would be a lock-order cycle with
        _save_mutex (graftlint caught exactly that). The GIL makes the
        ``list(...)`` copy coherent; a snapshot racing a replica
        append/remove just records the neighboring state, and the
        mutating path's own save (deploy/reconcile both end with one)
        supersedes it within the same tick — same discipline as
        ``status()``'s lock-free replica reads."""
        with self._lock:
            recs = list(self._deployments.values())
            state: Dict[str, Any] = {
                "epoch": self._epoch,
                "routes": dict(self._routes),
                "http_cfg": (dict(self._http_cfg)
                             if self._http_cfg else None),
                "proxies": {
                    n: {"actor_id": p.handle.actor_id.binary(),
                        "addr": tuple(p.addr) if p.addr else None}
                    for n, p in self._proxies.items()},
                "pending_releases": list(self._pending_releases),
            }
        deployments = []
        for rec in recs:
            replicas = [
                {"replica_id": r.replica_id,
                 "actor_id": r.handle.actor_id.binary(),
                 "ranks": [h.actor_id.binary() for h in r.ranks],
                 "sub_slice": (dict(r.sub_slice)
                               if r.sub_slice else None)}
                for r in list(rec.replicas)]
            deployments.append({
                "name": rec.name, "cls_blob": rec.cls_blob,
                "init_args": rec.init_args,
                "init_kwargs": rec.init_kwargs, "cfg": rec.cfg,
                "next_replica_ord": rec.next_replica_ord,
                "pub_version": rec.pub_version,
                "deleting": rec.deleting, "replicas": replicas})
        state["deployments"] = deployments
        return state

    def _save_state(self) -> None:
        """Checkpoint the control plane through the core KV, fenced by
        the epoch lease. Every state-mutating handler must reach this
        before returning (graftlint: checkpoint-missing-save); the
        reconcile/proxy loops save when their pass changed anything. A
        False from the fenced write means a newer epoch exists — this
        instance is a zombie and ceases all mutation."""
        faultinject.check("serve.controller.save_state")
        if self._fenced or self._epoch <= 0:
            return
        import pickle

        from ray_tpu_torch.core.runtime import get_core_worker

        with self._save_mutex:
            blob = pickle.dumps(self._snapshot_state())
            try:
                # _save_mutex exists precisely to serialize this RPC
                # with concurrent snapshots: an unserialized slow save
                # would let a STALE snapshot overwrite a fresher one.
                # Nothing else ever takes _save_mutex.
                ok = ControllerStub(
                    get_core_worker().controller).kv_put_fenced(
                        STATE_KEY, blob, self._epoch, EPOCH_NAME,
                        timeout=config.ctrl_call_timeout_s)
            except Exception:
                # Head blip: state is stale until the next mutation or
                # reconcile-tick change saves again. Never silent —
                # degraded fault tolerance is an operator concern.
                log_every("serve.save_state", 10.0, logger,
                          "serve controller checkpoint failed; restart "
                          "would replay the previous checkpoint",
                          exc_info=True)
                return
        if not ok:
            self._fence("the checkpoint KV rejected this epoch's write")

    def _fence(self, why: str) -> None:
        """A newer controller epoch exists: this instance is a zombie
        (its replacement already restored and owns the plane). Cease
        every mutation — but do NOT drain: the replicas now belong to
        the successor, and killing them from here would be exactly the
        split-brain damage fencing exists to prevent."""
        if self._fenced:
            return
        self._fenced = True
        self._stop.set()
        logger.warning(
            "serve controller epoch %s fenced (%s): ceasing mutation; "
            "the successor controller owns the serve plane", self._epoch,
            why)

    def _restore_state(self) -> None:
        """Rebuild from the last checkpoint and ADOPT surviving actors.

        Replicas are pinged (concurrently, one shared deadline): the
        live ones keep their actor AND their sub-slice reservation —
        the topology view outlived the controller, so re-reserving
        would double-book chips, and respawning would re-pay prefill
        and weight loading for no reason. Only the dead are replaced
        (their reservations queue for release; a replica that misses the
        deadline is dead only if the cluster says so — one still starting
        is adopted, where the JAX controller replaces it), mid-delete
        deployments
        finish draining, and every snapshot republishes under the new
        epoch with its persisted version floor so router clocks stay
        monotonic."""
        faultinject.check("serve.controller.restore")
        import pickle

        from ray_tpu_torch.core.runtime import get_core_worker

        try:
            blob = ControllerStub(
                get_core_worker().controller).kv_get(
                    STATE_KEY, timeout=config.ctrl_call_timeout_s)
        except Exception:
            log_every("serve.restore", 10.0, logger,
                      "serve controller checkpoint unreadable (head "
                      "unreachable); starting empty", exc_info=True)
            return
        if not blob:
            return
        try:
            state = pickle.loads(blob)
        except Exception:
            # A corrupt checkpoint must not brick the replacement
            # controller: starting empty (deployments re-run) beats not
            # starting (routing stalls forever).
            logger.warning("serve controller checkpoint corrupt; "
                           "starting empty", exc_info=True)
            return
        from ray_tpu_torch.core.actor import ActorHandle
        from ray_tpu_torch.core.ids import ActorID

        self._routes = dict(state.get("routes") or {})
        self._http_cfg = state.get("http_cfg")
        self._pending_releases = list(state.get("pending_releases") or [])
        for node_hex, p in (state.get("proxies") or {}).items():
            proxy = ProxyRecord(node_hex,
                                ActorHandle(ActorID(p["actor_id"])))
            proxy.addr = tuple(p["addr"]) if p.get("addr") else None
            # Adopted as-is: the proxy loop health-checks at 1 Hz and
            # replaces the dead, exactly as for any hung proxy.
            self._proxies[node_hex] = proxy
        pings = []
        for d in state.get("deployments") or []:
            rec = DeploymentRecord(d["name"], d["cls_blob"],
                                   d["init_args"], d["init_kwargs"],
                                   d["cfg"])
            rec.next_replica_ord = d["next_replica_ord"]
            rec.pub_version = d["pub_version"]
            rec.deleting = bool(d.get("deleting"))
            self._deployments[d["name"]] = rec
            for r in d.get("replicas") or []:
                handle = ActorHandle(ActorID(r["actor_id"]))
                # Fire all pings first; gather below on one deadline.
                pings.append((rec, r, handle, handle.ping.remote()))
        adopted = dead = 0
        deadline = time.monotonic() + config.serve_adopt_timeout_s
        for rec, r, handle, ref in pings:
            try:
                ray_tpu_torch.get(ref, timeout=max(0.2,
                                             deadline - time.monotonic()))
            except Exception:
                # A replica still starting (or slow) past the deadline is
                # not dead: only the cluster's DEAD verdict is, as in the
                # reconcile loop, which replaces it if that comes later.
                dead_now = self._actor_dead(handle)
            else:
                dead_now = False
            if dead_now:
                dead += 1
                for rank in r.get("ranks") or ():
                    self._kill_handle(ActorHandle(ActorID(rank)),
                                      r["replica_id"])
                sub = r.get("sub_slice")
                if sub:
                    # The dead replica's reservation releases through
                    # the normal retry queue (idempotent on the head).
                    self._pending_releases.append(sub["reservation_id"])
                continue
            rec.replicas.append(ReplicaRecord(
                handle, r["replica_id"], r.get("sub_slice"),
                [ActorHandle(ActorID(a)) for a in r.get("ranks") or ()]))
            adopted += 1
            try:
                # Adoption handshake: the replica now reports THIS
                # epoch as its owner (doctor's orphan-replica gauge).
                handle.set_owner_epoch.remote(self._epoch)
            except Exception:
                log_every("serve.adopt_epoch", 10.0, logger,
                          "epoch push to adopted replica %s failed",
                          r["replica_id"], exc_info=True)
        # Deployments the old controller died mid-delete: finish them.
        for rec in [r for r in self._deployments.values() if r.deleting]:
            self._drain(rec)
            del self._deployments[rec.name]
            self._publish(rec)
        # Routing resumes here: epoch-stamped snapshots above the
        # persisted version floor (MTTR clock stops on this publish).
        for rec in self._deployments.values():
            self._publish(rec)
        if pings or self._pending_releases:
            logger.info(
                "serve controller epoch %s restored: %d replica(s) "
                "adopted in place, %d dead queued for replacement, %d "
                "pending sub-slice release(s) resumed", self._epoch,
                adopted, dead, len(self._pending_releases))

    # ------------------------------------------------------------ deploy

    def deploy(self, name: str, cls_blob: bytes, init_args, init_kwargs,
               cfg: Dict[str, Any]) -> Optional[int]:
        """Create or update a deployment (reference: deploy_application).
        Config change redeploys replicas; scale-only change adjusts count.

        The old record is marked ``deleting`` under the lock BEFORE its
        replicas drain, and the reconcile loop re-validates record identity
        under the same lock — otherwise a reconcile tick that snapshotted
        the old record could resurrect old-class replicas and publish them
        over the live name."""
        faultinject.check("serve.controller.deploy")
        with self._lock:
            old = self._deployments.get(name)
            rec = DeploymentRecord(name, cls_blob, init_args, init_kwargs,
                                   cfg)
            drain_old = False
            if old is not None:
                # The version floor survives record replacement: routers'
                # long-poll clocks are per deployment NAME, so a redeploy
                # publishing below the old record's version would strand
                # every existing handle.
                rec.pub_version = old.pub_version
                if (old.cls_blob == cls_blob
                        and old.init_args == init_args
                        and old.init_kwargs == init_kwargs):
                    rec.replicas = old.replicas  # rolling config update
                    rec.next_replica_ord = old.next_replica_ord
                else:
                    old.deleting = True
                    drain_old = True
            self._deployments[name] = rec
        if drain_old:
            self._drain(old)
        orphans: List[tuple] = []
        try:
            with rec.lock:
                doomed = self._settle(rec, orphans)
        finally:
            # A failed mesh spawn's ranks are killed OUTSIDE rec.lock.
            self._kill_orphans(orphans)
        # Kill downscaled replicas OUTSIDE rec.lock: ray_tpu_torch.kill is a
        # controller RPC, and holding the record lock across it would
        # stall every reconcile tick on this deployment behind a dead
        # node's timeout (graftlint: lock-held-blocking).
        for replica in doomed:
            self._kill_replica(replica)
        version = self._publish(rec)
        self._save_state()
        return version

    # ------------------------------------------------- autopilot hooks

    def autopilot_resize(self, deployment: str, delta: int = 1,
                         epoch: int = 0) -> Dict[str, Any]:
        """Autopilot's resize-deployment action (SLO burn). Fenced on
        the serve-controller epoch the autopilot OBSERVED: a mismatch
        means this plane restarted (and re-settled) since the evidence
        was collected, so the action no-ops — the successor already
        reconciled against fresh reality. Autoscaling deployments get
        their floor raised (the autoscaler stays in charge of the rest);
        fixed deployments get num_replicas bumped. The reconcile loop
        settles toward the new target on its next tick."""
        if self._fenced or int(epoch) != self._epoch:
            return {"ok": False, "reason": "stale-epoch",
                    "epoch": self._epoch}
        with self._lock:
            rec = self._deployments.get(deployment)
        if rec is None or rec.deleting:
            return {"ok": False, "reason": "unknown-deployment"}
        return self._apply_resize(rec, delta)

    def _apply_resize(self, rec: "DeploymentRecord",
                      delta: int) -> Dict[str, Any]:
        """The mutating half (checkpoint-obliged: every exit saves)."""
        with rec.lock:
            auto = rec.cfg.get("autoscaling")
            if auto:
                auto["min_replicas"] = max(1, min(
                    int(auto.get("max_replicas", 1)),
                    int(auto.get("min_replicas", 1)) + int(delta)))
                target = auto["min_replicas"]
            else:
                rec.cfg["num_replicas"] = max(
                    1, int(rec.cfg.get("num_replicas", 1)) + int(delta))
                target = rec.cfg["num_replicas"]
        self._save_state()
        return {"ok": True, "target": target, "epoch": self._epoch}

    def autopilot_shed(self, deployment: str, queue_max: int,
                       epoch: int = 0) -> Dict[str, Any]:
        """Autopilot's shed-tenant action (sustained rpc-backpressure):
        tighten the deployment's admission cap so overload sheds at
        enqueue (OverloadedError -> HTTP 503 + Retry-After — PR 3's
        admission machinery) instead of queueing into minutes of
        latency and backpressuring the control plane. Fenced like
        autopilot_resize. The override persists in the deployment cfg
        (checkpointed; re-applied to respawned replicas) until a
        redeploy replaces the record."""
        if self._fenced or int(epoch) != self._epoch:
            return {"ok": False, "reason": "stale-epoch",
                    "epoch": self._epoch}
        with self._lock:
            rec = self._deployments.get(deployment)
        if rec is None or rec.deleting:
            return {"ok": False, "reason": "unknown-deployment"}
        return self._apply_shed(rec, queue_max)

    def _apply_shed(self, rec: "DeploymentRecord",
                    queue_max: int) -> Dict[str, Any]:
        """The mutating half (checkpoint-obliged: every exit saves)."""
        with rec.lock:
            rec.cfg["queue_max_override"] = max(1, int(queue_max))
            replicas = list(rec.replicas)
        applied = 0
        for r in replicas:
            try:
                r.handle.set_admission.remote(rec.cfg["queue_max_override"])
                applied += 1
            except Exception:
                log_every("serve.autopilot_shed", 10.0, logger,
                          "admission-cap push to replica %s failed",
                          r.replica_id, exc_info=True)
        self._save_state()
        return {"ok": True, "queue_max": rec.cfg["queue_max_override"],
                "replicas": applied, "epoch": self._epoch}

    def _target_replicas(self, rec: DeploymentRecord) -> int:
        auto = rec.cfg.get("autoscaling")
        if auto:
            return max(auto["min_replicas"],
                       min(auto["max_replicas"], len(rec.replicas) or
                           auto["min_replicas"]))
        return rec.cfg.get("num_replicas", 1)

    def _settle(self, rec: DeploymentRecord,
                orphans: List[tuple]) -> List[ReplicaRecord]:
        """Converge the replica count toward target under rec.lock.
        Returns the replicas a downscale removed — the caller kills them
        after releasing the lock, as it kills ``orphans`` (the ranks of a
        mesh spawn that failed, see :meth:`_add_replica`). A replica that
        cannot be PLACED (no ICI-contiguous sub-slice free for its mesh)
        stops the upscale: the deployment stays below target and the
        reconcile loop retries when topology frees up — it is never
        placed on a fragment."""
        target = self._target_replicas(rec)
        doomed: List[ReplicaRecord] = []
        while len(rec.replicas) < target:
            if not self._add_replica(rec, orphans):
                break
        while len(rec.replicas) > target:
            doomed.append(self._remove_replica(rec))
        return doomed

    @staticmethod
    def _mesh_shape(rec: DeploymentRecord) -> Optional[tuple]:
        ms = rec.cfg.get("mesh_shape")
        return tuple(int(x) for x in ms) if ms else None

    @staticmethod
    def _mesh_chips(rec: DeploymentRecord) -> int:
        ms = ServeController._mesh_shape(rec)
        return ms[0] * ms[1] if ms else 1

    def _add_replica(self, rec: DeploymentRecord,
                     orphans: List[tuple]) -> bool:
        """Spawn one replica under rec.lock. A mesh spawn that fails
        leaves the ranks it started in ``orphans`` as (handle, replica
        id) pairs: the caller kills them with :meth:`_kill_orphans` after
        releasing rec.lock (a kill is a controller RPC)."""
        from ray_tpu_torch.serve.replica import ReplicaActor

        replica_id = f"{rec.name}#{rec.next_replica_ord}"
        mesh_shape = self._mesh_shape(rec)
        sub = None
        if mesh_shape is not None:
            # Mesh-parallel replica: reserve an ICI-contiguous sub-slice
            # BEFORE spawning. A refusal (None) means no single slice
            # can host the mesh — the replica queues (reconcile retries)
            # rather than spawning on a fragment straddling slices.
            from ray_tpu_torch.core.runtime import get_core_worker

            chips = mesh_shape[0] * mesh_shape[1]
            try:
                sub = ControllerStub(
                    get_core_worker().controller).reserve_subslice(
                        replica_id, chips, list(mesh_shape),
                        timeout=config.ctrl_call_timeout_s)
            except Exception:
                sub = None  # head unreachable counts as no capacity
            if sub is None:
                log_every(f"serve.subslice.{rec.name}", 5.0, logger,
                          "no contiguous %sx%s sub-slice for replica %s "
                          "of %r; deployment stays below target until "
                          "topology frees", mesh_shape[0], mesh_shape[1],
                          replica_id, rec.name)
                return False
        rec.next_replica_ord += 1
        # Everything fallible between the reservation and the record
        # append runs under this try: a spawn failure (head blip, bad
        # actor options) must hand the sub-slice back, or the chips
        # stay stranded until the hosting node dies (the reservation
        # has no other owner yet — graftlint: resource-leak-path).
        try:
            actor_cls = ray_tpu_torch.remote(ReplicaActor)
            opts = dict(rec.cfg.get("actor_options") or {})
            opts.setdefault("max_concurrency",
                            rec.cfg.get("max_ongoing_requests", 8))
            init_kwargs = rec.init_kwargs
            if sub is not None:
                if "mesh_shape" not in (init_kwargs or {}):
                    init_kwargs = dict(init_kwargs or {})
                    init_kwargs["mesh_shape"] = tuple(mesh_shape)
                handle, ranks = self._spawn_mesh(
                    rec, replica_id, sub, tuple(mesh_shape), opts,
                    init_kwargs, orphans)
            else:
                ranks = []
                handle = actor_cls.options(**opts).remote(
                    rec.cls_blob, rec.init_args, init_kwargs,
                    replica_id=replica_id, owner_epoch=self._epoch,
                    role=rec.cfg.get("role") or "")
        except Exception:
            if sub is not None:
                self._release_reservation(sub["reservation_id"],
                                          replica_id)
            raise
        rec.replicas.append(ReplicaRecord(handle, replica_id, sub, ranks))
        if sub is not None:
            try:
                # Advisory push (fire-and-forget): the replica reports
                # its sub-slice back through replica_metrics.
                handle.set_topology.remote(sub)
            except Exception:
                log_every("serve.set_topology", 10.0, logger,
                          "pushing sub-slice to replica %s failed",
                          replica_id, exc_info=True)
        if rec.cfg.get("queue_max_override"):
            try:
                # A live shed-tenant override outlives the replicas it
                # was first pushed to: respawns get it too, or the heal
                # path would quietly undo the admission clamp.
                handle.set_admission.remote(
                    int(rec.cfg["queue_max_override"]))
            except Exception:
                log_every("serve.set_admission", 10.0, logger,
                          "pushing admission cap to replica %s failed",
                          replica_id, exc_info=True)
        return True

    def _spawn_mesh(self, rec: DeploymentRecord, replica_id: str,
                    sub: Dict[str, Any], mesh_shape: tuple,
                    opts: Dict[str, Any], init_kwargs,
                    orphans: List[tuple]):
        """Spawn a mesh replica's ranks, one process a rank: rank 0 a
        :class:`ReplicaActor` (the one the router sees), ranks 1.. a
        ``MeshRankActor`` each, all hosting the same deployment. Each rank
        holds one chip of the sub-slice (and ``num_gpus=1`` on a slice of
        cards) on the node that hosts it, and joins the mesh's process
        group through the rendezvous address rank 0 puts in the KV: NCCL
        on a slice of cards, gloo on a virtual slice of the CPU or for a
        deployment whose ``device`` is the CPU. A failure spawning any
        rank puts the ranks already spawned in ``orphans`` for the caller
        to kill once rec.lock is released; the caller releases the
        reservation."""
        import uuid

        from ray_tpu_torch.core import resources as resmath
        from ray_tpu_torch.core.placement import (
            NodeAffinitySchedulingStrategy)
        from ray_tpu_torch.serve.replica import MeshRankActor, ReplicaActor

        n = mesh_shape[0] * mesh_shape[1]
        device = str((init_kwargs or {}).get("device") or "")
        device_type = ("cpu" if sub["slice_id"].startswith("virtual-")
                       or device.startswith("cpu") else "cuda")
        key = f"serve:mesh:{replica_id}:{uuid.uuid4().hex[:12]}"
        nodes = list(sub["nodes"])
        spawned: List[Any] = []
        try:
            for rank in range(n):
                rank_opts = dict(opts)
                # The scalar accounting half of the reservation: each
                # rank's lease holds one chip / slice:<id> against its
                # node, so vector scheduling and the topology grid agree.
                rank_opts["resources"] = {
                    **(opts.get("resources") or {}),
                    **resmath.chip_resources(1, sub["slice_id"])}
                if device_type == "cuda":
                    rank_opts.setdefault("num_gpus", 1)
                rank_opts["scheduling_strategy"] = (
                    NodeAffinitySchedulingStrategy(
                        nodes[min(rank * len(nodes) // n,
                                  len(nodes) - 1)]))
                mesh_rank = {"rank": rank, "world": n, "key": key,
                             "device_type": device_type}
                if rank == 0:
                    spawned.append(ray_tpu_torch.remote(ReplicaActor)
                                   .options(**rank_opts).remote(
                        rec.cls_blob, rec.init_args, init_kwargs,
                        replica_id=replica_id, owner_epoch=self._epoch,
                        role=rec.cfg.get("role") or "",
                        mesh_rank=mesh_rank))
                else:
                    spawned.append(ray_tpu_torch.remote(MeshRankActor)
                                   .options(**rank_opts).remote(
                        rec.cls_blob, rec.init_args, init_kwargs,
                        replica_id, mesh_rank))
        except Exception:
            orphans.extend((handle, replica_id) for handle in spawned)
            raise
        return spawned[0], spawned[1:]

    def _kill_orphans(self, orphans: List[tuple]) -> None:
        """Kill the ranks of failed mesh spawns (never under rec.lock)."""
        for handle, replica_id in orphans:
            self._kill_handle(handle, replica_id)
        orphans.clear()

    def _kill_handle(self, handle, replica_id: str) -> None:
        try:
            ray_tpu_torch.kill(handle)
        except Exception:
            # Expected when healing replicas the cluster already declared
            # DEAD or when the head is briefly unreachable; rate-limited
            # so a systematic kill failure still surfaces.
            log_every("serve.kill_replica", 10.0, logger,
                      "kill of replica %s failed", replica_id,
                      exc_info=True)

    def _remove_replica(self, rec: DeploymentRecord,
                        index: int = -1) -> ReplicaRecord:
        """Pop a replica record. Killing the actor is the caller's job —
        via _kill_replica, outside any held lock."""
        return rec.replicas.pop(index)

    def _kill_replica(self, replica: ReplicaRecord) -> None:
        """Kill every process of the replica (a mesh replica's ranks
        too), then release its sub-slice."""
        for handle in [replica.handle] + replica.ranks:
            self._kill_handle(handle, replica.replica_id)
        self._release_subslice(replica)

    def _release_subslice(self, replica: ReplicaRecord) -> None:
        """Return a dead/downscaled replica's sub-slice to the topology
        view (idempotent; a leaked reservation would strand its chips
        until the hosting node dies)."""
        sub = replica.sub_slice
        if sub is None:
            return
        replica.sub_slice = None
        self._release_reservation(sub["reservation_id"],
                                  replica.replica_id)

    def _release_reservation(self, reservation_id: str,
                             owner: str) -> None:
        """Release a reservation id, parking it for reconcile-loop
        retry when the head is unreachable — the release must
        eventually land, or the chips stay stranded."""
        from ray_tpu_torch.core.runtime import get_core_worker

        try:
            ControllerStub(get_core_worker().controller) \
                .release_subslice(reservation_id,
                                  timeout=config.ctrl_call_timeout_s)
        except Exception:
            with self._lock:
                self._pending_releases.append(reservation_id)
            log_every("serve.release_subslice", 10.0, logger,
                      "releasing sub-slice %s of replica %s failed; "
                      "queued for retry", reservation_id, owner,
                      exc_info=True)
            # Checkpoint the queued release IMMEDIATELY: a controller
            # death between here and the retry must not leak the chips
            # until node death (the restarted controller resumes the
            # queue from the checkpoint).
            self._save_state()

    def _collect_metrics(self) -> None:
        """Snapshot-time gauges: pending sub-slice release depth (failed
        release RPCs are stranded chips until the retry succeeds) and
        the controller epoch (the doctor's controller-flapping /
        orphan-replica input)."""
        from ray_tpu_torch.serve import metrics as smetrics

        with self._lock:
            depth = len(self._pending_releases)
        smetrics.PENDING_RELEASES.set(float(depth))
        if self._epoch > 0:
            smetrics.CONTROLLER_EPOCH.set(float(self._epoch))

    def _retry_pending_releases(self) -> None:
        """Reconcile-tick retry of release RPCs that failed (head
        blip): idempotent on the controller, so replaying an id that
        already released is harmless — including one the previous
        controller incarnation managed to release before dying."""
        with self._lock:
            if not self._pending_releases:
                return
        # Chaos hook BEFORE the queue is popped: a die/error rule here
        # kills the controller mid-release-retry with the queue intact.
        faultinject.check("serve.controller.retry_pending_releases")
        with self._lock:
            pending = self._pending_releases
            self._pending_releases = []
        from ray_tpu_torch.core.runtime import get_core_worker

        released = 0
        for rid in pending:
            try:
                ControllerStub(get_core_worker().controller) \
                    .release_subslice(rid, timeout=config.ctrl_call_timeout_s)
                released += 1
            except Exception:
                with self._lock:
                    self._pending_releases.append(rid)
                log_every("serve.release_retry", 10.0, logger,
                          "retrying sub-slice release %s failed", rid,
                          exc_info=True)
        if released:
            # The drained ids must leave the checkpoint too: a restart
            # replaying them is harmless (idempotent) but noisy.
            self._save_state()

    def _drain(self, rec: DeploymentRecord) -> None:
        while rec.replicas:
            self._kill_replica(self._remove_replica(rec))

    def _publish(self, rec: DeploymentRecord) -> Optional[int]:
        """Push the routing snapshot (replica actor ids + model residency)
        to subscribers through the cluster pubsub (LongPollHost shape).
        Returns the published version so deploy() callers can wait for
        their own snapshot to reach their router.

        Snapshots are EPOCH-STAMPED and the hub fences them: a deposed
        zombie controller's publish is rejected server-side (and this
        instance self-fences on the rejection), and routers additionally
        ignore any snapshot whose epoch regresses below one they've
        applied."""
        from ray_tpu_torch.core.runtime import get_core_worker

        if self._fenced:
            return None
        snapshot = {
            "epoch": self._epoch,
            "replicas": [
                {"actor_id": r.handle.actor_id.binary(),
                 "replica_id": r.replica_id,
                 "models": r.last_stats.get("models", []),
                 "prefixes": r.last_stats.get("prefixes", []),
                 # Topology in the routing snapshot: routers prefer
                 # ICI-local (same-slice) replicas without any
                 # controller round-trip on the request path.
                 "slice_id": ((r.sub_slice or {}).get("slice_id")
                              or r.last_stats.get("slice_id")),
                 "mesh_shape": r.last_stats.get("mesh_shape")}
                for r in rec.replicas],
            "max_ongoing_requests": rec.cfg.get("max_ongoing_requests", 8),
            "deleted": rec.deleting,
            # Disaggregated posture: a role="prefill" deployment's
            # routers splice requests to decode_deployment's fleet.
            # Unset reads as colocated — the legacy path, byte-for-byte.
            "role": rec.cfg.get("role") or "colocated",
            "decode_deployment": rec.cfg.get("decode_deployment"),
        }
        try:
            # min_version keeps subscriber clocks monotonic across a hub
            # (head) restart: routers long-poll with the last version they
            # saw, so a republish below it would never wake them.
            version = ControllerStub(
                get_core_worker().controller).psub_publish(
                    SNAPSHOT_CHANNEL, rec.name, snapshot,
                    rec.pub_version + 1,
                    self._epoch if self._epoch > 0 else None,
                    timeout=config.ctrl_call_timeout_s)
        except Exception:
            return None
        if version is None:
            # The hub fenced this publish: a newer epoch owns the key.
            self._fence("the snapshot hub rejected this epoch's publish")
            return None
        rec.pub_version = version
        return version

    # ----------------------------------------------------------- queries

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                name: {
                    "replicas": len(rec.replicas),
                    "replica_ids": [r.replica_id for r in rec.replicas],
                    # Disaggregated posture (colocated = legacy).
                    "role": rec.cfg.get("role") or "colocated",
                    "decode_deployment": rec.cfg.get(
                        "decode_deployment"),
                    # Handoff-lease health, summed: live (undischarged)
                    # handoffs and the payload bytes they pin. Nonzero
                    # at steady state means a leaking splice path.
                    "handoffs_live": sum(
                        r.last_stats.get("handoffs_live", 0)
                        for r in rec.replicas),
                    "handoff_live_bytes": sum(
                        r.last_stats.get("handoff_live_bytes", 0)
                        for r in rec.replicas),
                    "ongoing": sum(
                        r.last_stats.get("ongoing", 0)
                        for r in rec.replicas),
                    "load": sum(
                        max(r.last_stats.get("ongoing", 0),
                            r.last_stats.get("load", 0))
                        for r in rec.replicas),
                    # Degradation counters (replica-reported, summed):
                    # shedding/cancellation/deadline expiry show up in
                    # serve.status() AS the overload happens, not after.
                    "shed": sum(r.last_stats.get("shed", 0)
                                for r in rec.replicas),
                    "cancelled": sum(r.last_stats.get("cancelled", 0)
                                     for r in rec.replicas),
                    "deadline_exceeded": sum(
                        r.last_stats.get("deadline_exceeded", 0)
                        for r in rec.replicas),
                    # Page-pool health (paged decode replicas): free /
                    # prefix-pinned pages and prefill-backlog tokens sum
                    # across replicas; fragmentation reports the WORST
                    # replica (it is a ratio — summing is meaningless).
                    "pages_free": sum(r.last_stats.get("pages_free", 0)
                                      for r in rec.replicas),
                    "pages_pinned": sum(
                        r.last_stats.get("pages_pinned", 0)
                        for r in rec.replicas),
                    "kv_fragmentation": max(
                        (r.last_stats.get("kv_fragmentation", 0.0)
                         for r in rec.replicas), default=0.0),
                    "prefill_backlog_tokens": sum(
                        r.last_stats.get("prefill_backlog_tokens", 0)
                        for r in rec.replicas),
                    "preempted": sum(r.last_stats.get("preempted", 0)
                                     for r in rec.replicas),
                    # Topology: total chips this deployment occupies
                    # (a (2,4)-mesh replica counts 8, a single-chip
                    # replica 1) and each replica's mesh footprint +
                    # sub-slice assignment — serve.status() shows WHERE
                    # every model-parallel replica lives.
                    "chips_in_use": sum(
                        r.last_stats.get("chips",
                                         (r.sub_slice or {}).get("chips",
                                                                 1))
                        for r in rec.replicas),
                    "replica_topology": [
                        {"replica_id": r.replica_id,
                         "role": rec.cfg.get("role") or "colocated",
                         "mesh_shape": r.last_stats.get("mesh_shape"),
                         "chips": r.last_stats.get(
                             "chips",
                             (r.sub_slice or {}).get("chips", 1)),
                         "slice_id": ((r.sub_slice or {}).get("slice_id")
                                      or r.last_stats.get("slice_id")),
                         "sub_slice": ({
                             "origin": r.sub_slice["origin"],
                             "shape": r.sub_slice["shape"],
                         } if r.sub_slice else None)}
                        for r in rec.replicas],
                }
                for name, rec in self._deployments.items()
            }

    def timelines(self) -> Dict[str, Any]:
        """Engine step timelines of every replica, keyed deployment ->
        replica_id (``ray_tpu timeline --serve`` merges them into the
        cross-process Chrome trace). Bounded per-replica RPCs OUTSIDE
        the controller lock; unreachable replicas report empty."""
        with self._lock:
            recs = {name: list(rec.replicas)
                    for name, rec in self._deployments.items()}
        out: Dict[str, Any] = {}
        for name, replicas in recs.items():
            dep = out.setdefault(name, {})
            refs = [(r, r.handle.engine_timeline.remote())
                    for r in replicas]
            for replica, ref in refs:
                try:
                    dep[replica.replica_id] = ray_tpu_torch.get(ref,
                                                          timeout=10.0)
                except Exception:
                    log_every("serve.timelines", 30.0, logger,
                              "timeline dump from replica %s failed",
                              replica.replica_id, exc_info=True)
                    dep[replica.replica_id] = {"rows": []}
        return out

    def proxy_status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                n: {"addr": p.addr, "failures": p.failures}
                for n, p in self._proxies.items()
            }

    def set_route(self, prefix: str, name: str) -> None:
        """Register an HTTP route prefix for an application (reference:
        route_prefix in serve deployments; the proxy resolves by longest
        matching prefix). REPLACES the app's previous routes so redeploys
        with a new prefix converge; prefixes normalize to a leading
        slash (a slash-less YAML value would otherwise never match)."""
        prefix = "/" + prefix.strip("/")
        with self._lock:
            self._routes = {p: n for p, n in self._routes.items()
                            if n != name}
            self._routes[prefix] = name
        self._save_state()

    def get_routes(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._routes)

    def delete(self, name: str) -> None:
        with self._lock:
            # Route purge + tombstone atomically: a concurrent redeploy
            # can't leave a route pointing at a doomed record. The
            # record STAYS in _deployments (deleting=True) until the
            # drain finishes — so the tombstone checkpoint below still
            # knows the replicas, and a controller death mid-drain
            # restores a record it finishes killing instead of
            # orphaning live replica actors nobody reconciles.
            self._routes = {p: n for p, n in self._routes.items()
                            if n != name}
            rec = self._deployments.get(name)
            if rec is not None:
                rec.deleting = True  # under lock: reconcile must not heal it
        self._save_state()  # tombstone first, then drain
        if rec is not None:
            self._drain(rec)
            with self._lock:
                # Identity-guarded pop: a redeploy racing the drain owns
                # the name now; only remove OUR tombstoned record.
                if self._deployments.get(name) is rec:
                    del self._deployments[name]
            self._publish(rec)
            self._last_models.pop(name, None)
            self._save_state()

    def shutdown(self, drain_timeout_s: float = 10.0) -> None:
        self._stop.set()
        # Ingress first: drain proxies so in-flight requests finish against
        # still-live replicas (reference: proxy draining on serve shutdown).
        self.disable_http(drain_timeout_s)
        with self._lock:
            names = list(self._deployments)
        for name in names:
            self.delete(name)
        # The final checkpoint is EMPTY state: a controller created
        # after a deliberate shutdown must start fresh, not adopt the
        # ghosts of a torn-down serve plane.
        self._save_state()

    # -------------------------------------------------- HTTP data plane

    def enable_http(self, host: str = "127.0.0.1",
                    port: int = 0) -> Dict[str, Any]:
        """Turn on per-node HTTP ingress. Returns the current (possibly
        still-converging) state; callers poll ``http_ready`` — this actor
        runs calls serially, so blocking here would stall the whole serve
        control plane. ``port=0`` = ephemeral per proxy (required for the
        multi-node-in-one-machine fixture; on real multi-host clusters a
        fixed port works like the reference's :8000)."""
        with self._lock:
            self._http_cfg = {"host": host, "port": port}
        self._save_state()
        # Convergence belongs to the 1 Hz _proxy_loop thread — doing it
        # here would hold this serially-executed actor (and thus every
        # deploy/status/get_routes call) hostage to slow proxy starts.
        return self.http_ready()

    def http_ready(self) -> Dict[str, Any]:
        """{addrs, want}: live proxy addresses and the number of alive
        nodes they should eventually cover (0 = membership unknown)."""
        alive = self._alive_nodes()
        return {"addrs": self.http_addresses(),
                "want": len(alive) if alive is not None else 0}

    def disable_http(self, drain_timeout_s: float = 10.0) -> None:
        with self._lock:
            self._http_cfg = None
            proxies = list(self._proxies.values())
            self._proxies.clear()
        self._save_state()
        # Drain all proxies CONCURRENTLY: serial drains would make this
        # call's latency scale with node count past the caller's timeout.
        drains = [(p, p.handle.drain.remote(drain_timeout_s))
                  for p in proxies]
        deadline = time.monotonic() + drain_timeout_s + 10.0
        for proxy, ref in drains:
            try:
                ray_tpu_torch.get(ref, timeout=max(0.1,
                                             deadline - time.monotonic()))
            except Exception:
                log_every("serve.proxy_drain", 10.0, logger,
                          "proxy %s drain did not complete",
                          proxy.node_hex, exc_info=True)
            try:
                ray_tpu_torch.kill(proxy.handle)
            except Exception:
                log_every("serve.proxy_kill", 10.0, logger,
                          "kill of proxy %s failed", proxy.node_hex,
                          exc_info=True)

    def http_addresses(self) -> Dict[str, tuple]:
        """node hex -> (host, port) of its live proxy."""
        with self._lock:
            return {n: p.addr for n, p in self._proxies.items()
                    if p.addr is not None}

    def _alive_nodes(self) -> Optional[List[str]]:
        """None = membership UNKNOWN (head unreachable / just restarted).
        Callers must treat unknown as "change nothing" — tearing down
        proxies on a head blip would sever live ingress cluster-wide."""
        from ray_tpu_torch.core.runtime import get_core_worker

        try:
            nodes = ControllerStub(
                get_core_worker().controller).list_nodes(
                    timeout=config.ctrl_call_timeout_s)
        except Exception:
            return None
        alive = [n["node_id"] for n in nodes if n["alive"]]
        return alive or None  # an empty table = restarted head, same rule

    def _reconcile_proxies(self) -> None:
        """Converge proxies with node membership (reference:
        proxy_state.py ProxyStateManager.update): start one on every new
        alive node, health-check existing ones, replace the dead, drain
        and remove proxies on departed nodes."""
        with self._lock:
            cfg = self._http_cfg
        if cfg is None:
            return
        alive_list = self._alive_nodes()
        if alive_list is None:
            return  # membership unknown: change nothing
        alive = set(alive_list)
        with self._lock:
            current = dict(self._proxies)
            before = {n: p.handle.actor_id
                      for n, p in self._proxies.items()}
        # Departed nodes: drain what's left of the proxy, forget it.
        for node_hex, proxy in current.items():
            if node_hex not in alive:
                with self._lock:
                    self._proxies.pop(node_hex, None)
                try:
                    ray_tpu_torch.kill(proxy.handle)
                except Exception:
                    # Departed node: the actor is usually already gone.
                    log_every("serve.proxy_kill", 10.0, logger,
                              "kill of proxy %s failed", node_hex,
                              exc_info=True)
        # Health-check live ones (the actor call doubles as the probe).
        for node_hex, proxy in current.items():
            if node_hex not in alive:
                continue
            try:
                health = ray_tpu_torch.get(proxy.handle.healthz.remote(),
                                     timeout=5.0)
                proxy.addr = tuple(health["addr"])
                proxy.failures = 0
            except Exception:
                proxy.failures += 1
                if proxy.failures < 3:
                    continue
                # Only replace a proxy the cluster declares DEAD — a slow
                # one still owns its port/socket.
                from ray_tpu_torch.core.runtime import get_core_worker

                try:
                    record = ControllerStub(
                        get_core_worker().controller).get_actor(
                            proxy.handle.actor_id.binary(),
                            timeout=config.ctrl_call_timeout_s)
                except Exception:
                    # Actor table unreachable: we can neither verify nor
                    # replace (starting a proxy needs the head too), so
                    # keep the record and retry next round — the normal
                    # paths below take over the moment the head answers.
                    continue
                if record is not None and record["state"] != "DEAD":
                    # Alive-but-unresponsive (healthz failing for many
                    # rounds while the actor table says ALIVE — a hung
                    # proxy): force-kill it, but DON'T forget the handle
                    # yet. Proxies bind a fixed ingress port, so the
                    # record may only be dropped once a later round
                    # observes DEAD — popping a live process would
                    # EADDRINUSE every replacement.
                    if proxy.failures >= 10:
                        try:
                            ray_tpu_torch.kill(proxy.handle)
                        except Exception:
                            log_every("serve.proxy_kill", 10.0, logger,
                                      "kill of hung proxy %s failed",
                                      node_hex, exc_info=True)
                    continue
                # No record, or DEAD: safe to forget and let the
                # missing-node pass below start a replacement.
                with self._lock:
                    if self._proxies.get(node_hex) is proxy:
                        self._proxies.pop(node_hex)
        # Missing nodes: start a proxy pinned to that node.
        with self._lock:
            have = set(self._proxies)
        for node_hex in alive - have:
            try:
                self._start_proxy(node_hex, cfg)
            except Exception:
                # A node with no proxy has no ingress — this must never
                # fail invisibly (retried next round either way).
                log_every("serve.proxy_start", 5.0, logger,
                          "starting proxy on node %s failed", node_hex,
                          exc_info=True)
        with self._lock:
            after = {n: p.handle.actor_id
                     for n, p in self._proxies.items()}
        if after != before:
            # Proxy membership changed: checkpoint so a restarted
            # controller adopts the live proxies instead of binding
            # duplicates next to them (EADDRINUSE on fixed ports).
            self._save_state()

    def _start_proxy(self, node_hex: str, cfg: Dict[str, Any]) -> None:
        from ray_tpu_torch.core.placement import NodeAffinitySchedulingStrategy
        from ray_tpu_torch.serve.proxy import ProxyActor

        actor_cls = ray_tpu_torch.remote(ProxyActor)
        handle = actor_cls.options(
            num_cpus=0,
            scheduling_strategy=NodeAffinitySchedulingStrategy(node_hex),
            max_concurrency=8,
        ).remote(cfg["host"], cfg["port"])
        proxy = ProxyRecord(node_hex, handle)
        with self._lock:
            raced = node_hex in self._proxies or self._http_cfg is None
            if not raced:
                self._proxies[node_hex] = proxy
        if raced:  # raced another reconcile/disable; kill OUTSIDE the lock
            try:
                ray_tpu_torch.kill(handle)
            except Exception:
                log_every("serve.proxy_kill", 10.0, logger,
                          "kill of raced proxy on %s failed", node_hex,
                          exc_info=True)
            return
        try:
            proxy.addr = tuple(ray_tpu_torch.get(
                handle.address.remote(), timeout=30.0))
        except Exception:
            proxy.failures += 1

    # --------------------------------------------------------- reconcile

    def _reconcile_loop(self) -> None:
        while not self._stop.wait(0.25):
            # Chaos hook: a die rule here SIGKILLs the controller at a
            # deterministic point in its duty cycle (the canonical
            # "controller death is a non-event" injection).
            faultinject.check("serve.controller.reconcile_tick")
            if self._epoch <= 0:
                # Epoch lease was unavailable at start: keep trying —
                # until it lands, publishes are unfenced and nothing
                # checkpoints.
                self._acquire_epoch()
                if self._epoch > 0:
                    self._save_state()
            try:
                self._retry_pending_releases()
            except Exception:
                log_every("serve.release_retry_pass", 10.0, logger,
                          "pending-release retry pass failed",
                          exc_info=True)
            with self._lock:
                recs = list(self._deployments.values())
            for rec in recs:
                try:
                    self._reconcile_one(rec)
                except Exception:
                    # The loop must survive one bad record, but a
                    # reconcile that fails every tick is an outage
                    # (replicas not healing) — say so, rate-limited.
                    log_every(f"serve.reconcile.{rec.name}", 5.0, logger,
                              "reconcile of deployment %r failed",
                              rec.name, exc_info=True)

    def _proxy_loop(self) -> None:
        # Membership changes are rare; 1 Hz keeps probe load low.
        while not self._stop.wait(1.0):
            try:
                self._reconcile_proxies()
            except Exception:
                log_every("serve.proxy_reconcile", 5.0, logger,
                          "proxy reconcile pass failed", exc_info=True)

    def _stale(self, rec: DeploymentRecord) -> bool:
        with self._lock:
            return (rec.deleting
                    or self._deployments.get(rec.name) is not rec)

    def _reconcile_one(self, rec: DeploymentRecord) -> None:
        """Collect replica stats, replace dead replicas, autoscale
        (reference: DeploymentState.update + autoscaling_policy.py:12).
        Every mutation re-validates the record is still live (_stale) so a
        concurrent redeploy/delete can't be resurrected; structural changes
        hold rec.lock so deploy's settle can't race a double-add."""
        if self._stale(rec):
            return
        changed = False
        stats_refs = [(r, r.handle.stats.remote()) for r in rec.replicas]
        suspect: List[ReplicaRecord] = []
        for replica, ref in stats_refs:
            try:
                replica.last_stats = ray_tpu_torch.get(ref, timeout=5.0)
            except Exception:
                suspect.append(replica)
        # A slow stats reply is NOT death: a replica still initializing or
        # saturated must not be dropped (and certainly not leaked). Only
        # replicas whose ACTOR the cluster declares DEAD are replaced.
        dead = [replica for replica in suspect
                if self._actor_dead(replica.handle)]
        # A mesh replica is one unit: the death of any rank kills the
        # rest (rank 0 may still answer stats while its lockstep fails).
        dead += [replica for replica in rec.replicas
                 if replica not in dead
                 and any(self._actor_dead(h) for h in replica.ranks)]
        if self._stale(rec):
            return
        to_kill: List[ReplicaRecord] = []
        orphans: List[tuple] = []
        try:
            with rec.lock:
                if self._stale(rec):
                    return
                for replica in dead:
                    try:
                        rec.replicas.remove(replica)
                    except ValueError:
                        continue
                    to_kill.append(replica)
                    changed = True
                while (len(rec.replicas) < self._min_replicas(rec)
                       and not self._stale(rec)):
                    if not self._add_replica(rec, orphans):
                        break  # unplaceable (no contiguous sub-slice):
                    changed = True  # retry next tick, never on a fragment
        finally:
            self._kill_orphans(orphans)
        # Idempotent cleanup kills happen after rec.lock is released —
        # an RPC under the record lock would stall deploy/settle on this
        # deployment (graftlint: lock-held-blocking).
        for replica in to_kill:
            self._kill_replica(replica)
        if self._stale(rec):
            self._drain(rec)  # raced a delete after adding: clean up
            return

        auto = rec.cfg.get("autoscaling")
        if auto:
            downscaled: Optional[ReplicaRecord] = None
            orphans: List[tuple] = []
            try:
                with rec.lock:
                    # Replica load = max(HTTP concurrency, replica-reported
                    # backlog): a decode engine with a full pending queue and
                    # every slot busy must scale OUT even when each request
                    # occupies only one "ongoing" call slot. autoscale_load
                    # additionally inflates speculative replicas' signal by
                    # their verify overhead at the observed accept rate, so
                    # spec engines don't over-report headroom.
                    ongoing = sum(autoscale_load(r.last_stats)
                                  for r in rec.replicas)
                    # A mesh-parallel replica is chips-many units of
                    # capacity, not one: load per CHIP drives the count, so
                    # an 8-chip replica absorbs 8x the target before a
                    # second replica (and its whole sub-slice) spawns.
                    cap = max(1e-9, auto["target_ongoing_requests"]
                              * self._mesh_chips(rec))
                    desired = max(auto["min_replicas"],
                                  min(auto["max_replicas"],
                                      math.ceil(ongoing / cap)))
                    now = time.monotonic()
                    if (desired > len(rec.replicas)
                            and now - rec.last_scale >
                            auto["upscale_delay_s"]):
                        if self._add_replica(rec, orphans):
                            rec.last_scale = now
                            changed = True
                    elif (desired < len(rec.replicas)
                            and now - rec.last_scale >
                            auto["downscale_delay_s"]):
                        downscaled = self._remove_replica(rec)
                        rec.last_scale = now
                        changed = True
            finally:
                self._kill_orphans(orphans)
            if downscaled is not None:
                self._kill_replica(downscaled)
        # Model residency changes also need a push (multiplex routing).
        if changed:
            self._publish(rec)
            # Structural change (replica healed/scaled): checkpoint so a
            # controller death right now restores THIS replica set.
            self._save_state()
        elif self._models_changed(rec):
            self._publish(rec)
        elif rec.pub_version:
            # Head-restart healing: a restarted cluster controller comes
            # back with an EMPTY pubsub hub, so routers created after the
            # restart would find no snapshot. Periodically compare the
            # hub's current version with what we last published and
            # republish on regression.
            now = time.monotonic()
            if now - rec.last_pub_check > 2.0:
                rec.last_pub_check = now
                try:
                    from ray_tpu_torch.core.runtime import get_core_worker

                    cur = ControllerStub(
                        get_core_worker().controller).psub_poll(
                            SNAPSHOT_CHANNEL, rec.name, 0, 0.0,
                            timeout=5.0)
                except Exception:
                    cur = rec.pub_version  # unreachable hub: not a reset
                if cur is None or (isinstance(cur, tuple)
                                   and (cur[0] < rec.pub_version
                                        or (isinstance(cur[1], dict)
                                            and cur[1].get(
                                                "epoch", self._epoch)
                                            < self._epoch))):
                    # Version regression (hub restarted empty) OR epoch
                    # regression (a zombie's stamp survives on the hub
                    # — possible only in the pre-fencing window): either
                    # way this epoch's snapshot must own the key again.
                    self._publish(rec)

    @staticmethod
    def _actor_dead(handle) -> bool:
        """Whether the cluster declares the actor DEAD (an unreachable
        head is not evidence of death)."""
        from ray_tpu_torch.core.runtime import get_core_worker

        try:
            record = ControllerStub(get_core_worker().controller).get_actor(
                handle.actor_id.binary(),
                timeout=config.ctrl_call_timeout_s)
        except Exception:
            return False
        return record is None or record["state"] == "DEAD"

    def _min_replicas(self, rec: DeploymentRecord) -> int:
        auto = rec.cfg.get("autoscaling")
        return (auto["min_replicas"] if auto
                else rec.cfg.get("num_replicas", 1))

    def _models_changed(self, rec: DeploymentRecord) -> bool:
        """Model OR prefix residency drift: both route affinity, so both
        need a snapshot push when they change."""
        cur = {r.replica_id: (tuple(r.last_stats.get("models", [])),
                              tuple(sorted(r.last_stats.get("prefixes",
                                                            []))))
               for r in rec.replicas}
        if self._last_models.get(rec.name) != cur:
            self._last_models[rec.name] = cur
            return True
        return False

    def ping(self) -> str:
        return "pong"


def get_or_create_controller():
    """Resolve (or start) the cluster's serve controller actor."""
    from ray_tpu_torch.core.errors import ActorDiedError, ActorUnavailableError

    try:
        handle = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        try:
            ray_tpu_torch.get(handle.ping.remote(), timeout=30.0)
        except ActorUnavailableError:
            # One retry on the SAME handle. A fresh handle hints
            # incarnation 0, so its first call to a RESTARTED
            # (max_restarts=-1) controller always fails — and the
            # failure taught the handle the live incarnation. When the
            # controller is genuinely down, attempt 1 doubled as the
            # failure report that triggers its restart, and this retry
            # parks until the restarted incarnation is ALIVE — callers
            # resume against the recovered control plane.
            ray_tpu_torch.get(handle.ping.remote(), timeout=30.0)
        return handle
    except (ValueError, ActorDiedError, ActorUnavailableError):
        pass  # absent or dead: (re)create — name registration allows
        # replacing a DEAD actor.
    actor_cls = ray_tpu_torch.remote(ServeController)
    try:
        handle = actor_cls.options(name=CONTROLLER_NAME, num_cpus=0,
                                   max_restarts=-1).remote()
        ray_tpu_torch.get(handle.ping.remote(), timeout=60.0)
        return handle
    except Exception:
        # Raced with another creator: the named actor exists now.
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
