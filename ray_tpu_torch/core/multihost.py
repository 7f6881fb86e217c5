"""Multi-host gangs (port of ``ray_tpu/core/multihost.py``).

The substrate train worker gangs, tune trial gangs and host groups share:

* :class:`GroupRegistry` — controller-side group state (the ``mh_*``
  RPC surface): group registration with a **monotonic group epoch**
  (every restart / re-election bumps it; stale-epoch writes, beats and
  barrier entries are rejected, so a deposed coordinator or a zombie
  member self-fences instead of corrupting the new gang), a
  **rendezvous barrier** (members post a payload and park until the
  whole gang arrives — the carrier for the program-hash check), a
  small per-group fenced KV (election results), and membership
  heartbeats.
* :class:`HostGroup` — the driver-side gang primitive: reserves a
  contiguous sub-slice from the topology view (**all-or-nothing**: a
  refusal feeds the autoscaler's pending demand and no member ever
  spawns), gang-spawns one :class:`HostWorker` actor per host with
  **aligned visibility** (each member's context carries
  ``coordinator_address`` / ``process_id`` / ``num_processes`` and a
  disjoint local chip mask covering the sub-slice; a member that drives
  its host's card holds the node's ``GPU`` lease), elects a coordinator
  (lowest live member index; the election result is a fenced group-KV
  write), and monitors the gang: **one member dying kills and
  reconciles the whole group as a unit** — the sub-slice is released
  exactly once, never half-alive groups — and a restart budget
  re-forms the gang under a bumped epoch (coordinator death is the same
  flow with a fresh election).
* **Program-hash barrier** — :func:`enter_program_barrier` runs a
  barrier'd fingerprint exchange BEFORE any collective: every member
  posts its fingerprint, and a mismatch raises the typed
  :class:`ProgramHashMismatch` on every member instead of the classic
  multi-process hang (ranks running different programs deadlock inside
  the collective, where nothing times out).
* :func:`form_torch_runtime` / :func:`join_torch_gang` — the ONE
  ``torch.distributed`` bootstrap path (the counterpart of the JAX
  package's ``jax.distributed`` one; train worker gangs, tune trial
  gangs and ``HostGroup.form_mesh`` all route through it): the gang
  registers, every member enters the bootstrap-fingerprint barrier (a
  misaligned ``num_processes`` or device type is a typed refusal — a
  wrong world size otherwise hangs ``init_process_group``'s rendezvous),
  then joins the tcp rendezvous rank 0 hosts. NCCL on the card, gloo
  only when the caller asks for ``device_type="cpu"`` (a virtual
  slice's members).

``program_fingerprint(fn=...)`` has no jaxpr to hash: it hashes the
function's qualified name and code with the arguments' shapes and dtypes
(``text=`` hashes verbatim, as in JAX).

Fault-injection sites: ``multihost.barrier.<group>.<member>`` (member-
side barrier entry) and ``multihost.member.<group>.<member>.beat``
(member heartbeat loop — a ``die`` rule SIGKILLs exactly that host's
worker process).
"""
from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.errors import RayTpuError
from ray_tpu_torch.util import faultinject, flightrec, tracing
from ray_tpu_torch.util.ratelimit import log_every

logger = logging.getLogger(__name__)


def _gang_span(name: str, **attrs):
    """A gang-lifecycle tracing span (formation, election, barrier
    entry, reconcile), gated on the train-plane tracing knob: these are
    control-plane events at human cadence, so the span cost is noise,
    but the knob keeps the off switch symmetric with the pipeline
    spans. Returns a context manager."""
    from contextlib import nullcontext

    from ray_tpu_torch.core.config import config

    if not config.pipe_trace_spans:
        return nullcontext()
    return tracing.trace(name, **attrs)


class MultihostError(RayTpuError):
    """Base for host-group failures."""


class GangPlacementError(MultihostError):
    """All-or-nothing placement refusal: no single slice can host the
    gang contiguously (the refusal feeds the autoscaler's pending
    demand), or a member failed to spawn. Nothing is left half-alive:
    the sub-slice is released and no member survives."""


class ProgramHashMismatch(MultihostError):
    """Members' program fingerprints diverge at a pre-collective
    barrier: the typed refusal that replaces the classic multi-host
    hang (mismatched traces deadlock inside the collective)."""


class GroupEpochFenced(MultihostError):
    """This member/coordinator belongs to a deposed group epoch: a
    newer incarnation exists, so the zombie must stop touching group
    state (writes rejected, barrier entries refused)."""


class BarrierTimeout(MultihostError):
    """A gang barrier timed out with members absent — the hang made
    VISIBLE (the absent members are named; the JAX package's ``ray_tpu
    doctor`` reads its gang-hang signature)."""


def _controller_client():
    """This process's controller RPC client (wrap it in a
    ControllerStub AT the call site — the rpc-contract linter reads
    literal ``ControllerStub(...)`` receivers as endpoint uses)."""
    from ray_tpu_torch.core.runtime import get_core_worker

    return get_core_worker().controller


def member_name(rank: int) -> str:
    """The registry-wide member naming convention: host ``rank`` of a
    group is ``host-<rank>`` (the registry derives the expected member
    set of a barrier from ``num_hosts`` through this)."""
    return f"host-{rank}"


# =====================================================================
# Controller side: the group registry (mh_* RPC surface)
# =====================================================================


class _Barrier:
    __slots__ = ("payloads", "done")

    def __init__(self):
        self.payloads: Dict[str, Any] = {}
        self.done = False


class _GroupRecord:
    def __init__(self, group_id: str, num_hosts: int,
                 reservation_id: Optional[str], owner: str):
        self.group_id = group_id
        self.num_hosts = num_hosts
        self.reservation_id = reservation_id
        self.owner = owner
        self.epoch = 1
        # member -> {"last_beat": monotonic, "epoch": int}
        self.members: Dict[str, Dict[str, Any]] = {}
        # pending (incomplete) barriers by name; completed barriers are
        # popped — waiters hold the _Barrier object reference.
        self.barriers: Dict[str, _Barrier] = {}
        # fenced rendezvous KV (election results, bootstrap metadata).
        self.kv: Dict[str, Any] = {}

    def expected_members(self) -> List[str]:
        return [member_name(i) for i in range(self.num_hosts)]


class GroupRegistry:
    """Controller-side host-group state. All handlers run on the
    controller's RPC pool threads; ``barrier`` parks its thread on the
    condition (bounded waits) exactly like the pubsub long-polls."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._groups: Dict[str, _GroupRecord] = {}
        from ray_tpu_torch.util import metrics as um

        um.add_collector(self._collect)

    # ------------------------------------------------------- handlers

    def register_group(self, group_id: str, num_hosts: int,
                       reservation_id: Optional[str] = None,
                       owner: str = "") -> Dict[str, Any]:
        """Create a group, or RE-register an existing id — which is the
        restart/re-election path: the epoch bumps (fencing every member
        and write of the previous incarnation), membership and pending
        barriers reset, and parked waiters wake to a stale-epoch
        refusal."""
        with self._cond:
            rec = self._groups.get(group_id)
            if rec is None:
                rec = _GroupRecord(group_id, int(num_hosts),
                                   reservation_id, owner)
                self._groups[group_id] = rec
            else:
                rec.epoch += 1
                rec.num_hosts = int(num_hosts)
                rec.reservation_id = reservation_id
                rec.members.clear()
                rec.barriers.clear()
                rec.kv.clear()
                self._cond.notify_all()
            # graftlint: disable=metrics-label-cardinality (gang ids bounded by live gangs; bounded ring)
            flightrec.record("gang.register", group=group_id,
                             epoch=rec.epoch, hosts=rec.num_hosts)
            return {"epoch": rec.epoch}

    def drop_group(self, group_id: str) -> bool:
        """Unregister (idempotent). Parked barrier waiters wake and
        return a refusal; the group's barrier-entered gauges flatten to
        zero so a dropped group can never read as a hang."""
        with self._cond:
            rec = self._groups.pop(group_id, None)
            self._cond.notify_all()
        if rec is not None:
            # graftlint: disable=metrics-label-cardinality (gang ids bounded by live gangs; bounded ring)
            flightrec.record("gang.drop", group=group_id,
                             epoch=rec.epoch)
            self._zero_entered(rec)
        return rec is not None

    def member_beat(self, group_id: str, member: str,
                    epoch: int) -> Dict[str, Any]:
        """Membership heartbeat. ``fenced=True`` tells the member its
        epoch is deposed (or its group gone) — the self-fence signal a
        zombie obeys by refusing all further group operations."""
        with self._lock:
            rec = self._groups.get(group_id)
            if rec is None:
                return {"known": False, "fenced": True, "epoch": 0}
            if epoch < rec.epoch:
                # graftlint: disable=metrics-label-cardinality (gang ids bounded by live gangs; bounded ring)
                flightrec.record("gang.beat.fenced", group=group_id,
                                 member=member, epoch=epoch,
                                 current=rec.epoch)
                return {"known": True, "fenced": True,
                        "epoch": rec.epoch}
            rec.members[member] = {"last_beat": time.monotonic(),
                                   "epoch": epoch}
            return {"known": True, "fenced": False, "epoch": rec.epoch}

    def barrier(self, group_id: str, name: str, member: str, epoch: int,
                payload: Any = None,
                timeout_s: float = 30.0) -> Dict[str, Any]:
        """Rendezvous: record ``member``'s arrival (with its payload —
        the program fingerprint) and park until every expected member
        of the CURRENT epoch arrives. Completion hands every waiter the
        full payload map (each member compares client-side — the
        mismatch refusal must raise on every rank, not just one). A
        timeout names the absent members instead of hanging."""
        deadline = time.monotonic() + max(0.0, min(float(timeout_s),
                                                   600.0))
        t0 = time.monotonic()
        with self._cond:
            rec = self._groups.get(group_id)
            if rec is None:
                return {"ok": False, "reason": "unknown_group"}
            if epoch < rec.epoch:
                return {"ok": False, "reason": "stale_epoch",
                        "epoch": rec.epoch}
            bar = rec.barriers.get(name)
            if bar is None:
                bar = _Barrier()
                rec.barriers[name] = bar
            bar.payloads[member] = payload
            if len(bar.payloads) >= rec.num_hosts:
                bar.done = True
                # Archive: waiters keep the object; the next barrier
                # under this name starts fresh.
                rec.barriers.pop(name, None)
                # graftlint: disable=metrics-label-cardinality (gang ids bounded by live gangs; bounded ring)
                flightrec.record("gang.barrier.done", group=group_id,
                                 barrier=name, epoch=epoch,
                                 hosts=rec.num_hosts)
                self._cond.notify_all()
            while not bar.done:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                cur = self._groups.get(group_id)
                if cur is not rec:
                    return {"ok": False, "reason": "group_dropped"}
                if rec.epoch > epoch:
                    return {"ok": False, "reason": "stale_epoch",
                            "epoch": rec.epoch}
                self._cond.wait(timeout=min(remaining, 0.25))
            if bar.done:
                result = {"ok": True,
                          "payloads": dict(bar.payloads)}
            else:
                arrived = sorted(bar.payloads)
                absent = sorted(set(rec.expected_members())
                                - set(arrived))
                # graftlint: disable=metrics-label-cardinality (gang ids bounded by live gangs; bounded ring)
                flightrec.record("gang.barrier.timeout", group=group_id,
                                 barrier=name, epoch=epoch,
                                 absent=",".join(absent))
                result = {"ok": False, "reason": "timeout",
                          "arrived": arrived, "absent": absent}
        self._observe_wait(time.monotonic() - t0)
        return result

    def group_put(self, group_id: str, key: str, value: Any,
                  epoch: int) -> Dict[str, Any]:
        """Fenced rendezvous-KV write (election results live here): a
        writer whose epoch is deposed gets ``stale_epoch`` back and
        must self-fence — the PR 12 ``kv_put_fenced`` idiom at group
        granularity."""
        with self._lock:
            rec = self._groups.get(group_id)
            if rec is None:
                return {"ok": False, "reason": "unknown_group"}
            if epoch < rec.epoch:
                return {"ok": False, "reason": "stale_epoch",
                        "epoch": rec.epoch}
            rec.kv[key] = value
            return {"ok": True, "epoch": rec.epoch}

    def group_get(self, group_id: str, key: str) -> Any:
        with self._lock:
            rec = self._groups.get(group_id)
            return None if rec is None else rec.kv.get(key)

    def group_state(self, group_id: Optional[str] = None
                    ) -> Dict[str, Any]:
        """Operator/test view of every group: epoch, membership with
        beat ages, pending barriers with who arrived / who is absent."""
        now = time.monotonic()

        def summary(rec: _GroupRecord) -> Dict[str, Any]:
            return {
                "group_id": rec.group_id,
                "num_hosts": rec.num_hosts,
                "epoch": rec.epoch,
                "owner": rec.owner,
                "reservation_id": rec.reservation_id,
                "members": {
                    m: {"epoch": info["epoch"],
                        "beat_age_s": round(now - info["last_beat"], 3)}
                    for m, info in rec.members.items()},
                "barriers": {
                    bname: {"arrived": sorted(bar.payloads),
                            "absent": sorted(
                                set(rec.expected_members())
                                - set(bar.payloads))}
                    for bname, bar in rec.barriers.items()},
                "kv_keys": sorted(rec.kv),
            }

        with self._lock:
            if group_id is not None:
                rec = self._groups.get(group_id)
                return summary(rec) if rec is not None else None
            return {g: summary(rec) for g, rec in self._groups.items()}

    # -------------------------------------------------------- metrics

    def _observe_wait(self, waited_s: float) -> None:
        from ray_tpu_torch.core.config import config

        if not config.core_metrics_enabled:
            return
        from ray_tpu_torch.core import coremetrics as cm

        cm.MH_BARRIER_WAIT_S.observe(waited_s)

    def _zero_entered(self, rec: _GroupRecord) -> None:
        """Flatten a dropped group's barrier-entered gauges: divergence
        is the doctor's gang-hang signal, and a dead group must read as
        uniform, not wedged."""
        from ray_tpu_torch.core.config import config

        if not config.core_metrics_enabled:
            return
        from ray_tpu_torch.core import coremetrics as cm

        for m in rec.expected_members():
            # Gang ids and member names are bounded by LIVE groups (a
            # handful per cluster, zeroed on drop), not request volume;
            # the snapshot series cap bounds any tail.
            # graftlint: disable=metrics-label-cardinality
            cm.MH_BARRIER_ENTERED.set(0.0, tags={"group": rec.group_id,
                                                 "member": m})

    def _collect(self) -> None:
        """Snapshot-time collector (util.metrics.add_collector): group
        count, per-member epochs, and the barrier-entered split the
        doctor's gang-hang signature reads (1 = arrived at a pending
        barrier, 0 = the gang is waiting on this member — uniform zero
        when nothing is pending)."""
        from ray_tpu_torch.core.config import config

        if not config.core_metrics_enabled:
            return
        rows: List[Tuple[str, str, float, float]] = []
        with self._lock:
            n = len(self._groups)
            for rec in self._groups.values():
                arrived = set()
                for bar in rec.barriers.values():
                    arrived.update(bar.payloads)
                pending = bool(rec.barriers)
                for m in rec.expected_members():
                    ep = float(rec.members.get(m, {}).get("epoch", 0))
                    entered = 1.0 if (pending and m in arrived) else 0.0
                    rows.append((rec.group_id, m, ep, entered))
        from ray_tpu_torch.core import coremetrics as cm

        cm.MH_GROUPS.set(float(n))
        for g, m, ep, entered in rows:
            # See _zero_entered for the cardinality justification.
            cm.MH_MEMBER_EPOCH.set(ep, tags={"group": g, "member": m})
            cm.MH_BARRIER_ENTERED.set(entered,
                                      tags={"group": g, "member": m})


# =====================================================================
# Member side: barrier entry, program fingerprints, torch gang join
# =====================================================================


def _code_text(code) -> str:
    """A code object's bytecode, names and constants, nested code objects
    included (their reprs carry addresses, which differ across
    processes)."""
    consts = [_code_text(c) if hasattr(c, "co_code") else repr(c)
              for c in code.co_consts]
    return "|".join([code.co_code.hex(), ",".join(code.co_names),
                     ";".join(consts)])


def _arg_text(arg) -> str:
    """Shapes and dtypes of an argument tree (the avals a trace sees)."""
    if isinstance(arg, dict):
        return "{" + ",".join(f"{k}:{_arg_text(arg[k])}"
                              for k in sorted(arg)) + "}"
    if isinstance(arg, (list, tuple)):
        return "(" + ",".join(_arg_text(a) for a in arg) + ")"
    shape = getattr(arg, "shape", None)
    if shape is not None:
        return f"{tuple(shape)}:{getattr(arg, 'dtype', None)}"
    return type(arg).__name__


def program_fingerprint(fn=None, args: tuple = (), *,
                        text: Optional[str] = None) -> str:
    """A stable fingerprint of the program a member is about to run:
    ``text`` hashes verbatim; otherwise the function's qualified name and
    code are hashed with the shapes and dtypes of ``args`` — two members
    that would run different programs get different fingerprints."""
    import hashlib

    if text is None:
        code = getattr(fn, "__code__", None)
        text = "|".join([
            getattr(fn, "__module__", "") or "",
            getattr(fn, "__qualname__", type(fn).__name__),
            _code_text(code) if code is not None else "",
            _arg_text(tuple(args))])
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def enter_barrier(group_id: str, member: str, epoch: int, name: str,
                  payload: Any = None,
                  timeout_s: Optional[float] = None) -> Dict[str, Any]:
    """Enter the named group barrier from a member process; returns the
    full member->payload map once the whole gang arrived. Raises the
    typed refusals (:class:`GroupEpochFenced`, :class:`BarrierTimeout`)
    instead of hanging."""
    from ray_tpu_torch.core.config import config

    if timeout_s is None:
        timeout_s = config.mh_barrier_timeout_s
    if config.faultinject_path:
        faultinject.check(f"multihost.barrier.{group_id}.{member}")
    from ray_tpu_torch.core.rpc_stubs import ControllerStub

    # graftlint: disable=metrics-label-cardinality (gang ids bounded by live gangs; bounded ring)
    flightrec.record("gang.barrier.enter", group=group_id, member=member,
                     barrier=name, epoch=epoch)
    # The span duration IS this member's rendezvous wait.
    with _gang_span(f"gang:barrier:{name}", group=group_id,
                    member=member, epoch=epoch):
        reply = ControllerStub(_controller_client()).mh_barrier(
            group_id, name, member, epoch, payload, timeout_s,
            timeout=timeout_s + 30.0)
    if reply.get("ok"):
        return reply["payloads"]
    reason = reply.get("reason")
    # graftlint: disable=metrics-label-cardinality (gang ids bounded by live gangs; bounded ring)
    flightrec.record("gang.barrier.refused", group=group_id,
                     member=member, barrier=name, epoch=epoch,
                     reason=str(reason))
    if reason == "stale_epoch":
        raise GroupEpochFenced(
            f"member {member} of group {group_id} entered barrier "
            f"{name!r} with deposed epoch {epoch} (current: "
            f"{reply.get('epoch')}) — a newer gang incarnation exists")
    if reason == "timeout":
        raise BarrierTimeout(
            f"barrier {name!r} of group {group_id}: member(s) "
            f"{reply.get('absent')} never arrived within "
            f"{timeout_s:.0f}s (arrived: {reply.get('arrived')})")
    raise MultihostError(
        f"barrier {name!r} of group {group_id} refused: {reply!r}")


def enter_program_barrier(group_id: str, member: str, epoch: int,
                          name: str, fingerprint: str,
                          timeout_s: Optional[float] = None
                          ) -> Dict[str, Any]:
    """The pre-collective program-hash check: exchange fingerprints
    through the group barrier and raise :class:`ProgramHashMismatch`
    on EVERY member when they diverge — a typed refusal where the
    collective would have hung."""
    payloads = enter_barrier(group_id, member, epoch, name,
                             payload=fingerprint, timeout_s=timeout_s)
    if len(set(payloads.values())) > 1:
        raise ProgramHashMismatch(
            f"program fingerprints diverge across group {group_id} at "
            f"barrier {name!r}: {payloads} — refusing to run the "
            f"collective (mismatched programs are the classic "
            f"multi-process hang)")
    return payloads


def join_torch_gang(group_id: str, member: str, epoch: int,
                    coordinator_address: str, num_processes: int,
                    process_id: int, local_rank: int = 0,
                    device_type: Optional[str] = None,
                    timeout_s: Optional[float] = None) -> int:
    """The ONE member-side ``torch.distributed`` join path (train worker
    gangs and tune trial gangs call this): barrier'd bootstrap-fingerprint
    check FIRST — a member with a different coordinator, world size or
    device type raises the typed mismatch before
    ``init_process_group``, whose rendezvous would otherwise wait for
    ranks that are never coming — then the join, on the card
    ``local_rank``. Returns the world size."""
    from ray_tpu_torch.train import torch_backend

    fp = program_fingerprint(text=(
        f"torch.distributed|{coordinator_address}|{num_processes}|"
        f"{device_type}"))
    enter_program_barrier(group_id, member, epoch, "torch-bootstrap", fp,
                          timeout_s=timeout_s)
    return torch_backend.init_process(coordinator_address, num_processes,
                                      process_id, local_rank, device_type)


# =====================================================================
# Driver side: gang registration + the torch runtime over any actor gang
# =====================================================================


def register_gang(num_members: int, *, group_id: Optional[str] = None,
                  reservation_id: Optional[str] = None,
                  owner: str = "") -> Tuple[str, int]:
    """Register a host group with the controller; returns
    ``(group_id, epoch)``. Re-registering an existing id bumps the
    epoch (restart/re-election fencing)."""
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.core.rpc_stubs import ControllerStub

    gid = group_id or f"gang-{uuid.uuid4().hex[:8]}"
    reg = ControllerStub(_controller_client()).mh_register_group(
        gid, num_members, reservation_id, owner,
        timeout=config.ctrl_call_timeout_s)
    return gid, reg["epoch"]


def drop_gang(group_id: str) -> bool:
    """Unregister a group (idempotent, best-effort: a head blip here
    only leaves a record the next re-registration recycles)."""
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.core.rpc_stubs import ControllerStub

    try:
        return ControllerStub(_controller_client()).mh_drop_group(
            group_id, timeout=config.ctrl_call_timeout_s)
    except Exception:
        log_every("multihost.drop_gang", 10.0, logger,
                  "dropping group %s failed", group_id, exc_info=True)
        return False


def registry_state(group_id: Optional[str] = None) -> Dict[str, Any]:
    """The controller's view of registered groups (``mh_group_state``)."""
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.core.rpc_stubs import ControllerStub

    return ControllerStub(_controller_client()).mh_group_state(
        group_id, timeout=config.ctrl_call_timeout_s)


def form_torch_runtime(actors: List[Any], torch_config, *, group_id: str,
                       epoch: int,
                       local_ranks: Optional[List[int]] = None) -> str:
    """Form ONE ``torch.distributed`` process group across a gang of
    actors (anything exposing ``reserve_coordinator`` and
    ``join_gang_runtime`` remote methods — TrainWorker does): the
    lowest-ranked member hosts the tcp rendezvous, every member enters
    the bootstrap-fingerprint barrier, then joins with its rank on its
    card (``local_ranks[rank]``, the card's index in the member's own
    process: 0 for a member whose ``GPU`` lease narrowed
    ``CUDA_VISIBLE_DEVICES`` to its cards). Returns the coordinator
    address."""
    import ray_tpu_torch

    local_ranks = local_ranks or [0] * len(actors)
    coordinator = ray_tpu_torch.get(
        actors[0].reserve_coordinator.remote(torch_config.coordinator_port),
        timeout=60.0)
    refs = [
        a.join_gang_runtime.remote(
            group_id, epoch, member_name(rank), coordinator,
            len(actors), rank, local_ranks[rank],
            torch_config.device_type)
        for rank, a in enumerate(actors)
    ]
    counts = ray_tpu_torch.get(refs, timeout=120.0)
    if len(set(counts)) != 1:
        raise MultihostError(
            f"inconsistent world sizes across the gang: {counts}")
    return coordinator


def leave_torch_runtime(actors: List[Any], group_id: Optional[str] = None,
                        timeout: float = 20.0) -> None:
    """Cooperative gang teardown: every member destroys its process
    group concurrently (killing a rank that holds a live NCCL
    communicator can hang or abort the survivors), bounded by one shared
    deadline; then the group record drops."""
    import ray_tpu_torch

    refs = [a.shutdown_torch.remote(10.0) for a in actors]
    try:
        ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=timeout)
    except Exception:  # graftlint: disable=swallowed-exception (best-effort process-group leave at teardown)
        pass
    if group_id is not None:
        drop_gang(group_id)


# =====================================================================
# The gang member actor
# =====================================================================


class MemberRuntime:
    """What a user function run via :meth:`HostWorker.run` receives:
    the member's aligned context plus the group primitives (barrier,
    program-hash check, fencing state)."""

    def __init__(self, worker: "HostWorker"):
        self._worker = worker

    @property
    def ctx(self) -> Dict[str, Any]:
        return self._worker.member_info()

    @property
    def process_id(self) -> int:
        return int(self.ctx["process_id"])

    @property
    def num_processes(self) -> int:
        return int(self.ctx["num_processes"])

    @property
    def coordinator_address(self) -> Optional[str]:
        return self.ctx.get("coordinator_address")

    def barrier(self, name: str, payload: Any = None,
                timeout_s: Optional[float] = None) -> Dict[str, Any]:
        return self._worker.barrier(name, payload, timeout_s)

    def check_program(self, name: str, fn=None, args: tuple = (), *,
                      fingerprint: Optional[str] = None,
                      timeout_s: Optional[float] = None
                      ) -> Dict[str, Any]:
        if fingerprint is None:
            fingerprint = program_fingerprint(fn, args)
        return self._worker.program_barrier(name, fingerprint,
                                            timeout_s)


class HostWorker:
    """One gang member: an actor pinned to one host of the reserved
    sub-slice, holding the member's aligned context (process index,
    group size, coordinator, local chip mask) and the group runtime
    (heartbeat thread, epoch fencing, barrier entry, the torch join).
    User payloads run through :meth:`run`."""

    def __init__(self, ctx: Dict[str, Any]):
        self._lock = threading.Lock()
        self._ctx = dict(ctx)
        self._fenced = False
        self._stop = threading.Event()
        flightrec.record("gang.member.up", group=ctx.get("group_id", ""),
                         member=ctx.get("member", ""),
                         epoch=int(ctx.get("epoch", 0)))
        self._beat = threading.Thread(target=self._beat_loop,
                                      name="mh-member-beat", daemon=True)
        self._beat.start()

    # ----------------------------------------------------- heartbeat

    def _beat_loop(self) -> None:
        from ray_tpu_torch.core.config import config

        period = config.mh_member_beat_period_s
        while not self._stop.wait(period):
            with self._lock:
                if self._fenced:
                    return
                gid = self._ctx["group_id"]
                member = self._ctx["member"]
                epoch = self._ctx["epoch"]
            try:
                # Inside the guard: an injected error/drop here is a
                # failed beat (logged, retried), not a dead beat
                # thread; a `die` rule still SIGKILLs regardless.
                if config.faultinject_path:
                    faultinject.check(
                        f"multihost.member.{gid}.{member}.beat")
                from ray_tpu_torch.core.rpc_stubs import ControllerStub

                reply = ControllerStub(
                    _controller_client()).mh_member_beat(
                        gid, member, epoch, timeout=5.0)
            except Exception:
                # Head blip: liveness is judged by the group monitor's
                # pings, not by this beat — keep trying.
                log_every("multihost.member_beat", 10.0, logger,
                          "member beat failed", exc_info=True)
                continue
            if reply.get("fenced"):
                # Zombie: a newer group epoch exists (the gang restarted
                # without us). Stop touching group state forever.
                flightrec.record("gang.fenced", group=gid, member=member,
                                 epoch=epoch)
                with self._lock:
                    self._fenced = True
                return

    def _guard(self) -> Tuple[str, str, int]:
        with self._lock:
            if self._fenced:
                raise GroupEpochFenced(
                    f"member {self._ctx['member']} of group "
                    f"{self._ctx['group_id']} is fenced (deposed epoch "
                    f"{self._ctx['epoch']})")
            return (self._ctx["group_id"], self._ctx["member"],
                    self._ctx["epoch"])

    # ------------------------------------------------------- surface

    def ping(self) -> str:
        return "pong"

    def member_info(self) -> Dict[str, Any]:
        import os

        with self._lock:
            return {**self._ctx, "fenced": self._fenced,
                    "pid": os.getpid()}

    def fenced(self) -> bool:
        with self._lock:
            return self._fenced

    def configure(self, coordinator_address: str, coordinator: str,
                  epoch: int) -> bool:
        """The election result pushed to every member: who coordinates
        and at which address (aligned visibility — every member holds
        the same values)."""
        with self._lock:
            self._ctx["coordinator_address"] = coordinator_address
            self._ctx["coordinator"] = coordinator
            self._ctx["epoch"] = max(self._ctx["epoch"], int(epoch))
        return True

    def barrier(self, name: str, payload: Any = None,
                timeout_s: Optional[float] = None) -> Dict[str, Any]:
        gid, member, epoch = self._guard()
        return enter_barrier(gid, member, epoch, name, payload,
                             timeout_s)

    def program_barrier(self, name: str, fingerprint: str,
                        timeout_s: Optional[float] = None
                        ) -> Dict[str, Any]:
        gid, member, epoch = self._guard()
        return enter_program_barrier(gid, member, epoch, name,
                                     fingerprint, timeout_s)

    def beat_once(self) -> Dict[str, Any]:
        """One synchronous membership beat (tests drive fencing
        deterministically through this; the background loop is the
        production path)."""
        with self._lock:
            gid = self._ctx["group_id"]
            member = self._ctx["member"]
            epoch = self._ctx["epoch"]
        from ray_tpu_torch.core.rpc_stubs import ControllerStub

        reply = ControllerStub(_controller_client()).mh_member_beat(
            gid, member, epoch, timeout=5.0)
        if reply.get("fenced"):
            with self._lock:
                self._fenced = True
        return reply

    # ---------------------------------------------- torch.distributed

    def reserve_coordinator(self, port: int = 0) -> str:
        from ray_tpu_torch.train.torch_backend import \
            pick_coordinator_address

        return pick_coordinator_address(port)

    def join_gang_runtime(self, group_id: str, epoch: int, member: str,
                          coordinator: str, num_processes: int,
                          process_id: int, local_rank: int,
                          device_type: Optional[str]) -> int:
        """Barrier'd ``torch.distributed`` join (the shared gang path
        ``form_torch_runtime`` drives; see :func:`join_torch_gang`)."""
        n = join_torch_gang(group_id, member, epoch, coordinator,
                            num_processes, process_id, local_rank,
                            device_type)
        with self._lock:
            self._ctx["coordinator_address"] = coordinator
        return n

    def join_torch(self, timeout_s: Optional[float] = None) -> int:
        """Join the group's process group using the member's OWN aligned
        context (coordinator / process_id / num_processes handed to it
        at election; NCCL on its host's first card, gloo on a virtual
        slice). Returns the world size."""
        gid, member, epoch = self._guard()
        with self._lock:
            ctx = dict(self._ctx)
        coordinator = ctx.get("coordinator_address")
        if not coordinator:
            raise MultihostError(
                f"member {member} has no coordinator address yet "
                f"(election incomplete)")
        return join_torch_gang(
            gid, member, epoch, coordinator, int(ctx["num_processes"]),
            int(ctx["process_id"]), 0, ctx.get("device_type"),
            timeout_s=timeout_s)

    def shutdown_torch(self, timeout: float = 10.0) -> bool:
        """Leave the process group (every member calls in concurrently
        through ``leave_torch_runtime``; timeout-guarded so a wedged
        group cannot hang the actor)."""
        from ray_tpu_torch.train.torch_backend import shutdown_process

        done = threading.Event()

        def run():
            shutdown_process()
            done.set()

        t = threading.Thread(target=run, name="torch-shutdown",
                             daemon=True)
        t.start()
        t.join(timeout)
        return done.is_set()

    # -------------------------------------------------- user payload

    def run(self, fn_blob: bytes, args: tuple = (),
            kwargs: Optional[Dict[str, Any]] = None) -> Any:
        """Execute a user callable on this member: ``fn(member, *args,
        **kwargs)`` where ``member`` is a :class:`MemberRuntime`."""
        from ray_tpu_torch.core import serialization

        self._guard()
        fn = serialization.loads_function(fn_blob)
        return fn(MemberRuntime(self), *args, **(kwargs or {}))

    def stop(self) -> bool:
        self._stop.set()
        return True


# =====================================================================
# The driver-side gang
# =====================================================================

_FORMING = "FORMING"
_ALIVE = "ALIVE"
_RESTARTING = "RESTARTING"
_DEAD = "DEAD"
_SHUTDOWN = "SHUTDOWN"


class HostGroup:
    """A gang-scheduled group of one worker actor per host of an
    ICI-contiguous sub-slice reservation. See the module docstring for
    the contract; the short version:

    * ``start()`` is all-or-nothing: reservation refusal or any member
      spawn failure leaves NOTHING behind (sub-slice released exactly
      once, group record dropped) and raises
      :class:`GangPlacementError`.
    * One member dying reconciles the WHOLE gang: every member is
      killed, the sub-slice is released once, and (restart budget
      permitting) a fresh gang forms under a bumped epoch with a fresh
      coordinator election. Zombie members of the old epoch self-fence.
    * ``broadcast``/``call_all`` fan a payload across the gang.
    """

    def __init__(self, num_hosts: int, *,
                 chips_per_host: Optional[int] = None,
                 name: Optional[str] = None,
                 max_group_restarts: int = 1,
                 worker_options: Optional[Dict[str, Any]] = None,
                 worker_cls: Optional[type] = None,
                 owner: str = ""):
        if num_hosts < 1:
            raise ValueError("num_hosts must be >= 1")
        if worker_cls is not None and not issubclass(worker_cls,
                                                     HostWorker):
            # The gang contract (beat loop, fencing, barrier entry,
            # aligned ctx) lives in HostWorker; a member class that
            # doesn't extend it would silently opt out of epoch fencing.
            raise TypeError(f"worker_cls must extend HostWorker, got "
                            f"{worker_cls!r}")
        self._worker_cls = worker_cls or HostWorker
        self.group_id = name or f"gang-{uuid.uuid4().hex[:8]}"
        self.num_hosts = int(num_hosts)
        self.max_group_restarts = int(max_group_restarts)
        self._chips_per_host = chips_per_host
        self._worker_options = dict(worker_options or {})
        self._owner = owner or f"hostgroup:{self.group_id}"
        self._lock = threading.Lock()
        self._state = "NEW"
        self._members: List[Any] = []
        self._epoch = 0
        self._sub: Optional[Dict[str, Any]] = None
        self._coordinator: Optional[str] = None
        self._coordinator_address: Optional[str] = None
        self._restarts = 0
        self._releases = 0
        self._death_cause: Optional[str] = None
        self._stopped = threading.Event()
        self._monitor: Optional[threading.Thread] = None

    # ------------------------------------------------------ lifecycle

    def start(self) -> "HostGroup":
        with self._lock:
            if self._state != "NEW":
                raise MultihostError(
                    f"group {self.group_id} already started "
                    f"({self._state})")
            self._state = _FORMING
        try:
            self._form()
        except BaseException:
            with self._lock:
                self._state = _DEAD
                self._death_cause = "gang formation failed"
            raise
        with self._lock:
            self._state = _ALIVE
        from ray_tpu_torch.core.config import config

        self._monitor = threading.Thread(
            target=self._monitor_loop,
            args=(config.mh_monitor_period_s,),
            name="hostgroup-monitor", daemon=True)
        self._monitor.start()
        return self

    def _resolve_chips_per_host(self, stub) -> int:
        from ray_tpu_torch.core.config import config

        if self._chips_per_host is not None:
            return int(self._chips_per_host)
        state = stub.topology_state(timeout=config.ctrl_call_timeout_s)
        for s in state.get("slices", {}).values():
            cph = s.get("chips_per_host")
            if cph:
                return int(cph)
        raise GangPlacementError(
            f"group {self.group_id}: no advertised slice to derive "
            f"chips_per_host from (pass chips_per_host=, or advertise "
            f"a slice — RAY_TPU_VIRTUAL_SLICE on dev boxes)")

    def _form(self) -> None:
        """Reserve -> register -> gang-spawn -> elect. The sub-slice
        lease and the group registration are BOTH discharged on every
        exception path between acquisition and the handoff to ``self``
        — a partial spawn must strand nothing (graftlint
        resource-leak-path, at gang granularity). The lease locals
        (``sub``, ``reg``) are only ever read through subscripts inside
        the fallible region: the reservation has no owner record until
        ``_commit_formation`` takes it, so the exception path below is
        the only thing standing between a spawn failure and chips
        stranded until node death."""
        from ray_tpu_torch.core.config import config
        from ray_tpu_torch.core.rpc_stubs import ControllerStub
        from ray_tpu_torch.util.deadline import Deadline

        stub = ControllerStub(_controller_client())
        cph = self._resolve_chips_per_host(stub)
        chips = self.num_hosts * cph
        # One budget covers the whole reserve -> register -> fence
        # sequence: each RPC gets the REMAINING time, not a fresh
        # per-call allowance, so a slow head cannot stretch formation
        # to N x the knob before the spawn phase even starts.
        dl = Deadline.after(config.mh_form_timeout_s)
        with _gang_span("gang:form", group=self.group_id,
                        hosts=self.num_hosts):
            sub = stub.reserve_subslice(self._owner, chips,
                                        timeout=dl.remaining())
            if sub is None:
                # The controller's refusal already fed _pending_demand
                # (the autoscaler sees a gang that could not place).
                # graftlint: disable=metrics-label-cardinality (gang ids bounded by live gangs; bounded ring)
                flightrec.record("gang.refused", group=self.group_id,
                                 hosts=self.num_hosts, chips=chips)
                raise GangPlacementError(
                    f"no contiguous {chips}-chip sub-slice for a "
                    f"{self.num_hosts}-host gang (chips_per_host={cph});"
                    f" refusal recorded as autoscaler pending demand")
            members = []
            try:
                reg = stub.mh_register_group(self.group_id,
                                             self.num_hosts,
                                             None, self._owner,
                                             timeout=dl.remaining())
                # The fenced write's verdict matters even during
                # formation: a stale epoch here means a concurrent
                # re-registration already owns the group — spawning
                # members against it would form a zombie gang. The
                # verdict is consumed in test position and the raise
                # message stays off ``reg``: assignment values and
                # raise expressions transfer lease ownership to the
                # lifetime checker, which would mask the
                # _abort_formation leak edges (the docstring's
                # subscript-only-read invariant).
                if not (stub.mh_group_put(self.group_id, "reservation",
                                          sub["reservation_id"],
                                          int(reg["epoch"]),
                                          timeout=dl.remaining())
                        or {}).get("ok"):
                    raise GroupEpochFenced(
                        f"reservation write for group {self.group_id} "
                        "rejected: a newer registration owns the epoch")
                self._spawn_members_into(
                    members, int(reg["epoch"]), sub["reservation_id"],
                    sub["slice_id"], sub["nodes"], sub["origin"],
                    sub["shape"], cph)
                self._elect(members, int(reg["epoch"]))
            except BaseException as e:
                # Release-once on partial-spawn failure: the
                # half-created group record drops and the chips go back
                # to the grid.
                self._abort_formation(stub, sub["reservation_id"])
                if isinstance(e, MultihostError):
                    raise
                raise GangPlacementError(
                    f"gang spawn for group {self.group_id} failed: "
                    f"{e!r}") from e
        # Ownership handoff FIRST: the group object owns the
        # reservation from here (release_reservation_once / shutdown
        # discharge it), so the record below can never strand it.
        self._commit_formation(sub, reg, members)
        # Gang ids are bounded by live gangs (the recorder ring is
        # bounded regardless); the id IS the evidence.
        # graftlint: disable=metrics-label-cardinality
        flightrec.record("gang.form", group=self.group_id,
                         epoch=int(reg["epoch"]), hosts=self.num_hosts)

    def _abort_formation(self, stub, reservation_id: str) -> None:
        """Partial-spawn cleanup: hand the chips back and drop the
        half-registered group record — each best-effort in its own
        guard, so a head blip during one cannot strand the other (a
        failed release is logged; node-death reclamation is the
        backstop) — before the formation error propagates."""
        from ray_tpu_torch.core.config import config

        try:
            stub.release_subslice(reservation_id,
                                  timeout=config.ctrl_call_timeout_s)
        except Exception:
            log_every("multihost.abort_release", 10.0, logger,
                      "releasing sub-slice %s during formation abort "
                      "failed", reservation_id, exc_info=True)
        try:
            stub.mh_drop_group(self.group_id,
                               timeout=config.ctrl_call_timeout_s)
        except Exception:
            log_every("multihost.abort_drop", 10.0, logger,
                      "dropping group %s during formation abort failed",
                      self.group_id, exc_info=True)

    def _commit_formation(self, sub: Dict[str, Any],
                          reg: Dict[str, Any],
                          members: List[Any]) -> None:
        with self._lock:
            self._sub = sub
            self._epoch = int(reg["epoch"])
            self._members = list(members)

    def _spawn_members_into(self, members: List[Any], epoch: int,
                            reservation_id: str, slice_id: str,
                            nodes: List[str], origin: List[int],
                            shape: List[int], cph: int) -> None:
        """One HostWorker per host, all-or-nothing: every member gets a
        disjoint chip mask covering the sub-slice and the same group
        geometry (a member that drives its host's cards holds their
        ``GPU`` lease through ``worker_options``, e.g. ``{"num_gpus":
        1}``: the node starts it with ``CUDA_VISIBLE_DEVICES`` narrowed
        to the leased cards and hides them from CPU workers); any
        failure kills whatever spawned. Appends into
        ``members`` (the caller's list) rather than returning so the
        lease locals in ``_form`` stay subscript-read borrows."""
        import ray_tpu_torch
        from ray_tpu_torch.core.config import config
        from ray_tpu_torch.core.placement import \
            NodeAffinitySchedulingStrategy

        chip_ids = [[origin[0] + i, origin[1] + j]
                    for i in range(shape[0]) for j in range(shape[1])]
        # Formation-time taint consult (autopilot taint-host action):
        # the reservation's node list is already untainted-first, but
        # taints move between reserve and spawn — and a RE-formation
        # after a member death is exactly when a freshly-demoted host
        # must not get the gang back. Best-effort: an unreachable head
        # changes nothing (empty taint set = legacy order).
        if nodes:
            try:
                from ray_tpu_torch.core.rpc_stubs import ControllerStub
                taints = ControllerStub(_controller_client()).taint_state(
                    timeout=config.ctrl_call_timeout_s)
            except Exception:
                taints = {}
            if taints:
                nodes = ([n for n in nodes if n not in taints]
                         + [n for n in nodes if n in taints])
        actor_cls = ray_tpu_torch.remote(self._worker_cls)
        try:
            for rank in range(self.num_hosts):
                ctx = {
                    "group_id": self.group_id,
                    "member": member_name(rank),
                    "process_id": rank,
                    "num_processes": self.num_hosts,
                    "epoch": epoch,
                    "reservation_id": reservation_id,
                    "slice_id": slice_id,
                    "chips_per_host": cph,
                    "local_device_ids":
                        chip_ids[rank * cph:(rank + 1) * cph],
                    "local_device_count": cph,
                    # The member's process group runs on its host's card
                    # (NCCL), or on the CPU (gloo) on a virtual slice,
                    # whose hosts have no card.
                    "device_type": ("cpu" if slice_id.startswith(
                        "virtual-") else None),
                }
                opts = dict(self._worker_options)
                opts.setdefault("max_concurrency", 8)
                if nodes and "scheduling_strategy" not in opts:
                    opts["scheduling_strategy"] = \
                        NodeAffinitySchedulingStrategy(
                            nodes[rank % len(nodes)])
                members.append(actor_cls.options(**opts).remote(ctx))
            # Gang formation check: every member must come up before
            # the group exists at all.
            ray_tpu_torch.get([m.ping.remote() for m in members],
                        timeout=config.mh_form_timeout_s)
        except BaseException:
            self._kill_members(members)
            del members[:]
            raise

    def _elect(self, members: List[Any], epoch: int) -> None:
        """Coordinator election: the lowest live member index wins
        (every formation has a full fresh gang, so that is rank 0 of
        THIS epoch), picks the address the rest will join, and the
        result is recorded as a FENCED group-KV write — a deposed
        coordinator replaying its election is rejected, not applied.
        Every member then receives the same (address, coordinator,
        epoch) triple: aligned visibility by construction."""
        import ray_tpu_torch
        from ray_tpu_torch.core.config import config
        from ray_tpu_torch.core.rpc_stubs import ControllerStub

        coordinator = member_name(0)
        with _gang_span("gang:elect", group=self.group_id, epoch=epoch):
            coord_addr = ray_tpu_torch.get(
                members[0].reserve_coordinator.remote(0), timeout=60.0)
            put = ControllerStub(_controller_client()).mh_group_put(
                self.group_id, "coordinator",
                {"member": coordinator, "address": coord_addr,
                 "epoch": epoch}, epoch,
                timeout=config.ctrl_call_timeout_s)
            if not put.get("ok"):
                raise GroupEpochFenced(
                    f"election write for group {self.group_id} epoch "
                    f"{epoch} rejected: {put!r}")
            ray_tpu_torch.get([m.configure.remote(coord_addr, coordinator,
                                            epoch)
                         for m in members], timeout=60.0)
        # graftlint: disable=metrics-label-cardinality (gang ids bounded by live gangs; bounded ring)
        flightrec.record("gang.elect", group=self.group_id, epoch=epoch,
                         coordinator=coordinator)
        with self._lock:
            self._coordinator = coordinator
            self._coordinator_address = coord_addr

    # ------------------------------------------------------- monitor

    def _monitor_loop(self, period: float) -> None:
        from ray_tpu_torch.core.config import config

        while not self._stopped.wait(period):
            with self._lock:
                if self._state != _ALIVE:
                    continue
                members = list(self._members)
            dead: List[int] = []
            for i, m in enumerate(members):
                import ray_tpu_torch

                try:
                    ray_tpu_torch.get(m.ping.remote(),
                                timeout=config.mh_ping_timeout_s)
                except Exception:
                    dead.append(i)
            if not dead:
                victim = (self._poll_autopilot_eviction()
                          if config.autopilot_enabled else None)
                if victim is None:
                    continue
                with self._lock:
                    if self._state != _ALIVE or self._members != members:
                        continue
                self._reconcile([victim])
                continue
            with self._lock:
                # The gang may have been replaced while we pinged the
                # old incarnation; only reconcile the CURRENT members.
                if self._state != _ALIVE or self._members != members:
                    continue
            self._reconcile([member_name(i) for i in dead])

    def _poll_autopilot_eviction(self) -> Optional[str]:
        """Autopilot's reschedule-gang action arrives as a FENCED
        group-KV write (key ``autopilot_evict``, fenced on the epoch
        the autopilot observed — the registry already rejected any
        stale write, and re-registration clears the key with the rest
        of the group KV, so a consumed eviction dies with its epoch).
        The monitor treats the named member as dead, funnelling the
        action through the exact same epoch-fenced reconcile path as a
        real member death: never a double kill. Only polled when
        config.autopilot_enabled — the OFF path does not even RPC."""
        from ray_tpu_torch.core.config import config
        from ray_tpu_torch.core.rpc_stubs import ControllerStub

        try:
            victim = ControllerStub(_controller_client()).mh_group_get(
                self.group_id, "autopilot_evict",
                timeout=config.ctrl_call_timeout_s)
        except Exception:
            return None
        if not isinstance(victim, str):
            return None
        valid = {member_name(i) for i in range(self.num_hosts)}
        return victim if victim in valid else None

    def _reconcile(self, dead_members: List[str]) -> None:
        """Death reconciliation: the WHOLE gang dies as a unit (no
        half-alive meshes), the sub-slice is released exactly once,
        and — restart budget permitting — a fresh gang forms under a
        bumped epoch with a fresh coordinator election. Survivors of
        the old epoch that were merely unreachable self-fence on their
        next beat."""
        with self._lock:
            if self._state != _ALIVE:
                return
            self._state = _RESTARTING
            members = self._members
            self._members = []
            coordinator_died = self._coordinator in dead_members
            cause = (f"member(s) {', '.join(dead_members)} died"
                     + (" (coordinator — re-electing)"
                        if coordinator_died else ""))
            self._death_cause = cause
            old_epoch = self._epoch
        logger.info("host group %s: %s; reconciling the whole gang",
                    self.group_id, cause)
        # The monitor names the dead IN DETECTION ORDER: dead[0] is the
        # post-mortem's "first-dying member" (corroborated by the
        # victim's own recorder going silent / a fault.fired die event).
        # graftlint: disable=metrics-label-cardinality (gang ids bounded by live gangs; bounded ring)
        flightrec.record("gang.reconcile", group=self.group_id,
                         epoch=old_epoch, dead=",".join(dead_members),
                         coordinator_died=coordinator_died)
        with _gang_span("gang:reconcile", group=self.group_id,
                        epoch=old_epoch, dead=",".join(dead_members)):
            self._kill_members(members)
            self.release_reservation_once()
            restart = False
            with self._lock:
                if self._restarts < self.max_group_restarts:
                    self._restarts += 1
                    restart = True
            if restart:
                try:
                    self._form()
                except Exception as e:
                    # graftlint: disable=metrics-label-cardinality (gang ids bounded by live gangs; bounded ring)
                    flightrec.record("gang.dead", group=self.group_id,
                                     epoch=old_epoch,
                                     cause=f"restart failed: {e!r}")
                    with self._lock:
                        self._state = _DEAD
                        self._death_cause = (
                            f"{self._death_cause}; restart failed: "
                            f"{e!r}")
                    return
                with self._lock:
                    # shutdown() may have run while the fresh gang was
                    # forming (it found nothing to tear down then): the
                    # re-formed gang must not outlive the group object.
                    stale = self._stopped.is_set()
                    if stale:
                        members = self._members
                        self._members = []
                    else:
                        # death_cause stays as the last-reconciliation
                        # record (status() history), state returns to
                        # life.
                        self._state = _ALIVE
                if stale:
                    self._kill_members(members)
                    self.release_reservation_once()
                    drop_gang(self.group_id)
                return
            # graftlint: disable=metrics-label-cardinality (gang ids bounded by live gangs; bounded ring)
            flightrec.record("gang.dead", group=self.group_id,
                             epoch=old_epoch,
                             cause="restart budget exhausted")
            drop_gang(self.group_id)
            with self._lock:
                self._state = _DEAD

    def _kill_members(self, members: List[Any]) -> None:
        import ray_tpu_torch

        for m in members:
            try:
                ray_tpu_torch.kill(m)
            except Exception:  # graftlint: disable=swallowed-exception (best-effort gang teardown; the cluster reaps dead workers)
                pass

    def release_reservation_once(self) -> bool:
        """Hand the sub-slice back to the topology view EXACTLY once
        (the swap under the lock is the once-guard; the release RPC
        itself is idempotent on the head, and node-death reclamation is
        the backstop if the head is unreachable)."""
        with self._lock:
            sub, self._sub = self._sub, None
        if sub is None:
            return False
        from ray_tpu_torch.core.config import config
        from ray_tpu_torch.core.rpc_stubs import ControllerStub

        try:
            ControllerStub(_controller_client()).release_subslice(
                sub["reservation_id"],
                timeout=config.ctrl_call_timeout_s)
        except Exception:
            log_every("multihost.release", 10.0, logger,
                      "releasing sub-slice %s of group %s failed "
                      "(node-death reclamation is the backstop)",
                      sub["reservation_id"], self.group_id,
                      exc_info=True)
        with self._lock:
            self._releases += 1
        return True

    def shutdown(self) -> None:
        self._stopped.set()
        with self._lock:
            if self._state == _SHUTDOWN:
                return
            self._state = _SHUTDOWN
            members = self._members
            self._members = []
            epoch = self._epoch
        # graftlint: disable=metrics-label-cardinality (gang ids bounded by live gangs; bounded ring)
        flightrec.record("gang.shutdown", group=self.group_id,
                         epoch=epoch)
        self._kill_members(members)
        self.release_reservation_once()
        drop_gang(self.group_id)

    # ------------------------------------------------------- surface

    @property
    def members(self) -> List[Any]:
        with self._lock:
            return list(self._members)

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def coordinator(self) -> Optional[Dict[str, Any]]:
        """The current election record, from the group's fenced KV."""
        from ray_tpu_torch.core.config import config
        from ray_tpu_torch.core.rpc_stubs import ControllerStub

        return ControllerStub(_controller_client()).mh_group_get(
            self.group_id, "coordinator",
            timeout=config.ctrl_call_timeout_s)

    def call_all(self, method: str, *args,
                 timeout: Optional[float] = None, **kwargs) -> List[Any]:
        """Invoke one method on every member concurrently; returns the
        results in member order (all-or-nothing: any member failing
        raises)."""
        import ray_tpu_torch

        refs = [getattr(m, method).remote(*args, **kwargs)
                for m in self.members]
        return ray_tpu_torch.get(refs, timeout=timeout)

    def broadcast(self, fn, *args, timeout: Optional[float] = None,
                  **kwargs) -> List[Any]:
        """Run ``fn(member_runtime, *args, **kwargs)`` on every member
        concurrently (the gang-wide user-payload helper)."""
        from ray_tpu_torch.core import serialization

        fn_blob = serialization.dumps_function(fn)
        return self.call_all("run", fn_blob, args, kwargs,
                             timeout=timeout)

    def form_mesh(self, *, timeout: float = 120.0) -> List[int]:
        """Join every member into one ``torch.distributed`` process group
        (NCCL on cards, gloo on a virtual slice), each from its own
        aligned context. Returns each member's world size."""
        return self.call_all("join_torch", timeout=timeout)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "group_id": self.group_id,
                "state": self._state,
                "epoch": self._epoch,
                "num_hosts": self.num_hosts,
                "restarts": self._restarts,
                "releases": self._releases,
                "death_cause": self._death_cause,
                "coordinator": self._coordinator,
                "coordinator_address": self._coordinator_address,
                "sub_slice": dict(self._sub) if self._sub else None,
            }
        try:
            out["registry"] = registry_state(self.group_id)
        except Exception:
            out["registry"] = None
        return out
