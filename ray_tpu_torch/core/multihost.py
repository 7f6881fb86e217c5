"""Multi-host gangs (port of the gang half of ``ray_tpu/core/multihost.py``).

The substrate train worker gangs and tune trial gangs share:

* :class:`GroupRegistry` — controller-side group state (the ``mh_*``
  RPC surface): group registration with a **monotonic group epoch**
  (every restart / re-election bumps it; stale-epoch writes, beats and
  barrier entries are rejected, so a deposed coordinator or a zombie
  member self-fences instead of corrupting the new gang), a
  **rendezvous barrier** (members post a payload and park until the
  whole gang arrives — the carrier for the program-hash check), a
  small per-group fenced KV, and membership heartbeats.
* **Program-hash barrier** — :func:`enter_program_barrier` runs a
  barrier'd fingerprint exchange BEFORE any collective: every member
  posts its fingerprint, and a mismatch raises the typed
  :class:`ProgramHashMismatch` on every member instead of the classic
  multi-process hang (ranks running different programs deadlock inside
  the collective, where nothing times out).
* :func:`form_torch_runtime` / :func:`join_torch_gang` — the ONE
  ``torch.distributed`` bootstrap path (the counterpart of the JAX
  package's ``jax.distributed`` one): the gang registers, every member
  enters the bootstrap-fingerprint barrier (a misaligned
  ``num_processes`` or device type is a typed refusal — a wrong world
  size otherwise hangs ``init_process_group``'s rendezvous), then joins
  the tcp rendezvous rank 0 hosts. NCCL on the card, gloo only when the
  caller asks for ``device_type="cpu"``.

``program_fingerprint(fn=...)`` has no jaxpr to hash: it hashes the
function's qualified name and code with the arguments' shapes and dtypes
(``text=`` hashes verbatim, as in JAX).

``HostGroup`` (one actor per host of a sub-slice reservation, its
heartbeats, election and reconcile) is not ported yet (ROADMAP.md queue 1,
item 4); the name raises.

Fault-injection site: ``multihost.barrier.<group>.<member>`` (member-
side barrier entry).
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.errors import RayTpuError, not_ported
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
    card (``local_ranks[rank]``, its index among the gang's members on
    its node). Returns the coordinator address."""
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


class HostGroup:
    def __init__(self, *args, **kwargs):
        raise not_ported("HostGroup", "item 4, HostGroup and the gang "
                         "registry")
