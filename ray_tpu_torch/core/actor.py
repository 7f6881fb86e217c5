"""Actors: stateful workers with ordered method invocation.

Analogue of the reference's ``python/ray/actor.py`` frontend over the GCS
actor lifecycle (``gcs_actor_manager.cc``: register -> schedule -> ALIVE ->
RESTARTING/DEAD) and the direct actor transport
(``direct_actor_task_submitter.h:74``: per-caller sequence numbers, direct
push to the actor's worker). Creation and restarts are driven by the
controller (as in the reference, where the GCS owns actor scheduling);
the handle is usable immediately — method calls block on ALIVE, and creation
errors surface as ``ActorDiedError`` carrying the ``__init__`` traceback.

Restart semantics (``max_restarts``): when a caller observes the actor's
worker unreachable it reports the failure; the controller either restarts
(incrementing the *incarnation*) or marks the actor DEAD. In-flight calls to
the dead incarnation fail with ``ActorUnavailableError``; the caller's
sequence stream resets for the new incarnation.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.controller import ALIVE, DEAD, RESTARTING
from ray_tpu_torch.core.errors import ActorDiedError, ActorUnavailableError
from ray_tpu_torch.core.ids import ActorID, ObjectID, TaskID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.remote_function import (
    _normalized_env,
    _placement_tuple,
    _resources_from_options,
    _strategy_dict,
    export_callable,
)
from ray_tpu_torch.core.rpc import RemoteCallError, RpcError
from ray_tpu_torch.core.runtime import get_core_worker

# Per-process submission sequence numbers, keyed by (actor, incarnation) so a
# restarted actor sees a fresh seq stream from each caller.
_seq_counters: Dict[tuple, int] = {}
_seq_lock = threading.Lock()
# Per-actor cap on in-flight pushes so out-of-order arrivals can't exhaust the
# actor server's handler pool (reference: max_pending_calls).
_inflight: Dict[ActorID, threading.Semaphore] = {}


def _next_seq(actor_id: ActorID, incarnation: int) -> int:
    with _seq_lock:
        key = (actor_id, incarnation)
        seq = _seq_counters.get(key, 0)
        _seq_counters[key] = seq + 1
        return seq


def _inflight_sem(actor_id: ActorID) -> threading.Semaphore:
    with _seq_lock:
        sem = _inflight.get(actor_id)
        if sem is None:
            sem = threading.Semaphore(32)
            _inflight[actor_id] = sem
        return sem


class ActorClass:
    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = dict(options or {})
        self.__name__ = getattr(cls, "__name__", "ActorClass")

    def options(self, **overrides) -> "ActorClass":
        merged = dict(self._options)
        merged.update(overrides)
        return ActorClass(self._cls, merged)

    def remote(self, *args, **kwargs) -> "ActorHandle":
        core = get_core_worker()
        opts = self._options
        actor_id = ActorID.from_random()
        cls_key, _ = export_callable(self._cls)
        resources = _resources_from_options(opts)
        info = {
            "name": opts.get("name"),
            "class_name": self.__name__,
            "resources": resources,
            "max_restarts": opts.get("max_restarts", 0),
            "cls_key": cls_key,
        }
        spec = {
            "cls_key": cls_key,
            "desc": self.__name__,
            "args_blob": serialization.serialize((args, kwargs)),
            "max_concurrency": opts.get("max_concurrency", 1),
        }
        creation_opts = {
            "resources": resources,
            "scheduling_strategy": _strategy_dict(opts.get("scheduling_strategy")),
            "placement": _placement_tuple(opts),
            "runtime_env": _normalized_env(opts),
        }
        core.controller.call("register_actor", actor_id.binary(), info,
                             spec, creation_opts)
        return ActorHandle(actor_id)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def options(self, num_returns: int = 1) -> "ActorMethod":
        return ActorMethod(self._handle, self._name, num_returns)

    def remote(self, *args, **kwargs):
        return self._handle._submit(self._name, args, kwargs,
                                    self._num_returns)


class ActorHandle:
    def __init__(self, actor_id: ActorID):
        self._actor_id = actor_id
        self._cached: Optional[Dict[str, Any]] = None
        # Last incarnation this process observed; new submissions open their
        # seq stream against it so a restarted actor sees seqs from 0.
        self._known_inc = 0

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def __reduce__(self):
        return (ActorHandle, (self._actor_id,))

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()})"

    def _resolve(self, timeout: float = 60.0) -> Dict[str, Any]:
        """Wait until the actor is ALIVE; raise ActorDiedError if DEAD.

        Push-driven: one synchronous read, then a long-poll subscription on
        the controller's actor channel (reference: GCS actor pubsub replacing
        WaitForActorRefDeleted-style polling; serve long_poll.py:173)."""
        cached = self._cached
        if cached is not None:
            return cached
        core = get_core_worker()
        record = core.controller.call("get_actor", self._actor_id.binary())
        if record is None:
            raise ActorDiedError(self._actor_id, "unknown actor")
        deadline = time.monotonic() + timeout
        version = 0
        while True:
            if record["state"] == ALIVE:
                self._cached = record
                self._known_inc = max(self._known_inc, record["incarnation"])
                return record
            if record["state"] == DEAD:
                raise ActorDiedError(self._actor_id,
                                     record.get("death_cause") or "")
            step = min(10.0, deadline - time.monotonic())
            if step <= 0:
                raise ActorDiedError(
                    self._actor_id,
                    f"actor stuck in state {record['state']} for {timeout}s")
            try:
                update = core.controller.call(
                    "psub_poll", "actors", self._actor_id.hex(), version,
                    step, timeout=step + 15.0)
            except (RpcError, TimeoutError):
                # A slow/saturated controller long-poll is NOT an actor
                # failure (the caller's except-branch would misclassify it
                # and restart a healthy actor): degrade to a plain re-read.
                time.sleep(0.2)
                update = None
            if update is None:  # long-poll timed out: re-read and loop
                record = core.controller.call(
                    "get_actor", self._actor_id.binary())
                if record is None:
                    raise ActorDiedError(self._actor_id, "unknown actor")
                continue
            version, record = update

    def _incarnation_hint(self) -> int:
        return self._known_inc

    def _submit(self, method: str, args: tuple, kwargs: dict,
                num_returns: int) -> Any:
        core = get_core_worker()
        return_ids = [ObjectID.from_random() for _ in range(num_returns)]
        refs = [ObjectRef(oid, core.addr) for oid in return_ids]
        for oid in return_ids:
            core.store.create_pending(oid)
        # Seq allocated synchronously (submission order) against the caller's
        # current view of the incarnation; a stale view is healed by the
        # actor-side bounded gap wait plus the reset below.
        incarnation = self._incarnation_hint()
        seq = _next_seq(self._actor_id, incarnation)
        with serialization.capture_refs() as held_refs:
            args_blob = serialization.serialize((args, kwargs))
        spec = {
            "task_id": TaskID.from_random().binary(),
            "method": method,
            "desc": f"{self._actor_id.hex()[:8]}.{method}",
            "args_blob": args_blob,
            "return_ids": [o.binary() for o in return_ids],
            "owner_addr": core.addr,
            "seq": seq,
            "epoch": incarnation,
        }
        from ray_tpu_torch.util import tracing

        trace_ctx = tracing.context_for_spec()
        if trace_ctx is not None:
            spec["trace"] = trace_ctx
        from ray_tpu_torch.core.runtime import _collect_top_level_refs

        arg_refs = _collect_top_level_refs(args, kwargs)
        sem = _inflight_sem(self._actor_id)
        core.submitter._pool.submit(
            self._push, core, spec, return_ids, arg_refs, sem, held_refs)
        if num_returns == 0:
            return None
        if num_returns == 1:
            return refs[0]
        return refs

    def _push(self, core, spec, return_ids, arg_refs, sem,
              held_refs=None) -> None:
        # held_refs keeps every ref pickled into the args alive (handles
        # registered) for the in-flight window; see TaskSubmitter.submit.
        try:
            for ref in arg_refs:
                core.wait_ready(ref, None)
            record = self._resolve()
            if record["incarnation"] != spec["epoch"]:
                # Submitted against an incarnation that died before the push:
                # the call is lost (reference: in-flight actor tasks are not
                # transparently retried across restarts by default).
                raise _StaleEpoch(record["incarnation"])
            worker_addr = tuple(record["addr"][0])
            sem.acquire()
            try:
                reply = core.clients.get(worker_addr).call(
                    "push_actor_task", spec, timeout=None)
            finally:
                sem.release()
            if reply["ok"]:
                for oid, packed in zip(return_ids, reply["results"]):
                    core.fulfil_result(oid, packed)
            else:
                for oid in return_ids:
                    core.store.put_serialized(oid, reply["error_frame"])
        except _StaleEpoch as e:
            self._known_inc = max(self._known_inc, e.incarnation)
            err = ActorUnavailableError(
                f"actor {self._actor_id.hex()} restarted before this call "
                f"was delivered; resubmit")
            for oid in return_ids:
                core.store.put_error(oid, err)
        except (RpcError, RemoteCallError, TimeoutError) as e:
            # Worker unreachable: report to the controller, which restarts
            # (new incarnation) or declares the actor dead.
            self._cached = None
            err: BaseException
            try:
                record = core.controller.call(
                    "report_actor_failure", self._actor_id.binary(),
                    f"worker unreachable: {e}")
            except Exception:
                record = None
            if record is not None:
                self._known_inc = max(self._known_inc, record["incarnation"])
            if record is not None and record["state"] in (RESTARTING, ALIVE):
                err = ActorUnavailableError(
                    f"actor {self._actor_id.hex()} restarting; call lost: {e}")
            else:
                err = ActorDiedError(self._actor_id, f"actor task failed: {e}")
            for oid in return_ids:
                core.store.put_error(oid, err)
        except BaseException as e:  # noqa: BLE001
            for oid in return_ids:
                core.store.put_error(oid, e)

    def kill(self, no_restart: bool = True) -> None:
        core = get_core_worker()
        self._cached = None
        core.controller.call("kill_actor", self._actor_id.binary(), no_restart)


class _StaleEpoch(Exception):
    def __init__(self, incarnation: int):
        self.incarnation = incarnation
        super().__init__(f"stale epoch; current incarnation {incarnation}")


def get_actor(name: str) -> ActorHandle:
    """Look up a named actor (reference: ``ray.get_actor``)."""
    core = get_core_worker()
    actor_id_bytes = core.controller.call("get_named_actor", name)
    if actor_id_bytes is None:
        raise ValueError(f"no actor named {name!r}")
    return ActorHandle(ActorID(actor_id_bytes))
