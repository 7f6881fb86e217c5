"""Exception hierarchy for the runtime (copy of ``ray_tpu/core/errors.py``,
plus ``not_ported``).

Analogue of the reference's ``python/ray/exceptions.py``: user-visible errors
raised by ``get``/``remote``/actor calls. Errors that occur inside a remote
task are captured, pickled, and re-raised at the caller wrapped in
``TaskError`` so the original traceback is preserved as text.
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A remote task raised an exception.

    Stored in the object store in place of the task's return value; re-raised
    on ``get`` (reference: ``RayTaskError`` in ``python/ray/exceptions.py``).
    """

    def __init__(self, cause: BaseException, task_desc: str = "", tb: str = ""):
        self.cause = cause
        self.task_desc = task_desc
        if tb:
            self.tb = tb
        elif isinstance(cause, BaseException):
            self.tb = "".join(traceback.format_exception(
                type(cause), cause, cause.__traceback__))
        else:
            self.tb = str(cause)
        super().__init__(f"Task {task_desc} failed:\n{self.tb}")

    def __reduce__(self):
        # The cause itself may be unpicklable (or carry an unpicklable
        # traceback); ship a picklable surrogate plus the formatted text.
        cause = self.cause
        try:
            import pickle

            pickle.dumps(cause)
        except Exception:
            cause = RayTpuError(repr(self.cause))
        return (TaskError, (cause, self.task_desc, self.tb))


class WorkerCrashedError(RayTpuError):
    """The worker process executing a task died unexpectedly."""


class ActorDiedError(RayTpuError):
    """An actor is dead; pending and future calls fail with this."""

    def __init__(self, actor_id=None, reason: str = ""):
        self.actor_id = actor_id
        self.reason = reason
        super().__init__(f"Actor {actor_id} is dead. {reason}")


class ActorUnavailableError(RayTpuError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class ObjectLostError(RayTpuError):
    """An object could not be found or reconstructed."""


class ObjectFreedError(RayTpuError):
    """The object was explicitly freed."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get(ref, timeout=...)`` timed out."""


class RuntimeEnvSetupError(RayTpuError):
    """Setting up a runtime environment for a task/actor failed."""


class NodeDiedError(RayTpuError):
    """The node hosting a task/object died."""


class PendingCallsLimitExceeded(RayTpuError):
    """Actor max_pending_calls exceeded."""


class OutOfMemoryError(RayTpuError):
    """Object store is out of memory and eviction could not make room."""


# ------------------------------------------------- serve request lifecycle
#
# Typed terminal outcomes for a serve-plane request (reference: Ray Serve's
# BackPressureError / RequestCancelledError / deadline handling in
# serve/_private/proxy.py). These travel from the DecodeEngine / replica
# through actor-call error shipping to the handle and the HTTP proxy, which
# maps them onto status codes (503 + Retry-After, 504, 499).


class DeadlineExceededError(RayTpuError, TimeoutError):
    """The request's deadline passed before generation completed.

    Raised at admission (the deadline expired while queued) or mid-decode
    (the engine checks at every ``step()`` and frees the slot instead of
    burning decode steps for a caller that already gave up)."""


class RequestCancelledError(RayTpuError):
    """The request was cancelled (client disconnected / stream closed)
    before completing."""


class OverloadedError(RayTpuError):
    """The serving queue is at capacity; the request was shed at enqueue.

    Carries ``retry_after_s`` — the replica's estimate (from observed
    token throughput) of when a slot will free — which the HTTP proxy
    surfaces as a 503 ``Retry-After`` header."""

    def __init__(self, message: str = "server overloaded",
                 retry_after_s: float = 1.0):
        self.retry_after_s = float(retry_after_s)
        super().__init__(message)

    def __reduce__(self):
        return (OverloadedError, (self.args[0] if self.args else
                                  "server overloaded", self.retry_after_s))


class HandoffAdoptError(RayTpuError):
    """A decode replica could not adopt a published KV-page handoff
    (page-geometry mismatch, payload shape that does not fit the pool,
    or the page payload refs were already gone).

    Raised by ``DecodeEngine.submit(adopt=...)`` validation and shipped
    back through the actor-call error path; the router treats it as
    "this splice cannot work" and falls back to the colocated path
    after aborting the prefill side's lease."""


def not_ported(what: str, roadmap_item: str) -> NotImplementedError:
    """The error every knob the port does not carry yet raises, naming its
    ROADMAP.md item."""
    return NotImplementedError(
        f"{what} is not ported to ray_tpu_torch yet (ROADMAP.md queue 1: "
        f"{roadmap_item})")
