"""Serve-plane errors (copy of the parts of ``ray_tpu/core/errors.py`` the
port raises).

Typed terminal outcomes for a decode request: the engine raises them at
enqueue (shed, expired deadline, an adopt it cannot splice) or re-raises
them from a request's terminal status (``_Request.raise_for_status``).
The object plane's stand-in (``core/api.py``) raises the two object
errors.
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


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

    Carries ``retry_after_s``, the engine's estimate of when a slot will
    free."""

    def __init__(self, message: str = "server overloaded",
                 retry_after_s: float = 1.0):
        self.retry_after_s = float(retry_after_s)
        super().__init__(message)

    def __reduce__(self):
        return (OverloadedError, (self.args[0] if self.args else
                                  "server overloaded", self.retry_after_s))


class ObjectLostError(RayTpuError):
    """An object could not be found or reconstructed."""


class ObjectFreedError(RayTpuError):
    """The object was explicitly freed."""


class HandoffAdoptError(RayTpuError):
    """A decode engine could not adopt a published KV-page handoff
    (page-geometry mismatch, a payload that does not fit the pool, or
    page payload refs that were already gone).

    Raised by ``DecodeEngine.submit(adopt=...)`` validation before
    enqueue and by the deployment's ``_fetch_adopt``; the router (ROADMAP
    queue 1, item 4) treats it as "this splice cannot work" and falls
    back to the colocated path after aborting the prefill side's
    lease."""
