"""Deadline: the blessed remaining-time idiom for bounded waits.

Control-plane code that accepts a ``timeout_s`` budget and then makes
SEVERAL blocking calls must not hand the FULL budget to each one — a
three-RPC path with ``timeout_s=30`` threaded raw can park for 90 s,
silently tripling the caller's budget (the deadline-not-propagated
graftlint rule). The fix this module blesses::

    dl = Deadline.after(timeout_s)
    stub.reserve_subslice(owner, chips, timeout=dl.remaining())
    stub.mh_register_group(gid, n, None, owner, timeout=dl.remaining())
    if dl.expired:
        raise ...

``remaining()`` never returns a value a wait primitive would read as
"forever": once the budget is spent it returns ``MIN_WAIT_S`` (a small
positive float), so the next bounded call fires its typed timeout
promptly instead of parking — the terminal state is an exception from
the wait site, never a hang. ``Deadline(None)`` is the explicit
unlimited deadline for callers that genuinely mean forever:
``remaining()`` returns ``None`` and ``expired`` is always False, so a
single code path serves both bounded and unbounded callers.

Sub-budgets: ``dl.sub(5.0)`` returns a child deadline capped at BOTH
5 s and the parent's remaining time — the idiom for "this phase gets at
most 5 s of whatever is left" (e.g. one formation RPC inside a gang
budget). Pure ``time.monotonic`` arithmetic; no threads, no state.
"""

from __future__ import annotations

import time
from typing import Optional

__all__ = ["Deadline", "MIN_WAIT_S"]

# Floor handed to wait primitives once the budget is spent: small enough
# that the timeout fires "now", large enough that a zero/negative value
# never reads as "no timeout" to an API with that convention.
MIN_WAIT_S = 0.001


class Deadline:
    """A fixed point on the monotonic clock; ``remaining()`` shrinks."""

    __slots__ = ("_at",)

    def __init__(self, at: Optional[float]):
        # ``at`` is an absolute time.monotonic() instant (None = never).
        self._at = at

    @classmethod
    def after(cls, timeout_s: Optional[float]) -> "Deadline":
        """Deadline ``timeout_s`` from now (None = unlimited)."""
        if timeout_s is None:
            return cls(None)
        return cls(time.monotonic() + float(timeout_s))

    @property
    def expired(self) -> bool:
        return self._at is not None and time.monotonic() >= self._at

    def remaining(self) -> Optional[float]:
        """Seconds left, floored at MIN_WAIT_S; None when unlimited.

        The floor (instead of 0 / negative) keeps the contract "a
        bounded caller's wait always fires a typed timeout": several
        wait APIs treat 0/None as "poll"/"forever" and a negative
        value as an error.
        """
        if self._at is None:
            return None
        return max(self._at - time.monotonic(), MIN_WAIT_S)

    def sub(self, timeout_s: Optional[float]) -> "Deadline":
        """A child deadline: ``timeout_s`` from now, capped at the
        parent — a phase budget that can never outlive the call's."""
        if timeout_s is None:
            return Deadline(self._at)
        child = time.monotonic() + float(timeout_s)
        return Deadline(child if self._at is None
                        else min(child, self._at))

    def __repr__(self) -> str:
        if self._at is None:
            return "Deadline(unlimited)"
        return f"Deadline(remaining={self.remaining():.3f}s)"
