"""Rate-limited logging for hot paths (copy of ``ray_tpu/util/ratelimit.py``).

A failure that can repeat thousands of times a second (a broken metrics
collector at every snapshot, a streaming consumer on every token) must be
diagnosable without drowning the log. ``log_every`` emits at most one
record per key per period and counts what it suppressed, so the first line
after a quiet stretch says how many identical failures it stands for.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Tuple

_lock = threading.Lock()
# key -> (last emit monotonic, suppressed count since)
_state: Dict[str, Tuple[float, int]] = {}


def log_every(key: str, period_s: float, logger: logging.Logger,
              msg: str, *args, level: int = logging.WARNING,
              exc_info: bool = False) -> bool:
    """Log ``msg % args`` at most once per ``period_s`` per ``key``.

    Returns True when the record was emitted. Suppressed repeats are
    counted and reported in the next emitted record's suffix.
    """
    now = time.monotonic()
    with _lock:
        last, suppressed = _state.get(key, (0.0, 0))
        emit = now - last >= period_s
        if emit:
            _state[key] = (now, 0)
        else:
            _state[key] = (last, suppressed + 1)
    if not emit:
        _count_suppressed(key)  # outside _lock: registry has its own
        return False
    suffix = f" ({suppressed} similar suppressed)" if suppressed else ""
    try:
        logger.log(level, msg + suffix, *args, exc_info=exc_info)
    except Exception:
        # Logging must never take down the caller (interpreter teardown
        # closes handlers mid-write).
        return False
    return True


def _count_suppressed(key: str) -> None:
    """Every suppressed occurrence increments ``log_suppressed_total``
    labeled by its site key: a suppressed error flood is invisible in the
    log by design, so it must be visible in the metrics instead. Site
    keys are literal strings at the call sites, so the label stays
    bounded."""
    try:
        from ray_tpu_torch.util.metrics import Counter

        global _SUPPRESSED
        if _SUPPRESSED is None:
            _SUPPRESSED = Counter(
                "log_suppressed_total",
                "log_every records suppressed by rate limiting, by site.",
                tag_keys=("site",))
        _SUPPRESSED.inc(1.0, {"site": key})
    # The one place that cannot log its failure: log_every is the logging
    # path, and recursing into it from its own metrics hook (or at
    # interpreter teardown) must never take down the caller.
    # graftlint: disable=swallowed-exception
    except Exception:
        pass


_SUPPRESSED = None


def reset() -> None:
    """Test hook: forget all rate-limit state."""
    with _lock:
        _state.clear()
