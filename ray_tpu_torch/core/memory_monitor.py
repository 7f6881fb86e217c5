"""Node memory watermark monitor + OOM worker-killing policies.

TPU-native analogue of the reference's ``MemoryMonitor``
(``src/ray/common/memory_monitor.h:52``) and its worker-killing policies
(``src/ray/raylet/worker_killing_policy_retriable_fifo.cc``,
``worker_killing_policy_group_by_owner.cc``): when the node's memory usage
crosses ``memory_usage_threshold``, one worker is killed per check (with a
cooldown) to shed load before the OS OOM killer takes the whole node down.

Policy order mirrors the reference's intent:

* idle pooled workers go first — they hold interpreter memory but no task,
  so killing them is pure relief;
* then ``retriable_fifo``: the most recently leased *retriable* task worker
  (its owner resubmits; older tasks keep their progress);
* ``group_by_owner`` instead prefers the owner with the most leased workers
  on this node (sheds the biggest contributor's newest task first);
* a non-retriable worker is killed only as a last resort — its owner
  surfaces :class:`ray_tpu_torch.core.errors.OutOfMemoryError` (the node recorded
  the death cause, see ``Node.worker_death_cause``).

Usage is read from cgroup v2 limits when present (containers), else
``/proc/meminfo`` (used = MemTotal - MemAvailable). Tests inject a fake
reader via ``MemoryMonitor.set_reader``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional, Tuple

from ray_tpu_torch.core.config import config
from ray_tpu_torch.util.ratelimit import log_every

logger = logging.getLogger(__name__)

Reading = Tuple[int, int]  # (used_bytes, total_bytes)


def default_memory_reader() -> Reading:
    """Cgroup-v2-aware node memory usage; falls back to /proc/meminfo."""
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            limit = f.read().strip()
        if limit != "max":
            with open("/sys/fs/cgroup/memory.current") as f:
                used = int(f.read().strip())
            # Page cache in memory.current is reclaimable — counting it
            # would OOM-kill workers during heavy file I/O (the reference
            # subtracts inactive_file for exactly this reason,
            # memory_monitor.cc GetCGroupMemoryUsedBytes).
            try:
                with open("/sys/fs/cgroup/memory.stat") as f:
                    for line in f:
                        if line.startswith("inactive_file "):
                            used -= int(line.split()[1])
                            break
            except (OSError, ValueError):
                pass
            return max(0, used), int(limit)
    except (OSError, ValueError):
        pass
    total = avail = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
                if total and avail:
                    break
    except OSError:
        return 0, 0
    return max(0, total - avail), total


def pick_victim(handles: List, policy: str) -> Optional[object]:
    """Choose one worker handle to kill. ``handles`` is a snapshot of the
    node's live :class:`WorkerHandle` objects; returns a handle or None.
    Pure function of the snapshot so the selection logic is unit-testable
    without a node (the reference tests its policies the same way)."""
    alive = [h for h in handles if h.proc.poll() is None]
    # 1. Idle pooled workers: no task aboard, cheapest relief.
    idle = [h for h in alive if h.idle]
    if idle:
        return min(idle, key=lambda h: h.last_used)  # oldest idle first
    leased = [h for h in alive
              if h.lease_resources is not None and not h.dedicated]
    if not leased:
        return None

    def retriable(h) -> bool:
        return bool((getattr(h, "task_meta", None) or {}).get(
            "retriable", True))

    if policy == "group_by_owner":
        groups = {}
        for h in leased:
            owner = (getattr(h, "task_meta", None) or {}).get("owner", "")
            groups.setdefault(owner, []).append(h)
        # Largest group sheds first; retriable groups preferred at equal size.
        ordered = sorted(
            groups.values(),
            key=lambda g: (len(g), sum(retriable(h) for h in g)),
            reverse=True)
        group = ordered[0]
        pick = [h for h in group if retriable(h)] or group
        return max(pick, key=lambda h: h.last_used)  # newest in group
    # retriable_fifo (default): newest retriable lease; non-retriable only
    # as a last resort (also newest-first).
    pool = [h for h in leased if retriable(h)] or leased
    return max(pool, key=lambda h: h.last_used)


class MemoryMonitor:
    """Background watermark check attached to a :class:`Node`."""

    def __init__(self, node, reader: Optional[Callable[[], Reading]] = None):
        self._node = node
        self._reader = reader or default_memory_reader
        self._stopped = threading.Event()
        self._last_kill = 0.0
        self.kills: List[dict] = []  # bounded history for get_info/tests
        self.total_kills = 0  # monotonic; history above is trimmed
        self._thread = threading.Thread(
            target=self._loop, name="memory-monitor", daemon=True)
        self._thread.start()

    def set_reader(self, reader: Callable[[], Reading]) -> None:
        self._reader = reader

    def stop(self) -> None:
        self._stopped.set()

    def _loop(self) -> None:
        period = config.memory_monitor_refresh_s
        while not self._stopped.wait(period):
            try:
                self.check_once()
            except Exception:
                # A monitor that fails every tick means NO oom
                # protection — keep running, but say so.
                log_every("memory_monitor.check", 60.0, logger,
                          "memory watermark check failed", exc_info=True)

    def check_once(self) -> Optional[bytes]:
        """One watermark check; returns the killed worker id (or None)."""
        used, total = self._reader()
        if total <= 0 or used / total < config.memory_usage_threshold:
            return None
        now = time.monotonic()
        if now - self._last_kill < config.memory_kill_interval_s:
            return None
        with self._node._lock:
            handles = list(self._node._workers.values())
        victim = pick_victim(handles, config.worker_killing_policy)
        if victim is None:
            return None
        self._last_kill = now
        reason = (f"memory monitor: node memory {used}/{total} "
                  f"({used / total:.0%}) above threshold "
                  f"{config.memory_usage_threshold:.0%}")
        self.kills.append({"worker": victim.worker_id.hex(), "ts": time.time(),
                           "used": used, "total": total,
                           "retriable": bool((getattr(victim, "task_meta",
                                                      None) or {}).get(
                               "retriable", True))})
        del self.kills[:-100]
        self.total_kills += 1
        self._node.kill_worker(victim.worker_id.binary(), force=True,
                               reason=reason)
        return victim.worker_id.binary()
