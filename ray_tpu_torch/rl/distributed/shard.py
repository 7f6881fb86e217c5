"""Trajectory shards: fixed-shape rollouts shipped by ObjectRef (a copy
of ``ray_tpu/rl/distributed/shard.py``; pure host code).

The Podracer/sebulba data contract (PAPERS.md "Podracer architectures
for scalable Reinforcement Learning"): rollout actors ship TRAJECTORY
BYTES through the object plane (``ray_tpu_torch.put`` in the actor process ->
the learner pulls the ref), while the learner-facing RPC surface only
ever carries a small :class:`TrajectoryShard` descriptor — ref + fixed
metadata. The learner host drains descriptors from a BOUNDED
:class:`ShardQueue`: when the learner falls behind, the queue fills,
the intake loop stops refilling the slow path, and backpressure reaches
the rollout actors as idle time instead of unbounded memory growth
(the reference's aggregator-queue role, collapsed in-process).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# A descriptor is metadata-only by contract; anything close to this
# many serialized bytes means trajectory arrays leaked into the RPC
# payload (pinned by tests/test_torch_rl_distributed.py).
DESCRIPTOR_BYTE_BUDGET = 8192


@dataclass
class TrajectoryShard:
    """What transits the learner RPC: the object-plane ref and fixed
    shard metadata. Never the arrays themselves."""

    ref: Any                      # ObjectRef to the (T, N) rollout dict
    weights_version: int          # version the actor sampled with
    env_steps: int                # valid env steps in the shard
    actor_index: int              # which rollout actor produced it
    seq: int                      # per-actor shard sequence number
    desc_bytes: int = 0           # serialized descriptor size (intake)
    episodes: Dict[str, Any] = field(default_factory=dict)


class ShardQueueClosed(Exception):
    """put/get on a queue after close()."""


class ShardQueue:
    """Bounded, thread-safe FIFO of :class:`TrajectoryShard`.

    One condition guards all state: ``put`` blocks while full (the
    backpressure edge), ``get`` blocks while empty (the learner's
    intake wait), ``close`` wakes every waiter and hands back whatever
    was still queued so the caller can drop the refs deterministically
    (the zero-leaked-slots shutdown contract).
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._capacity = capacity
        self._cond = threading.Condition()
        self._items: List[TrajectoryShard] = []
        self._closed = False
        self._total_put = 0
        self._total_got = 0

    @property
    def capacity(self) -> int:
        return self._capacity

    def qsize(self) -> int:
        with self._cond:
            return len(self._items)

    def counters(self) -> Dict[str, int]:
        with self._cond:
            return {"put": self._total_put, "got": self._total_got,
                    "depth": len(self._items)}

    def put(self, shard: TrajectoryShard,
            timeout: Optional[float] = None) -> bool:
        """Blocking bounded put. Returns False on timeout; raises
        :class:`ShardQueueClosed` once the queue is closed (including
        while parked — close() must unstick the intake thread)."""
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._closed:
                    raise ShardQueueClosed("put on closed ShardQueue")
                if len(self._items) < self._capacity:
                    self._items.append(shard)
                    self._total_put += 1
                    self._cond.notify_all()
                    return True
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._cond.wait(remaining if remaining is not None
                                else 1.0)

    def get(self, timeout: Optional[float] = None
            ) -> Optional[TrajectoryShard]:
        """Blocking get. Returns None on timeout; raises
        :class:`ShardQueueClosed` when closed and drained."""
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._items:
                    shard = self._items.pop(0)
                    self._total_got += 1
                    self._cond.notify_all()
                    return shard
                if self._closed:
                    raise ShardQueueClosed("get on closed, empty queue")
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                self._cond.wait(remaining if remaining is not None
                                else 1.0)

    def close(self) -> List[TrajectoryShard]:
        """Close and return the undrained shards (callers drop their
        refs). Idempotent; wakes every blocked put/get."""
        with self._cond:
            self._closed = True
            leftover, self._items = self._items, []
            self._cond.notify_all()
            return leftover
