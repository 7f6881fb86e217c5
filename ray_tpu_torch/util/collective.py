"""Library-level collectives over actor groups — host-data plane (copy
of ``ray_tpu/util/collective.py``).

Analogue of the reference's ``ray.util.collective``
(``util/collective/collective.py:120-615``: NCCL/Gloo groups over actors,
rendezvous via a named actor store). Like the JAX package's, this API
covers only *host* (numpy) data: it has no NCCL group and no CUDA-tensor
path. Device-tensor collectives belong to ``torch.distributed`` process
groups inside a train step (``ray_tpu_torch.parallel``). What remains
useful at the framework level is CPU-side coordination:
allreduce/broadcast/allgather of numpy arrays between actors (metrics
fan-in, weight broadcast to env runners, rendezvous barriers),
implemented over the object store with a named rendezvous actor.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch


class _GroupStore:
    """Rendezvous + per-round mailbox (reference: NCCLUniqueIDStore named
    actor used for rendezvous)."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._rounds: Dict[tuple, Dict[int, Any]] = {}
        self._reads: Dict[tuple, set] = {}

    def put(self, op: str, round_id: int, rank: int, value) -> None:
        self._rounds.setdefault((op, round_id), {})[rank] = value

    def gather(self, op: str, round_id: int, rank: int):
        key = (op, round_id)
        entries = self._rounds.get(key, {})
        if len(entries) < self.world_size:
            return None
        result = [entries[r] for r in range(self.world_size)]
        # Only clear a round once every rank has read it — a rank-0-side
        # clear.remote() raced slower ranks' polls and made them time out.
        reads = self._reads.setdefault(key, set())
        reads.add(rank)
        if len(reads) == self.world_size:
            self._rounds.pop(key, None)
            self._reads.pop(key, None)
        return result


class CollectiveGroup:
    """Handle held by each participant (rank)."""

    def __init__(self, name: str, world_size: int, rank: int):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self._round: Dict[str, int] = {}
        self._store = ray_tpu_torch.get_actor(f"_collective_{name}")

    def _next_round(self, op: str) -> int:
        r = self._round.get(op, 0)
        self._round[op] = r + 1
        return r

    def _exchange(self, op: str, value, timeout: float = 120.0):
        round_id = self._next_round(op)
        ray_tpu_torch.get(self._store.put.remote(op, round_id, self.rank,
                                                 value))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            gathered = ray_tpu_torch.get(
                self._store.gather.remote(op, round_id, self.rank))
            if gathered is not None:
                return gathered
            time.sleep(0.005)
        raise TimeoutError(f"collective {op} round {round_id} timed out")

    # ------------------------------------------------------------ ops

    def allreduce(self, array: np.ndarray, op: str = "sum") -> np.ndarray:
        gathered = self._exchange("allreduce", np.asarray(array))
        stacked = np.stack(gathered)
        if op == "sum":
            return stacked.sum(axis=0)
        if op == "mean":
            return stacked.mean(axis=0)
        if op == "max":
            return stacked.max(axis=0)
        if op == "min":
            return stacked.min(axis=0)
        raise ValueError(f"unknown reduce op {op!r}")

    def allgather(self, array: np.ndarray) -> List[np.ndarray]:
        return self._exchange("allgather", np.asarray(array))

    def broadcast(self, array: Optional[np.ndarray],
                  src_rank: int = 0) -> np.ndarray:
        gathered = self._exchange(
            "broadcast", np.asarray(array) if self.rank == src_rank else None)
        return gathered[src_rank]

    def barrier(self) -> None:
        self._exchange("barrier", self.rank)


def create_collective_group(name: str, world_size: int) -> None:
    """Create the rendezvous store (call once, e.g. from the driver)."""
    cls = ray_tpu_torch.remote(_GroupStore)
    cls.options(name=f"_collective_{name}", num_cpus=0).remote(world_size)


def init_collective_group(name: str, world_size: int,
                          rank: int) -> CollectiveGroup:
    """Join a group from a participant (reference:
    ``init_collective_group``, collective.py:120)."""
    deadline = time.monotonic() + 30
    while True:
        try:
            return CollectiveGroup(name, world_size, rank)
        except ValueError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)
