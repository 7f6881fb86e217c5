"""ActorPool: work distribution over a fixed set of actors (copy of
``ray_tpu/util/actor_pool.py``).

Analogue of the reference's ``ray.util.ActorPool``
(``python/ray/util/actor_pool.py``): submit tasks to idle actors, collect
results in order or as-available.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._future_to_actor = {}
        self._future_to_index = {}  # O(1) unordered pops (no ref scan)
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0

    def submit(self, fn: Callable, value: Any) -> None:
        if not self._idle:
            raise ValueError("no idle actors; call get_next first")
        actor = self._idle.pop(0)
        ref = fn(actor, value)
        self._future_to_actor[ref] = actor
        self._future_to_index[ref] = self._next_task_index
        self._index_to_future[self._next_task_index] = ref
        self._next_task_index += 1

    def has_next(self) -> bool:
        return bool(self._index_to_future)

    def get_next(self, timeout=None) -> Any:
        """Next result in submission order (skipping indices already
        consumed by ``get_next_unordered``)."""
        while (self._next_return_index < self._next_task_index
               and self._next_return_index not in self._index_to_future):
            self._next_return_index += 1
        ref = self._index_to_future.pop(self._next_return_index)
        self._future_to_index.pop(ref, None)
        self._next_return_index += 1
        value = ray_tpu_torch.get(ref, timeout=timeout)
        self._idle.append(self._future_to_actor.pop(ref))
        return value

    def get_next_unordered(self, timeout=None) -> Any:
        pending = list(self._future_to_actor.keys())
        ready, _ = ray_tpu_torch.wait(pending, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result ready")
        ref = ready[0]
        idx = self._future_to_index.pop(ref)  # O(1): ref -> index map
        self._index_to_future.pop(idx, None)
        value = ray_tpu_torch.get(ref)
        self._idle.append(self._future_to_actor.pop(ref))
        return value

    def map(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            while not self._idle:
                yield self.get_next()
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def has_free(self) -> bool:
        return bool(self._idle)
