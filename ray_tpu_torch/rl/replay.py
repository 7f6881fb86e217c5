"""Replay buffers for off-policy RL.

Analogue of the reference's replay-buffer stack
(``rllib/utils/replay_buffers/``: ``EpisodeReplayBuffer``,
``PrioritizedEpisodeReplayBuffer`` and the old-stack
``prioritized_replay_buffer.py``). Transitions live in preallocated numpy
ring arrays (fixed shapes keep learner batches XLA-static); prioritized
sampling uses a sum-tree (proportional prioritization, Schaul et al.) with
O(log N) sample/update.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class SumTree:
    """Binary indexed sum-tree over leaf priorities; leaves are buffer
    slots. Sampling draws a uniform mass in [0, total) and descends."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._tree = np.zeros(2 * self.capacity, np.float64)

    def set(self, idx, priority) -> None:
        idx = np.atleast_1d(np.asarray(idx, np.int64))
        priority = np.atleast_1d(np.asarray(priority, np.float64))
        for i, p in zip(idx, priority):  # leaf updates; O(log N) each
            node = i + self.capacity
            delta = p - self._tree[node]
            while node >= 1:
                self._tree[node] += delta
                node //= 2

    def get(self, idx) -> np.ndarray:
        return self._tree[np.asarray(idx, np.int64) + self.capacity]

    @property
    def total(self) -> float:
        return float(self._tree[1])

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """Stratified proportional sampling: one draw per equal slice of
        the total mass (reduces variance vs. i.i.d. draws)."""
        bounds = np.linspace(0.0, self.total, n + 1)
        targets = rng.uniform(bounds[:-1], bounds[1:])
        out = np.empty(n, np.int64)
        for row, t in enumerate(targets):
            node = 1
            while node < self.capacity:
                left = 2 * node
                if t <= self._tree[left]:
                    node = left
                else:
                    t -= self._tree[left]
                    node = left + 1
            out[row] = node - self.capacity
        return out


class ReplayBuffer:
    """Uniform or prioritized transition replay.

    ``add`` takes dict batches of transitions (leading axis = batch);
    ``sample`` returns a dict batch plus (for prioritized mode) the sampled
    indices and importance-sampling weights; ``update_priorities`` feeds
    TD errors back (proportional: p = |td| + eps).
    """

    def __init__(self, capacity: int, prioritized: bool = False,
                 alpha: float = 0.6, beta: float = 0.4,
                 priority_eps: float = 1e-3, seed: int = 0):
        self.capacity = int(capacity)
        self.prioritized = prioritized
        self.alpha = alpha
        self.beta = beta
        self.priority_eps = priority_eps
        self._rng = np.random.default_rng(seed)
        self._storage: Optional[Dict[str, np.ndarray]] = None
        self._next = 0
        self._size = 0
        self._tree = SumTree(self.capacity) if prioritized else None
        self._max_priority = 1.0

    def __len__(self) -> int:
        return self._size

    def _ensure_storage(self, batch: Dict[str, np.ndarray]) -> None:
        if self._storage is not None:
            return
        self._storage = {
            k: np.zeros((self.capacity,) + v.shape[1:], v.dtype)
            for k, v in batch.items()
        }

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        self._ensure_storage(batch)
        n = len(next(iter(batch.values())))
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._storage[k][idx] = v
        if self._tree is not None:
            # New experience enters at max priority so it is seen at least
            # once before its TD error takes over.
            self._tree.set(idx, self._max_priority ** self.alpha)
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)

    def sample(self, batch_size: int
               ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
        """Returns (batch, indices, is_weights). Uniform mode returns unit
        weights."""
        if self._size == 0:
            raise ValueError("empty replay buffer")
        if self._tree is None:
            idx = self._rng.integers(0, self._size, batch_size)
            weights = np.ones(batch_size, np.float32)
        else:
            idx = self._tree.sample(batch_size, self._rng)
            idx = np.clip(idx, 0, self._size - 1)
            probs = self._tree.get(idx) / max(self._tree.total, 1e-12)
            weights = (self._size * np.maximum(probs, 1e-12)) ** (-self.beta)
            weights = (weights / weights.max()).astype(np.float32)
        batch = {k: v[idx] for k, v in self._storage.items()}
        return batch, idx, weights

    def update_priorities(self, idx: np.ndarray,
                          td_errors: np.ndarray) -> None:
        if self._tree is None:
            return
        p = np.abs(np.asarray(td_errors, np.float64)) + self.priority_eps
        self._max_priority = max(self._max_priority, float(p.max()))
        self._tree.set(idx, p ** self.alpha)

    # --------------------------------------------------- checkpoint state

    def state_dict(self, max_transitions: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
        """The newest ``max_transitions`` transitions in insertion order
        (None = everything). Priorities are not persisted: restored
        experience re-enters at max priority, exactly like fresh
        experience (reference: replay checkpointing keeps content, and
        one pass of TD updates re-establishes the priority profile)."""
        if self._storage is None or self._size == 0:
            return {"batch": None}
        n = self._size if max_transitions is None \
            else min(self._size, int(max_transitions))
        idx = (self._next - n + np.arange(n)) % self.capacity
        return {"batch": {k: v[idx].copy()
                          for k, v in self._storage.items()}}

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        batch = state.get("batch")
        if batch is not None and len(next(iter(batch.values()))):
            self.add(batch)
