"""Distributed FIFO queue backed by an actor (copy of
``ray_tpu/util/queue.py``).

Analogue of the reference's ``ray.util.queue.Queue``: a named-actor-backed
queue usable from any process in the cluster.
"""

from __future__ import annotations

import collections
import time
from typing import Any, List, Optional

import ray_tpu_torch


class _QueueActor:
    def __init__(self, maxsize: int):
        self._maxsize = maxsize
        self._items = collections.deque()

    def put(self, item, block_token=None) -> bool:
        if self._maxsize > 0 and len(self._items) >= self._maxsize:
            return False
        self._items.append(item)
        return True

    def get_nowait(self):
        if not self._items:
            return (False, None)
        return (True, self._items.popleft())

    def qsize(self) -> int:
        return len(self._items)


class Empty(Exception):
    pass


class Full(Exception):
    pass


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        cls = ray_tpu_torch.remote(_QueueActor)
        self._actor = cls.options(num_cpus=0,
                                  **(actor_options or {})).remote(maxsize)

    def put(self, item, block: bool = True, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if ray_tpu_torch.get(self._actor.put.remote(item)):
                return
            if not block or (deadline and time.monotonic() > deadline):
                raise Full()
            time.sleep(0.02)

    def get(self, block: bool = True, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = ray_tpu_torch.get(self._actor.get_nowait.remote())
            if ok:
                return item
            if not block or (deadline and time.monotonic() > deadline):
                raise Empty()
            time.sleep(0.02)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0
