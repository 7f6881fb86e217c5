"""Dynamic request batching with TPU-friendly size bucketing.

Analogue of the reference's ``serve/batching.py`` (``@serve.batch``): calls
accumulate until ``max_batch_size`` or ``batch_wait_timeout_s``, then one
batched invocation serves them all. TPU adaptation: ``pad_to_buckets`` pads
each batch up to the nearest bucket size so a jitted model sees only a few
static shapes (each new shape is an XLA recompile — the reference's
dynamic batch sizes are hostile to TPU serving, SURVEY §7 hard part 5).
"""

from __future__ import annotations

import functools
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence


class _BatchQueue:
    def __init__(self, fn, max_batch_size: int, timeout_s: float,
                 buckets: Optional[Sequence[int]]):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = timeout_s
        self.buckets = sorted(buckets) if buckets else None
        self._lock = threading.Lock()
        self._pending: List[tuple] = []  # (item, Future)
        self._timer: Optional[threading.Timer] = None

    def submit(self, instance, item) -> Future:
        fut: Future = Future()
        flush = False
        with self._lock:
            self._pending.append((item, fut))
            if len(self._pending) >= self.max_batch_size:
                flush = True
            elif self._timer is None:
                self._timer = threading.Timer(
                    self.timeout_s, self._flush, args=(instance,))
                self._timer.daemon = True
                self._timer.start()
        if flush:
            self._flush(instance)
        return fut

    def _flush(self, instance) -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            batch, self._pending = self._pending, []
        if not batch:
            return
        items = [b[0] for b in batch]
        futures = [b[1] for b in batch]
        n = len(items)
        padded = items
        if self.buckets:
            target = next((b for b in self.buckets if b >= n),
                          self.buckets[-1])
            while len(padded) < target:
                padded = padded + [items[-1]]
        try:
            if instance is not None:
                results = self.fn(instance, padded)
            else:
                results = self.fn(padded)
            for fut, result in zip(futures, results[:n]):
                fut.set_result(result)
        except BaseException as e:  # noqa: BLE001
            for fut in futures:
                fut.set_exception(e)


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01,
          pad_to_buckets: Optional[Sequence[int]] = None):
    """Decorator: the wrapped method receives a *list* of requests and must
    return a list of responses of the same length (padding excluded)."""

    def wrap(fn):
        # The queue holds locks/timers, so it must be created lazily inside
        # the replica process (the decorated class is pickled to replicas).
        attr = f"__batch_queue_{fn.__name__}"

        @functools.wraps(fn)
        def wrapper(self, item):
            queue = getattr(self, attr, None)
            if queue is None:
                # dict.setdefault is atomic under the GIL: concurrent first
                # calls converge on one queue (no unpicklable lock captured).
                queue = self.__dict__.setdefault(
                    attr, _BatchQueue(fn, max_batch_size,
                                      batch_wait_timeout_s, pad_to_buckets))
            return queue.submit(self, item).result()

        wrapper.__ray_tpu_torch_batched__ = True
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
