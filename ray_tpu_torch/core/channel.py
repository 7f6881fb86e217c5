"""Mutable shared-memory ring channels for compiled-DAG edges (copy of
``ray_tpu/core/channel.py``, with the same header and ring protocol).

Analogue of the reference's experimental mutable plasma objects
(``src/ray/core_worker/experimental_mutable_object_manager.h``) with the
BUFFERED semantics of its shared-memory channels
(``python/ray/experimental/channel/shared_memory_channel.py:169``): a
small ring of fixed-size memory-mapped slots per pipeline edge, each
REWRITTEN in turn instead of allocating new immutable objects — repeated
graph execution becomes allocation-free shared-memory handoff, and the
ring depth (default 3) lets the writer run up to N-1 items ahead of the
reader's ack, overlapping stage compute with transfer (the 1F1B pipeline
case; a 1-deep channel serializes handoff with compute).

Protocol (single writer, single reader, same host):

* header: ``write_seq`` (items written), ``read_ack`` (items consumed),
  ``nslots``, ``slot_capacity``, then per-slot payload lengths — 8-byte
  aligned fields; slot payloads follow at ``HEADER + i * slot_capacity``.
* writer: wait until ``write_seq - read_ack < nslots`` (a slot is free),
  serialize the value straight into slot ``write_seq % nslots``
  (``serialization.build_frame`` — one copy), publish the slot's length
  then ``write_seq + 1``.
* reader: wait until ``write_seq > read_ack``, deserialize zero-copy from
  slot ``read_ack % nslots`` (numpy views point into the slot), and
  ``ack`` AFTER the stage function consumed the value — the writer can't
  overwrite a slot whose item is still being read (the reference's
  writer/reader semaphores), but CAN fill the other slots meanwhile.

Waiting is micro-sleep polling: on one host the uncontended round-trip is
microseconds; a futex-free design keeps the file format trivial and
robust to either side dying (the survivor times out). Payloads larger
than a slot fall back to the RPC push path at the call site
(``dag._PipeStage``), as do cross-node edges.
"""

from __future__ import annotations

import mmap
import os
import struct
import time
from typing import Any, Optional, Tuple

HEADER_SIZE = 64  # one cache line: u64 @ 0/8/16/24 + 4 slot lengths @ 32+
MAX_SLOTS = 4     # slot-length array must fit in the header line


class ChannelTimeout(Exception):
    pass


class ChannelClosed(Exception):
    pass


class MutableChannel:
    """One endpoint of a ring-buffered mutable channel over an mmap'd
    file. ``capacity`` is PER SLOT; the creator fixes ``nslots`` (1-4,
    default ``config.dag_channel_slots``) and the opener reads both from
    the header."""

    def __init__(self, path: str, create: bool = False,
                 capacity: int = 8 << 20, nslots: Optional[int] = None):
        self.path = path
        if create:
            if nslots is None:
                from ray_tpu_torch.core.config import config

                nslots = config.dag_channel_slots
            nslots = max(1, min(MAX_SLOTS, int(nslots)))
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "wb") as f:
                f.truncate(HEADER_SIZE + nslots * capacity)
                f.seek(16)
                f.write(struct.pack("<QQ", nslots, capacity))
            os.rename(tmp, path)
        with open(path, "r+b") as f:
            size = os.fstat(f.fileno()).st_size
            self._map = mmap.mmap(f.fileno(), size)
        self.nslots = struct.unpack_from("<Q", self._map, 16)[0]
        self.capacity = struct.unpack_from("<Q", self._map, 24)[0]
        self._closed = False

    # ------------------------------------------------------------- header

    def _load(self, off: int) -> int:
        return struct.unpack_from("<Q", self._map, off)[0]

    def _store(self, off: int, value: int) -> None:
        struct.pack_into("<Q", self._map, off, value)

    @property
    def write_seq(self) -> int:
        return self._load(0)

    @property
    def read_ack(self) -> int:
        return self._load(8)

    # ------------------------------------------------------------- writer

    def write(self, value: Any,
              timeout: Optional[float] = 60.0) -> bool:
        """Serialize ``value`` into the slot; returns False when it does
        not fit (caller falls back to RPC). Blocks while the previous item
        is unconsumed."""
        from ray_tpu_torch.core import serialization

        total, write_fn = serialization.build_frame(value)
        if total > self.capacity:
            return False
        self.write_frame(total, write_fn, timeout)
        return True

    def write_frame(self, total: int, write_fn,
                    timeout: Optional[float] = 60.0) -> None:
        """Low-level write of an already-built frame (callers that must
        size-check before committing — the DAG stage builds the frame
        ONCE and reuses it for the RPC fallback when it doesn't fit).
        ``timeout=None`` waits indefinitely: a full ring is backpressure
        from a slow consumer, not a failure — only ``close()`` (teardown)
        breaks the wait."""
        self._wait(lambda: self.write_seq - self.read_ack < self.nslots,
                   timeout, "reader fell a full ring behind")
        slot = self.write_seq % self.nslots
        off = HEADER_SIZE + slot * self.capacity
        write_fn(memoryview(self._map)[off:off + total])
        self._store(32 + 8 * slot, total)
        # Publish AFTER the payload lands (x86 TSO keeps store order
        # visible across processes).
        self._store(0, self.write_seq + 1)

    # ------------------------------------------------------------- reader

    def read(self, timeout: float = 60.0) -> memoryview:
        """Wait for the next item; returns a zero-copy view of its slot.
        The caller MUST ``ack()`` when done with the view (and anything
        deserialized from it) — until then the writer cannot reuse THIS
        slot (it may still fill the ring's other slots)."""
        self._wait(lambda: self.write_seq > self.read_ack, timeout,
                   "no item arrived")
        slot = self.read_ack % self.nslots
        length = self._load(32 + 8 * slot)
        off = HEADER_SIZE + slot * self.capacity
        return memoryview(self._map)[off:off + length]

    def ack(self) -> None:
        self._store(8, self.read_ack + 1)

    # ------------------------------------------------------------ plumbing

    def _wait(self, cond, timeout: float, what: str) -> None:
        """Micro-sleep polling, NO hot spin: a Python spin loop holds the
        GIL and (on small hosts) the only core, starving the very peer it
        is waiting for — measured 2x slower end-to-end than sleeping."""
        try:
            if cond():
                return
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            while not cond():
                if self._closed:
                    raise ChannelClosed(self.path)
                if deadline is not None and time.monotonic() > deadline:
                    raise ChannelTimeout(f"{self.path}: {what}")
                time.sleep(0.0002)
        except ValueError as e:  # mmap closed mid-wait (teardown race)
            raise ChannelClosed(self.path) from e

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._map.close()
            except (BufferError, ValueError):
                pass  # exported views still alive; the map dies with us

    def unlink(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


def channel_path(channel_id: str) -> str:
    """Deterministic path both endpoints derive (same host), under the
    port's own name: ``<object_store_fallback_dir>/ray_tpu_torch/
    channels``."""
    from ray_tpu_torch.core.config import config

    d = os.path.join(config.object_store_fallback_dir, "ray_tpu_torch",
                     "channels")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{channel_id}.chan")
