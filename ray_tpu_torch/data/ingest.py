"""Device-side ingest prefetch (port of ``ray_tpu/data/ingest.py``):
overlap host batch assembly and the host-to-device copy with the step.

A daemon thread pulls the next host batch (a dict tree of numpy arrays
or CPU tensors, as ``Dataset.iter_batches`` yields) and puts its device
copy on a bounded queue of ``max(1, prefetch)``; the consumer iterates
device batches in order.
An exception of the host iterator is raised on the consumer's side after
the batches before it. Without a mesh the JAX producer calls
``jax.device_put``, an asynchronous dispatch; on a CUDA device the
producer here does what that dispatch does:

* copies each leaf into a pinned host buffer from a ring of ``_RING``
  buffer sets, reused while the leaf's shape and dtype hold, and refilled
  only after the copy out of it has completed (its event);
* issues ``.to(device, non_blocking=True)`` for every leaf on a side CUDA
  stream, and records an event after the copies;
* the consumer makes its current stream wait on that event and calls
  ``record_stream`` on each tensor, so the caching allocator cannot hand
  the memory out again while the consumer's stream may still read it.

On ``device="cpu"`` the leaves become CPU tensors (copies), with no
stream. Dtypes follow the JAX package with x64 off for floats (float64
becomes float32) but keep int64, torch's index dtype, where JAX would
give int32 (ROADMAP.md queue 3). With a ``mesh`` each device batch is
then placed through ``parallel.train_step.shard_batch`` (batch over
``("data", "fsdp")``, on the consumer's side, after the wait: each rank
keeps its rows of the global batch), as the JAX producer's
``shard_batch`` does.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterator, List, Optional

import numpy as np
import torch

from ray_tpu_torch.core.device import resolve_device
from ray_tpu_torch.ops.optim import tree_leaves, tree_map

_SENTINEL = object()
# Pinned buffer sets: one fills while the copy out of the other runs.
_RING = 2


def _host_tensor(x) -> torch.Tensor:
    """A leaf (numpy array, scalar or CPU tensor) as a CPU tensor, sharing
    its memory where the layout allows."""
    if isinstance(x, (list, tuple)):
        raise TypeError(f"a batch is a dict tree of arrays; got a "
                        f"{type(x).__name__} leaf")
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.c_contiguous else a.copy())


def _device_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype a leaf lands in: float64 becomes float32 (JAX with x64
    off); everything else, int64 included, keeps its dtype."""
    return torch.float32 if t.dtype == torch.float64 else t.dtype


class DevicePrefetch:
    """Iterator of device batches over ``host_batches``, with up to
    ``prefetch`` batches in flight (``device_prefetch`` builds it). The
    producer thread starts at the first ``next``, as the JAX generator's
    does. ``stats()`` reads the consumer's waits and, on a card, the
    copies' bytes and times."""

    def __init__(self, host_batches, device: torch.device, prefetch: int,
                 mesh=None, rules=None):
        self.device = device
        self._mesh, self._rules = mesh, rules
        self._host = host_batches
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(prefetch)))
        self._err: list = []
        self._thread: Optional[threading.Thread] = None
        self._cuda = device.type == "cuda"
        self._stream = None          # the producer's side stream
        self._ring: list = [{"spec": None, "bufs": [], "free": None}
                            for _ in range(_RING)]
        self._copies: list = []      # (start, end, nbytes) events per batch
        self.pinned_allocs = 0
        self.wait_s: List[float] = []

    def __iter__(self) -> "DevicePrefetch":
        return self

    def __next__(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._produce,
                                            daemon=True,
                                            name="device-prefetch")
            self._thread.start()
        t0 = time.perf_counter()
        item = self._q.get()
        if item is _SENTINEL:
            self._q.put(_SENTINEL)     # a later next() stops again
            err, self._err = self._err, []
            if err:
                raise err[0]
            raise StopIteration
        self.wait_s.append(time.perf_counter() - t0)
        if self._cuda:
            batch, leaves, done = item
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in leaves:
                t.record_stream(stream)
        else:
            batch = item
        if self._mesh is None:
            return batch
        from ray_tpu_torch.parallel.train_step import shard_batch

        return shard_batch(batch, self._mesh, self._rules)

    # ------------------------------------------------------------ producer

    def _produce(self) -> None:
        try:
            if self._cuda:
                torch.cuda.set_device(self.device)
                self._stream = torch.cuda.Stream(self.device)
            for i, b in enumerate(self._host):
                self._q.put(self._to_cuda(b, self._ring[i % _RING])
                            if self._cuda else self._to_cpu(b))
        except BaseException as e:  # surfaced on the consumer side
            self._err.append(e)
        finally:
            self._q.put(_SENTINEL)

    def _to_cpu(self, batch):
        def copy(x):
            t = _host_tensor(x)
            return t.to(_device_dtype(t), copy=True)

        return tree_map(copy, batch)

    def _to_cuda(self, batch, slot: dict):
        srcs = [_host_tensor(x) for x in tree_leaves(batch)]
        spec = [(t.shape, _device_dtype(t)) for t in srcs]
        if slot["free"] is not None:
            slot["free"].synchronize()   # the last copy out of this set
        if slot["spec"] != spec:
            slot["bufs"] = [torch.empty(shape, dtype=dt, pin_memory=True)
                            for shape, dt in spec]
            slot["spec"] = spec
            self.pinned_allocs += len(spec)
        for buf, t in zip(slot["bufs"], srcs):
            buf.copy_(t)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._stream):
            start.record()
            out = [b.to(self.device, non_blocking=True)
                   for b in slot["bufs"]]
            done.record()
        slot["free"] = done
        self._copies.append((start, done, sum(
            b.numel() * b.element_size() for b in slot["bufs"])))
        it = iter(out)
        return tree_map(lambda _: next(it), batch), out, done

    # --------------------------------------------------------------- stats

    def stats(self) -> dict:
        """The consumer's wait on the queue per batch (seconds), and on a
        card each batch's copy: bytes, milliseconds between events on the
        side stream around it (this waits for the copies), the rate, and
        whether every pinned buffer is pinned and the stream is not the
        default one."""
        out = {"batches": len(self.wait_s), "wait_s": list(self.wait_s)}
        if not self._cuda:
            return out
        for _, done, _ in self._copies:
            done.synchronize()
        ms = [s.elapsed_time(d) for s, d, _ in self._copies]
        nbytes = [n for _, _, n in self._copies]
        bufs = [b for slot in self._ring for b in slot["bufs"]]
        out.update(
            copy_bytes=nbytes, copy_ms=ms,
            h2d_gb_per_s=(sum(nbytes) / (sum(ms) * 1e6) if sum(ms) else None),
            pinned=bool(bufs) and all(b.is_pinned() for b in bufs),
            pinned_allocs=self.pinned_allocs,
            side_stream=(self._stream is not None and self._stream
                         != torch.cuda.default_stream(self.device)))
        return out


def device_prefetch(host_batches: Iterator[Any], mesh=None, rules=None,
                    prefetch: int = 2, device=None) -> DevicePrefetch:
    """Wrap a host-batch iterator into a device-batch iterator with
    ``prefetch`` batches in flight on ``device`` (``cuda`` unless the
    caller passes another; without a card ``None`` raises). With
    ``mesh`` the device is this rank's on the mesh, and each batch lands
    batch-sharded through ``shard_batch(batch, mesh, rules)``."""
    if mesh is not None:
        from ray_tpu_torch.parallel.sharding import mesh_device

        dev = mesh_device(mesh)
    else:
        dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return DevicePrefetch(host_batches, dev, prefetch, mesh, rules)
