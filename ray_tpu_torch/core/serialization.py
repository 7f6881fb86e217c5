"""Object serialization with zero-copy buffer framing (copy of
``ray_tpu/core/serialization.py``, plus a reducer for ``torch.Tensor``).

Analogue of the reference's serialization stack
(``python/ray/_private/serialization.py`` + the cloudpickle fork +
pickle-protocol-5 out-of-band buffers): values are pickled with
``protocol=5`` and a ``buffer_callback`` so large contiguous payloads are
captured as separate buffers rather than copied into the pickle stream. The
framed layout below is what lands in the shared-memory object store;
deserialization builds arrays that *view* the store's mmap directly
(zero-copy).

Tensors: a ``torch.Tensor`` is staged to the host (a CUDA tensor is copied
to the CPU, as the JAX package host-stages a ``jax.Array``) and travels as
its dtype name, its shape and its raw bytes as one out-of-band buffer; bf16
has no numpy dtype, so the bytes are never routed through numpy's. The
reader rebuilds a CPU tensor over that buffer with ``torch.frombuffer``: a
view of the store's mmap, no copy. A reader without a card can therefore
read a tensor a GPU worker wrote. The view is read-only by contract, as the
numpy arrays over a sealed object are: it shares the sealed object's bytes.
Autograd state is not carried (the tensor is detached). Torch is never
imported here: a process that pickles no tensor never loads it.

Frame layout (little-endian u64s, buffers 64-byte aligned for safe array
views)::

    u64 npickle | u64 nbuf | (u64 offset, u64 len) * nbuf | pickle | pad | buf0 | pad | buf1 ...
"""

from __future__ import annotations

import contextlib
import io
import pickle
import struct
import sys
import threading
import warnings
from typing import Any, List, Tuple

import cloudpickle

_ALIGN = 64
_U64 = struct.Struct("<Q")

# Nested-ObjectRef capture: while a capture is active on this thread, every
# ObjectRef pickled (at any nesting depth) is recorded. The runtime pins
# those refs for as long as the serialized frame is alive, so an object
# reachable only through a stored/in-flight frame can't be freed (reference:
# ReferenceCounter tracking refs found at serialization time,
# reference_count.h:61).
_capture = threading.local()


@contextlib.contextmanager
def capture_refs():
    prev = getattr(_capture, "refs", None)
    _capture.refs = []
    try:
        yield _capture.refs
    finally:
        _capture.refs = prev


def record_serialized_ref(ref) -> None:
    refs = getattr(_capture, "refs", None)
    if refs is not None:
        refs.append(ref)


def _reduce_tensor(obj):
    """Pickle reduction of a strided ``torch.Tensor``: (dtype name, shape,
    raw bytes as a ``PickleBuffer``), or ``NotImplemented`` for anything
    else (sparse and quantized tensors keep torch's own reduction)."""
    torch = sys.modules.get("torch")
    if (torch is None or not isinstance(obj, torch.Tensor)
            or obj.layout != torch.strided or obj.is_quantized):
        return NotImplemented
    t = obj.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.resolve_conj().resolve_neg().contiguous()
    dtype = str(t.dtype).removeprefix("torch.")
    shape = tuple(t.shape)
    if t.numel() == 0:
        return _rebuild_tensor, (b"", dtype, shape)
    raw = t.reshape(-1).view(torch.uint8).numpy()
    return _rebuild_tensor, (pickle.PickleBuffer(raw), dtype, shape)


def _rebuild_tensor(buf, dtype: str, shape: Tuple[int, ...]):
    """A CPU tensor over ``buf`` (the frame's out-of-band buffer: a view
    of the store's mmap when the frame lives there)."""
    import torch

    dt = getattr(torch, dtype)
    if len(memoryview(buf)) == 0:
        return torch.empty(shape, dtype=dt)
    with warnings.catch_warnings():
        # A sealed object's buffer is read-only; torch warns that the
        # tensor it builds over one is not.
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(buf, dtype=dt).reshape(shape)


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj):
        return _reduce_tensor(obj)


class _CloudPickler(cloudpickle.Pickler):
    def reducer_override(self, obj):
        rv = _reduce_tensor(obj)
        if rv is NotImplemented:
            return super().reducer_override(obj)
        return rv


def _dumps(pickler_cls, value: Any, buffers: List[pickle.PickleBuffer]):
    out = io.BytesIO()
    pickler_cls(out, protocol=5, buffer_callback=buffers.append).dump(value)
    return out.getvalue()


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


# A buffer at least this large is copied into its frame by numpy, which
# releases the GIL while it copies. A memoryview slice assignment holds
# the GIL for the whole copy: putting a multi-GB state blob stalled every
# other thread of the process (the RPC reactor, the controller a driver
# hosts, a gang's liveness pings) for seconds, long enough for a gang
# monitor to declare a live member dead.
_GIL_FREE_COPY_BYTES = 1 << 20


def _copy_into(out, off: int, raw) -> None:
    """``out[off:off + raw.nbytes] = raw``, without the GIL for a large
    buffer."""
    if raw.nbytes < _GIL_FREE_COPY_BYTES:
        out[off:off + raw.nbytes] = raw
        return
    import numpy as np

    np.copyto(np.frombuffer(out, np.uint8, raw.nbytes, off),
              np.frombuffer(raw, np.uint8))


def build_frame(value: Any):
    """Pickle ``value`` (protocol 5, out-of-band buffers) and compute the
    frame layout WITHOUT materializing it. Returns ``(total_size, write)``
    where ``write(buf)`` fills any writable buffer of ``total_size`` bytes —
    letting callers serialize straight into the shared-memory store with one
    copy instead of three (build bytearray -> bytes() -> shm memcpy)."""
    buffers: List[pickle.PickleBuffer] = []
    try:
        payload = _dumps(_Pickler, value, buffers)
    except Exception:
        buffers = []
        payload = _dumps(_CloudPickler, value, buffers)
    raws = [b.raw() for b in buffers]
    header_size = 16 + 16 * len(raws)
    # Compute aligned offsets (relative to frame start).
    cursor = _align(header_size + len(payload))
    offsets: List[Tuple[int, int]] = []
    for raw in raws:
        offsets.append((cursor, raw.nbytes))
        cursor = _align(cursor + raw.nbytes)
    total = cursor if raws else header_size + len(payload)

    def write(out) -> None:
        out[0:8] = _U64.pack(len(payload))
        out[8:16] = _U64.pack(len(raws))
        pos = 16
        for off, ln in offsets:
            out[pos:pos + 8] = _U64.pack(off)
            out[pos + 8:pos + 16] = _U64.pack(ln)
            pos += 16
        out[pos:pos + len(payload)] = payload
        for raw, (off, _ln) in zip(raws, offsets):
            _copy_into(out, off, raw)

    return total, write


def serialize(value: Any) -> bytes:
    """Serialize ``value`` to the framed zero-copy layout."""
    total, write = build_frame(value)
    out = bytearray(total)
    write(out)
    return bytes(out)


def serialized_size(value: Any) -> int:
    """Size the framed serialization of ``value`` would occupy (by building it)."""
    return len(serialize(value))


def deserialize(frame) -> Any:
    """Deserialize a frame produced by :func:`serialize`.

    ``frame`` may be ``bytes`` or a ``memoryview`` over shared memory; in the
    latter case out-of-band buffers are zero-copy views into it.
    """
    view = memoryview(frame)
    npickle = _U64.unpack(view[0:8])[0]
    nbuf = _U64.unpack(view[8:16])[0]
    pos = 16
    bufs = []
    for _ in range(nbuf):
        off = _U64.unpack(view[pos:pos + 8])[0]
        ln = _U64.unpack(view[pos + 8:pos + 16])[0]
        bufs.append(view[off:off + ln])
        pos += 16
    payload = view[pos:pos + npickle]
    return pickle.loads(payload, buffers=bufs)


def dumps_function(fn) -> bytes:
    """Pickle a function/class for shipping to workers (cloudpickle: handles
    ``__main__``, closures, lambdas by value; importable modules by reference,
    resolvable on workers because the driver's ``sys.path`` is propagated —
    reference: ``python/ray/_private/function_manager.py``)."""
    return cloudpickle.dumps(fn, protocol=5)


def loads_function(blob: bytes):
    return pickle.loads(blob)
