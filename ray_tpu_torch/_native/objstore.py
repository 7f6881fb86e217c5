"""ctypes bindings for the C++ shared-memory object store.

Client-side analogue of the reference's ``plasma/client.cc``: create/seal for
writers, zero-copy pinned views for readers. A view pins its object in the
store until released (the reference pins via client-connection bookkeeping;
here the pin is an explicit refcount dropped by ``ShmView.release`` or GC).
"""

from __future__ import annotations

import ctypes
import mmap
import os
import threading
from typing import Optional

from ray_tpu_torch._native.build import build_library

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = build_library("shm_store", ["shm_store.cpp"])
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        # A prebuilt .so that doesn't load on THIS host (e.g. linked
        # against a newer glibc) is stale regardless of mtime: rebuild
        # from source with the local toolchain and retry.
        try:
            os.remove(path)
        except OSError:
            pass
        path = build_library("shm_store", ["shm_store.cpp"])
        lib = ctypes.CDLL(path)
    lib.shm_store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                     ctypes.c_uint64]
    lib.shm_store_create.restype = ctypes.c_int
    lib.shm_store_open.argtypes = [ctypes.c_char_p]
    lib.shm_store_open.restype = ctypes.c_void_p
    lib.shm_store_close.argtypes = [ctypes.c_void_p]
    lib.shm_store_base.argtypes = [ctypes.c_void_p]
    lib.shm_store_base.restype = ctypes.c_void_p
    lib.shm_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_uint64]
    lib.shm_create.restype = ctypes.c_uint64
    lib.shm_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.shm_seal.restype = ctypes.c_int
    lib.shm_seal2.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_int]
    lib.shm_seal2.restype = ctypes.c_int
    lib.shm_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
    lib.shm_get.restype = ctypes.c_uint64
    lib.shm_unpin.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.shm_unpin.restype = ctypes.c_int
    lib.shm_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.shm_contains.restype = ctypes.c_int
    lib.shm_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.shm_delete.restype = ctypes.c_int
    lib.shm_used_bytes.argtypes = [ctypes.c_void_p]
    lib.shm_used_bytes.restype = ctypes.c_uint64
    lib.shm_capacity.argtypes = [ctypes.c_void_p]
    lib.shm_capacity.restype = ctypes.c_uint64
    lib.shm_num_objects.argtypes = [ctypes.c_void_p]
    lib.shm_num_objects.restype = ctypes.c_uint64
    _lib = lib
    return lib


class ShmView:
    """A pinned, zero-copy readable view of a sealed object."""

    def __init__(self, store: "ShmStore", object_id: bytes, mv: memoryview):
        self._store = store
        self._object_id = object_id
        self.data = mv
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self.data = None
            self._store._unpin(self._object_id)

    def __del__(self):
        try:
            self.release()
        except Exception:  # graftlint: disable=swallowed-exception (interpreter-teardown __del__)
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class ShmPin:
    """A primary-copy pin taken at put time (no data view). Released by the
    owner when the object leaves scope; keeps LRU eviction away from the
    only copy of a live object."""

    def __init__(self, store: "ShmStore", object_id: bytes):
        self._store = store
        self._object_id = object_id
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._store._unpin(self._object_id)

    def __del__(self):
        try:
            self.release()
        except Exception:  # graftlint: disable=swallowed-exception (interpreter-teardown __del__)
            pass


class StoreClosedError(RuntimeError):
    """A write reached a store that ``close()`` already released."""


class ShmStore:
    """One per process per store file; all methods thread-safe (locking lives
    in the C++ layer).

    Every call that hands the C library the store handle takes
    ``self._lock``, which ``close()`` takes too, and checks the handle under
    it: after ``close`` no call reaches the library with a null or freed
    handle. Reads and deletes then return their empty value (``None``,
    ``False``, 0); writes raise :class:`StoreClosedError`. Payload copies
    run outside the lock."""

    def __init__(self, path: str):
        self._lib = _load()
        self.path = path
        self._lock = threading.Lock()
        self._handle = self._lib.shm_store_open(path.encode())
        if not self._handle:
            raise OSError(f"cannot open shm store at {path}")
        # Re-map read-write through Python mmap for zero-copy memoryviews
        # (the C++ mapping isn't exposed as a buffer).
        self._fd = os.open(path, os.O_RDWR)
        size = os.fstat(self._fd).st_size
        self._map = mmap.mmap(self._fd, size)
        self._mv = memoryview(self._map)

    @staticmethod
    def create(path: str, capacity: int, n_slots: int = 0) -> "ShmStore":
        lib = _load()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        rc = lib.shm_store_create(path.encode(), capacity, n_slots)
        if rc != 0:
            raise OSError(f"shm_store_create({path}) failed: {rc}")
        return ShmStore(path)

    def _call(self, fn, *args, closed=None):
        """``fn(handle, *args)`` under the lock, or ``closed`` once the
        store is closed."""
        with self._lock:
            if not self._handle:
                return closed
            return fn(self._handle, *args)

    def _write_call(self, fn, *args):
        with self._lock:
            if not self._handle:
                raise StoreClosedError(f"shm store {self.path} is closed")
            return fn(self._handle, *args)

    # ------------------------------------------------------------ writer

    def put_bytes(self, object_id: bytes, payload, pin: bool = False):
        """Create + copy + seal. Returns None when the store can't fit it;
        otherwise True, or a ShmPin when ``pin`` (the primary-copy pin the
        owner must hold until the object is freed)."""
        n = len(payload)
        off = self._write_call(self._lib.shm_create, object_id, n)
        if off == 0:
            return None
        self._mv[off:off + n] = payload
        self._write_call(self._lib.shm_seal2, object_id, 1 if pin else 0)
        return ShmPin(self, object_id) if pin else True

    def create_buffer(self, object_id: bytes, size: int):
        """Reserve a writable buffer; caller fills it then calls seal()."""
        off = self._write_call(self._lib.shm_create, object_id, size)
        if off == 0:
            return None
        return self._mv[off:off + size]

    def seal(self, object_id: bytes, pin: bool = False):
        """Seal a buffer created via create_buffer; with ``pin`` the primary
        copy stays unevictable and the returned ShmPin must be held."""
        if pin:
            self._write_call(self._lib.shm_seal2, object_id, 1)
            return ShmPin(self, object_id)
        self._write_call(self._lib.shm_seal, object_id)
        return None

    # ------------------------------------------------------------ reader

    def get_view(self, object_id: bytes) -> Optional[ShmView]:
        size = ctypes.c_uint64()
        with self._lock:
            if not self._handle:
                return None
            off = self._lib.shm_get(self._handle, object_id,
                                    ctypes.byref(size), 1)
            if off == 0:
                return None
            # Sliced under the lock: close() releases ``_mv``.
            mv = self._mv[off:off + size.value]
        return ShmView(self, object_id, mv)

    def contains(self, object_id: bytes) -> bool:
        return bool(self._call(self._lib.shm_contains, object_id,
                               closed=0))

    def _unpin(self, object_id: bytes) -> None:
        self._call(self._lib.shm_unpin, object_id)

    def delete(self, object_id: bytes) -> bool:
        return self._call(self._lib.shm_delete, object_id, closed=-1) == 0

    # ------------------------------------------------------------- stats

    def used_bytes(self) -> int:
        return self._call(self._lib.shm_used_bytes, closed=0)

    def capacity(self) -> int:
        return self._call(self._lib.shm_capacity, closed=0)

    def num_objects(self) -> int:
        return self._call(self._lib.shm_num_objects, closed=0)

    def close(self) -> None:
        with self._lock:
            if not self._handle:
                return
            handle, self._handle = self._handle, None
            self._lib.shm_store_close(handle)
            self._mv.release()
            try:
                self._map.close()
            except BufferError:
                # A live view still exports the mapping; it unmaps when
                # the last view goes.
                pass
            os.close(self._fd)
