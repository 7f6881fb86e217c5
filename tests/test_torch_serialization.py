"""The port's object framing and shared-memory store held against the JAX
package's on the CPU.

numpy payloads frame byte for byte as in ``ray_tpu.core.serialization``,
and each package reads the other's frames. Torch tensors (which the JAX
package pickles in band) travel as dtype, shape and one out-of-band buffer
of raw bytes, and come back as CPU tensors that view the frame: values and
dtypes intact for float32, bf16, int64, a non-contiguous view, a 0-d and
an empty tensor. Refs nested in a frame are captured. The port's
``ShmStore`` (its own copy of the C++ source, built into
``ray_tpu_torch/_build/``) gives the JAX package's store's results on one
seeded sequence of creates, puts, gets, pins, evictions and deletes."""

import numpy as np
import pytest
import torch

from ray_tpu.core import serialization as jser
from ray_tpu_torch.core import serialization as tser


def _numpy_payloads():
    rng = np.random.default_rng(0)
    return [
        {"a": rng.standard_normal((64, 33)).astype(np.float32),
         "b": np.arange(10, dtype=np.int64), "tag": "x", "n": 3},
        [rng.integers(0, 255, 4096, dtype=np.uint8), 1.5, None, (2, "y")],
        rng.standard_normal((3, 5, 7)),
        np.zeros((0, 4), np.float16),
        {"nested": {"deep": [np.ones(7, np.bool_)]}},
    ]


@pytest.mark.parametrize("i", range(5))
def test_numpy_frames_equal_and_cross_read(i):
    value = _numpy_payloads()[i]
    jf, tf = jser.serialize(value), tser.serialize(value)
    assert jf == tf
    for reader, frame in ((tser, jf), (jser, tf)):
        got = reader.deserialize(frame)
        assert repr(got) == repr(value)


def _tensors():
    g = torch.Generator().manual_seed(0)
    base = torch.randn(6, 8, generator=g)
    return {
        "f32": base,
        "bf16": base.to(torch.bfloat16),
        "i64": torch.randint(-2**40, 2**40, (17,), generator=g),
        "strided": base[:, ::3].t(),
        "scalar": torch.tensor(2.5),
        "empty": torch.empty(0, 3, dtype=torch.bfloat16),
        "grad": torch.randn(4, generator=g, requires_grad=True),
    }


@pytest.mark.parametrize("name", sorted(_tensors()))
def test_tensor_round_trip(name):
    t = _tensors()[name]
    got = tser.deserialize(tser.serialize({"t": t, "meta": name}))
    assert got["meta"] == name
    out = got["t"]
    assert out.dtype == t.dtype and out.shape == t.shape
    assert out.device.type == "cpu" and not out.requires_grad
    assert torch.equal(out, t.detach())
    assert out.is_contiguous()


def test_reader_tensor_views_the_frame():
    """The tensor's bytes travel out of band, and the reader's tensor
    points into the frame itself: no copy on read."""
    t = torch.randn(1 << 16).to(torch.bfloat16)
    frame = tser.serialize(t)
    assert len(frame) < t.numel() * 2 + 4096  # bytes once, not twice
    buf = np.frombuffer(frame, np.uint8)
    lo = buf.ctypes.data
    got = tser.deserialize(frame)
    assert lo <= got.data_ptr() < lo + len(frame)
    assert torch.equal(got, t)


def test_nested_refs_are_captured():
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.object_ref import ObjectRef

    refs = [ObjectRef(ObjectID.from_random()) for _ in range(3)]
    value = {"k": refs[0], "deep": [torch.ones(3), (refs[1], {"v": refs[2]})]}
    with tser.capture_refs() as held:
        frame = tser.serialize(value)
    assert sorted(r.hex() for r in held) == sorted(r.hex() for r in refs)
    got = tser.deserialize(frame)
    assert got["deep"][1][1]["v"] == refs[2]
    assert torch.equal(got["deep"][0], torch.ones(3))


def test_no_torch_import_for_plain_values():
    """A process that pickles no tensor never loads torch: the reducer
    reads ``sys.modules`` and the reader imports torch only to rebuild a
    tensor."""
    import subprocess
    import sys

    code = ("import sys\n"
            "from ray_tpu_torch.core import serialization as s\n"
            "import numpy as np\n"
            "v = s.deserialize(s.serialize({'a': np.arange(5), 'b': 'x'}))\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


def _store_trace(store_cls, path):
    """Results of one seeded op sequence on a fresh 1 MiB store."""
    rng = np.random.default_rng(7)
    store = store_cls.create(path, 1 << 20)
    live, views, pins, out = [], [], [], []
    try:
        for step in range(300):
            op = rng.choice(["put", "put_pin", "create", "get", "unpin",
                             "delete", "contains"],
                            p=[0.3, 0.1, 0.1, 0.2, 0.1, 0.1, 0.1])
            if op in ("put", "put_pin") or not live:
                oid = rng.bytes(16)
                n = int(rng.integers(1, 200_000))
                payload = rng.bytes(n)
                r = store.put_bytes(oid, payload, pin=(op == "put_pin"))
                if r is not None:
                    live.append(oid)
                    if op == "put_pin":
                        pins.append(r)
                out.append(("put", r is not None))
            elif op == "create":
                oid = rng.bytes(16)
                n = int(rng.integers(1, 50_000))
                buf = store.create_buffer(oid, n)
                if buf is not None:
                    buf[:] = bytes([step % 251]) * n
                    buf.release()
                    store.seal(oid)
                    live.append(oid)
                out.append(("create", buf is not None))
            elif op == "get":
                oid = live[int(rng.integers(len(live)))]
                v = store.get_view(oid)
                out.append(("get", None if v is None else
                            (len(v.data), bytes(v.data[:8]))))
                if v is not None:
                    views.append(v)
            elif op == "unpin":
                if views:
                    views.pop(int(rng.integers(len(views)))).release()
                elif pins:
                    pins.pop().release()
                out.append(("unpin",))
            elif op == "delete":
                oid = live.pop(int(rng.integers(len(live))))
                out.append(("delete", store.delete(oid)))
            else:
                oid = live[int(rng.integers(len(live)))]
                out.append(("contains", store.contains(oid)))
            out.append((store.used_bytes(), store.num_objects()))
    finally:
        for v in views:
            v.release()
        for p in pins:
            p.release()
        store.close()
    return out


def test_shm_store_matches_jax_store(tmp_path):
    from ray_tpu._native.objstore import ShmStore as JaxStore
    from ray_tpu_torch._native.objstore import ShmStore as TorchStore

    want = _store_trace(JaxStore, str(tmp_path / "jax.store"))
    got = _store_trace(TorchStore, str(tmp_path / "port.store"))
    assert got == want
    # the sequence reached eviction: a live object stopped being there
    assert ("get", None) in got or ("contains", False) in got


@pytest.mark.parametrize("dest", ["bytearray", "mmap"])
def test_large_buffers_frame_as_small_ones(dest):
    """Buffers above the GIL-free copy's threshold land in the frame byte
    for byte as the JAX package frames them, whether the frame is a
    bytearray or a memoryview of an mmap (the shm store's and the spill
    file's case); the other package reads them back."""
    import mmap

    rng = np.random.default_rng(1)
    big = rng.standard_normal(3 * tser._GIL_FREE_COPY_BYTES // 8)
    value = {"big": big, "small": np.arange(7), "odd": big[1:].copy()}
    total, write = tser.build_frame(value)
    if dest == "bytearray":
        out = bytearray(total)
        write(out)
        frame = bytes(out)
    else:
        with mmap.mmap(-1, total) as m:
            write(memoryview(m))
            frame = bytes(m)
    assert frame == jser.serialize(value)
    got = jser.deserialize(frame)
    assert all(np.array_equal(got[k], value[k]) for k in value)
    t = torch.from_numpy(big).to(torch.bfloat16)
    assert torch.equal(tser.deserialize(tser.serialize(t)), t)


def test_large_copy_leaves_the_gil_to_other_threads():
    """While a large buffer is copied into its frame, the process's other
    threads run: the longest pause of a ticking thread during the write
    is a small part of the write. A copy under the GIL stalled a driver's
    controller and its gang monitor for seconds when it put a multi-GB
    stage state. Timed on a shared host, so the best of three writes
    counts; a copy that holds the GIL pauses the ticker for all of it."""
    import threading
    import time

    total, write = tser.build_frame(torch.ones(64 << 20, dtype=torch.uint8))
    best = float("inf")
    for _ in range(3):
        out = bytearray(total)
        ticks, stop = [], threading.Event()

        def tick():
            while not stop.is_set():
                ticks.append(time.perf_counter())
                time.sleep(0.0005)

        th = threading.Thread(target=tick)
        th.start()
        while not ticks:
            time.sleep(0.001)
        t0 = time.perf_counter()
        write(out)
        t1 = time.perf_counter()
        stop.set()
        th.join()
        edges = [t0] + [x for x in ticks if t0 < x < t1] + [t1]
        pause = max(b - a for a, b in zip(edges, edges[1:]))
        best = min(best, pause / (t1 - t0))
        del out
    assert best < 0.5, best
