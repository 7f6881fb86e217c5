"""The port's shared-memory store after ``close()``: every call that hands
the C library the store handle checks it under the lock ``close`` takes, so
a call after ``close`` returns its empty value (or raises a Python error for
a write) instead of dereferencing a freed handle, and ``Node.stop`` closes
the store after the handlers that read or free objects have finished.

Both cases run in a subprocess: without the guard the first one dies with
SIGSEGV (-11), which would take a test worker down with it."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script: str, tmp_path, timeout: float = 120.0):
    path = tmp_path / "case.py"
    path.write_text(textwrap.dedent(script))
    env = {**os.environ, "PYTHONPATH": REPO, "TMPDIR": str(tmp_path)}
    return subprocess.run([sys.executable, str(path)], capture_output=True,
                          text=True, timeout=timeout, env=env,
                          cwd=str(tmp_path))


def test_calls_after_close_return_without_a_crash(tmp_path):
    proc = _run(f"""
        import os
        from ray_tpu_torch._native.objstore import ShmStore, StoreClosedError

        store = ShmStore.create({str(tmp_path / "s.store")!r}, 1 << 20)
        oid = b"o" * 20
        assert store.put_bytes(oid, b"payload") is True
        pin = store.put_bytes(b"p" * 20, b"pinned", pin=True)
        view = store.get_view(oid)
        assert bytes(view.data) == b"payload"
        view.release()
        store.close()
        store.close()  # twice is a no-op
        out = [store.delete(oid), store.contains(oid), store.get_view(oid),
               store.used_bytes(), store.capacity(), store.num_objects()]
        pin.release()  # an unpin after close goes nowhere
        for write in (lambda: store.put_bytes(b"q" * 20, b"x"),
                      lambda: store.create_buffer(b"q" * 20, 8),
                      lambda: store.seal(oid)):
            try:
                write()
            except StoreClosedError:
                out.append("refused")
        print(out)
    """, tmp_path)
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
    assert proc.stdout.strip() == str(
        [False, False, None, 0, 0, 0, "refused", "refused", "refused"])


def test_frees_from_other_threads_while_the_node_stops(tmp_path):
    """Objects are freed through the node's RPC handler and in process
    from other threads while ``Node.stop`` runs; frees that come after
    the close find it closed and return."""
    proc = _run("""
        import threading
        import time

        from ray_tpu_torch.core.config import config
        from ray_tpu_torch.core.controller import Controller
        from ray_tpu_torch.core.node import Node
        from ray_tpu_torch.core.rpc import RpcClient

        config.object_store_memory_bytes = 64 << 20
        ctrl = Controller()
        node = Node(ctrl.address, {"CPU": 1.0})
        oids = [i.to_bytes(4, "little") * 5 for i in range(2000)]
        for oid in oids:
            assert node._shm.put_bytes(oid, b"x" * 1024)
        start = threading.Event()
        errors = []

        def in_process():
            start.wait()
            for oid in oids:
                node.free_shm_object(oid)

        def over_rpc():
            client = RpcClient(node.address)
            start.wait()
            for oid in oids[::-1]:
                try:
                    client.notify("free_shm_object", oid)
                except Exception as e:  # the server went away
                    errors.append(type(e).__name__)
                    break

        threads = [threading.Thread(target=f)
                   for f in (in_process, in_process, over_rpc)]
        for t in threads:
            t.start()
        start.set()
        time.sleep(0.01)
        node.stop()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        node.free_shm_object(oids[0])  # after the close: a no-op
        assert node.read_shm_object(oids[1]) is None
        assert node._shm.used_bytes() == 0
        ctrl.stop()
        print("ok")
    """, tmp_path)
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
    assert proc.stdout.strip().endswith("ok")
