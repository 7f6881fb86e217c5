"""The port's thin client (``ray_tpu_torch.client``, ``rt.init(
"ray-tpu://...")``) on the CPU: the cases of ``tests/test_client.py`` with
the port in place of the JAX package. The client process owns nothing: a
``ClientServer`` inside the cluster hosts the real refs and actors. Beside
them: a thin client creates no CUDA context, and the api's calls reach the
client (``cluster_resources``, ``get_actor``, ``kill``)."""

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

import ray_tpu_torch as rt

REPO = str(Path(__file__).resolve().parents[1])


@pytest.fixture
def torch_regular():
    core = rt.init(num_cpus=4)
    yield core
    rt.shutdown()


@pytest.fixture
def client_pair(torch_regular):
    from ray_tpu_torch import client as client_mod

    server = client_mod.ClientServer(host="127.0.0.1")
    client = client_mod.connect(f"ray-tpu://{server.address[0]}:"
                                f"{server.address[1]}")
    yield server, client
    client.disconnect()
    server.stop()


def test_put_get_task_actor_roundtrip(client_pair):
    _server, client = client_pair

    arr = np.arange(1000, dtype=np.float32)
    ref = rt.put(arr)
    np.testing.assert_array_equal(rt.get(ref), arr)

    # top-level ref arg: resolved to its value before execution
    @rt.remote
    def add(a, b):
        return a + b

    out = rt.get(add.remote(ref, np.ones(1000, np.float32)))
    np.testing.assert_array_equal(out, arr + 1.0)

    # NESTED ref (reference semantics: stays a ref; the task gets it)
    @rt.remote
    def nested_sum(d):
        import ray_tpu_torch

        return float(ray_tpu_torch.get(d["r"]).sum()) + d["c"]

    assert rt.get(nested_sum.remote({"r": ref, "c": 0.5})) == \
        float(arr.sum()) + 0.5

    @rt.remote(num_returns=2)
    def two():
        return 1, 2

    r1, r2 = two.remote()
    assert rt.get(r1) == 1 and rt.get(r2) == 2

    ready, pending = rt.wait([r1, r2], num_returns=2, timeout=30)
    assert len(ready) == 2 and not pending

    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote(10)
    assert rt.get(c.inc.remote()) == 11
    assert rt.get(c.inc.remote(5)) == 16
    rt.kill(c)

    @rt.remote(max_retries=0)
    def boom():
        raise ValueError("boom-from-task")

    with pytest.raises(Exception, match="boom"):
        rt.get(boom.remote(), timeout=60)
    assert rt.cluster_resources()["CPU"] == 4.0


def test_named_actor_survives_disconnect(client_pair):
    from ray_tpu_torch import client as client_mod

    server, client = client_pair

    @rt.remote
    class Holder:
        def __init__(self):
            self.v = 7

        def v_(self):
            return self.v

    named = Holder.options(name="keeper").remote()
    unnamed = Holder.remote()
    assert rt.get(named.v_.remote()) == 7
    unnamed_key = unnamed._key
    client.disconnect()

    # Reconnect: the named actor is still there, the unnamed one is gone.
    client2 = client_mod.connect(
        f"ray-tpu://{server.address[0]}:{server.address[1]}")
    try:
        again = rt.get_actor("keeper")
        assert rt.get(again.v_.remote()) == 7
        with pytest.raises(Exception):
            h = client_mod.ClientActorHandle(unnamed_key, client2)
            rt.get(h.v_.remote(), timeout=15)
        rt.kill(again)
    finally:
        client2.disconnect()


@pytest.mark.slow  # as the reference's: the reap rides the session timer
@pytest.mark.timeout_s(120)
def test_stale_session_reaped(torch_regular):
    """A crashed client (keepalive stops, no disconnect) gets its session
    reaped server-side: refs released, unnamed actors killed."""
    from ray_tpu_torch import client as client_mod
    from ray_tpu_torch.core.config import config

    config.update({"client_session_timeout_s": 3.0})
    server = client_mod.ClientServer(host="127.0.0.1")
    client = client_mod.connect(
        f"ray-tpu://{server.address[0]}:{server.address[1]}")
    try:
        @rt.remote
        class Doomed:
            def alive(self):
                return True

        d = Doomed.remote()
        assert rt.get(d.alive.remote(), timeout=60)
        assert len(server._sessions) == 1
        client._stop_ping.set()
        deadline = time.monotonic() + 30
        while server._sessions and time.monotonic() < deadline:
            time.sleep(0.2)
        assert not server._sessions, "stale session was not reaped"
    finally:
        client.disconnect()
        server.stop()
        config.update({"client_session_timeout_s": 60.0})


@pytest.mark.timeout_s(150)
def test_separate_client_process(torch_regular):
    """A separate OS process drives the cluster as a thin client over one
    outbound TCP connection, and creates no CUDA context."""
    from ray_tpu_torch import client as client_mod

    server = client_mod.ClientServer(host="127.0.0.1")
    script = textwrap.dedent(f"""
        import numpy as np
        import torch
        import ray_tpu_torch

        ray_tpu_torch.init(
            address="ray-tpu://{server.address[0]}:{server.address[1]}")

        @ray_tpu_torch.remote
        def square(x):
            return x * x

        refs = [square.remote(i) for i in range(8)]
        assert ray_tpu_torch.get(refs, timeout=90) == [i * i for i in range(8)]

        @ray_tpu_torch.remote
        class Acc:
            def __init__(self):
                self.total = 0
            def add(self, v):
                self.total += v
                return self.total

        acc = Acc.remote()
        for i in range(5):
            last = acc.add.remote(i)
        assert ray_tpu_torch.get(last, timeout=60) == 10
        big = ray_tpu_torch.put(np.ones((256, 256)))
        assert float(ray_tpu_torch.get(big).sum()) == 256 * 256
        t = ray_tpu_torch.get(ray_tpu_torch.put(torch.arange(6.0)))
        assert t.tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
        ray_tpu_torch.shutdown()
        print("CUDA-INIT", torch.cuda.is_initialized())
        print("CLIENT-OK")
    """)
    try:
        proc = subprocess.run(
            [sys.executable, "-c", script], capture_output=True, text=True,
            timeout=120, env={**os.environ, "PYTHONPATH": REPO})
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "CLIENT-OK" in proc.stdout
        assert "CUDA-INIT False" in proc.stdout
    finally:
        server.stop()
