"""One user program for the runtime and the serve plane, run on ``ray_tpu``
and then on ``ray_tpu_torch`` by ``tests/test_torch_runtime_core.py`` and
``tests/test_torch_serve_runtime.py``.

Every function takes the package's name and imports it, so the same code
drives both runtimes. This module imports neither package, nor JAX, nor
torch: the cluster's workers import it to run the tasks, actors and
deployments defined here, and stay light.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np


def _pkg(name: str):
    return importlib.import_module(name)


def _raised(fn):
    """The name of the exception ``fn`` raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the class name is the result
        return type(e).__name__
    return None


def _poll(fn, want, timeout_s: float = 30.0):
    """``fn()`` once it returns ``want``, or its last value at the
    deadline."""
    deadline = time.monotonic() + timeout_s
    got = fn()
    while got != want and time.monotonic() < deadline:
        time.sleep(0.05)
        got = fn()
    return got


# ------------------------------------------------------------ the core


def add(a, b):
    return a + b


def total(pkg: str, refs):
    return sum(_pkg(pkg).get(refs))


def boom(msg: str):
    raise ValueError(msg)


def nap(s: float):
    time.sleep(s)
    return s


def gen(n: int):
    for i in range(n):
        yield i * 10


def worker_env():
    """What a worker sees: its card variable, its parent, and whether any
    code in it created a CUDA context."""
    torch = sys.modules.get("torch")
    return {"cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "ppid": os.getppid(),
            "cuda_initialized": bool(torch is not None
                                     and torch.cuda.is_initialized())}


class Counter:
    def __init__(self, start: int = 0):
        self.n = start

    def inc(self):
        self.n += 1
        return self.n

    def get(self):
        return self.n

    def die(self):
        os._exit(1)


def core_program(pkg: str):
    """Tasks with nested refs and an error, put / get / wait / free, named
    actors with kill and a restart, a streaming return, and the resource
    books before, during and after a lease."""
    rt = _pkg(pkg)
    out = {}
    rt.get([rt.remote(nap).remote(0.0) for _ in range(4)])  # warm workers
    radd = rt.remote(add)
    r1 = radd.remote(1, 2)
    out["chain"] = rt.get(radd.remote(r1, 10))
    out["nested"] = rt.get(rt.remote(total).remote(
        pkg, [rt.put(3), rt.put(4), r1]))
    bad = rt.remote(boom).options(max_retries=0).remote("bad input")
    try:
        rt.get(bad)
    except Exception as e:  # noqa: BLE001 — its classes are the result
        out["task_error"] = (type(e).__name__,
                             type(getattr(e, "cause", None)).__name__,
                             "bad input" in str(e))

    arr = np.arange(1 << 18, dtype=np.float32)  # 1 MiB: the shm path
    ref = rt.put(arr)
    got = rt.get(ref)
    out["put_get"] = (bool(np.array_equal(got, arr)), str(got.dtype))
    slow = rt.remote(nap).remote(3.0)
    fast = rt.remote(nap).remote(0.0)
    ready, pending = rt.wait([slow, fast], num_returns=1, timeout=30)
    out["wait"] = (len(ready), len(pending), ready[0].hex() == fast.hex())
    ready, pending = rt.wait([slow], num_returns=1, timeout=0.2)
    out["wait_timeout"] = (len(ready), len(pending))
    out["get_timeout"] = _raised(lambda: rt.get(slow, timeout=0.2))
    out["slow"] = rt.get(slow)
    rt.free(ref)
    rt.free([ref, None])  # twice: a no-op
    out["freed"] = _raised(lambda: rt.get(ref, timeout=5))

    ctr = rt.remote(Counter)
    named = ctr.options(name="ctr").remote(5)
    rt.get(named.inc.remote())
    out["named"] = rt.get(rt.get_actor("ctr").get.remote())
    rt.kill(named)
    out["killed"] = _raised(lambda: rt.get(named.get.remote(), timeout=30))
    phoenix = ctr.options(max_restarts=1).remote()
    first = rt.get(phoenix.inc.remote())
    phoenix.die.remote()

    def after_restart():
        try:
            return rt.get(phoenix.inc.remote(), timeout=30)
        except Exception:  # noqa: BLE001 — the lost call, then a retry
            return None

    out["restart"] = (first, _poll(after_restart, 1, 60))
    rt.kill(phoenix)

    g = rt.remote(gen).options(num_returns="streaming").remote(4)
    out["stream"] = (type(g).__name__, [rt.get(r) for r in g])

    def avail(key):
        return lambda: rt.available_resources().get(key)

    books = {}
    for key, opts in (("CPU", {"num_cpus": 2}),
                      ("GPU", {"num_cpus": 0, "num_gpus": 1})):
        total_ = rt.cluster_resources()[key]
        before = _poll(avail(key), total_)
        held = rt.remote(nap).options(**opts).remote(1.5)
        during = _poll(avail(key), total_ - opts.get("num_gpus", 2))
        rt.get(held)
        books[key] = (before, during, _poll(avail(key), total_))
    out["books"] = books
    out["cluster_resources"] = rt.cluster_resources()

    env = rt.remote(worker_env)
    out["cpu_env"] = rt.get(env.remote())
    out["gpu_env"] = rt.get(env.options(num_cpus=0, num_gpus=1).remote())
    out["driver_pid"] = os.getpid()
    return out


# ------------------------------------------------------ the serve plane


class Lifecycle:
    """A plain deployment with one slot: ``hold`` sheds a second caller
    with ``OverloadedError``, ``sleep`` gives up at the deadline the serve
    stack propagated (``request_deadline_s``) with
    ``DeadlineExceededError``, as the decode engine does, and ``count``
    streams and counts the streams closed before their end."""

    def __init__(self, pkg: str):
        self._errors = _pkg(pkg + ".core.errors")
        self._serve = _pkg(pkg + ".serve")
        self._slot = threading.Semaphore(1)
        self._held = False
        self.cancelled = 0

    def __call__(self, p):
        op = p["op"]
        if op == "echo":
            return {"x": p["x"] * 2}
        if op == "hold":
            if not self._slot.acquire(blocking=False):
                raise self._errors.OverloadedError("slot busy",
                                                   retry_after_s=2.5)
            self._held = True
            try:
                time.sleep(p["s"])
                return {"held": p["s"]}
            finally:
                self._held = False
                self._slot.release()
        if op == "sleep":
            left = self._serve.request_deadline_s()
            if left is not None and left < p["s"]:
                time.sleep(max(0.0, left))
                raise self._errors.DeadlineExceededError("out of time")
            time.sleep(p["s"])
            return {"slept": p["s"]}
        return self._count(p["n"], p["delay"])

    def _count(self, n: int, delay: float):
        done = False
        try:
            for i in range(n):
                time.sleep(delay)
                yield i
            done = True
        finally:
            if not done:
                self.cancelled += 1

    def stats(self):
        return {"cancelled": self.cancelled, "busy": self._held}


class Fragile:
    """Two replicas share a marker file: the first call kills the replica
    it lands on, so the handle must retry it on the other one."""

    def __init__(self, marker: str):
        self.marker = marker

    def __call__(self, _):
        try:
            fd = os.open(self.marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return {"survived": True}
        os.close(fd)
        os._exit(1)


def post(addr, route: str, payload, headers=None, timeout: float = 60.0):
    """POST ``payload`` to the proxy: (status, headers, body lines)."""
    req = urllib.request.Request(
        f"http://{addr[0]}:{addr[1]}/{route}",
        data=json.dumps(payload).encode(), headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return (resp.status, dict(resp.headers),
                    resp.read().splitlines())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().splitlines()


def _in_thread(fn):
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    return t


def serve_program(pkg: str, marker: str):
    """A plain deployment through the handle and the proxy: status keys,
    overload (503 with Retry-After), deadlines (typed error, 504), a
    cancelled stream, a handle retry across a replica death, delete."""
    serve = _pkg(pkg + ".serve")
    proxy = _pkg(pkg + ".serve.proxy")
    out = {}
    h = serve.run(serve.deployment(Lifecycle).options(
        max_concurrency=8).bind(pkg), name="life")
    out["echo"] = h.remote({"op": "echo", "x": 21}).result(timeout=60)
    out["status_keys"] = sorted(serve.status()["life"])

    def lifecycle(fut):
        try:
            fut.result(timeout=60)
        except Exception as e:  # noqa: BLE001 — its class is the result
            return type(proxy._lifecycle_error(e)).__name__
        return None

    out["handle_deadline"] = lifecycle(h.options(timeout_s=0.3).remote(
        {"op": "sleep", "s": 2.0}))
    stats = h.options(method_name="stats")

    def busy():
        return stats.remote().result(timeout=30)["busy"]

    holder = h.remote({"op": "hold", "s": 2.0})
    _poll(busy, True)  # the holder has the slot
    out["handle_overload"] = lifecycle(h.remote({"op": "hold", "s": 0.0}))
    holder.result(timeout=60)

    addr = serve.start_http()
    t = _in_thread(lambda: post(addr, "life", {"op": "hold", "s": 2.0}))
    _poll(busy, True)
    code, headers, _ = post(addr, "life", {"op": "hold", "s": 0.0})
    out["http_overload"] = (code, headers.get("Retry-After"))
    t.join(60)
    code, _, _ = post(addr, "life", {"op": "sleep", "s": 2.0},
                      headers={"X-Request-Timeout-S": "0.3"})
    out["http_deadline"] = code
    code, _, lines = post(addr, "life", {"op": "echo", "x": 4})
    out["http_echo"] = (code, [json.loads(x) for x in lines])

    stream = h.stream({"op": "count", "n": 200, "delay": 0.02})
    out["stream_head"] = [next(stream) for _ in range(3)]
    stream.close()
    out["stream_cancelled"] = _poll(
        lambda: stats.remote().result(timeout=30)["cancelled"], 1)

    fh = serve.run(serve.deployment(Fragile).options(
        num_replicas=2).bind(marker), name="fragile")
    out["retry"] = fh.remote(None).result(timeout=60)
    out["healed_replicas"] = _poll(
        lambda: serve.status()["fragile"]["replicas"], 2, 60)

    serve.delete("life")
    out["listed_after_delete"] = _poll(lambda: "life" in serve.status(),
                                       False)
    serve.shutdown()
    return out
