"""The port's tracing and profiling (``ray_tpu_torch.util.tracing``,
``util/profiling.py``): the 7 cases of ``tests/test_tracing.py`` under
the same names: span propagation through tasks and actors, stack dumps,
and CPU and heap profiles of live workers over RPC."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import tracing
from torch_fixtures import ray_start_regular  # noqa: F401


def _events(core, match):
    core._flush_task_events()
    events = core.controller.call("list_task_events", 10000)
    return [e for e in events if match(e)]


def test_span_propagates_through_task(ray_start_regular):
    core = ray_start_regular

    @ray_tpu_torch.remote
    def traced_task():
        ctx = tracing.current()
        with tracing.profile_event("inner-work"):
            time.sleep(0.01)
        return ctx

    with tracing.trace("root-span") as (trace_id, _span):
        inside = ray_tpu_torch.get(traced_task.remote())

    # The worker saw the caller's trace id with a fresh span id.
    assert inside is not None and inside[0] == trace_id

    # The task's FINISHED event carries the trace id; the root span and the
    # WORKER-side profile event (flushed on the worker's own cadence) land
    # in the controller's event table too.
    deadline = time.monotonic() + 30
    linked, names = [], set()
    while time.monotonic() < deadline:
        linked = _events(core, lambda e: e.get("trace_id") == trace_id
                         and e.get("state") in ("FINISHED", "FAILED"))
        names = {e["desc"] for e in _events(
            core, lambda e: e.get("state") == "SPAN"
            and e.get("trace_id") == trace_id)}
        if linked and {"root-span", "profile:inner-work"} <= names:
            break
        time.sleep(0.2)
    assert linked, "no task event linked to the trace"
    assert "root-span" in names
    assert "profile:inner-work" in names, names


def test_span_propagates_through_actor(ray_start_regular):
    @ray_tpu_torch.remote
    class Echo:
        def ctx(self):
            return tracing.current()

    actor = Echo.remote()
    with tracing.trace("actor-root") as (trace_id, _):
        inside = ray_tpu_torch.get(actor.ctx.remote())
    assert inside is not None and inside[0] == trace_id
    ray_tpu_torch.kill(actor)


def test_dump_stacks_local():
    text = tracing.dump_stacks()
    assert "thread" in text and "test_dump_stacks_local" in text


@pytest.mark.slow  # 5.1 s: remote stack-dump
# surface; local dump coverage stays tier-1
def test_worker_stack_dump_rpc(ray_start_regular):
    from ray_tpu_torch.core import api as api_mod
    from ray_tpu_torch.core.rpc import RpcClient

    @ray_tpu_torch.remote
    def napper():
        time.sleep(5)
        return 1

    ref = napper.remote()
    node = api_mod._local_cluster[1]
    deadline = time.monotonic() + 30
    dump = ""
    while time.monotonic() < deadline:
        busy = [w for w in node.list_workers() if not w["idle"]]
        for w in busy:
            try:
                wc = RpcClient(tuple(w["addr"]))
                dump = wc.call("dump_stacks", timeout=10.0)
                wc.close()
            except Exception:
                continue
            if "napper" in dump:
                break
        if "napper" in dump:
            break
        time.sleep(0.2)
    assert "napper" in dump, dump[-2000:]
    assert ray_tpu_torch.get(ref, timeout=60) == 1


# ------------------------------------------------- on-demand profiling
# (reference: dashboard reporter attaching py-spy/memray
# to live workers, profile_manager.py:79,190)


# Load-sensitive (it samples a busy worker for 1.5 s): its own limit.
@pytest.mark.timeout_s(90)
def test_profile_cpu_flamegraph_of_live_worker(ray_start_regular):
    """Sample a busy worker's stacks over RPC and render a flamegraph:
    the hot function must dominate the samples and appear in the SVG."""
    import ray_tpu_torch
    from ray_tpu_torch.core.rpc import RpcClient
    from ray_tpu_torch.core.runtime import get_core_worker
    from ray_tpu_torch.util.profiling import flamegraph_svg

    @ray_tpu_torch.remote
    def burn(seconds):
        import time as _t

        def hot_loop(deadline):
            x = 0
            while _t.monotonic() < deadline:
                x += 1
            return x

        return hot_loop(_t.monotonic() + seconds)

    ref = burn.remote(4.0)
    time.sleep(0.5)  # let the task start
    core = get_core_worker()
    nodes = core.controller.call("list_nodes")
    workers = []
    for n in nodes:
        nc = RpcClient(tuple(n["addr"]))
        workers += nc.call("list_workers")
        nc.close()
    busy = [w for w in workers if not w["idle"]]
    assert busy, workers
    wc = RpcClient(tuple(busy[0]["addr"]))
    folded = wc.call("profile_cpu", 1.5, 100.0, timeout=30.0)
    wc.close()
    assert sum(folded.values()) > 50  # ~100Hz x 1.5s, load-tolerant
    hot = [s for s in folded if "hot_loop" in s]
    assert hot, list(folded)[:5]
    # Wall-clock sampling counts IDLE threads too (the worker runs ~8
    # service threads parked in waits, like py-spy's all-thread view),
    # and under CI load the busy worker shares one core with the whole
    # suite — so the bar is "clearly present", not a share threshold.
    assert sum(folded[s] for s in hot) >= 10
    svg = flamegraph_svg(folded)
    assert svg.startswith("<svg") and "hot_loop" in svg
    assert ray_tpu_torch.get(ref, timeout=60) > 0


def test_profile_heap_growth(ray_start_regular):
    """Heap profiling over RPC: first call arms tracemalloc, later calls
    report the allocations made in between."""
    import ray_tpu_torch
    from ray_tpu_torch.core.actor import ActorHandle  # noqa: F401
    from ray_tpu_torch.core.rpc import RpcClient

    @ray_tpu_torch.remote
    class Hoarder:
        def __init__(self):
            self.stuff = []

        def grab(self, n):
            self.stuff.append(bytearray(n))
            return len(self.stuff)

        def addr(self):
            from ray_tpu_torch.core.runtime import get_core_worker

            return get_core_worker().addr

    h = Hoarder.remote()
    addr = ray_tpu_torch.get(h.addr.remote(), timeout=60)
    wc = RpcClient(tuple(addr))
    first = wc.call("profile_heap", 10, timeout=30.0)
    assert first["started"] is True
    ray_tpu_torch.get([h.grab.remote(512 * 1024) for _ in range(4)], timeout=60)
    second = wc.call("profile_heap", 10, timeout=30.0)
    wc.close()
    assert second["started"] is False
    assert second["traced_current_kb"] > 1500  # the 4 x 512KB grabs
    assert second["top"], second


def test_profile_heap_stop(ray_start_regular):
    """Heap tracing can be turned back off (a diagnostic probe must not
    slow the worker forever)."""
    import ray_tpu_torch
    from ray_tpu_torch.core.rpc import RpcClient

    @ray_tpu_torch.remote
    class A:
        def addr(self):
            from ray_tpu_torch.core.runtime import get_core_worker

            return get_core_worker().addr

    a = A.remote()
    addr = ray_tpu_torch.get(a.addr.remote(), timeout=60)
    wc = RpcClient(tuple(addr))
    assert wc.call("profile_heap", 5, timeout=30.0)["started"]
    assert wc.call("profile_heap_stop", timeout=30.0)["stopped"]
    # Off again: a new call re-arms rather than snapshotting.
    assert wc.call("profile_heap", 5, timeout=30.0)["started"]
    assert wc.call("profile_heap_stop", timeout=30.0)["stopped"]
    wc.close()
