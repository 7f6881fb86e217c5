"""A process that dies holding a reference returns it. The owner counts each
holder's handles apart; a node's reaper reports the worker processes it
found gone, the controller publishes them, and every owner drops their
counts, so the usual sweep frees what only the dead held. A live holder
keeps its object, and a holder on another node of the cluster is handled
the same way. A worker that leaves its node's table while its process
still runs (an owner returns it as dead after a missed RPC) keeps its
counts until the process exits. The JAX package keeps the fault (its
owners never learn of a holder's death), so these cases run on the port
alone."""

import os
import signal
import time

import numpy as np
import pytest

import ray_tpu_torch as rt

N = 1 << 20  # 4 MiB of float32: past the inline limit, so in the store
GRACE_S = 0.5  # the owner's ``ref_free_grace_s`` here
# The reaper's 5 s tick, the owner's 1 s poll, and slack for a loaded box.
NOTICE_S = 12.0


@pytest.fixture(scope="module")
def cluster():
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.config import config

    old = config.ref_free_grace_s
    config.ref_free_grace_s = GRACE_S
    c = Cluster(initialize_head=False)
    near = c.add_node(num_cpus=3, resources={"near": 3.0})
    c.add_node(num_cpus=2, resources={"far": 1.0})
    c.wait_for_nodes(30)
    rt.init(address=c.address)
    try:
        yield {"cluster": c, "near": near}
    finally:
        rt.shutdown()
        c.shutdown()
        config.ref_free_grace_s = old


@rt.remote
class Holder:
    """Keeps a reference, or a value from ``get``. A value lies in the
    store (and holds its reference) only on the object's own node; one
    pulled from another node is a private copy."""

    def keep(self, refs, as_value: bool) -> int:
        if as_value:
            self.value = rt.get(refs[0])
        else:
            self.ref = refs[0]
        return os.getpid()

    def drop(self) -> None:
        self.value = self.ref = None


_stash = []  # a task worker's module state: lives as long as its process


@rt.remote(resources={"near": 1.0})
def stash(refs) -> int:
    _stash.append(refs[0])
    return os.getpid()


@rt.remote(resources={"near": 1.0})
def stash_and_name(refs):
    """``stash``, also naming the worker to its node."""
    from ray_tpu_torch.core.runtime import get_core_worker

    _stash.append(refs[0])
    return os.getpid(), get_core_worker().worker_id.binary()


def _core():
    from ray_tpu_torch.core.runtime import get_core_worker

    return get_core_worker()


def _entry(oid: bytes):
    from ray_tpu_torch.core.ids import ObjectID

    return _core().store._entries.get(ObjectID(oid))


def _count(oid: bytes) -> int:
    """The owner's count of live handles to ``oid``, over all processes."""
    e = _entry(oid)
    return 0 if e is None else e.refcount


def _freed(oid: bytes) -> bool:
    e = _entry(oid)
    return e is None or e.freed


def _wait(pred, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def _put():
    ref = rt.put(np.arange(N, dtype=np.float32))
    return ref, ref.binary()


def _kill_and_time_free(pid: int, oid: bytes) -> float:
    # Alive holder: the object stays past the grace period.
    time.sleep(3 * GRACE_S)
    assert not _freed(oid)
    t0 = time.monotonic()
    os.kill(pid, signal.SIGKILL)
    assert _wait(lambda: _freed(oid), GRACE_S + NOTICE_S), (
        "the owner kept an object whose only holder was killed")
    return time.monotonic() - t0


@pytest.mark.timeout_s(120)
def test_killed_task_worker_returns_its_reference(cluster):
    """A task keeps a reference in its worker's module state and returns;
    the pooled worker is then killed."""
    ref, oid = _put()
    pid = rt.get(stash.remote([ref]), timeout=60)
    assert _wait(lambda: _count(oid) == 2, 10)  # this owner and the worker
    del ref
    assert _kill_and_time_free(pid, oid) < GRACE_S + NOTICE_S
    assert _count(oid) == 0


@pytest.mark.timeout_s(120)
def test_killed_actor_returns_the_reference_of_its_get_value(cluster):
    ref, oid = _put()
    h = Holder.options(resources={"near": 1.0}).remote()
    pid = rt.get(h.keep.remote([ref], True), timeout=60)
    assert _wait(lambda: _count(oid) == 2, 10)
    del ref
    _kill_and_time_free(pid, oid)


@pytest.mark.timeout_s(120)
def test_live_second_holder_keeps_the_object(cluster):
    ref, oid = _put()
    a = Holder.options(resources={"near": 1.0}).remote()
    b = Holder.remote()
    pid_a = rt.get(a.keep.remote([ref], True), timeout=60)
    rt.get(b.keep.remote([ref], False), timeout=60)
    assert _wait(lambda: _count(oid) == 3, 10)
    del ref
    os.kill(pid_a, signal.SIGKILL)
    # a's count goes with its death notice; b's stays.
    assert _wait(lambda: _count(oid) == 1, GRACE_S + NOTICE_S)
    time.sleep(3 * GRACE_S)
    assert not _freed(oid)
    rt.get(b.drop.remote(), timeout=30)
    assert _wait(lambda: _freed(oid), GRACE_S + 5.0)


@pytest.mark.timeout_s(120)
def test_holder_on_the_second_node_returns_its_reference(cluster):
    ref, oid = _put()
    h = Holder.options(resources={"far": 1.0}).remote()
    pid = rt.get(h.keep.remote([ref], False), timeout=60)
    assert _wait(lambda: _count(oid) == 2, 10)
    del ref
    _kill_and_time_free(pid, oid)


@pytest.mark.timeout_s(120)
def test_worker_returned_as_dead_keeps_its_count_while_it_runs(cluster):
    """An owner whose push to a worker fails returns the worker as dead
    (``Node.return_worker(dead=True)``), and the node drops it from its
    table without killing it. Stopped, the process still runs and cannot
    notice that its node forgot it: its count stays past the reaper's
    ticks, and goes once the process is killed."""
    ref, oid = _put()
    pid, wid = rt.get(stash_and_name.remote([ref]), timeout=60)
    assert _wait(lambda: _count(oid) == 2, 10)
    del ref
    os.kill(pid, signal.SIGSTOP)
    try:
        cluster["near"].return_worker(wid, {}, dead=True)
        time.sleep(GRACE_S + NOTICE_S)
        assert _count(oid) == 1 and not _freed(oid), (
            "a live holder's count was dropped")
    finally:
        os.kill(pid, signal.SIGKILL)
    assert _wait(lambda: _freed(oid), GRACE_S + NOTICE_S), (
        "the owner kept an object whose only holder exited")
