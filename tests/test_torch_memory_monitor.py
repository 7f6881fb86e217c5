"""The port's memory monitor and OOM worker-killing policy
(``ray_tpu_torch.core.memory_monitor``): the 6 cases of
``tests/test_memory_monitor.py`` under the same names.

The policy is tested as a pure function of a worker-table snapshot; the
end-to-end path injects a fake memory reader into a live node and asserts
a running retriable task is killed and retried.
"""

import time
from types import SimpleNamespace

import pytest

from ray_tpu_torch.core.memory_monitor import pick_victim
from torch_fixtures import ray_start_regular  # noqa: F401


def _h(idle=False, dedicated=False, leased=True, retriable=True,
       owner="a", last_used=0.0, alive=True):
    return SimpleNamespace(
        idle=idle,
        dedicated=dedicated,
        lease_resources={"CPU": 1.0} if leased else None,
        task_meta={"retriable": retriable, "owner": owner},
        last_used=last_used,
        proc=SimpleNamespace(poll=lambda: None if alive else 1),
        worker_id=SimpleNamespace(hex=lambda: "w", binary=lambda: b"w"),
    )


def test_policy_idle_workers_die_first():
    idle_old = _h(idle=True, leased=False, last_used=1.0)
    idle_new = _h(idle=True, leased=False, last_used=2.0)
    busy = _h(last_used=3.0)
    assert pick_victim([busy, idle_new, idle_old],
                       "retriable_fifo") is idle_old


def test_policy_retriable_fifo_prefers_newest_retriable():
    old_r = _h(retriable=True, last_used=1.0)
    new_r = _h(retriable=True, last_used=5.0)
    newest_nonr = _h(retriable=False, last_used=9.0)
    assert pick_victim([old_r, newest_nonr, new_r],
                       "retriable_fifo") is new_r
    # Only non-retriable left -> last resort, still newest first.
    assert pick_victim([newest_nonr, _h(retriable=False, last_used=2.0)],
                       "retriable_fifo") is newest_nonr


def test_policy_never_picks_actors_or_dead():
    actor = _h(dedicated=True, last_used=9.0)
    dead = _h(last_used=8.0, alive=False)
    assert pick_victim([actor, dead], "retriable_fifo") is None


def test_policy_group_by_owner_sheds_biggest_group():
    a1 = _h(owner="a", last_used=1.0)
    a2 = _h(owner="a", last_used=4.0)
    b1 = _h(owner="b", last_used=9.0)
    assert pick_victim([a1, b1, a2], "group_by_owner") is a2


@pytest.mark.timeout_s(120)
def test_oom_kill_retries_then_raises(ray_start_regular):
    import ray_tpu_torch
    from ray_tpu_torch.core import api as api_mod

    node = api_mod._local_cluster[1]
    assert node.memory_monitor is not None
    node.memory_monitor.stop()  # drive check_once manually, race-free

    @ray_tpu_torch.remote(max_retries=0)
    def hog():
        time.sleep(60)
        return 1

    ref = hog.remote()
    # Let the lease land, then report the node as over the watermark.
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        with node._lock:
            if any(h.lease_resources is not None and not h.dedicated
                   for h in node._workers.values()):
                break
        time.sleep(0.05)
    node.memory_monitor.set_reader(lambda: (99, 100))
    killed = None
    deadline = time.monotonic() + 30
    while killed is None and time.monotonic() < deadline:
        killed = node.memory_monitor.check_once()
        time.sleep(0.1)
    assert killed is not None
    with pytest.raises(ray_tpu_torch.OutOfMemoryError):
        ray_tpu_torch.get(ref, timeout=30)
    assert node.get_info()["num_oom_kills"] == 1


@pytest.mark.timeout_s(120)
def test_oom_killed_retriable_task_succeeds_on_retry(ray_start_regular):
    import ray_tpu_torch
    from ray_tpu_torch.core import api as api_mod

    node = api_mod._local_cluster[1]
    node.memory_monitor.stop()  # drive check_once manually, race-free

    @ray_tpu_torch.remote(max_retries=2)
    def quick(x):
        time.sleep(1.0)
        return x + 1

    # Kill the first leased worker once; the resubmission completes.
    ref = quick.remote(41)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        node.memory_monitor.set_reader(lambda: (99, 100))
        if node.memory_monitor.check_once() is not None:
            break
        time.sleep(0.02)
    node.memory_monitor.set_reader(lambda: (0, 100))
    assert ray_tpu_torch.get(ref, timeout=60) == 42
