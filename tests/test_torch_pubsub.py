"""The port's long-poll pubsub hub and push-driven control paths
(``ray_tpu_torch.core.pubsub``): the 5 cases of ``tests/test_pubsub.py``
under the same names, the live ones on ``ray_tpu_torch.init``."""

import threading
import time

import ray_tpu_torch
from ray_tpu_torch.core.pubsub import Pubsub
from torch_fixtures import ray_start_regular  # noqa: F401


def test_poll_blocks_until_publish():
    hub = Pubsub()
    got = {}

    def waiter():
        got["result"] = hub.poll("ch", "k", 0, timeout=10.0)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    hub.publish("ch", "k", {"x": 1})
    t.join(timeout=5.0)
    assert got["result"] == (1, {"x": 1})


def test_poll_returns_latest_only():
    hub = Pubsub()
    hub.publish("ch", "k", "a")
    hub.publish("ch", "k", "b")
    version, value = hub.poll("ch", "k", 0, timeout=1.0)
    assert (version, value) == (2, "b")
    assert hub.poll("ch", "k", version, timeout=0.1) is None


def test_poll_many_wakes_on_any():
    hub = Pubsub()
    hub.publish("ch", "a", 1)
    watches = {"wa": ("ch", "a", 1), "wb": ("ch", "b", 0)}

    def publish_later():
        time.sleep(0.1)
        hub.publish("ch", "b", 42)

    threading.Thread(target=publish_later).start()
    updates = hub.poll_many(watches, timeout=5.0)
    assert updates == {"wb": (1, 42)}


def test_actor_alive_wait_is_push_driven(ray_start_regular):
    # A slow-__init__ actor: the handle's first call must block on the
    # controller's actor channel (not a poll loop) and still resolve.
    @ray_tpu_torch.remote
    class Slow:
        def __init__(self):
            time.sleep(1.0)

        def ping(self):
            return "up"

    start = time.monotonic()
    a = Slow.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=30) == "up"
    assert time.monotonic() - start < 25


def test_controller_pubsub_rpc(ray_start_regular):
    core = ray_start_regular
    core.controller.call("psub_publish", "custom", "key1", {"v": 7})
    got = core.controller.call("psub_poll", "custom", "key1", 0, 5.0)
    assert got == (1, {"v": 7})
    snap = core.controller.call("psub_snapshot", "custom")
    assert snap["key1"] == (1, {"v": 7})
