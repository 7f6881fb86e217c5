"""The autoscaler and instance-manager cases of
``tests/test_ft_subsystems.py`` on the port's ``autoscaler.py`` and
``instance_manager.py``, under the same names: demand-driven scale up and
idle scale down against real in-process nodes, and the instance
lifecycle's allocation backoff, setup retry and replacement, register
timeout, and the planner driving it end to end."""

import time

import pytest

from ray_tpu_torch.core.controller import Controller


@pytest.mark.timeout_s(240)
def test_autoscaler_scales_up_and_down():
    from ray_tpu_torch.autoscaler import (FakeMultiNodeProvider,
                                          StandardAutoscaler)

    controller = Controller()
    provider = FakeMultiNodeProvider(controller.address)
    autoscaler = StandardAutoscaler(
        controller, provider, node_resources={"CPU": 2.0, "burst": 2.0},
        min_nodes=0, max_nodes=3, idle_timeout_s=2.0,
        update_interval_s=0.3)
    try:
        # Demand for a resource no node has -> failed picks -> scale up.
        for _ in range(3):
            controller.pick_node({"burst": 1.0})
        autoscaler.update()
        assert autoscaler.num_launches >= 1
        deadline = time.monotonic() + 15
        while not any(n["alive"] and "burst" in n["resources"]
                      for n in controller.list_nodes()):
            assert time.monotonic() < deadline
            time.sleep(0.1)
        # Demand satisfied now.
        assert controller.pick_node({"burst": 1.0}) is not None

        # Idle past the timeout -> scale down to min_nodes. Wait on the
        # TERMINATION COUNT (the autoscaler's own action), not just the
        # provider list emptying — under suite load the bookkeeping can
        # lag the node teardown and a list-based wait races it.
        autoscaler.start()
        deadline = time.monotonic() + 45
        while autoscaler.num_terminations < 1:
            assert time.monotonic() < deadline, "never scaled down"
            time.sleep(0.3)
        deadline = time.monotonic() + 15
        while provider.non_terminated_nodes():
            assert time.monotonic() < deadline, "terminated node lingered"
            time.sleep(0.3)
    finally:
        autoscaler.stop()
        for pid in provider.non_terminated_nodes():
            provider.terminate_node(pid)
        controller.stop()


# ------------------------------------------- instance-manager lifecycle
# (reference: autoscaler/v2/instance_manager/ +
# the v1 updater.py retry/backoff node-setup state machine)


class _FlakyProvider:
    """Scripted provider: allocation failures, setup failures, and a node
    that never registers — the cloud-weather matrix."""

    def __init__(self, alloc_failures=0, setup_failures=0):
        self.alloc_failures = alloc_failures
        self.setup_failures = setup_failures
        self.created = []
        self.terminated = []
        self.setups = []
        self._n = 0

    def create_node(self, resources, labels):
        if self.alloc_failures > 0:
            self.alloc_failures -= 1
            raise RuntimeError("cloud says 503")
        self._n += 1
        pid = f"vm-{self._n}"
        self.created.append(pid)
        return pid

    def setup_node(self, pid):
        self.setups.append(pid)
        if self.setup_failures > 0:
            self.setup_failures -= 1
            raise RuntimeError("ssh bootstrap failed")

    def terminate_node(self, pid):
        self.terminated.append(pid)

    def non_terminated_nodes(self):
        return [p for p in self.created if p not in self.terminated]


def _reconcile_until(im, registered, pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, (im.summary(), im.events()[-6:])
        im.reconcile(registered())
        time.sleep(0.05)


def test_instance_manager_allocation_backoff():
    """Transient allocation failures retry with backoff and converge;
    permanent ones park the instance as FAILED after max attempts."""
    from ray_tpu_torch.instance_manager import InstanceManager

    provider = _FlakyProvider(alloc_failures=2)
    im = InstanceManager(provider, max_attempts=3, backoff_base_s=0.05)
    im.request_node({"CPU": 1.0}, {})
    _reconcile_until(im, lambda: set(),
                     lambda: im.summary().get("ALLOCATED", 0)
                     + im.summary().get("SETTING_UP", 0) >= 1)
    assert provider.created == ["vm-1"]

    dead = _FlakyProvider(alloc_failures=99)
    im2 = InstanceManager(dead, max_attempts=3, backoff_base_s=0.01)
    im2.request_node({"CPU": 1.0}, {})
    _reconcile_until(im2, lambda: set(),
                     lambda: im2.summary().get("FAILED", 0) == 1)
    assert not dead.created


def test_instance_manager_setup_retry_then_replace():
    """Setup (SSH bootstrap) retries with backoff; exhausting the budget
    terminates the instance and requests a REPLACEMENT (updater.py's
    recovery shape)."""
    from ray_tpu_torch.instance_manager import InstanceManager

    provider = _FlakyProvider(setup_failures=3)  # first vm never sets up
    im = InstanceManager(provider, max_attempts=3, backoff_base_s=0.05)
    im.request_node({"CPU": 1.0}, {"pool": "gpu"})
    _reconcile_until(im, lambda: set(),
                     lambda: "vm-1" in provider.terminated
                     and len(provider.created) >= 2)
    # The replacement inherits the original shape and sets up clean.
    _reconcile_until(im, lambda: set(),
                     lambda: "vm-2" in provider.setups)


def test_instance_manager_register_timeout_replaces():
    """An allocated node that never joins the cluster is torn down and
    replaced after register_timeout_s."""
    from ray_tpu_torch.instance_manager import InstanceManager

    provider = _FlakyProvider()
    im = InstanceManager(provider, backoff_base_s=0.01,
                         register_timeout_s=0.3)
    im.request_node({"CPU": 1.0}, {})
    _reconcile_until(im, lambda: set(),
                     lambda: "vm-1" in provider.terminated
                     and len(provider.created) >= 2)
    # Second one registers -> RUNNING.
    _reconcile_until(im, lambda: {"vm-2"},
                     lambda: im.summary().get("RUNNING", 0) == 1)


def test_autoscaler_with_instance_manager_end_to_end():
    """Planner + instance manager + real in-process nodes: demand scales
    up THROUGH the lifecycle layer."""
    from ray_tpu_torch.autoscaler import (FakeMultiNodeProvider,
                                          StandardAutoscaler)
    from ray_tpu_torch.instance_manager import InstanceManager

    controller = Controller()
    provider = FakeMultiNodeProvider(controller.address)
    im = InstanceManager(provider, backoff_base_s=0.05)
    autoscaler = StandardAutoscaler(
        controller, provider, node_resources={"CPU": 2.0, "gpu2": 2.0},
        min_nodes=0, max_nodes=3, idle_timeout_s=60.0,
        instance_manager=im)
    try:
        for _ in range(3):
            controller.pick_node({"gpu2": 1.0})
        deadline = time.monotonic() + 20
        while not any(n["alive"] and "gpu2" in n["resources"]
                      for n in controller.list_nodes()):
            assert time.monotonic() < deadline, im.events()[-5:]
            autoscaler.update()
            time.sleep(0.1)
        assert autoscaler.num_launches >= 1
        # The lifecycle record reaches RUNNING once membership shows it.
        deadline = time.monotonic() + 15
        while im.summary().get("RUNNING", 0) < 1:
            assert time.monotonic() < deadline, im.summary()
            autoscaler.update()
            time.sleep(0.1)
    finally:
        for pid in provider.non_terminated_nodes():
            provider.terminate_node(pid)
        controller.stop()
