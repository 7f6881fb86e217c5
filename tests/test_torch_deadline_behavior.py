"""The port's deadline-safety contract: the 12 cases of
``tests/test_deadline_behavior.py`` under the same names. Each installs
a faultinject ``drop`` rule on the controller endpoint its subsystem
calls and proves the caller surfaces the typed ``RpcTimeout`` (or its
documented degraded result) within the bound. The rules file lives in
the temp directory under the port's name. One module-scoped cluster
(virtual 4-host slice, faultinject plumbed in before init) is shared by
every test.
"""

import os
import tempfile
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.core import multihost
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.multihost import GangPlacementError, HostGroup
from ray_tpu_torch.core.rpc import RpcTimeout
from ray_tpu_torch.core.runtime import get_core_worker
from ray_tpu_torch.util import faultinject
from ray_tpu_torch.util.deadline import Deadline
from ray_tpu_torch.util.faultinject import Faults

# The rules file lives in the temp directory under the port's name, one
# per process, so concurrent test workers do not share it.
_FAULTS = os.path.join(tempfile.gettempdir(),
                       f"ray_tpu_torch_deadline_faults_{os.getpid()}.json")

# Every bounded-degradation assertion allows this much wall clock: the
# configured RPC bound (1-2s in these tests) plus generous CI slack.
# The point is the order-of-magnitude contrast with "forever".
_BOUND_S = 20.0


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    saved = {k: os.environ.get(k)
             for k in ("RAY_TPU_VIRTUAL_SLICE", "RAY_TPU_FAULTINJECT_PATH")}
    os.environ["RAY_TPU_VIRTUAL_SLICE"] = "4x4/4"
    os.environ["RAY_TPU_FAULTINJECT_PATH"] = _FAULTS
    old_path = config.faultinject_path
    config.faultinject_path = _FAULTS
    faultinject.reset_counters()
    core = ray_tpu_torch.init(num_cpus=8)
    yield core
    ray_tpu_torch.shutdown()
    config.faultinject_path = old_path
    faultinject.reset_counters()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture
def short_ctrl_timeout(cluster, monkeypatch):
    monkeypatch.setattr(config, "ctrl_call_timeout_s", 1.0)
    faultinject.reset_counters()
    yield
    faultinject.reset_counters()


def _reservations():
    from ray_tpu_torch.core.placement import cluster_topology

    out = {}
    for s in cluster_topology()["slices"].values():
        out.update(s["reservations"])
    return out


# ------------------------------------------------ gang formation


def test_gang_formation_lost_reply_is_typed_refusal(cluster, monkeypatch):
    """A dropped ``mh_register_group`` reply mid-formation: the
    formation Deadline fires as RpcTimeout, the abort path releases the
    already-reserved sub-slice, and the caller gets the typed
    GangPlacementError — not a parked formation thread holding chips."""
    monkeypatch.setattr(config, "mh_form_timeout_s", 2.0)
    faultinject.reset_counters()
    t0 = time.monotonic()
    with Faults(_FAULTS) as f:
        f.add("rpc.server.controller.mh_register_group", "drop")
        with pytest.raises(GangPlacementError) as exc:
            HostGroup(2, name="dl-gang").start()
    assert time.monotonic() - t0 < _BOUND_S
    assert isinstance(exc.value.__cause__, RpcTimeout)
    # Release-once on the abort path still ran: no stranded chips.
    assert _reservations() == {}
    faultinject.reset_counters()


def test_registry_state_lost_reply_is_typed(short_ctrl_timeout):
    t0 = time.monotonic()
    with Faults(_FAULTS) as f:
        f.add("rpc.server.controller.mh_group_state", "drop")
        with pytest.raises(RpcTimeout):
            multihost.registry_state()
    assert time.monotonic() - t0 < _BOUND_S


def test_drop_gang_lost_reply_degrades_false(short_ctrl_timeout):
    """drop_gang is documented best-effort: the lost reply must come
    back as ``False`` within the bound, never a hang."""
    t0 = time.monotonic()
    with Faults(_FAULTS) as f:
        f.add("rpc.server.controller.mh_drop_group", "drop")
        assert multihost.drop_gang("no-such-group") is False
    assert time.monotonic() - t0 < _BOUND_S


# ------------------------------------------------ serve control plane


def test_serve_controller_membership_unknown_not_hung(short_ctrl_timeout):
    """The serve controller's node-membership probe: a lost list_nodes
    reply is the documented UNKNOWN (None) — the reconcile loop changes
    nothing — instead of wedging the reconcile thread."""
    from ray_tpu_torch.serve.controller import ServeController

    sc = ServeController.__new__(ServeController)
    t0 = time.monotonic()
    with Faults(_FAULTS) as f:
        f.add("rpc.server.controller.list_nodes", "drop")
        assert sc._alive_nodes() is None
    assert time.monotonic() - t0 < _BOUND_S


def test_router_existence_probe_falls_through_bounded(short_ctrl_timeout):
    """The router's fail-fast existence probe must itself fail fast: a
    lost psub_snapshot reply degrades to "can't tell" (True -> normal
    wait path) within the bound."""
    from ray_tpu_torch.serve.deployment import _Router

    r = _Router.__new__(_Router)
    r.name = "no-such-deployment"
    t0 = time.monotonic()
    with Faults(_FAULTS) as f:
        f.add("rpc.server.controller.psub_snapshot", "drop")
        assert r._known_to_controller() is True
    assert time.monotonic() - t0 < _BOUND_S


def test_serve_status_retry_runs_on_remaining_budget(monkeypatch):
    """status(timeout=T) is one budget for the WHOLE probe: the
    retry-once path must run on the REMAINING time, not a fresh T."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve import api as serve_api

    seen = []

    class _H:
        class status:  # noqa: N801 - mimics a remote method handle
            @staticmethod
            def remote():
                return "ref"

    def fake_get(ref, timeout=None):
        seen.append(timeout)
        if len(seen) == 1:
            time.sleep(0.3)
            raise RuntimeError("first attempt burned 0.3s")
        return {}

    monkeypatch.setattr(ray_tpu_torch, "get_actor", lambda name: _H())
    monkeypatch.setattr(serve_api, "_controller_alive", lambda h: True)
    monkeypatch.setattr(ray_tpu_torch, "get", fake_get)
    assert serve.status(timeout=2.0, include_slo=False) == {}
    assert len(seen) == 2
    assert seen[0] == pytest.approx(2.0, abs=0.2)
    assert seen[1] < seen[0] - 0.25  # the 0.3s burn came OUT of it


# ------------------------------------------------ pipeline plane


def test_pipeline_registry_state_lost_reply_is_typed(short_ctrl_timeout):
    from ray_tpu_torch.train.pipeline_plane import PipelinePlane

    plane = PipelinePlane.__new__(PipelinePlane)
    plane.name = "no-such-pipeline"
    t0 = time.monotonic()
    with Faults(_FAULTS) as f:
        f.add("rpc.server.controller.pipe_state", "drop")
        with pytest.raises(RpcTimeout):
            plane.registry_state()
    assert time.monotonic() - t0 < _BOUND_S


# ------------------------------------------------ autopilot


def test_autopilot_status_taints_degrade_bounded(short_ctrl_timeout):
    """Autopilot.status() against a head that eats taint_state replies:
    the taints panel degrades to {} within the bound — observability of
    the autopilot must not hang on the exact outage it watches for."""
    from ray_tpu_torch.autopilot import Autopilot

    pilot = Autopilot(client=get_core_worker().controller)
    t0 = time.monotonic()
    with Faults(_FAULTS) as f:
        f.add("rpc.server.controller.taint_state", "drop")
        out = pilot.status()
    assert out["taints"] == {}
    assert time.monotonic() - t0 < _BOUND_S


# ------------------------------------------------ log streamer


def test_log_streamer_key_discovery_lost_reply_is_typed(cluster,
                                                        monkeypatch):
    """psub_keys was the streamer's ONE unbounded call (the long-polls
    were already bounded): a lost reply now raises RpcTimeout into the
    _loop's catch-and-backoff instead of parking the pump forever."""
    from ray_tpu_torch.core import log_monitor
    from ray_tpu_torch.core.log_monitor import LogStreamer

    monkeypatch.setattr(log_monitor, "_RPC_SLACK_S", 1.0)
    faultinject.reset_counters()
    streamer = LogStreamer.__new__(LogStreamer)
    streamer._controller = get_core_worker().controller
    streamer._seen = {}
    streamer._versions = {}
    streamer._stopped = threading.Event()
    t0 = time.monotonic()
    with Faults(_FAULTS) as f:
        f.add("rpc.server.controller.psub_keys", "drop")
        with pytest.raises(RpcTimeout):
            streamer.poll_once(window_s=0.2)
    assert time.monotonic() - t0 < _BOUND_S
    faultinject.reset_counters()


# ------------------------------------------------ Deadline helper


def test_deadline_unlimited_and_bounded():
    assert Deadline.after(None).remaining() is None
    assert not Deadline.after(None).expired
    dl = Deadline.after(5.0)
    r = dl.remaining()
    assert 0.0 < r <= 5.0
    assert not dl.expired


def test_deadline_expired_floors_not_forever():
    """An overdrawn budget must read as a tiny FINITE wait (so the
    typed timeout fires promptly), never as None/forever."""
    dl = Deadline(time.monotonic() - 1.0)
    assert dl.expired
    r = dl.remaining()
    assert r is not None and 0.0 < r <= 0.01


def test_deadline_child_capped_by_parent():
    parent = Deadline.after(10.0)
    child = parent.sub(2.0)
    assert child.remaining() <= 2.0
    capped = parent.sub(100.0)
    assert capped.remaining() <= parent.remaining() + 0.01
    assert Deadline.after(None).sub(3.0).remaining() <= 3.0
