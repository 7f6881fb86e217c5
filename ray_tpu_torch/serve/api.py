"""serve.run / status / delete + HTTP ingress management.

Analogue of the reference's ``serve.run`` (``serve/api.py``). All
control-plane state lives in the ServeController ACTOR (``controller.py``)
— this module is a thin client, so deployments survive the driver that
created them; a later driver resolves the controller by name and keeps
operating the same apps. The HTTP data plane is per-node ProxyActors
supervised by that controller (``proxy.py``; reference:
``serve/_private/proxy.py:131``, ``proxy_state.py``) — NOT a server in the
driver process, so ingress survives driver exit too.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.core import serialization
from ray_tpu_torch.serve.controller import get_or_create_controller
from ray_tpu_torch.serve.deployment import Deployment, DeploymentHandle, _Router


def run(app: Deployment, name: Optional[str] = None,
        route_prefix: Optional[str] = None,
        ready_timeout_s: float = 60.0) -> DeploymentHandle:
    """Deploy (or redeploy) an application; returns its handle. A
    deployment with a ``mesh_shape`` gets replicas that span a sub-slice,
    one process a rank (the serve controller's ``_spawn_mesh``)."""
    from ray_tpu_torch import usage as _usage

    _usage.record_feature("serve.run")
    cfg = app.config_dict()
    name = name or app.name
    controller = get_or_create_controller()
    version = ray_tpu_torch.get(controller.deploy.remote(
        name, serialization.dumps_function(app.cls), app._init_args,
        app._init_kwargs, cfg), timeout=ready_timeout_s)
    # HTTP route: explicit prefix, or /<name> by default. Stored on the
    # controller so proxies on ANY node resolve it.
    ray_tpu_torch.get(controller.set_route.remote(
        route_prefix or f"/{name}", name), timeout=30.0)
    handle = DeploymentHandle(name)
    router = _Router.get(name)
    if version is not None:
        router.wait_version(version, ready_timeout_s)
    else:
        router.wait_ready(ready_timeout_s)
    return handle


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def _controller_alive(handle) -> bool:
    """Cheap actor-table read: is the serve controller's record ALIVE
    right now? (RESTARTING/DEAD callers should degrade immediately
    instead of parking a blocking call against the restart.)"""
    try:
        from ray_tpu_torch.core.rpc_stubs import ControllerStub
        from ray_tpu_torch.core.runtime import get_core_worker

        rec = ControllerStub(get_core_worker().controller).get_actor(
            handle.actor_id.binary(), timeout=5.0)
        return rec is not None and rec["state"] == "ALIVE"
    except Exception:
        return False


def _degraded_status() -> Dict[str, Any]:
    """The cached view this process's routers hold: what ``status``
    degrades to while the serve controller is down or restarting. Every
    entry carries ``degraded: True`` so callers can tell a cached
    replica count from a reconciled one."""
    from ray_tpu_torch.serve.deployment import _Router

    with _Router._instances_lock:
        routers = dict(_Router._instances)
    out: Dict[str, Any] = {}
    for name, router in routers.items():
        with router._lock:
            out[name] = {
                "replicas": len(router._replicas),
                "replica_ids": [r["id"] for r in router._replicas],
                "degraded": True,
            }
    return out


def status(timeout: float = 30.0, include_slo: bool = True
           ) -> Dict[str, Any]:
    """Per-deployment control-plane state — replica count, autoscale
    load, page-pool health, disaggregation posture (``role``,
    ``decode_deployment``, live handoff leases ``handoffs_live`` /
    ``handoff_live_bytes``) — plus (``include_slo``) the SLO
    DISTRIBUTIONS from the metrics pipeline: each deployment gains
    an ``slo`` dict with TTFT / inter-token / queue-wait / HTTP-latency
    / handoff histogram summaries (count, mean, p50, p99), outcome
    counters and handoff lease-event counters — the same numbers the
    dashboard serve panel and the proxy's ``/metrics`` route report,
    because all three read the controller's aggregated registry
    through ``serve.metrics.slo_summary``.

    FAILS SOFT during a controller outage: when the controller actor is
    dead or restarting, the call returns this process's cached routing
    view (entries marked ``degraded: True``) instead of raising — the
    observing path must not be the thing that breaks first during the
    exact failure it is observing. The failed probe doubles as the
    failure report that triggers the controller's restart."""
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME
    from ray_tpu_torch.util.deadline import Deadline

    # ``timeout`` is the budget for the WHOLE probe, not per attempt:
    # the retry below runs on the REMAINING time, so a controller that
    # burned the first attempt to its deadline degrades immediately
    # instead of earning a second full allowance.
    dl = Deadline.after(timeout)
    try:
        # Lookup, not get_or_create: a status probe must neither SPAWN
        # a control plane nor block a long ping against a restarting
        # one — the degraded view answers immediately either way.
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        if not _controller_alive(controller):
            return _degraded_status()  # mid-restart: don't park on it
        try:
            st = ray_tpu_torch.get(controller.status.remote(),
                             timeout=dl.remaining())
        except Exception:
            # The failed call doubles as the failure report that starts
            # the controller's restart. Retry once on the same handle
            # ONLY if the record is still ALIVE — that's the
            # fresh-handle-to-restarted-actor case (stale incarnation
            # hint, the failure taught the handle the live one); a
            # record now RESTARTING means a real outage: degrade.
            if not _controller_alive(controller):
                return _degraded_status()
            st = ray_tpu_torch.get(controller.status.remote(),
                             timeout=dl.remaining())
    except Exception:
        return _degraded_status()
    if include_slo:
        try:
            from ray_tpu_torch.core.runtime import get_core_worker
            from ray_tpu_torch.serve.metrics import slo_summary

            agg = get_core_worker().controller.call("list_metrics",
                                                    timeout=10.0)
            slo = slo_summary(agg)
            for name, rec in st.items():
                rec["slo"] = slo.get(name, {})
        except Exception:
            # Histograms are additive detail: a briefly unreachable
            # head must not fail the whole status() call.
            from ray_tpu_torch.util.ratelimit import log_every

            log_every("serve.status_slo", 30.0,
                      __import__("logging").getLogger(__name__),
                      "SLO summary fetch failed", exc_info=True)
    return st


def timelines(timeout: float = 30.0) -> Dict[str, Any]:
    """Engine step timelines per deployment/replica (see
    ``serve/steplog.py``); merged into a Chrome trace by
    ``python -m ray_tpu timeline --serve``."""
    controller = get_or_create_controller()
    return ray_tpu_torch.get(controller.timelines.remote(), timeout=timeout)


def proxy_status(timeout: float = 30.0) -> Dict[str, Any]:
    """Per-node proxy health (node hex -> addr + consecutive failures)."""
    controller = get_or_create_controller()
    return ray_tpu_torch.get(controller.proxy_status.remote(), timeout=timeout)


def delete(name: str, timeout: float = 30.0) -> None:
    controller = get_or_create_controller()
    ray_tpu_torch.get(controller.delete.remote(name), timeout=timeout)


def shutdown(drain_timeout_s: float = 10.0) -> None:
    """Tear down all deployments AND the controller actor. Proxies drain
    FIRST (stop accepting, let in-flight requests finish against
    still-live replicas — reference: proxy draining on serve shutdown)."""
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME

    controller = None
    try:
        # Lookup, not get_or_create: tearing down serve that was never
        # started must not SPAWN a control plane.
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        controller = None
    if controller is None:
        _Router.reset_all()
        return
    try:
        ray_tpu_torch.get(controller.shutdown.remote(drain_timeout_s),
                    timeout=drain_timeout_s + 60.0)
    except Exception:  # graftlint: disable=swallowed-exception (best-effort serve teardown)
        pass
    finally:
        # Kill even when the graceful path timed out: a surviving named
        # controller whose _stop is set would be resolved by the next
        # serve.run as a zombie that never reconciles anything.
        if controller is not None:
            try:
                ray_tpu_torch.kill(controller)
            except Exception:  # graftlint: disable=swallowed-exception (best-effort serve teardown)
                pass
        # Drop the durable checkpoint too: shutdown is the ONE
        # controller death that must not be survived — a controller
        # created later (next serve.run) starts fresh instead of
        # adopting the ghosts of the plane we just tore down. (The
        # graceful path already checkpointed empty state; this covers
        # the timed-out/killed path.)
        try:
            from ray_tpu_torch.core.rpc_stubs import ControllerStub
            from ray_tpu_torch.core.runtime import get_core_worker
            from ray_tpu_torch.serve.controller import STATE_KEY

            ControllerStub(get_core_worker().controller).kv_del(STATE_KEY)
        except Exception:  # graftlint: disable=swallowed-exception (best-effort serve teardown)
            pass
    _Router.reset_all()


def start_http(host: str = "127.0.0.1", port: int = 0,
               ready_timeout_s: float = 60.0) -> Tuple[str, int]:
    """Enable per-node HTTP ingress (idempotent) and wait until every
    alive node has a listening proxy. Returns ONE reachable (host, port)
    — the proxy on this process's node when there is one, else the first
    (back-compat with the single-address shape; ``http_addresses()`` is
    the full per-node map). The wait polls CLIENT-side — the controller
    actor runs calls serially, so it must never block in enable_http."""
    controller = get_or_create_controller()
    state = ray_tpu_torch.get(controller.enable_http.remote(host, port),
                        timeout=60.0)
    deadline = time.monotonic() + ready_timeout_s
    while not (state["addrs"] and state["want"]
               and len(state["addrs"]) >= state["want"]):
        if time.monotonic() > deadline:
            if state["addrs"]:
                break  # partial ingress beats none after the deadline
            raise RuntimeError(f"no serve proxies came up: {state}")
        time.sleep(0.2)
        state = ray_tpu_torch.get(controller.http_ready.remote(), timeout=30.0)
    addrs = state["addrs"]
    try:
        from ray_tpu_torch.core.runtime import get_core_worker

        local = get_core_worker().node_id.hex()
    except Exception:
        local = None
    addr = addrs.get(local) or next(iter(addrs.values()))
    return tuple(addr)


def http_addresses() -> Dict[str, tuple]:
    """Pure getter: node hex -> (host, port) of live proxies. Does NOT
    enable ingress (``start_http`` does) — a getter that re-enabled HTTP
    would silently undo ``stop_http``."""
    controller = get_or_create_controller()
    return ray_tpu_torch.get(controller.http_addresses.remote(), timeout=30.0)


def stop_http(drain_timeout_s: float = 10.0) -> None:
    """Drain and stop every proxy (ingress off; deployments stay up).
    No-op when no controller exists — defensive cleanup must not SPAWN a
    control plane just to tell it to stop."""
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME

    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return
    ray_tpu_torch.get(controller.disable_http.remote(drain_timeout_s),
                timeout=drain_timeout_s + 60.0)
