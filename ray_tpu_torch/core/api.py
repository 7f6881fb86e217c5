"""Public core API: init / remote / get / put / wait / free / kill (copy of
``ray_tpu/core/api.py``).

Analogue of the reference's ``python/ray/_private/worker.py`` module-level API
(``ray.init`` :1225, ``get`` :2562, ``put`` :2688, ``wait`` :2753, ``remote``
:3146). ``init()`` with no address boots an in-process cluster — controller +
one node supervisor — then connects this process as the driver; ``init
(address=(host, port))`` connects to an existing cluster (the
multi-node-in-one-machine fixture from ``ray_tpu_torch.cluster_utils`` uses
this), and ``init(address="ray-tpu://host:port")`` connects a thin client
(``ray_tpu_torch.client``).

Where the port differs: ``init()`` advertises the node's cards as the
``GPU`` resource (``nvidia-smi -L``, so the driver's node threads never
create a CUDA context).
"""

from __future__ import annotations

import atexit
import inspect
import logging
import os
import subprocess
import uuid
from typing import Any, Dict, Optional, Sequence

from ray_tpu_torch.core.actor import ActorClass
from ray_tpu_torch.core.actor import get_actor as _get_actor_direct
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.errors import RayTpuError
from ray_tpu_torch.core.ids import NodeID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.remote_function import RemoteFunction
from ray_tpu_torch.core.runtime import (
    CoreWorker,
    get_core_worker,
    is_initialized,  # noqa: F401
    set_core_worker,
)

logger = logging.getLogger(__name__)

_local_cluster = None  # (controller, node) started by init()
_config_snapshot = None  # config state to restore on shutdown
_log_streamer = None  # driver-side worker-log echo (log_monitor.LogStreamer)


def init(
    address: Optional[Any] = None,
    num_cpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    labels: Optional[Dict[str, str]] = None,
    _system_config: Optional[Dict[str, Any]] = None,
    ignore_reinit_error: bool = False,
):
    """Start (or connect to) a cluster and attach this process as a driver.

    ``address="ray-tpu://host:port"`` instead connects as a THIN CLIENT to a
    :class:`ray_tpu_torch.client.ClientServer` running inside the cluster —
    this process never joins the cluster, needs one outbound connection
    only, and creates no CUDA context (reference: Ray Client,
    ``util/client/``)."""
    global _local_cluster
    if isinstance(address, str) and address.startswith("ray-tpu://"):
        from ray_tpu_torch import client as client_mod

        client = client_mod.connect(address,
                                    ignore_reinit_error=ignore_reinit_error)
        atexit.register(shutdown)
        return client
    if is_initialized():
        if ignore_reinit_error:
            return get_core_worker()
        raise RayTpuError("ray_tpu_torch.init() called twice; "
                          "pass ignore_reinit_error=True to allow")
    global _config_snapshot
    _config_snapshot = config.snapshot()
    if _system_config:
        config.update(_system_config)

    if address is None:
        from ray_tpu_torch.core.controller import Controller
        from ray_tpu_torch.core.node import Node

        node_resources = dict(resources or {})
        if num_cpus is not None:
            node_resources["CPU"] = float(num_cpus)
        node_resources.setdefault("CPU", float(os.cpu_count() or 1))
        _autodetect_gpu(node_resources, labels := dict(labels or {}))
        controller = Controller()
        node = Node(controller.address, node_resources, labels)
        _local_cluster = (controller, node)
        controller_addr = controller.address
        node_addr, node_id = node.address, node.node_id
    else:
        controller_addr = tuple(address)
        from ray_tpu_torch.core.rpc import RpcClient

        probe = RpcClient(controller_addr)
        nodes = [n for n in probe.call("list_nodes") if n["alive"]]
        probe.close()
        if not nodes:
            raise RayTpuError(f"no alive nodes in cluster at {address}")
        head = nodes[0]
        node_addr = tuple(head["addr"])
        node_id = NodeID.from_hex(head["node_id"])

    core = CoreWorker("driver", controller_addr, node_addr, node_id)
    set_core_worker(core)
    core.controller.call("register_job", uuid.uuid4().hex[:8],
                         {"driver_pid": os.getpid()})
    global _log_streamer
    if config.log_to_driver:
        from ray_tpu_torch.core.log_monitor import LogStreamer

        _log_streamer = LogStreamer(core.controller)
    atexit.register(shutdown)
    return core


def detect_gpus(timeout_s: float = 20.0):
    """(card count, first card's name) of this host, without creating a
    CUDA context: ``nvidia-smi -L`` in a subprocess under a timeout, then
    ``CUDA_VISIBLE_DEVICES`` when it is set (an empty value hides every
    card). (0, None) when there is no driver or no card."""
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=timeout_s)
    except (OSError, subprocess.TimeoutExpired):
        return 0, None
    if out.returncode != 0:
        return 0, None
    cards = [line.split(":", 1)[1].split("(")[0].strip()
             for line in out.stdout.splitlines() if line.startswith("GPU ")]
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        keep = [v.strip() for v in visible.split(",") if v.strip()]
        # Indices pick cards; a UUID or MIG entry counts as one card.
        cards = [cards[int(v)] if v.isdigit() else (cards or [v])[0]
                 for v in keep if not v.isdigit() or int(v) < len(cards)]
    return len(cards), (cards[0] if cards else None)


def _autodetect_gpu(resources: Dict[str, float],
                    labels: Dict[str, str]) -> None:
    """Expose the host's cards as the ``GPU`` resource (reference:
    ``_private/accelerators/nvidia_gpu.py``; counted with ``nvidia-smi``,
    never through a CUDA call in this process)."""
    if "GPU" in resources:
        return
    count, name = detect_gpus()
    if count:
        resources["GPU"] = float(count)
        labels.setdefault("gpu_name", name)


def shutdown() -> None:
    global _local_cluster, _config_snapshot, _log_streamer
    client = _client()
    if client is not None:
        client.disconnect()
        return
    if not is_initialized():
        return
    if _log_streamer is not None:
        # Final drain so prints from the last scan window reach the driver
        # before the cluster goes away.
        try:
            if _local_cluster is not None and \
                    _local_cluster[1].log_monitor is not None:
                _local_cluster[1].log_monitor.scan_once()
            _log_streamer.poll_once(window_s=0.2)
        except Exception:  # final log drain at shutdown
            logger.debug("final log drain failed", exc_info=True)
        _log_streamer.stop()
        _log_streamer = None
    try:
        # Local-only usage report (reference phones home; we never do).
        from ray_tpu_torch import usage as _usage

        _usage.write_report()
    except Exception:  # graftlint: disable=swallowed-exception (local usage report is optional)
        pass
    if _config_snapshot is not None:
        # _system_config overrides are scoped to the init()..shutdown() span;
        # restore so a later init() in the same process starts clean.
        config.update(_config_snapshot)
        _config_snapshot = None
    core = get_core_worker()
    set_core_worker(None)
    try:
        core.shutdown()
    except Exception:  # best-effort core teardown
        logger.debug("core worker shutdown failed", exc_info=True)
    if _local_cluster is not None:
        controller, node = _local_cluster
        _local_cluster = None
        try:
            node.stop()
        finally:
            controller.stop()
    # Reset per-process caches so a fresh init() starts clean.
    from ray_tpu_torch.core import actor as _actor
    from ray_tpu_torch.core import remote_function as _rf
    from ray_tpu_torch.util.metrics import _Registry

    _rf._exported_keys.clear()
    _actor._seq_counters.clear()
    _actor._inflight.clear()
    _Registry.get().clear_series()


def _client():
    """Active thin-client connection, if this process is in client mode."""
    from ray_tpu_torch import client as client_mod

    return client_mod.current_client()


def remote(*args, **options):
    """``@remote`` decorator for functions and classes (reference:
    ``worker.py:3146``)."""

    def decorate(target):
        if _client() is not None:
            from ray_tpu_torch import client as client_mod

            if inspect.isclass(target):
                return client_mod.ClientActorClass(target, options)
            return client_mod.ClientRemoteFunction(target, options)
        if inspect.isclass(target):
            return ActorClass(target, options)
        return RemoteFunction(target, options)

    if len(args) == 1 and callable(args[0]) and not options:
        return decorate(args[0])
    if args:
        raise TypeError("@remote options must be keyword arguments")
    return decorate


def get(refs, timeout: Optional[float] = None):
    client = _client()
    if client is not None:
        return client.get(refs, timeout)
    return get_core_worker().get(refs, timeout)


def put(value: Any) -> ObjectRef:
    client = _client()
    if client is not None:
        return client.put(value)
    return get_core_worker().put(value)


def wait(refs: Sequence[ObjectRef], num_returns: int = 1,
         timeout: Optional[float] = None):
    client = _client()
    if client is not None:
        return client.wait(refs, num_returns, timeout)
    return get_core_worker().wait(refs, num_returns, timeout)


def free(refs) -> None:
    """Eagerly release the object-store entries behind ``refs`` (one ref or
    a list; ``None`` entries are skipped). Owner-local refs free
    synchronously; remote owners get a best-effort ``free_object`` notify
    (an unreachable owner is usually a dead one, whose objects died with
    it). The serve plane's KV-page handoff drops its page payloads this
    way within one engine step of the adopt / abort decision."""
    if isinstance(refs, ObjectRef):
        refs = [refs]
    core = get_core_worker()
    for ref in refs:
        if ref is None:
            continue
        if ref.owner_addr in (None, core.addr):
            core.free_object(ref.id)
        else:
            try:
                core.clients.get(ref.owner_addr).notify(
                    "free_object", ref.id.binary())
            except Exception:  # noqa: BLE001 — dead owner == already freed
                from ray_tpu_torch.util.ratelimit import log_every

                log_every("api.free", 30.0, logger,
                          "remote free_object notify failed",
                          exc_info=True)


def kill(actor_handle, no_restart: bool = True) -> None:
    client = _client()
    if client is not None:
        from ray_tpu_torch.client import ClientActorHandle

        if isinstance(actor_handle, ClientActorHandle):
            client.kill(actor_handle, no_restart=no_restart)
            return
    actor_handle.kill(no_restart=no_restart)


def cluster_resources() -> Dict[str, float]:
    client = _client()
    if client is not None:
        return client.cluster_resources()
    return get_core_worker().controller.call("cluster_resources")


def get_actor(name: str):
    """Look up a named actor (reference: ``ray.get_actor``)."""
    client = _client()
    if client is not None:
        return client.get_actor(name)
    return _get_actor_direct(name)


def nodes():
    return get_core_worker().controller.call("list_nodes")


def available_resources() -> Dict[str, float]:
    total: Dict[str, float] = {}
    for n in nodes():
        if n["alive"]:
            for k, v in n["available"].items():
                total[k] = total.get(k, 0.0) + v
    return total
