"""@remote functions: the task-submission frontend (copy of
``ray_tpu/core/remote_function.py``).

Analogue of the reference's ``python/ray/remote_function.py``: wraps a Python
function, exports its pickled form once to the controller KV (reference:
``_private/function_manager.py`` exports to GCS KV), and submits invocations
through the core worker. ``.options(...)`` returns a shallow clone with
overridden submission options, exactly like the reference API.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.runtime import get_core_worker

_exported_keys = set()
_export_lock = threading.Lock()


def _resources_from_options(opts: Dict[str, Any]) -> Dict[str, float]:
    resources = dict(opts.get("resources") or {})
    num_cpus = opts.get("num_cpus")
    if num_cpus is None:
        num_cpus = 1.0 if "CPU" not in resources else resources.pop("CPU")
    resources["CPU"] = float(num_cpus)
    if opts.get("num_tpus"):
        raise ValueError("num_tpus has no card to lease on ray_tpu_torch; "
                         "pass num_gpus")
    if opts.get("num_gpus"):
        # The node spawns a GPU-resourced lease a fresh interpreter that
        # sees the card (core/node.py); every other worker has it hidden.
        resources["GPU"] = float(opts["num_gpus"])
    if resources["CPU"] == 0.0:
        del resources["CPU"]
    return resources


def export_callable(fn) -> tuple:
    """Pickle ``fn`` once and publish it to the controller KV once per
    cluster (reference: function export to GCS KV,
    ``_private/function_manager.py``). The pickle + hash is cached on the
    function object, and the KV write is synchronous before any task ships,
    so task specs carry only the key — workers fetch from KV on first use and
    cache by key. Returns (key, blob)."""
    # Read the cache from fn's OWN __dict__, never via getattr: classes
    # inherit attributes through the MRO, so after exporting a base
    # class, getattr on a SUBCLASS would return the base's cached
    # (key, blob) and every remote spawn of the subclass would silently
    # instantiate the base class on the worker.
    own = getattr(fn, "__dict__", None)
    cached = own.get("__ray_tpu_torch_export__") if own is not None else None
    if cached is None:
        blob = serialization.dumps_function(fn)
        key = "fn:" + hashlib.sha256(blob).hexdigest()[:32]
        cached = (key, blob)
        try:
            fn.__ray_tpu_torch_export__ = cached
        except (AttributeError, TypeError):
            pass  # builtins etc.: re-pickle per call
    key, blob = cached
    core = get_core_worker()
    with _export_lock:
        exported = key in _exported_keys
    if not exported:
        # The KV write happens OUTSIDE _export_lock: holding it across
        # the RPC would serialize every first-submit of every function
        # behind one controller round-trip (graftlint:
        # lock-held-blocking). Keys are content-addressed, so a
        # concurrent duplicate put is idempotent — worst case one
        # redundant RPC, never a wrong value.
        core.controller.call("kv_put", key, blob, False)
        with _export_lock:
            _exported_keys.add(key)
    return key, blob


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        self._fn = fn
        self._options = dict(options or {})
        self._desc = getattr(fn, "__qualname__", repr(fn))
        self.__name__ = getattr(fn, "__name__", "remote_function")

    def options(self, **overrides) -> "RemoteFunction":
        merged = dict(self._options)
        merged.update(overrides)
        return RemoteFunction(self._fn, merged)

    def remote(self, *args, **kwargs):
        core = get_core_worker()
        key, _ = export_callable(self._fn)
        opts = self._options
        submit_options = {
            "resources": _resources_from_options(opts),
            "num_returns": opts.get("num_returns", 1),
            "max_retries": opts.get("max_retries", 3),
            "retry_on_crash": opts.get("max_retries", 3) != 0,
            "scheduling_strategy": _strategy_dict(opts.get("scheduling_strategy")),
            "placement": _placement_tuple(opts),
            "runtime_env": _normalized_env(opts),
            "inline_results": opts.get("inline_results", True),
        }
        refs = core.submit_task(key, self._desc, args, kwargs,
                                submit_options)
        if submit_options["num_returns"] == 1:
            return refs[0]
        return refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._desc} cannot be called directly; "
            f"use .remote().")


def _normalized_env(opts) -> Optional[Dict[str, Any]]:
    """Validate the runtime_env at SUBMISSION time (typos and bad types
    fail in the driver, not as a lease error minutes later)."""
    spec = opts.get("runtime_env")
    if not spec:
        return None
    from ray_tpu_torch.runtime_env import normalize

    return normalize(spec)


def _strategy_dict(strategy) -> Optional[Dict[str, Any]]:
    if strategy is None:
        return None
    if isinstance(strategy, str):
        return {"kind": strategy.lower()}
    if isinstance(strategy, dict):
        return strategy
    # PlacementGroupSchedulingStrategy is handled by _placement_tuple.
    if hasattr(strategy, "placement_group"):
        return None
    # NodeAffinitySchedulingStrategy-like object
    if hasattr(strategy, "node_id"):
        return {"kind": "node_affinity", "node_id": strategy.node_id,
                "soft": getattr(strategy, "soft", False)}
    raise TypeError(f"unknown scheduling strategy {strategy!r}")


def _placement_tuple(opts) -> Optional[tuple]:
    pg = opts.get("placement_group")
    if pg is None:
        strategy = opts.get("scheduling_strategy")
        if hasattr(strategy, "placement_group"):
            pg = strategy.placement_group
            index = getattr(strategy, "placement_group_bundle_index", 0)
            return (pg.id.binary(), index)
        return None
    index = opts.get("placement_group_bundle_index", 0)
    return (pg.id.binary(), index)
