"""Usage report (copy of ``ray_tpu/usage.py``; reference:
``_private/usage/usage_lib.py``).

The reference phones cluster usage home unless opted out. This build has
zero egress by design, so the equivalent surface is LOCAL-ONLY: a JSON
usage report summarizing the cluster (nodes, resources, library features
touched) written under the session tmp dir, for operators to inspect or
ship themselves. Disable entirely with ``RAY_TPU_USAGE_STATS_ENABLED=0``.

The report goes under the temp directory, in ``ray_tpu_torch_usage_<uid>``,
so a JAX runtime's report is never overwritten.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Dict

REPORT_DIR = os.path.join(tempfile.gettempdir(),
                          f"ray_tpu_torch_usage_{os.getuid()}")

_features: set = set()


def enabled() -> bool:
    return os.environ.get("RAY_TPU_USAGE_STATS_ENABLED", "1") not in (
        "0", "false", "False")


def record_feature(name: str) -> None:
    """Library entry points call this (cheap set add) so the report shows
    which subsystems a workload actually used."""
    if enabled():
        _features.add(name)


def collect() -> Dict[str, Any]:
    from ray_tpu_torch.core.runtime import get_core_worker

    report: Dict[str, Any] = {
        "ts": time.time(),
        "version": _version(),
        "features": sorted(_features),
    }
    try:
        core = get_core_worker()
        nodes = core.controller.call("list_nodes")
        report["nodes"] = len([n for n in nodes if n["alive"]])
        report["cluster_resources"] = core.controller.call(
            "cluster_resources")
    except Exception:  # graftlint: disable=swallowed-exception (local-only telemetry probe; absence of a source is normal)
        pass
    return report


def write_report() -> str:
    """Write the local usage report; returns its path ('' if disabled).
    Features reset afterwards so a later init()/shutdown() cycle in the
    same process reports only its own session."""
    if not enabled():
        return ""
    os.makedirs(REPORT_DIR, exist_ok=True)
    path = os.path.join(REPORT_DIR, "usage_latest.json")
    try:
        with open(path, "w") as f:
            json.dump(collect(), f, indent=2, default=str)
    except OSError:
        return ""
    finally:
        _features.clear()
    return path


def _version() -> str:
    try:
        from ray_tpu_torch._version import __version__

        return __version__
    except Exception:
        return "unknown"
