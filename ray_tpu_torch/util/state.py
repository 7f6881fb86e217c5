"""Python state API (copy of ``ray_tpu/util/state.py``; reference:
``ray.util.state`` — ``api.py``:
``list_nodes/list_actors/list_tasks/list_jobs/summarize_tasks``).

The CLI (``python -m ray_tpu_torch list ...``) and dashboard share these
same controller RPCs; this module is the in-process Python surface.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


def _controller():
    from ray_tpu_torch.core.runtime import get_core_worker

    return get_core_worker().controller


def list_nodes() -> List[Dict[str, Any]]:
    return _controller().call("list_nodes")


def list_actors() -> List[Dict[str, Any]]:
    return _controller().call("list_actors")


def list_jobs() -> Dict[str, Dict[str, Any]]:
    return _controller().call("list_jobs")


def list_tasks(limit: int = 1000) -> List[Dict[str, Any]]:
    """Recent task state-transition events (FINISHED/FAILED/SPAN...)."""
    return _controller().call("list_task_events", limit)


def node_infos(nodes: Optional[List[Dict[str, Any]]] = None,
               timeout: float = 10.0) -> List[Dict[str, Any]]:
    """Live node-supervisor ``get_info`` for every alive node (the ONE
    per-node poll shared by ``list_objects``, the ``memory`` CLI and the
    dashboard — pass ``nodes`` when the caller already has a node list or
    no core worker, e.g. a standalone controller client). Unreachable
    nodes yield an ``{"error": ...}`` entry rather than disappearing; RPCs
    are bounded so one hung supervisor can't wedge the caller."""
    from ray_tpu_torch.core.rpc import RpcClient

    out = []
    for n in (nodes if nodes is not None else list_nodes()):
        if not n.get("alive"):
            continue
        client = None
        try:
            client = RpcClient(tuple(n["addr"]), connect_timeout=timeout)
            # graftlint: disable=deadline-not-propagated (PER-NODE bound by design: the docstring's contract is that one hung supervisor costs at most `timeout`, not that the whole sweep fits in it — errors fill in for slow nodes, so a Deadline here would starve the tail of a big cluster)
            out.append(client.call("get_info", timeout=timeout))
        except Exception as e:
            out.append({"node_id": n["node_id"], "error": str(e)})
        finally:
            if client is not None:
                client.close()
    return out


def list_objects() -> List[Dict[str, Any]]:
    """Per-node object-store occupancy (the object-level listing the
    reference offers is owner-distributed; store totals are the
    cluster-level view). Unreachable nodes appear with an ``error`` field
    so capacity sums don't silently shrink."""
    out = []
    for info in node_infos():
        if "error" in info:
            out.append({"node_id": info["node_id"],
                        "error": info["error"]})
        else:
            out.append({
                "node_id": info["node_id"],
                "store_used_bytes": info.get("store_used_bytes", 0),
                "store_capacity_bytes": info.get("store_capacity_bytes", 0),
                "spilled_bytes": info.get("spilled_bytes", 0),
            })
    return out


def summarize_tasks(limit: int = 10000) -> Dict[str, Any]:
    """Counts by (desc, state) — reference: ``ray summary tasks``."""
    summary: Dict[str, Dict[str, int]] = {}
    for e in list_tasks(limit):
        desc = e.get("desc") or e.get("task_id", "?")[:8]
        states = summary.setdefault(desc, {})
        state = e.get("state", "?")
        states[state] = states.get(state, 0) + 1
    return {"by_task": summary,
            "total": sum(sum(s.values()) for s in summary.values())}


def cluster_resources() -> Dict[str, float]:
    return _controller().call("cluster_resources")


def available_resources() -> Dict[str, float]:
    total: Dict[str, float] = {}
    for n in list_nodes():
        if n.get("alive"):
            for k, v in n.get("available", {}).items():
                total[k] = total.get(k, 0.0) + v
    return total
