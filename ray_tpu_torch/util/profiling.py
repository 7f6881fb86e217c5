"""On-demand worker profiling: CPU flamegraphs + heap snapshots.

Analogue of the reference's dashboard profiling endpoints
(``dashboard/modules/reporter/profile_manager.py:79`` attaches py-spy for
CPU flamegraphs, ``:190`` memray for heap). Here both are NATIVE and
zero-dependency: a sampling thread collapses ``sys._current_frames`` into
folded stacks (the flamegraph input format), rendered as a self-contained
SVG; heap profiling uses ``tracemalloc`` snapshots with growth diffing
between calls. Exposed as RPCs on every live worker (``profile_cpu`` /
``profile_heap``), surfaced through the ``ray_tpu profile`` CLI and the
dashboard's per-worker drill-down pages.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

# ------------------------------------------------------------ CPU sampling


def sample_stacks(duration_s: float = 3.0, hz: float = 100.0,
                  exclude_self: bool = True) -> Dict[str, int]:
    """Sample every thread's Python stack for ``duration_s`` and return
    folded stacks ("frame;frame;frame" -> sample count) — the flamegraph
    wire format. Pure-Python sampling costs one GIL hop per tick; at
    100 Hz that is well under 1% overhead."""
    counts: Dict[str, int] = {}
    me = threading.get_ident()
    period = 1.0 / max(1.0, hz)
    deadline = time.monotonic() + duration_s
    while time.monotonic() < deadline:
        for tid, top in sys._current_frames().items():
            if exclude_self and tid == me:
                continue
            frames: List[str] = []
            frame = top
            while frame is not None:
                code = frame.f_code
                frames.append(
                    f"{code.co_name} ({code.co_filename.rsplit('/', 1)[-1]}"
                    f":{frame.f_lineno})")
                frame = frame.f_back
            key = ";".join(reversed(frames))
            counts[key] = counts.get(key, 0) + 1
        time.sleep(period)
    return counts


# ------------------------------------------------------------- flamegraph


class _Node:
    __slots__ = ("name", "value", "children")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self.children: Dict[str, "_Node"] = {}


def _build_trie(folded: Dict[str, int]) -> _Node:
    root = _Node("all")
    for stack, count in folded.items():
        root.value += count
        node = root
        for frame in stack.split(";"):
            child = node.children.get(frame)
            if child is None:
                child = _Node(frame)
                node.children[frame] = child
            child.value += count
            node = child
    return root


def _color(name: str) -> str:
    h = hash(name) & 0xFFFF
    r = 205 + (h % 50)
    g = 80 + ((h >> 4) % 110)
    b = 40 + ((h >> 8) % 40)
    return f"rgb({r},{g},{b})"


def flamegraph_svg(folded: Dict[str, int], width: int = 1100,
                   row_h: int = 17, title: str = "CPU flamegraph") -> str:
    """Render folded stacks as a self-contained SVG flamegraph (hover
    titles carry frame + sample counts; no JS, no external assets)."""
    root = _build_trie(folded)
    if root.value == 0:
        # Keep the caller's title: it often carries the ERROR ("no worker
        # xyz") and a bare "no samples" would read as an idle process.
        safe = (title.replace("&", "&amp;").replace("<", "&lt;"))
        return ("<svg xmlns='http://www.w3.org/2000/svg' width='700' "
                f"height='40'><text x='5' y='25'>{safe} — no samples"
                "</text></svg>")

    def depth(node: _Node) -> int:
        return 1 + max((depth(c) for c in node.children.values()),
                       default=0)

    def esc(s: str) -> str:
        return (s.replace("&", "&amp;").replace("<", "&lt;")
                .replace(">", "&gt;").replace("'", "&apos;"))

    height = (depth(root) + 2) * row_h
    out = [
        f"<svg xmlns='http://www.w3.org/2000/svg' width='{width}' "
        f"height='{height}' font-family='monospace' font-size='11'>",
        f"<text x='5' y='{row_h - 4}' font-size='13'>{esc(title)} "
        f"({root.value} samples)</text>",
    ]

    def emit(node: _Node, x: float, y: int, w: float) -> None:
        if w < 1.0:
            return
        pct = 100.0 * node.value / root.value
        out.append(
            f"<g><title>{esc(node.name)} — {node.value} samples "
            f"({pct:.1f}%)</title>"
            f"<rect x='{x:.1f}' y='{y}' width='{w:.1f}' "
            f"height='{row_h - 1}' fill='{_color(node.name)}' rx='1'/>")
        if w > 40:
            label = esc(node.name)[:int(w / 6.5)]
            out.append(f"<text x='{x + 2:.1f}' y='{y + row_h - 5}' "
                       f"fill='#222'>{label}</text>")
        out.append("</g>")
        cx = x
        for child in sorted(node.children.values(),
                            key=lambda c: -c.value):
            cw = w * child.value / node.value
            emit(child, cx, y + row_h, cw)
            cx += cw

    emit(root, 0.0, row_h, float(width))
    out.append("</svg>")
    return "".join(out)


# ------------------------------------------------------------------ heap

_heap_lock = threading.Lock()
_heap_prev = None  # previous snapshot for growth diffing


def stop_heap_profile() -> Dict[str, object]:
    """Turn allocation tracing back OFF (tracing costs every allocation a
    traceback capture — a diagnostic probe must not slow the worker for
    the rest of its life)."""
    import tracemalloc

    global _heap_prev
    with _heap_lock:
        was = tracemalloc.is_tracing()
        if was:
            tracemalloc.stop()
        _heap_prev = None
        return {"stopped": was}


def heap_profile(top_n: int = 25) -> Dict[str, object]:
    """tracemalloc snapshot of this process. First call starts tracing
    (subsequent allocations get tracked); later calls return the top
    allocation sites AND the growth since the previous call (the memray
    'leaks between two points' workflow). Call :func:`stop_heap_profile`
    (RPC ``profile_heap_stop``) when done."""
    import tracemalloc

    global _heap_prev
    with _heap_lock:
        if not tracemalloc.is_tracing():
            tracemalloc.start(16)
            _heap_prev = None
            return {"started": True,
                    "note": "tracing started; call again to see "
                            "allocations made from now on, and "
                            "profile_heap_stop when done"}
        snap = tracemalloc.take_snapshot()
        snap = snap.filter_traces([
            tracemalloc.Filter(False, tracemalloc.__file__),
            tracemalloc.Filter(False, "<frozen importlib._bootstrap>"),
        ])
        top = [{
            "site": str(stat.traceback[-1]) if stat.traceback else "?",
            "size_kb": round(stat.size / 1024, 1),
            "count": stat.count,
        } for stat in snap.statistics("lineno")[:top_n]]
        growth = []
        if _heap_prev is not None:
            growth = [{
                "site": str(stat.traceback[-1]) if stat.traceback else "?",
                "size_diff_kb": round(stat.size_diff / 1024, 1),
                "count_diff": stat.count_diff,
            } for stat in snap.compare_to(_heap_prev, "lineno")[:top_n]]
        _heap_prev = snap
        current, peak = tracemalloc.get_traced_memory()
        return {"started": False,
                "traced_current_kb": round(current / 1024, 1),
                "traced_peak_kb": round(peak / 1024, 1),
                "top": top, "growth_since_last": growth}


def list_cluster_workers(controller_client, prefix: Optional[str] = None,
                         rpc_timeout: float = 10.0) -> List[Dict]:
    """Enumerate live workers across all alive nodes (each row carries a
    ``node_id``). One bounded RPC per node; unreachable nodes are skipped
    and never leak a client. Shared by the CLI and the dashboard."""
    from ray_tpu_torch.core.rpc import RpcClient

    out: List[Dict] = []
    for node in controller_client.call("list_nodes",
                                       timeout=rpc_timeout):
        if not node.get("alive"):
            continue
        node_client = None
        try:
            node_client = RpcClient(tuple(node["addr"]))
            workers = node_client.call("list_workers",
                                       timeout=rpc_timeout)
        except Exception:
            continue
        finally:
            if node_client is not None:
                node_client.close()
        for w in workers:
            if prefix is None or w["worker_id"].startswith(prefix):
                w["node_id"] = node["node_id"]
                out.append(w)
    return out


def profile_worker(addr: Tuple[str, int], duration_s: float = 3.0,
                   hz: float = 100.0,
                   timeout: Optional[float] = None) -> Dict[str, int]:
    """Client helper: folded stacks from a live worker's profile_cpu RPC."""
    from ray_tpu_torch.core.rpc import RpcClient

    client = RpcClient(tuple(addr))
    try:
        return client.call("profile_cpu", duration_s, hz,
                           timeout=timeout or duration_s + 30.0)
    finally:
        client.close()
