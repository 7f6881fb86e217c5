"""Metrics: Counter / Gauge / Histogram with cluster export.

Analogue of the reference's two-layer metrics pipeline: the user API
(``python/ray/util/metrics.py`` Counter/Gauge/Histogram) and the C++
registry exported to the node agent and on to Prometheus
(``src/ray/stats/metric_defs.cc:44-183``, ``metric_exporter.cc``).
Here: every process has a registry; a daemon flusher pushes snapshots to
the cluster controller (tagged with node/worker identity), which aggregates
them and serves them via the state API (``list_metrics``) and a
Prometheus-text endpoint (``metrics_text``).
"""

from __future__ import annotations

import bisect
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60)


class _Registry:
    _instance: Optional["_Registry"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, tuple], Dict[str, Any]] = {}
        self._flusher: Optional[threading.Thread] = None
        # Snapshot-time collectors (see add_collector): hot paths keep
        # plain attribute counters at zero registry cost; these callables
        # publish them (gauges / counter deltas / batched histogram
        # observations) only when a snapshot is actually taken.
        self._collectors: List[Any] = []
        self._collectors_lock = threading.Lock()
        # One process, one pusher: the core-worker flusher owns the push
        # when a runtime is connected; a node's MetricsAgent claims it
        # otherwise. Two pushers shipping the same (cumulative) registry
        # under different source keys would double every counter.
        self._pusher: Optional[str] = None

    @classmethod
    def get(cls) -> "_Registry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def record(self, name: str, kind: str, tags: Dict[str, str],
               value: float, buckets=None) -> None:
        self.record_many(name, kind, tags, (value,), buckets)

    def record_many(self, name: str, kind: str, tags: Dict[str, str],
                    values, buckets=None) -> None:
        """Bulk record under ONE lock acquisition — hot producers (the
        decode engine flushing a step's worth of observations) pay a
        single registry round-trip instead of one per value."""
        key = (name, tuple(sorted(tags.items())))
        with self._lock:
            entry = self._metrics.get(key)
            if entry is None:
                entry = {"name": name, "kind": kind, "tags": dict(tags),
                         "value": 0.0}
                if kind == "histogram":
                    entry["buckets"] = list(buckets or _DEFAULT_BUCKETS)
                    entry["counts"] = [0] * (len(entry["buckets"]) + 1)
                    entry["sum"] = 0.0
                    entry["count"] = 0
                self._metrics[key] = entry
            for value in values:
                if kind == "counter":
                    entry["value"] += value
                elif kind == "gauge":
                    entry["value"] = value
                else:
                    idx = bisect.bisect_left(entry["buckets"], value)
                    entry["counts"][idx] += 1
                    entry["sum"] += value
                    entry["count"] += 1
            self._ensure_flusher()

    def _ensure_flusher(self) -> None:
        if self._flusher is None or not self._flusher.is_alive():
            self._flusher = threading.Thread(
                target=self._flush_loop, name="metrics-flush", daemon=True)
            self._flusher.start()

    def add_collector(self, fn) -> None:
        """Register a snapshot-time collector. Bound methods are held
        weakly so registering never pins its owner (an RpcServer that is
        simply dropped must still be collectable); dead entries are
        pruned at the next snapshot."""
        import weakref

        ref = (weakref.WeakMethod(fn)
               if getattr(fn, "__self__", None) is not None else fn)
        with self._collectors_lock:
            self._collectors.append(ref)

    def _run_collectors(self) -> None:
        import weakref

        with self._collectors_lock:
            refs = list(self._collectors)
        dead = []
        for ref in refs:
            fn = ref() if isinstance(ref, weakref.WeakMethod) else ref
            if fn is None:
                dead.append(ref)
                continue
            try:
                fn()
            except Exception:
                from ray_tpu_torch.util.ratelimit import log_every

                # A broken collector must never take down the flusher;
                # systematically failing ones still leave a trail.
                log_every("metrics.collector", 60.0,
                          logging.getLogger(__name__),
                          "metrics collector failed", exc_info=True)
        if dead:
            with self._collectors_lock:
                for ref in dead:
                    if ref in self._collectors:
                        self._collectors.remove(ref)

    def claim_pusher(self, owner: str) -> bool:
        """First caller per process wins; the core-worker flusher passes
        the reserved name 'core' which always wins (it has the richest
        source identity). A stale 'core' claim is reclaimable once the
        runtime disconnects (driver shutdown in a long-lived node
        process). Returns True when ``owner`` should push."""
        with self._collectors_lock:
            if owner == "core":
                self._pusher = "core"
                return True
            if self._pusher == "core":
                from ray_tpu_torch.core import runtime

                if runtime._core_worker is not None:
                    return False
                self._pusher = owner
                return True
            if self._pusher in (None, owner):
                self._pusher = owner
                return True
            return False

    def release_pusher(self, owner: str) -> None:
        with self._collectors_lock:
            if self._pusher == owner:
                self._pusher = None

    def clear_series(self) -> None:
        """Forget every series recorded so far. A driver's ``shutdown``
        calls it: what the process recorded for one cluster is never
        pushed to the next one it joins."""
        with self._lock:
            self._metrics.clear()

    def snapshot(self, run_collectors: bool = True) -> List[Dict[str, Any]]:
        if run_collectors:
            self._run_collectors()
        from ray_tpu_torch.core.config import config as rt_config

        limit = rt_config.metrics_max_series
        with self._lock:
            out = []
            dropped = 0
            for e in self._metrics.values():
                if limit and len(out) >= limit:
                    # Bounded push: a runaway-cardinality producer must
                    # not grow every snapshot RPC without limit. Insertion
                    # order is stable, so established series keep
                    # flowing and the overflow is visible below.
                    dropped += 1
                    continue
                d = dict(e)
                if "counts" in d:
                    # Deep-copy the mutable histogram state: the shallow
                    # dict still aliases the live counts list, and the
                    # flusher serializes this snapshot OUTSIDE the lock.
                    d["counts"] = list(d["counts"])
                    d["buckets"] = list(d["buckets"])
                out.append(d)
            if dropped:
                out.append({"name": "metrics_series_dropped", "kind": "gauge",
                            "tags": {}, "value": float(dropped)})
            return out

    def flush_now(self) -> bool:
        """Push one snapshot to the cluster controller synchronously
        (tests and benches that cannot wait out the flush interval).
        Returns False when no runtime is connected or the push failed."""
        from ray_tpu_torch.core import runtime

        core = runtime._core_worker
        if core is None:
            return False
        self.claim_pusher("core")
        try:
            core.controller.notify("push_metrics", self._source(core),
                                   self.snapshot())
            return True
        except Exception:
            return False

    @staticmethod
    def _source(core) -> Dict[str, Any]:
        return {"node_id": core.node_id.binary(),
                "worker_id": core.worker_id.binary(),
                "role": getattr(core, "mode", "worker"),
                "pid": __import__("os").getpid()}

    def _flush_loop(self) -> None:
        from ray_tpu_torch.core import runtime
        from ray_tpu_torch.core.config import config as rt_config

        while True:
            time.sleep(max(0.1, rt_config.metrics_flush_interval_s))
            core = runtime._core_worker
            if core is None:
                continue
            self.claim_pusher("core")
            try:
                core.controller.notify("push_metrics", self._source(core),
                                       self.snapshot())
            except Exception:
                from ray_tpu_torch.util.ratelimit import log_every

                # Metrics are droppable, but a push that fails every
                # 5 s tick means the head is unreachable — worth a line.
                log_every("metrics.push", 60.0,
                          logging.getLogger(__name__),
                          "metrics push to controller failed",
                          exc_info=True)


def add_collector(fn) -> None:
    """Register a snapshot-time collector on this process's registry.

    The idiom for hot paths: keep plain attribute counters where the
    locks you already hold make them cheap, and publish them (gauge
    sets, counter deltas via :class:`CounterDeltas`, batched histogram
    observations) only when a snapshot is taken — the RPC reactor and
    the decode loop never touch the registry lock."""
    _Registry.get().add_collector(fn)


class CounterDeltas:
    """Publish monotonic plain-int totals as registry counters.

    ``inc_to(counter, key, total, tags)`` increments ``counter`` by the
    growth since the last call for ``key``; a total that went BACKWARDS
    (owner restarted / conn churned) re-bases without emitting, so a
    restart never double-counts. Collector-thread only — no locking."""

    def __init__(self):
        self._last: Dict[Any, float] = {}

    def inc_to(self, counter: "Counter", key: Any, total: float,
               tags: Optional[Dict[str, str]] = None) -> None:
        prev = self._last.get(key, 0.0)
        if total > prev:
            counter.inc(total - prev, tags)
        self._last[key] = total


class _Metric:
    kind = ""

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _tags(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        return merged


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        _Registry.get().record(self._name, "counter", self._tags(tags),
                               value)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        _Registry.get().record(self._name, "gauge", self._tags(tags), value)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self._boundaries = tuple(boundaries or _DEFAULT_BUCKETS)

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        _Registry.get().record(self._name, "histogram", self._tags(tags),
                               value, self._boundaries)

    def observe_many(self, values: Sequence[float],
                     tags: Optional[Dict[str, str]] = None) -> None:
        """Record a batch of observations under one registry lock."""
        if values:
            _Registry.get().record_many(self._name, "histogram",
                                        self._tags(tags), values,
                                        self._boundaries)


def prometheus_text(aggregated: Dict[str, Any]) -> str:
    """Render the controller's aggregated metrics as Prometheus exposition
    text (the shape the reference's node agent exposes). Histograms emit
    the full cumulative ``_bucket{le=...}`` ladder (+Inf last) so a real
    Prometheus can compute quantiles with histogram_quantile()."""
    lines: List[str] = []
    for source, metrics in aggregated.items():
        # Cluster source keys are "<node8>/<role>/pid<N>" (controller
        # push_metrics): expose the parts as first-class labels so a
        # Prometheus query can aggregate by node or role directly.
        parts = source.split("/")
        src_tags = {"source": source}
        if len(parts) == 3 and parts[2].startswith("pid"):
            src_tags.update(node=parts[0], role=parts[1], pid=parts[2][3:])
        for m in metrics:
            tags = dict(m.get("tags", {}))
            tags.update(src_tags)
            label = ",".join(f'{k}="{v}"' for k, v in sorted(tags.items()))
            if m["kind"] == "histogram":
                cum = 0
                for edge, n in zip(m["buckets"], m["counts"]):
                    cum += n
                    blabel = (label + "," if label else "") + f'le="{edge}"'
                    lines.append(f'{m["name"]}_bucket{{{blabel}}} {cum}')
                blabel = (label + "," if label else "") + 'le="+Inf"'
                lines.append(f'{m["name"]}_bucket{{{blabel}}} {m["count"]}')
                lines.append(f'{m["name"]}_sum{{{label}}} {m["sum"]}')
                lines.append(f'{m["name"]}_count{{{label}}} {m["count"]}')
            else:
                lines.append(f'{m["name"]}{{{label}}} {m["value"]}')
    return "\n".join(lines) + "\n"


# ------------------------------------------------ aggregation helpers
#
# Shared by serve.status()'s SLO summaries, the dashboard's serve panel
# and the benches: ONE way to merge per-process histogram snapshots and
# read quantiles out of them, so every surface reports the same number.


def merge_histograms(aggregated: Dict[str, List[Dict[str, Any]]],
                     name: str) -> Dict[tuple, Dict[str, Any]]:
    """Merge same-name histogram entries across sources, keyed by their
    tag items. Entries whose bucket boundaries disagree are skipped (the
    metrics-name-collision lint makes that a build failure)."""
    out: Dict[tuple, Dict[str, Any]] = {}
    for metrics in aggregated.values():
        for m in metrics:
            if m.get("name") != name or m.get("kind") != "histogram":
                continue
            key = tuple(sorted(m.get("tags", {}).items()))
            cur = out.get(key)
            if cur is None:
                out[key] = {"name": name, "kind": "histogram",
                            "tags": dict(m.get("tags", {})),
                            "buckets": list(m["buckets"]),
                            "counts": list(m["counts"]),
                            "sum": m["sum"], "count": m["count"]}
            elif cur["buckets"] == list(m["buckets"]):
                cur["counts"] = [a + b for a, b in zip(cur["counts"],
                                                       m["counts"])]
                cur["sum"] += m["sum"]
                cur["count"] += m["count"]
    return out


def histogram_quantile(entry: Dict[str, Any], q: float) -> Optional[float]:
    """Bucket-interpolated quantile of one (merged) histogram entry —
    Prometheus histogram_quantile() semantics: linear within the bucket,
    the top (+Inf) bucket clamps to its lower edge. None when empty.
    Quantiles are bucket-QUANTIZED: precision is the bucket grid, which
    is the documented trade for surviving process death and transport."""
    total = entry.get("count", 0)
    if not total:
        return None
    rank = q * total
    cum = 0
    prev_edge = 0.0
    for edge, n in zip(entry["buckets"], entry["counts"]):
        if cum + n >= rank and n > 0:
            frac = (rank - cum) / n
            return prev_edge + (edge - prev_edge) * max(0.0, min(1.0, frac))
        cum += n
        prev_edge = edge
    return prev_edge  # landed in the +Inf bucket: clamp to the last edge


def histogram_summary(entry: Dict[str, Any]) -> Dict[str, Any]:
    """{count, mean, p50, p99} of one merged histogram entry."""
    count = entry.get("count", 0)
    return {
        "count": count,
        "mean": (entry["sum"] / count) if count else None,
        "p50": histogram_quantile(entry, 0.5),
        "p99": histogram_quantile(entry, 0.99),
    }


def counter_totals(aggregated: Dict[str, List[Dict[str, Any]]],
                   name: str) -> Dict[tuple, float]:
    """Sum same-name counter entries across sources, keyed by tag items."""
    out: Dict[tuple, float] = {}
    for metrics in aggregated.values():
        for m in metrics:
            if m.get("name") == name and m.get("kind") == "counter":
                key = tuple(sorted(m.get("tags", {}).items()))
                out[key] = out.get(key, 0.0) + m.get("value", 0.0)
    return out


def gauge_totals(aggregated: Dict[str, List[Dict[str, Any]]],
                 name: str) -> Dict[tuple, float]:
    """Sum same-name gauge entries across sources, keyed by tag items
    (each source reports its own level; the cluster view is the sum —
    e.g. per-process outbound queue bytes -> cluster queued bytes)."""
    out: Dict[tuple, float] = {}
    for metrics in aggregated.values():
        for m in metrics:
            if m.get("name") == name and m.get("kind") == "gauge":
                key = tuple(sorted(m.get("tags", {}).items()))
                out[key] = out.get(key, 0.0) + m.get("value", 0.0)
    return out


def delta_aggregated(before: Dict[str, List[Dict[str, Any]]],
                     after: Dict[str, List[Dict[str, Any]]]
                     ) -> Dict[str, List[Dict[str, Any]]]:
    """Per-source deltas between two cluster snapshots (the doctor's
    two-sample view): counters and histogram counts become the growth
    over the window (clamped at >= 0 — a restarted producer re-bases
    instead of going negative), gauges keep their AFTER level. Sources
    present only in ``after`` count from zero."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    for source, metrics in after.items():
        prev = {(m.get("name"), tuple(sorted(m.get("tags", {}).items()))): m
                for m in before.get(source, [])}
        rows = []
        for m in metrics:
            key = (m.get("name"), tuple(sorted(m.get("tags", {}).items())))
            p = prev.get(key)
            d = dict(m)
            if m.get("kind") == "counter":
                d["value"] = max(0.0, m.get("value", 0.0)
                                 - (p.get("value", 0.0) if p else 0.0))
            elif m.get("kind") == "histogram":
                d["counts"] = list(m["counts"])
                d["buckets"] = list(m["buckets"])
                if p and list(p.get("buckets", [])) == d["buckets"]:
                    d["counts"] = [max(0, a - b) for a, b in
                                   zip(d["counts"], p["counts"])]
                    d["count"] = max(0, m["count"] - p["count"])
                    d["sum"] = max(0.0, m["sum"] - p["sum"])
            rows.append(d)
        out[source] = rows
    return out
