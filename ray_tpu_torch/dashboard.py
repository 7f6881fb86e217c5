"""Cluster dashboard: HTTP JSON API + HTML views with logs, drill-down
and metric history (copy of ``ray_tpu/dashboard.py``; its pages name the
port).

Analogue of the reference's dashboard head (``dashboard/head.py:81``) +
its log module (``dashboard/modules/log``), state drill-down pages and
metrics module (``dashboard/modules/metrics`` — Grafana replaced by an
in-process time-series ring rendered as inline SVG sparklines) — no
frontend build, one stdlib process. Live logs ride the same pubsub windows
the driver's log streaming uses; task/actor detail pages assemble from the
controller's task-event buffer and actor table.

    python -m ray_tpu_torch.dashboard [--address host:port] [--port 8265]
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

_PAGE = """<!doctype html><html><head><title>ray_tpu_torch dashboard</title>
<meta http-equiv="refresh" content="5">
<style>
 body{font-family:monospace;margin:2em;background:#fafafa}
 table{border-collapse:collapse;margin:1em 0}
 td,th{border:1px solid #ccc;padding:4px 10px;text-align:left}
 th{background:#eee} h2{margin-top:1.5em}
 pre{background:#111;color:#ddd;padding:1em;overflow-x:auto}
 svg{background:#fff;border:1px solid #ccc;margin-right:8px}
</style></head><body>
<h1><a href="/" style="text-decoration:none">ray_tpu_torch cluster</a></h1>
<div id="content">%s</div>
<p><a href="/api/nodes">/api/nodes</a> <a href="/api/actors">/api/actors</a>
<a href="/api/jobs">/api/jobs</a> <a href="/api/tasks">/api/tasks</a>
<a href="/api/memory">/api/memory</a> <a href="/api/logs">/api/logs</a>
<a href="/api/history">/api/history</a> <a href="/api/train">/api/train</a>
<a href="/logs">logs</a>
<a href="/metrics">/metrics</a></p></body></html>"""


class _HistoryRing:
    """In-memory time series (reference: the metrics module's Grafana
    backing store, scoped down): one bounded ring of (ts, value) per
    series, sampled by a daemon thread from the controller's cluster
    state + pushed metrics (so a training run's reported gauges — loss,
    MFU — chart alongside CPU/store/task throughput)."""

    def __init__(self, client, capacity: int = 360, period_s: float = 2.0):
        self._client = client
        self._capacity = capacity
        self._period = period_s
        self._series: Dict[str, List[Tuple[float, float]]] = {}
        self._lock = threading.Lock()
        self._last_sample_ts: Optional[float] = None
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="dash-history", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def _push(self, name: str, value: float, now: float) -> None:
        ring = self._series.setdefault(name, [])
        ring.append((now, float(value)))
        del ring[:-self._capacity]

    def _loop(self) -> None:
        from ray_tpu_torch.util.ratelimit import log_every

        while not self._stopped.wait(self._period):
            try:
                self.sample_once()
            except Exception:
                log_every("dashboard.sample", 60.0,
                          logging.getLogger(__name__),
                          "dashboard history sample failed",
                          exc_info=True)

    def sample_once(self) -> None:
        now = time.time()
        nodes = self._client.call("list_nodes", timeout=5.0)
        alive = [n for n in nodes if n["alive"]]
        with self._lock:
            self._push("nodes_alive", len(alive), now)
            cpu_total = sum(n["resources"].get("CPU", 0) for n in alive)
            cpu_free = sum(n["available"].get("CPU", 0) for n in alive)
            if cpu_total:
                self._push("cpu_utilization",
                           1.0 - cpu_free / cpu_total, now)
            self._push("lease_queue_len",
                       sum(n["queue_len"] for n in alive), now)
        # Task throughput by COMPLETION TIME, not buffer position: the
        # event ring saturates under load, so counting events in a fixed
        # window would flatline exactly when the cluster is busy.
        events = self._client.call("list_task_events", 2000, timeout=5.0)
        since = self._last_sample_ts
        finished = sum(
            1 for e in events
            if e.get("state") == "FINISHED" and (e.get("end_ts") or 0) >
            (since or 0))
        metrics = self._client.call("list_metrics", timeout=5.0)
        with self._lock:
            if since is not None:
                self._push("tasks_finished_per_s",
                           finished / max(1e-9, now - since), now)
            self._last_sample_ts = now
            # Pushed user/system gauges (util.metrics): latest value per
            # metric name, e.g. a trainer reporting loss or MFU.
            for _src, snapshot in metrics.items():
                for m in snapshot:
                    if m.get("kind") == "gauge":
                        self._push(f"metric:{m['name']}",
                                   m.get("value", 0.0), now)

    def snapshot(self) -> Dict[str, List[Tuple[float, float]]]:
        with self._lock:
            return {k: list(v) for k, v in self._series.items()}


def _sparkline(points: List[Tuple[float, float]], width: int = 220,
               height: int = 40) -> str:
    """Inline SVG sparkline for one series."""
    if len(points) < 2:
        return "<svg width='%d' height='%d'></svg>" % (width, height)
    vals = [v for _t, v in points]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    n = len(vals)
    coords = " ".join(
        f"{i * (width - 4) / (n - 1) + 2:.1f},"
        f"{height - 4 - (v - lo) / span * (height - 8) + 2:.1f}"
        for i, v in enumerate(vals))
    return (f"<svg width='{width}' height='{height}'>"
            f"<polyline points='{coords}' fill='none' stroke='#36c' "
            f"stroke-width='1.5'/></svg>")


def _table(rows, columns) -> str:
    if not rows:
        return "<p>(none)</p>"
    head = "".join(f"<th>{c}</th>" for c in columns)
    body = "".join(
        "<tr>" + "".join(f"<td>{r.get(c, '')}</td>" for c in columns)
        + "</tr>" for r in rows)
    return f"<table><tr>{head}</tr>{body}</table>"


class _Handler(BaseHTTPRequestHandler):
    client = None   # RpcClient to the controller (set by start())
    history = None  # _HistoryRing (set by start())

    def _send(self, payload: bytes, ctype: str = "application/json",
              code: int = 200) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):  # noqa: N802 (stdlib API)
        parsed = urlparse(self.path)
        path = parsed.path
        query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        try:
            if path == "/api/nodes":
                self._send(json.dumps(self.client.call("list_nodes")).encode())
            elif path == "/api/actors":
                actors = self.client.call("list_actors")
                for a in actors:
                    a["actor_id"] = a["actor_id"].hex()
                    a["node_id"] = (a["node_id"].hex()
                                    if a.get("node_id") else None)
                    a.pop("addr", None)
                self._send(json.dumps(actors).encode())
            elif path == "/api/jobs":
                self._send(json.dumps(self.client.call("list_jobs")).encode())
            elif path == "/api/tasks":
                self._send(json.dumps(
                    self.client.call("list_task_events",
                                     int(query.get("limit", 500)))).encode())
            elif path == "/api/memory":
                self._send(json.dumps(self._memory()).encode())
            elif path == "/api/logs":
                self._send(json.dumps(self._logs(query)).encode())
            elif path == "/api/history":
                self._send(json.dumps(self.history.snapshot()).encode())
            elif path == "/api/serve":
                self._send(json.dumps(self._serve_slo()).encode())
            elif path == "/api/core":
                self._send(json.dumps(self._core_summary()).encode())
            elif path == "/api/train":
                self._send(json.dumps(self._train_summary()).encode())
            elif path == "/metrics":
                self._send(self.client.call("metrics_text").encode(),
                           "text/plain")
            elif path == "/logs":
                self._send(self._render_logs(query).encode(), "text/html")
            elif path.startswith("/task/"):
                self._send(self._render_task(path[len("/task/"):]).encode(),
                           "text/html")
            elif path.startswith("/actor/"):
                self._send(
                    self._render_actor(path[len("/actor/"):]).encode(),
                    "text/html")
            elif path.startswith("/worker/") and path.endswith("/flame"):
                worker_hex = path[len("/worker/"):-len("/flame")]
                self._send(self._render_flame(worker_hex, query).encode(),
                           "image/svg+xml")
            elif path.startswith("/worker/") and path.endswith("/heap"):
                worker_hex = path[len("/worker/"):-len("/heap")]
                self._send(json.dumps(
                    self._worker_call(worker_hex, "profile_heap", 25,
                                      timeout=30.0)).encode())
            elif path.startswith("/worker/") and path.endswith(
                    "/heap_stop"):
                worker_hex = path[len("/worker/"):-len("/heap_stop")]
                self._send(json.dumps(
                    self._worker_call(worker_hex, "profile_heap_stop",
                                      timeout=30.0)).encode())
            elif path == "/workers":
                self._send(self._render_workers().encode(), "text/html")
            elif path in ("/", "/index.html"):
                self._send(self._render().encode(), "text/html")
            else:
                self._send(b'{"error": "not found"}', code=404)
        except Exception as e:  # noqa: BLE001
            self._send(json.dumps({"error": str(e)}).encode(), code=500)

    # --------------------------------------------------------------- logs

    def _logs(self, query: Dict[str, str]) -> Dict:
        """Live log windows per node from the pubsub hub (the same windows
        the driver's log streaming consumes); filter with ?node= and
        ?worker= (tag prefix)."""
        from ray_tpu_torch.core.log_monitor import LOG_CHANNEL

        snapshot = self.client.call("psub_snapshot", LOG_CHANNEL)
        out = {}
        want_node = query.get("node")
        want_worker = query.get("worker")
        for node_hex, (_version, value) in snapshot.items():
            if want_node and not node_hex.startswith(want_node):
                continue
            window = value.get("window", [])
            if want_worker:
                window = [(tag, line) for tag, line in window
                          if want_worker in tag]
            out[node_hex] = {"end": value.get("end", 0), "lines": window}
        return out

    def _render_logs(self, query: Dict[str, str]) -> str:
        logs = self._logs(query)
        html = ["<h2>live worker logs</h2>",
                "<p>filter: /logs?node=&lt;hex&gt;&amp;worker=&lt;tag&gt;"
                "</p>"]
        if not logs:
            html.append("<p>(no log lines published yet)</p>")
        for node_hex, data in sorted(logs.items()):
            html.append(f"<h2>node {node_hex[:16]} "
                        f"({data['end']} lines total)</h2><pre>")
            for tag, line in data["lines"][-200:]:
                html.append(f"[{_esc(tag)}] {_esc(line)}")
            html.append("</pre>")
        return _PAGE % "\n".join(html)

    # ---------------------------------------------------------- profiling

    def _find_worker(self, worker_hex: str):
        from ray_tpu_torch.util.profiling import list_cluster_workers

        matches = list_cluster_workers(self.client, prefix=worker_hex)
        return matches[0] if matches else None

    def _call_worker(self, worker, method: str, *args,
                     timeout: float = 30.0):
        from ray_tpu_torch.core.rpc import RpcClient

        wc = RpcClient(tuple(worker["addr"]))
        try:
            return wc.call(method, *args, timeout=timeout)
        finally:
            wc.close()

    def _worker_call(self, worker_hex: str, method: str, *args,
                     timeout: float = 30.0):
        w = self._find_worker(worker_hex)
        if w is None:
            return {"error": f"no live worker {worker_hex}"}
        return self._call_worker(w, method, *args, timeout=timeout)

    def _render_flame(self, worker_hex: str, query: Dict[str, str]) -> str:
        """CPU flamegraph of a live worker, rendered inline (reference:
        the dashboard attaching py-spy to any worker,
        profile_manager.py:79 — here the worker samples itself)."""
        from ray_tpu_torch.util.profiling import flamegraph_svg

        duration = min(30.0, float(query.get("duration", 3.0)))
        w = self._find_worker(worker_hex)
        if w is None:
            return flamegraph_svg({}, title=f"no worker {worker_hex}")
        try:
            folded = self._call_worker(w, "profile_cpu", duration, 100.0,
                                       timeout=duration + 30.0)
        except Exception as e:
            return flamegraph_svg({}, title=f"profiling failed: {e}")
        return flamegraph_svg(
            folded, title=f"worker {w['worker_id'][:8]} pid={w['pid']} "
                          f"({duration:.0f}s @ 100Hz)")

    def _render_workers(self) -> str:
        """Live workers with profile links (flamegraph + heap)."""
        from ray_tpu_torch.util.profiling import list_cluster_workers

        rows = []
        for w in list_cluster_workers(self.client):
            wid = w["worker_id"]
            rows.append({
                "worker": wid[:12], "node": w["node_id"][:12],
                "pid": w["pid"],
                "state": "idle" if w["idle"] else
                         ("actor" if w["dedicated"] else "busy"),
                "profile": (f"<a href='/worker/{wid}/flame?duration=3'>"
                            f"flame</a> "
                            f"<a href='/worker/{wid}/heap'>heap</a> "
                            f"<a href='/worker/{wid}/heap_stop'>heap "
                            f"off</a>"),
            })
        return _PAGE % ("<h2>workers</h2>"
                        + _table(rows, ["worker", "node", "pid", "state",
                                        "profile"]))

    # ---------------------------------------------------------- drill-down

    def _render_task(self, task_hex: str) -> str:
        events = self.client.call("list_task_events", 10000)
        mine = [e for e in events
                if e.get("task_id", "").startswith(task_hex)]
        if not mine:
            return _PAGE % f"<p>no events for task {_esc(task_hex)}</p>"
        rows = []
        for e in mine:
            lat = ""
            if e.get("lease_ts") and e.get("submitted_ts"):
                lat = f"{(e['lease_ts'] - e['submitted_ts']) * 1000:.1f}ms"
            dur = ""
            if e.get("end_ts") and e.get("lease_ts"):
                dur = f"{(e['end_ts'] - e['lease_ts']) * 1000:.1f}ms"
            rows.append({
                "state": e.get("state"), "desc": _esc(e.get("desc", "")),
                "sched_latency": lat, "run_time": dur,
                "worker": (e.get("worker") or "")[:12],
                "error": _esc(str(e.get("error", ""))[:200]),
            })
        return _PAGE % (f"<h2>task {_esc(task_hex[:16])}</h2>"
                        + _table(rows, ["state", "desc", "sched_latency",
                                        "run_time", "worker", "error"]))

    def _render_actor(self, actor_hex: str) -> str:
        actors = self.client.call("list_actors")
        rec = next((a for a in actors
                    if a["actor_id"].hex().startswith(actor_hex)), None)
        if rec is None:
            return _PAGE % f"<p>no actor {_esc(actor_hex)}</p>"
        info = rec["info"]
        detail = [
            ("actor_id", rec["actor_id"].hex()),
            ("class", _esc(str(info.get("class_name", "")))),
            ("name", _esc(str(info.get("name") or ""))),
            ("state", rec["state"]),
            ("restarts", rec["num_restarts"]),
            ("incarnation", rec["incarnation"]),
            ("node", rec["node_id"].hex()[:16] if rec.get("node_id")
             else ""),
            ("resources", _esc(str(info.get("resources", "")))),
            ("death_cause", _esc(str(rec.get("death_cause") or ""))),
        ]
        html = (f"<h2>actor {rec['actor_id'].hex()[:16]}</h2>"
                + _table([dict(detail)], [k for k, _v in detail]))
        if rec.get("node_id"):
            node_hex = rec["node_id"].hex()
            html += (f"<p><a href='/logs?node={node_hex}'>worker logs on "
                     f"this node</a></p>")
        return _PAGE % html

    def _serve_slo(self) -> Dict:
        """Per-deployment serve SLO summaries from the controller's
        aggregated metrics — the SAME ``serve.metrics.slo_summary``
        read that backs ``serve.status()``'s slo dicts, so the panel
        and the API can never disagree about a latency number."""
        from ray_tpu_torch.serve.metrics import slo_summary

        return slo_summary(self.client.call("list_metrics", timeout=5.0))

    def _core_summary(self) -> Dict:
        """Core-plane cluster view — the SAME ``coremetrics.core_summary``
        read that backs ``python -m ray_tpu_torch metrics``, so the panel
        and the CLI can never disagree (the serve-panel/slo_summary
        contract, applied to the runtime underneath)."""
        from ray_tpu_torch.core.coremetrics import core_summary

        return core_summary(self.client.call("list_metrics", timeout=5.0))

    def _train_summary(self) -> Dict:
        """Train panel data: the ``core_summary.pipeline``/``multihost``
        sections (the SAME read path as ``python -m ray_tpu_torch
        metrics``) plus the controller's pipeline registry records —
        geometry, epoch and last completed step per live pipeline."""
        core = self._core_summary()
        out = {"pipeline": core.get("pipeline", {}),
               "multihost": core.get("multihost", {})}
        try:
            out["pipelines"] = self.client.call("pipe_state",
                                                timeout=5.0) or {}
        except Exception:
            out["pipelines"] = {}
        return out

    def _render_train_panel(self) -> str:
        """Train panel: one row per registered pipeline (geometry,
        epoch, progress) + the cluster-wide step-phase split and MFU
        estimate off the same gauges `python -m ray_tpu_torch metrics`
        prints."""
        try:
            train = self._train_summary()
        except Exception:
            return ""
        pipes = train.get("pipelines") or {}
        pl = train.get("pipeline", {})
        breakdown = pl.get("step_breakdown_s") or {}
        if not pipes and not breakdown:
            return ""
        rows = []
        tflops = pl.get("model_tflops") or {}
        mfu = pl.get("mfu_pct") or {}
        for name, rec in sorted(pipes.items()):
            rows.append({
                "pipeline": _esc(name),
                "stages": rec.get("num_stages", ""),
                "epoch": rec.get("epoch", ""),
                "last_step": rec.get("last_step", ""),
                "tflops": (f"{tflops[name]:.3f}"
                           if name in tflops else ""),
                "mfu": (f"{mfu[name]:.1f}%" if name in mfu else ""),
            })
        html = "<h2>train plane</h2>"
        if rows:
            html += _table(rows, ["pipeline", "stages", "epoch",
                                  "last_step", "tflops", "mfu"])
        if breakdown:
            total = sum(breakdown.values()) or 1.0
            html += ("<p>last step phase split (stage-seconds): "
                     + ", ".join(
                         f"{k}={v:.3f}s ({100 * v / total:.0f}%)"
                         for k, v in sorted(breakdown.items()))
                     + "</p>")
        html += ("<p><a href='/api/train'>/api/train</a> · "
                 "`python -m ray_tpu_torch timeline --train` renders "
                 "the per-stage rows · "
                 "`python -m ray_tpu_torch doctor --post-mortem` explains "
                 "crashes</p>")
        return html

    def _render_core_panel(self) -> str:
        """Core-plane panel: RPC write path, object plane, pubsub and
        control-plane health at a glance."""
        try:
            core = self._core_summary()
        except Exception:
            return ""
        rpc, obj = core.get("rpc", {}), core.get("objects", {})
        psub, ctl = core.get("pubsub", {}), core.get("control", {})
        if not (rpc.get("tx_frames") or obj.get("put_bytes")
                or ctl.get("heartbeats")):
            return ""
        rows = [{
            "plane": "rpc",
            "throughput": f"{rpc.get('tx_frames', 0):,.0f} frames / "
                          f"{rpc.get('tx_bytes', 0) / 1e6:.1f} MB",
            "queued": f"{rpc.get('queue_bytes', 0) / 1e6:.1f} MB on "
                      f"{rpc.get('queued_conns', 0):.0f} conns",
            "degraded": _esc(", ".join(filter(None, [
                f"backpressure_drops={rpc['backpressure_drops']:.0f}"
                if rpc.get("backpressure_drops") else "",
                f"dial_failures={sum(rpc.get('dial_failures', {}).values()):.0f}"
                if rpc.get("dial_failures") else "",
                f"reconnects={rpc['reconnect_retries']:.0f}"
                if rpc.get("reconnect_retries") else ""]))),
        }, {
            "plane": "objects",
            "throughput": f"put {obj.get('put_bytes', 0) / 1e6:.1f} MB / "
                          f"xfer {obj.get('transfer_bytes', 0) / 1e6:.1f} MB",
            "queued": f"{obj.get('live_refs', 0):.0f} live refs, "
                      f"{obj.get('store_bytes', 0) / 1e6:.1f} MB inline",
            "degraded": _esc(
                f"flush_abandoned={obj['flush_abandoned']:.0f}"
                if obj.get("flush_abandoned") else ""),
        }, {
            "plane": "pubsub",
            "throughput": f"{sum(psub.get('publishes', {}).values()):,.0f} "
                          f"publishes",
            "queued": "",
            "degraded": _esc(
                f"dropped_notifies={psub['dropped_notifies']:.0f}"
                if psub.get("dropped_notifies") else ""),
        }, {
            "plane": "control",
            "throughput": f"{ctl.get('heartbeats', 0):,.0f} heartbeats",
            "queued": f"pending_demand={ctl.get('pending_demand', 0):.0f}",
            "degraded": _esc(", ".join(filter(None, [
                f"node_deaths={ctl['node_deaths']:.0f}"
                if ctl.get("node_deaths") else "",
                f"pending_releases={ctl['pending_subslice_releases']:.0f}"
                if ctl.get("pending_subslice_releases") else ""]))),
        }]
        return ("<h2>core planes</h2>"
                + _table(rows, ["plane", "throughput", "queued",
                                "degraded"])
                + "<p><a href='/api/core'>/api/core</a> · "
                  "`python -m ray_tpu_torch doctor` explains degradations</p>")

    @staticmethod
    def _fmt_ms(summary: Optional[Dict], field: str) -> str:
        if not summary:
            return ""
        v = summary.get(field)
        return f"{v * 1000:.1f}ms" if v is not None else ""

    def _render_serve_panel(self) -> str:
        """Serve panel rows: one per deployment with TTFT / inter-token
        / queue-wait p50+p99 and outcome counters."""
        try:
            slo = self._serve_slo()
        except Exception:
            return ""
        if not slo:
            return ""
        rows = []
        for dep, rec in sorted(slo.items()):
            outcomes = rec.get("outcomes", {})
            rows.append({
                "deployment": _esc(dep),
                "requests": sum(outcomes.values()),
                "ttft_p50": self._fmt_ms(rec.get("ttft_s"), "p50"),
                "ttft_p99": self._fmt_ms(rec.get("ttft_s"), "p99"),
                "tok_p50": self._fmt_ms(rec.get("inter_token_s"), "p50"),
                "tok_p99": self._fmt_ms(rec.get("inter_token_s"), "p99"),
                "queue_p99": self._fmt_ms(rec.get("queue_wait_s"), "p99"),
                "degraded": _esc(", ".join(
                    f"{k}={v}" for k, v in sorted(outcomes.items())
                    if k != "completed" and v)
                    + (f", retries={rec['retries']}"
                       if rec.get("retries") else "")
                    + (f", preempted={rec['preempted']}"
                       if rec.get("preempted") else "")),
            })
        return ("<h2>serve SLOs</h2>"
                + _table(rows, ["deployment", "requests", "ttft_p50",
                                "ttft_p99", "tok_p50", "tok_p99",
                                "queue_p99", "degraded"])
                + "<p><a href='/api/serve'>/api/serve</a></p>")

    def _memory(self, nodes=None):
        """Per-node object-store usage via the shared node-info poll
        (bounded RPCs: one hung supervisor can't wedge the page; the
        HTML render passes its already-fetched node list)."""
        from ray_tpu_torch.util.state import node_infos

        out = []
        for info in node_infos(
                nodes if nodes is not None
                else self.client.call("list_nodes"), timeout=2.0):
            if "error" in info:
                out.append(info)
            else:
                out.append({
                    "node_id": info["node_id"],
                    "store_used_bytes": info.get("store_used_bytes", 0),
                    "store_capacity_bytes":
                        info.get("store_capacity_bytes", 0),
                    "spilled_bytes": info.get("spilled_bytes", 0),
                    "workers": info.get("num_workers", 0),
                    "oom_kills": info.get("num_oom_kills", 0),
                })
        return out

    def _render(self) -> str:
        nodes = self.client.call("list_nodes")
        for n in nodes:
            n["addr"] = f"{n['addr'][0]}:{n['addr'][1]}"
            n["node_id"] = n["node_id"][:16]
        actors = self.client.call("list_actors")
        arows = [{"actor_id":
                  f"<a href='/actor/{a['actor_id'].hex()}'>"
                  f"{a['actor_id'].hex()[:16]}</a>",
                  "class": a["info"].get("class_name", ""),
                  "name": a["info"].get("name") or "",
                  "state": a["state"],
                  "restarts": a["num_restarts"]} for a in actors]
        jobs = [{"job_id": j, **info}
                for j, info in self.client.call("list_jobs").items()]
        html = ("<h2>nodes</h2>"
                + _table(nodes, ["node_id", "addr", "alive", "resources",
                                 "available", "queue_len"])
                + "<h2>actors</h2>"
                + _table(arows, ["actor_id", "class", "name", "state",
                                 "restarts"])
                + "<h2>jobs</h2>" + _table(jobs, ["job_id", "state"]))
        mem = []
        for m in self._memory():
            if "error" in m:
                mem.append({"node_id": m["node_id"][:16],
                            "store": m["error"]})
            else:
                mem.append({
                    "node_id": m["node_id"][:16],
                    "store": f"{m['store_used_bytes'] / 1e6:.1f} / "
                             f"{m['store_capacity_bytes'] / 1e6:.0f} MB",
                    "spilled": f"{m['spilled_bytes'] / 1e6:.1f} MB",
                    "workers": m["workers"],
                    "oom_kills": m["oom_kills"],
                })
        html += "<h2>object store</h2>" + _table(
            mem, ["node_id", "store", "spilled", "workers", "oom_kills"])
        html += self._render_serve_panel()
        html += self._render_train_panel()
        html += self._render_core_panel()
        # Recent tasks with drill-down links.
        events = self.client.call("list_task_events", 20)
        trows = [{
            "task": f"<a href='/task/{e.get('task_id', '')}'>"
                    f"{e.get('task_id', '')[:12]}</a>",
            "desc": _esc(str(e.get("desc", ""))[:40]),
            "state": e.get("state"),
        } for e in reversed(events)]
        html += "<h2>recent tasks</h2>" + _table(
            trows, ["task", "desc", "state"])
        # Metric history sparklines.
        spark = []
        for name, points in sorted(self.history.snapshot().items()):
            cur = points[-1][1] if points else 0.0
            spark.append(
                f"<div>{_sparkline(points)} {_esc(name)} = {cur:.3g}</div>")
        if spark:
            html += "<h2>history (last ~12 min)</h2>" + "".join(spark)
        html += ("<p><a href='/logs'>live worker logs</a> · "
                 "<a href='/workers'>workers + profiling</a></p>")
        return _PAGE % html

    def log_message(self, *args):  # silence
        pass


def _esc(s: str) -> str:
    return (str(s).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


def start(controller_addr: Tuple[str, int], host: str = "127.0.0.1",
          port: int = 0) -> Tuple[ThreadingHTTPServer, Tuple[str, int]]:
    """Start the dashboard server (non-blocking); returns (server, addr)."""
    from ray_tpu_torch.core.rpc import ReconnectingClient

    client = ReconnectingClient(tuple(controller_addr))
    history = _HistoryRing(client)
    handler = type("BoundHandler", (_Handler,),
                   {"client": client, "history": history})
    server = ThreadingHTTPServer((host, port), handler)
    server._history = history  # stopped with the server by callers
    threading.Thread(target=server.serve_forever, name="dashboard",
                     daemon=True).start()
    return server, server.server_address


def main(argv=None) -> int:
    import argparse

    from ray_tpu_torch.scripts import resolve_address

    parser = argparse.ArgumentParser(prog="ray_tpu_torch.dashboard")
    parser.add_argument("--address", default=None)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8265)
    args = parser.parse_args(argv)
    _server, addr = start(resolve_address(args.address), args.host,
                          args.port)
    print(f"dashboard at http://{addr[0]}:{addr[1]}/")
    threading.Event().wait()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
