"""State CLI: ``python -m ray_tpu_torch <command>`` (copy of
``ray_tpu/scripts.py``).

Analogue of the reference's state observability surface
(``python/ray/util/state/state_cli.py`` — ``ray list nodes/actors/tasks``,
``ray status``, ``ray timeline``). Talks to the cluster controller over the
same RPC the SDK uses; the controller's address comes from ``--address``,
``RAY_TPU_ADDRESS``, or the discovery file the newest controller writes.

The port's differences: the discovery file lies under the port's own name in
the temp directory, so a JAX runtime's is never overwritten; ``start`` counts
the host's cards (``GPU``) where the JAX package counts TPU chips; ``up``
and ``submit`` take the ``gpu_vm`` provider where the JAX CLI takes
``tpu_vm``, and ``down`` also stops a fake_multinode cluster's parked
``up``. ``status``,
``list``, ``memory``, ``stacks`` and ``doctor`` on a cluster with no serve
series import neither torch nor JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional, Tuple

DISCOVERY_PATH = os.path.join(tempfile.gettempdir(), "ray_tpu_torch",
                              "cluster_latest.json")


def write_discovery(addr: Tuple[str, int]) -> None:
    try:
        os.makedirs(os.path.dirname(DISCOVERY_PATH), exist_ok=True)
        with open(DISCOVERY_PATH, "w") as f:
            json.dump({"address": list(addr), "pid": os.getpid()}, f)
    except OSError:
        pass


def resolve_address(flag: Optional[str]) -> Tuple[str, int]:
    spec = flag or os.environ.get("RAY_TPU_ADDRESS")
    if spec:
        host, _, port = spec.partition(":")
        return (host, int(port))
    try:
        with open(DISCOVERY_PATH) as f:
            return tuple(json.load(f)["address"])
    except (OSError, KeyError, ValueError):
        raise SystemExit(
            "no cluster address: pass --address host:port, set "
            "RAY_TPU_ADDRESS, or start a cluster on this machine first")


def _client(args):
    from ray_tpu_torch.core.rpc import RpcClient

    return RpcClient(resolve_address(args.address))


def _table(rows: List[Dict[str, Any]], columns: List[str]) -> str:
    if not rows:
        return "(none)"
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in columns}
    head = "  ".join(c.ljust(widths[c]) for c in columns)
    sep = "  ".join("-" * widths[c] for c in columns)
    body = "\n".join(
        "  ".join(str(r.get(c, "")).ljust(widths[c]) for c in columns)
        for r in rows)
    return f"{head}\n{sep}\n{body}"


def cmd_status(args) -> None:
    client = _client(args)
    nodes = client.call("list_nodes")
    total = client.call("cluster_resources")
    alive = [n for n in nodes if n["alive"]]
    print(f"nodes: {len(alive)} alive / {len(nodes)} total")
    print(f"cluster resources: {total}")
    avail: Dict[str, float] = {}
    for n in alive:
        for k, v in n["available"].items():
            avail[k] = avail.get(k, 0.0) + v
    print(f"available: {avail}")


def cmd_memory(args) -> None:
    """Per-node object-store usage (reference: ``ray memory`` /
    object-store columns of ``ray status``): shared-memory segment used /
    capacity plus bytes spilled to disk, live from each node supervisor."""
    from ray_tpu_torch.util.state import node_infos

    client = _client(args)
    rows = []
    for info in node_infos(client.call("list_nodes")):
        if "error" in info:
            rows.append({"node": info["node_id"][:12],
                         "store_used": f"unreachable: {info['error']}"})
            continue
        used = info.get("store_used_bytes", 0)
        cap = info.get("store_capacity_bytes", 0) or 1
        rows.append({
            "node": info["node_id"][:12],
            "store_used": f"{used / 1e6:.1f} MB",
            "capacity": f"{cap / 1e6:.1f} MB",
            "util": f"{100 * used / cap:.1f}%",
            "spilled": f"{info.get('spilled_bytes', 0) / 1e6:.1f} MB",
            "workers": info.get("num_workers", 0),
        })
    print(_table(rows, ["node", "store_used", "capacity", "util",
                        "spilled", "workers"]))


def cmd_list(args) -> None:
    client = _client(args)
    kind = args.kind
    if kind == "nodes":
        rows = client.call("list_nodes")
        for r in rows:
            r["addr"] = f"{r['addr'][0]}:{r['addr'][1]}"
            r["node_id"] = r["node_id"][:16]
        print(_table(rows, ["node_id", "addr", "alive", "resources",
                            "available", "queue_len"]))
    elif kind == "actors":
        rows = client.call("list_actors")
        out = []
        for r in rows:
            info = r.get("info", {})
            out.append({
                "actor_id": r["actor_id"].hex()[:16],
                "class": info.get("class_name", ""),
                "name": info.get("name") or "",
                "state": r["state"],
                "restarts": r["num_restarts"],
            })
        print(_table(out, ["actor_id", "class", "name", "state",
                           "restarts"]))
    elif kind == "jobs":
        jobs = client.call("list_jobs")
        rows = [{"job_id": j, **info} for j, info in jobs.items()]
        print(_table(rows, ["job_id", "state"]))
    elif kind == "tasks":
        rows = client.call("list_task_events", args.limit)
        out = []
        for r in rows:
            dur = ""
            if r.get("end_ts") and r.get("lease_ts"):
                dur = f"{(r['end_ts'] - r['lease_ts']) * 1000:.1f}ms"
            out.append({
                "task_id": r["task_id"][:16],
                "desc": r.get("desc", "")[:40],
                "state": r.get("state", ""),
                "duration": dur,
                "worker": (r.get("worker") or "")[:12],
            })
        print(_table(out, ["task_id", "desc", "state", "duration",
                           "worker"]))
    elif kind == "metrics":
        print(client.call("metrics_text"), end="")
    else:
        raise SystemExit(f"unknown kind {kind!r}")


def _fmt_summary(s: Optional[Dict[str, Any]],
                 unit: str = "ms") -> str:
    if not s or not s.get("count"):
        return "-"

    def fmt(v):
        if v is None:
            return "-"
        if unit == "B":  # byte histograms (e.g. pipeline_desc_bytes)
            return f"{v:.0f}B"
        return f"{v * 1e3:.2f}ms"

    return (f"n={s['count']} mean={fmt(s.get('mean'))} "
            f"p50={fmt(s.get('p50'))} p99={fmt(s.get('p99'))}")


def _summary_unit(name: str) -> str:
    return "B" if "bytes" in name else "ms"


def cmd_metrics(args) -> None:
    """Cluster metrics with quantile summaries (reference: the Grafana
    panels over ``ray list metrics``): the core-plane view via the same
    ``core_summary`` read path the dashboard core panel uses, plus a
    merged table of every histogram in the cluster. ``--raw`` prints
    Prometheus exposition text instead (same as ``list metrics``)."""
    from ray_tpu_torch.core.coremetrics import core_summary
    from ray_tpu_torch.util.metrics import (histogram_summary,
                                            merge_histograms)

    client = _client(args)
    if args.raw:
        print(client.call("metrics_text"), end="")
        return
    agg = client.call("list_metrics")
    summary = core_summary(agg)
    print(f"sources: {len(agg)} "
          f"({', '.join(sorted(agg)[:8])}{'…' if len(agg) > 8 else ''})")
    for plane in ("rpc", "objects", "pubsub", "control", "multihost",
                  "pipeline", "autopilot"):
        print(f"\n[{plane}]")
        for field, value in summary[plane].items():
            unit = _summary_unit(field)
            if isinstance(value, dict) and {"count", "p50"} <= set(value):
                print(f"  {field:28s} {_fmt_summary(value, unit)}")
            elif isinstance(value, dict):
                for label, inner in sorted(value.items()):
                    text = (_fmt_summary(inner, unit)
                            if isinstance(inner, dict) else f"{inner:g}")
                    print(f"  {field:28s} {label}: {text}")
            else:
                print(f"  {field:28s} {value:g}")
    names = sorted({m["name"] for ms in agg.values() for m in ms
                    if m.get("kind") == "histogram"
                    and (not args.name or args.name in m["name"])})
    if names:
        print("\n[histograms, merged across sources]")
        for name in names:
            for key, entry in sorted(merge_histograms(agg, name).items()):
                tags = ",".join(f"{k}={v}" for k, v in key)
                label = f"{name}{{{tags}}}" if tags else name
                summary = histogram_summary(entry)
                print(f"  {label:44s} "
                      f"{_fmt_summary(summary, _summary_unit(name))}")


def cmd_doctor(args) -> int:
    """Diagnose cluster failure signatures from two metric snapshots a
    window apart (see ray_tpu_torch/doctor.py for the signature catalog).
    With ``--post-mortem``, skip the live snapshots entirely and
    explain a gang death / pipeline stall from flight-recorder dumps
    (``--fr-dir`` reads persisted fr-<pid>.json files directly — no
    cluster needed, the crashed-cluster case; otherwise the
    controller's ``fr_dump`` RPC merges its host's dumps)."""
    from ray_tpu_torch import doctor

    if getattr(args, "post_mortem", False):
        if args.fr_dir:
            from ray_tpu_torch.util import flightrec

            dumps = flightrec.dump_all(args.fr_dir)
        else:
            from ray_tpu_torch.core.rpc_stubs import ControllerStub

            dumps = ControllerStub(_client(args)).fr_dump()
        findings = doctor.post_mortem(dumps)
        if args.json:
            print(json.dumps(findings, indent=2, default=str))
        else:
            print(doctor.render_post_mortem(findings, dumps))
        return _findings_exit_code(findings, args.fail_on_findings)
    client = _client(args)
    before, after, nodes, interval = doctor.collect(client, args.interval)
    findings = doctor.diagnose(before, after, interval, nodes=nodes)
    if args.json:
        print(json.dumps(findings, indent=2, default=str))
    else:
        print(doctor.render(findings))
    return _findings_exit_code(findings, args.fail_on_findings)


def _findings_exit_code(findings: List[Dict[str, Any]],
                        fail_on_findings: bool) -> int:
    """Severity-aware gating: 0 = clean, 1 = warnings only, 2 = at
    least one critical — so CI can gate on criticals (`!= 2`) without
    a warning-class finding failing the build."""
    if not (fail_on_findings and findings):
        return 0
    return 2 if any(f.get("severity") == "critical"
                    for f in findings) else 1


def cmd_autopilot(args) -> int:
    """Inspect or exercise the closed-loop remediator (``autopilot.py``).
    ``--status`` prints the reconciler view (streaks, buckets, audit ring,
    live taints); ``--dry-run`` runs ONE live reconcile pass with mutations
    disabled and prints the actions that WOULD have fired (fences still
    evaluated); ``--untaint NODE`` lifts a host demotion early
    (probe-gated — a host that still fails its health probe stays
    tainted)."""
    from ray_tpu_torch.autopilot import Autopilot
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.core.rpc_stubs import ControllerStub

    client = _client(args)
    if args.untaint:
        res = ControllerStub(client).untaint_host(args.untaint,
                                                  probe=True)
        print(json.dumps(res, indent=2, default=str))
        return 0 if res.get("untainted") else 1
    if args.dry_run:
        old_enabled, old_dry = (config.autopilot_enabled,
                                config.autopilot_dry_run)
        config.autopilot_enabled = True
        config.autopilot_dry_run = True
        # Dry-run must see past the hysteresis damper — the point is
        # "what would the autopilot do about THIS window".
        old_hyst = config.autopilot_hysteresis_windows
        config.autopilot_hysteresis_windows = 1
        try:
            pilot = Autopilot(client=client)
            records = pilot.run_once(interval_s=args.interval)
        finally:
            config.autopilot_enabled = old_enabled
            config.autopilot_dry_run = old_dry
            config.autopilot_hysteresis_windows = old_hyst
        print(json.dumps(records, indent=2, default=str))
        return 0
    pilot = Autopilot(client=client)
    print(json.dumps(pilot.status(), indent=2, default=str))
    return 0


def build_chrome_trace(events: List[Dict[str, Any]],
                       serve_timelines: Optional[Dict[str, Any]] = None
                       ) -> List[Dict[str, Any]]:
    """Task events (+ optional serve engine step timelines) -> Chrome
    trace events (chrome://tracing / ui.perfetto.dev). Spans carry
    span_id/parent_span in args AND emit flow arrows between parent and
    child — the rendering of the causal chain a serve request leaves
    across proxy, router and replica processes. Shared by the timeline
    CLI, ``serve/trace_demo.py`` and the tests that assert on it."""
    trace: List[Dict[str, Any]] = []
    span_pid: Dict[str, tuple] = {}  # span_id -> (pid, tid, end_ts)
    for e in events:
        if not e.get("lease_ts") or not e.get("end_ts"):
            continue
        is_span = e.get("state") == "SPAN"
        pid = str(e.get("owner", "driver"))
        tid = e.get("worker") or "worker"
        trace.append({
            "name": e.get("desc", e["task_id"][:8]),
            "cat": "span" if is_span else "task",
            "ph": "X",
            "ts": e["lease_ts"] * 1e6,
            "dur": (e["end_ts"] - e["lease_ts"]) * 1e6,
            "pid": pid,
            "tid": tid,
            "args": {"state": e.get("state"),
                     "trace_id": e.get("trace_id"),
                     "span_id": e.get("span_id"),
                     "parent_span": e.get("parent_span"),
                     **(e.get("attrs") or {})},
        })
        if is_span and e.get("span_id"):
            span_pid[e["span_id"]] = (pid, tid, e["lease_ts"])
    # Flow arrows parent -> child (chrome renders them as curved links;
    # perfetto groups them as one flow per trace step).
    for e in events:
        parent = e.get("parent_span")
        if (e.get("state") != "SPAN" or not parent
                or parent not in span_pid or not e.get("lease_ts")):
            continue
        src_pid, src_tid, _ = span_pid[parent]
        flow_id = f"{parent}->{e['span_id']}"
        trace.append({"name": "causal", "cat": "flow", "ph": "s",
                      "id": flow_id, "ts": span_pid[parent][2] * 1e6,
                      "pid": src_pid, "tid": src_tid})
        trace.append({"name": "causal", "cat": "flow", "ph": "f",
                      "bp": "e", "id": flow_id,
                      "ts": e["lease_ts"] * 1e6,
                      "pid": str(e.get("owner", "driver")),
                      "tid": e.get("worker") or "worker"})
    for deployment, replicas in (serve_timelines or {}).items():
        from ray_tpu_torch.serve.steplog import timeline_chrome_events

        for replica_id, dump in replicas.items():
            pid = f"engine:{replica_id}"
            trace.append({"name": "process_name", "ph": "M", "pid": pid,
                          "args": {"name": f"engine {replica_id}"}})
            trace.extend(timeline_chrome_events(dump, pid=pid))
    # Train-plane stage rows: every process that emitted 1F1B cell
    # spans (fwd/bwd/apply with a stage attr) is one pipeline stage —
    # name its row so the bubble structure reads as a GPipe diagram,
    # not a pile of anonymous worker addresses.
    stage_pids: Dict[str, int] = {}
    for e in events:
        attrs = e.get("attrs") or {}
        if (e.get("state") == "SPAN" and "stage" in attrs
                and e.get("desc") in ("fwd", "bwd", "apply", "snap")
                and attrs.get("stage") is not None):
            stage_pids.setdefault(str(e.get("owner", "driver")),
                                  int(attrs["stage"]))
    for pid, stage in stage_pids.items():
        trace.append({"name": "process_name", "ph": "M", "pid": pid,
                      "args": {"name": f"stage s{stage}"}})
        trace.append({"name": "process_sort_index", "ph": "M",
                      "pid": pid, "args": {"sort_index": stage}})
    return trace


def train_trace_summary(events: List[Dict[str, Any]]
                        ) -> Dict[str, Dict[str, Any]]:
    """Per-pipeline occupancy summary from the train-plane spans. Two
    families feed it: the DRIVER's ``cell:fwd``/``cell:bwd`` spans
    (dispatch->reply per 1F1B cell — exactly the clocks
    ``bench_pipeline.py``'s bubble rows are computed from) give the
    per-stage busy seconds, and the ``pipe:step`` root spans give the
    step window; the derived bubble fraction
    ``1 - sum(busy) / (stages * window)`` therefore matches the
    bench's ``(S-1)/(m+S-1)`` rows by construction (tests pin the two
    within 10%). ``compute_s`` separately sums the STAGE-side
    fwd/bwd spans — pure stage compute occupancy, which on a
    time-sliced CPU host is much smaller than dispatch->reply."""
    # The step root span carries the pipeline name; its trace_id links
    # every cell to it across processes.
    pipeline_of: Dict[str, str] = {}
    windows: Dict[str, float] = {}
    for e in events:
        attrs = e.get("attrs") or {}
        if (e.get("state") == "SPAN" and e.get("desc") == "pipe:step"
                and e.get("trace_id") and attrs.get("pipeline")
                and e.get("lease_ts") and e.get("end_ts")):
            pipe = str(attrs["pipeline"])
            pipeline_of[e["trace_id"]] = pipe
            windows[pipe] = (windows.get(pipe, 0.0)
                             + (e["end_ts"] - e["lease_ts"]))
    out: Dict[str, Dict[str, Any]] = {}
    for e in events:
        attrs = e.get("attrs") or {}
        desc = e.get("desc", "")
        if (e.get("state") != "SPAN" or attrs.get("stage") is None
                or not e.get("lease_ts") or not e.get("end_ts")):
            continue
        is_cell = desc in ("cell:fwd", "cell:bwd")
        is_compute = desc in ("fwd", "bwd", "apply")
        if not (is_cell or is_compute):
            continue
        pipe = pipeline_of.get(e.get("trace_id"))
        if pipe is None:
            continue
        rec = out.setdefault(pipe, {"stages": {}, "compute_s": {},
                                    "cells": 0})
        key = f"s{int(attrs['stage'])}"
        dur = e["end_ts"] - e["lease_ts"]
        if is_cell:
            rec["stages"][key] = rec["stages"].get(key, 0.0) + dur
            rec["cells"] += 1
        else:
            rec["compute_s"][key] = (rec["compute_s"].get(key, 0.0)
                                     + dur)
    for pipe, rec in out.items():
        window = max(windows.get(pipe, 0.0), 1e-9)
        busy = sum(rec["stages"].values())
        n_stages = max(len(rec["stages"]) or len(rec["compute_s"]), 1)
        rec["n_stages"] = n_stages
        rec["window_s"] = window
        rec["busy_s"] = busy
        rec["bubble_fraction"] = max(
            0.0, 1.0 - busy / (n_stages * window))
    return out


def cmd_timeline(args) -> None:
    """Dump task events as a Chrome trace (chrome://tracing /
    ui.perfetto.dev) — reference: ``ray timeline``,
    ``_private/state.py:942``. With ``--serve``, additionally joins the
    cluster, pulls every decode replica's engine step timeline through
    the serve controller and merges it into the same trace: request
    spans (proxy http -> router -> attempts -> replica -> engine
    queue-wait/prefill/decode) alongside the per-step engine record
    that explains WHY a given token was slow."""
    serve_timelines = None
    if getattr(args, "serve", False):
        import ray_tpu_torch
        from ray_tpu_torch import serve

        ray_tpu_torch.init(address=resolve_address(args.address))
        try:
            serve_timelines = serve.timelines()
        finally:
            ray_tpu_torch.shutdown()
    client = _client(args)
    events = client.call("list_task_events", args.limit)
    trace = build_chrome_trace(events, serve_timelines)
    with open(args.output, "w") as f:
        json.dump(trace, f)
    n_spans = sum(1 for t in trace if t.get("cat") == "span")
    n_engine = sum(1 for t in trace if t.get("cat") == "engine-step")
    print(f"wrote {len(trace)} events ({n_spans} spans, {n_engine} "
          f"engine-step slices) to {args.output}")
    if getattr(args, "train", False):
        # The train-plane read of the same trace: per-stage occupancy
        # + the measured bubble fraction (compare against the
        # bench_pipeline (S-1)/(m+S-1) rows).
        summary = train_trace_summary(events)
        if not summary:
            print("no train-plane spans in the window (is "
                  "pipe_trace_spans on, and did a pipeline step run?)")
        for pipe, rec in sorted(summary.items()):
            busy = ", ".join(f"{s}={v:.3f}s" for s, v in
                             sorted(rec["stages"].items()))
            print(f"pipeline {pipe}: {rec['n_stages']} stages, "
                  f"{rec['cells']} cells over {rec['window_s']:.3f}s — "
                  f"bubble fraction {rec['bubble_fraction']:.3f} "
                  f"({busy})")


def cmd_start(args) -> int:
    """Bring up cluster daemons from the shell (reference: ``ray start``,
    ``scripts.py:571``). ``--head`` starts the controller + a head node (+
    thin-client server unless disabled) and writes the discovery file;
    without it, a worker node joins ``--address``. Blocks until SIGINT/
    SIGTERM, then shuts the daemons down."""
    import signal
    import threading

    resources = json.loads(args.resources) if args.resources else {}
    if args.num_cpus is not None:
        resources["CPU"] = float(args.num_cpus)
    controller = client_server = None
    if args.head:
        from ray_tpu_torch.core.controller import Controller

        controller = Controller(host=args.host, port=args.port,
                                persist_path=args.persist_path)
        controller_addr = controller.address
        write_discovery(controller_addr)
        print(f"controller: {controller_addr[0]}:{controller_addr[1]}")
    else:
        spec = args.worker_address or args.address
        if not spec:
            raise SystemExit("worker start needs --address host:port "
                             "(the head's controller address)")
        host, _, port = spec.partition(":")
        if not port.isdigit():
            raise SystemExit(f"malformed --address {spec!r}: "
                             f"expected host:port")
        controller_addr = (host, int(port))

    from ray_tpu_torch.core.api import _autodetect_gpu
    from ray_tpu_torch.core.node import Node

    labels: Dict[str, str] = {}
    _autodetect_gpu(resources, labels)
    if getattr(args, "labels", None):
        labels.update({str(k): str(v)
                       for k, v in json.loads(args.labels).items()})
    node = Node(controller_addr, resources or None, labels, host=args.host)
    print(f"node {node.node_id.hex()[:8]}: "
          f"{node.address[0]}:{node.address[1]} "
          f"resources={node.total_resources}")

    if args.head and not args.no_client_server:
        # The head also accepts thin clients (ray-tpu:// connect); this
        # process is the hosting driver.
        from ray_tpu_torch import client as client_mod
        from ray_tpu_torch.core.api import init

        init(address=controller_addr)
        client_server = client_mod.ClientServer(host=args.host)
        print(f"client server: ray-tpu://{client_server.address[0]}:"
              f"{client_server.address[1]}")

    print(f"to connect: ray_tpu_torch.init(address="
          f"('{controller_addr[0]}', {controller_addr[1]}))")
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    print("daemons running; press Ctrl-C to stop")
    try:
        while not stop.wait(1.0):
            pass
    finally:
        if client_server is not None:
            client_server.stop()
        node.stop()
        if controller is not None:
            controller.stop()
    return 0


def cmd_stacks(args) -> None:
    """Dump every live worker's Python thread stacks (the py-spy-equivalent
    debugging view, reference: dashboard reporter profiling,
    ``profile_manager.py:79`` — native via sys._current_frames here)."""
    from ray_tpu_torch.core.rpc import RpcClient

    client = _client(args)
    for node in client.call("list_nodes"):
        if not node.get("alive"):
            continue
        try:
            node_client = RpcClient(tuple(node["addr"]))
            workers = node_client.call("list_workers")
        except Exception as e:
            print(f"node {node['node_id'][:8]}: unreachable ({e})")
            continue
        print(f"=== node {node['node_id'][:8]} "
              f"({len(workers)} workers) ===")
        for w in workers:
            print(f"--- worker {w['worker_id'][:8]} pid={w['pid']} "
                  f"{'idle' if w['idle'] else 'busy'} ---")
            try:
                wc = RpcClient(tuple(w["addr"]))
                print(wc.call("dump_stacks", timeout=10.0))
                wc.close()
            except Exception as e:
                print(f"  unreachable: {e}")
        node_client.close()


def cmd_profile(args) -> int:
    """On-demand profiling of one live worker: CPU flamegraph (sampling
    profiler -> folded stacks -> self-contained SVG) or heap snapshot
    (tracemalloc top sites + growth since last call). Reference: the
    dashboard reporter shelling out to py-spy/memray per worker
    (``profile_manager.py:79,190``)."""
    from ray_tpu_torch.core.rpc import RpcClient
    from ray_tpu_torch.util.profiling import list_cluster_workers

    client = _client(args)
    matches = list_cluster_workers(client, prefix=args.worker)
    target = matches[0] if matches else None
    if target is None:
        print(f"no live worker matches {args.worker!r} "
              f"(see `python -m ray_tpu_torch stacks` for ids)")
        return 1
    wc = RpcClient(tuple(target["addr"]))
    try:
        if args.heap_stop:
            print(wc.call("profile_heap_stop", timeout=30.0))
            return 0
        if args.heap:
            import json as _json

            out = wc.call("profile_heap", 25, timeout=30.0)
            print(_json.dumps(out, indent=2))
            return 0
    finally:
        wc.close()
    from ray_tpu_torch.util.profiling import flamegraph_svg, profile_worker

    folded = profile_worker(target["addr"], args.duration)

    svg = flamegraph_svg(
        folded, title=f"worker {target['worker_id'][:8]} "
                      f"pid={target['pid']}")
    if args.out:
        with open(args.out, "w") as f:
            f.write(svg)
        print(f"wrote {args.out} ({sum(folded.values())} samples)")
    else:
        for stack, n in sorted(folded.items(), key=lambda kv: -kv[1])[:30]:
            print(f"{n:6d}  {stack}")
    return 0


def cmd_job(args) -> int:
    """Job submission CLI (reference: ``ray job submit/status/logs/stop``,
    ``dashboard/modules/job/cli.py``)."""
    from ray_tpu_torch.job_submission import JobSubmissionClient

    addr = resolve_address(args.address)
    client = JobSubmissionClient(addr)
    if args.action == "submit":
        if not args.arg:
            raise SystemExit(
                "usage: python -m ray_tpu_torch job submit '<entrypoint cmd>'")
        runtime_env = None
        if args.working_dir:
            # Upload so the supervisor can land on ANY host (reference:
            # ray job submit's working_dir package upload).
            from ray_tpu_torch.runtime_env import upload_working_dir

            runtime_env = {
                "working_dir": upload_working_dir(args.working_dir)}
        job_id = client.submit_job(entrypoint=args.arg,
                                   runtime_env=runtime_env)
        print(f"submitted {job_id}")
        if args.wait:
            status = client.wait_until_finished(job_id)
            print(client.get_job_logs(job_id), end="")
            print(f"job {job_id}: {status}")
            return 0 if status == "SUCCEEDED" else 1
    elif args.action == "status":
        print(client.get_job_status(args.arg))
    elif args.action == "logs":
        print(client.get_job_logs(args.arg), end="")
    elif args.action == "stop":
        print("stopped" if client.stop_job(args.arg) else "not running")
    elif args.action == "list":
        jobs = client.list_jobs()
        print(_table(
            [{"job_id": k, **v} for k, v in jobs.items()],
            ["job_id", "state", "entrypoint"]))
    return 0


def cmd_up(args) -> int:
    """``up cluster.yaml`` (reference: ``ray up``,
    ``autoscaler/_private/commands.py`` create_or_update_cluster): validate
    the YAML, boot head + autoscaler, keep provisioning until stopped (a
    fake_multinode cluster lives in this process; ``down`` stops it)."""
    from ray_tpu_torch.cluster_launcher import up

    cluster = up(args.config, block=False)
    for line in cluster.actions:
        print(f"  {line}")
    if cluster.address:
        print(f"cluster up; controller at {cluster.address[0]}:"
              f"{cluster.address[1]}")
    if cluster.config.dry_run:
        print("(dry run: no instances created)")
        cluster.shutdown()
        return 0
    if args.no_block:
        # Caller manages lifetime (tests); daemons die with this process.
        return 0
    from ray_tpu_torch.cluster_launcher import block_until_signal

    print("autoscaling; press Ctrl-C to stop", flush=True)
    block_until_signal(cluster)
    return 0


def cmd_down(args) -> int:
    """``down cluster.yaml`` (reference: ``ray down``)."""
    from ray_tpu_torch.cluster_launcher import down

    for name in down(args.config):
        print(f"terminated {name}")
    print("cluster down")
    return 0


def cmd_submit(args) -> int:
    """``submit cluster.yaml 'entrypoint'`` — job submission against the
    cluster the YAML describes (reference: ``ray submit``). --address
    overrides; otherwise a gpu_vm YAML resolves the head through the
    Compute API (its controller listens on the launcher's fixed port) and
    a fake/local YAML falls back to the local discovery file."""
    from ray_tpu_torch.job_submission import JobSubmissionClient

    addr = None
    if args.address:
        addr = resolve_address(args.address)
    else:
        from ray_tpu_torch.cluster_config import load_config

        cfg = load_config(args.config)
        if cfg.provider.type == "gpu_vm":
            from ray_tpu_torch.cluster_launcher import HEAD_PORT
            from ray_tpu_torch.gpu_vm_api import GpuVmClient

            client_api = GpuVmClient(cfg.provider.project_id,
                                     cfg.provider.zone, dry_run=cfg.dry_run)
            head = client_api.get_instance(f"{cfg.cluster_name}-head")
            host = GpuVmClient.instance_host(head)
            if not host:
                raise SystemExit(
                    f"head instance {cfg.cluster_name}-head not found or "
                    f"has no address (is the cluster up?)")
            addr = (host, HEAD_PORT)
        else:
            addr = resolve_address(None)
    client = JobSubmissionClient(addr)
    runtime_env = None
    if args.working_dir:
        from ray_tpu_torch.runtime_env import upload_working_dir

        runtime_env = {"working_dir": upload_working_dir(args.working_dir)}
    job_id = client.submit_job(entrypoint=args.entrypoint,
                               runtime_env=runtime_env)
    print(f"submitted {job_id}")
    status = client.wait_until_finished(job_id)
    print(client.get_job_logs(job_id), end="")
    print(f"job {job_id}: {status}")
    return 0 if status == "SUCCEEDED" else 1


def cmd_serve(args) -> int:
    """Declarative serve operations (reference: ``serve deploy/status/
    shutdown`` CLI, ``serve/scripts.py``)."""
    import json as _json

    import ray_tpu_torch

    ray_tpu_torch.init(address=resolve_address(args.address))
    from ray_tpu_torch import serve

    if args.action == "deploy":
        if not args.config:
            raise SystemExit(
                "usage: python -m ray_tpu_torch serve deploy config.yaml")
        from ray_tpu_torch.serve.build import deploy_config

        handles = deploy_config(args.config)
        print(f"deployed {len(handles)} application(s)")
    elif args.action == "status":
        print(_json.dumps({"applications": serve.status(),
                           "proxies": serve.proxy_status()},
                          indent=2, default=str))
    elif args.action == "shutdown":
        serve.shutdown()
        print("serve shut down")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="ray_tpu_torch", description="ray_tpu_torch cluster state CLI")
    parser.add_argument("--address", default=None,
                        help="controller host:port")
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("status")
    p_list = sub.add_parser("list")
    p_list.add_argument("kind", choices=["nodes", "actors", "jobs", "tasks",
                                         "metrics"])
    p_list.add_argument("--limit", type=int, default=1000)
    p_metrics = sub.add_parser("metrics")
    p_metrics.add_argument("--raw", action="store_true",
                           help="Prometheus exposition text instead of "
                                "quantile summaries")
    p_metrics.add_argument("--name", default=None,
                           help="substring filter for the histogram table")
    p_doc = sub.add_parser("doctor")
    p_doc.add_argument("--interval", type=float, default=2.0,
                       help="seconds between the two metric snapshots "
                            "(rates/growth need a window)")
    p_doc.add_argument("--json", action="store_true")
    p_doc.add_argument("--fail-on-findings", action="store_true",
                       help="exit 2 when a CRITICAL signature is "
                            "detected, 1 for warnings only, 0 clean")
    p_doc.add_argument("--post-mortem", action="store_true",
                       help="explain a gang death / pipeline stall "
                            "from flight-recorder dumps instead of "
                            "live metric snapshots")
    p_doc.add_argument("--fr-dir", default=None,
                       help="post-mortem: read persisted fr-<pid>.json "
                            "dumps from this directory directly (no "
                            "cluster needed); default asks the "
                            "controller's fr_dump RPC")
    p_ap = sub.add_parser("autopilot")
    p_ap.add_argument("--status", action="store_true",
                      help="print the reconciler view: streaks, "
                           "token buckets, audit ring, live taints "
                           "(default when no other flag given)")
    p_ap.add_argument("--dry-run", action="store_true",
                      help="run ONE reconcile pass with mutations "
                           "disabled; print what WOULD have fired")
    p_ap.add_argument("--untaint", default=None, metavar="NODE",
                      help="lift a host demotion early (probe-gated)")
    p_ap.add_argument("--interval", type=float, default=2.0,
                      help="dry-run: seconds between the two metric "
                           "snapshots")
    p_tl = sub.add_parser("timeline")
    p_tl.add_argument("--output", "-o", default="timeline.json")
    p_tl.add_argument("--limit", type=int, default=10000)
    p_tl.add_argument("--serve", action="store_true",
                      help="merge every serve replica's engine step "
                           "timeline into the trace (joins the cluster "
                           "to reach the serve controller)")
    p_tl.add_argument("--train", action="store_true",
                      help="print the train-plane per-stage occupancy "
                           "summary (trace-derived 1F1B bubble "
                           "fraction) for the pipeline spans in the "
                           "window")
    sub.add_parser("stacks")
    p_prof = sub.add_parser("profile")
    p_prof.add_argument("worker", help="worker id (hex prefix ok)")
    p_prof.add_argument("--duration", type=float, default=3.0)
    p_prof.add_argument("--heap", action="store_true")
    p_prof.add_argument("--heap-stop", action="store_true",
                        help="turn allocation tracing back off")
    p_prof.add_argument("--out", default=None,
                        help="write SVG flamegraph here (default: print "
                             "folded stacks)")
    sub.add_parser("memory")
    p_start = sub.add_parser("start")
    p_start.add_argument("--head", action="store_true")
    p_start.add_argument("--address", dest="worker_address", default=None,
                         help="controller host:port to join (worker mode)")
    p_start.add_argument("--host", default="127.0.0.1")
    p_start.add_argument("--port", type=int, default=0,
                         help="controller port (head only; 0 = ephemeral)")
    p_start.add_argument("--num-cpus", type=float, default=None)
    p_start.add_argument("--resources", default=None,
                         help='JSON, e.g. \'{"GPU": 1}\'')
    p_start.add_argument("--labels", default=None,
                         help='JSON node labels, e.g. '
                         '\'{"provider_node_id": "..."}\'')
    p_start.add_argument("--persist-path", default=None,
                         help="controller state snapshot dir (GCS FT)")
    p_start.add_argument("--no-client-server", action="store_true")
    p_serve = sub.add_parser("serve")
    p_serve.add_argument("action", choices=["deploy", "status", "shutdown"])
    p_serve.add_argument("config", nargs="?", default=None,
                         help="config.yaml (deploy)")
    p_up = sub.add_parser("up")
    p_up.add_argument("config", help="cluster YAML")
    p_up.add_argument("--no-block", action="store_true",
                      help="return after bring-up (testing)")
    p_down = sub.add_parser("down")
    p_down.add_argument("config", help="cluster YAML")
    p_submit = sub.add_parser("submit")
    p_submit.add_argument("config", help="cluster YAML (address discovery)")
    p_submit.add_argument("entrypoint", help="shell command to run")
    p_submit.add_argument("--working-dir", default=None)
    p_job = sub.add_parser("job")
    p_job.add_argument("action", choices=["submit", "status", "logs",
                                          "stop", "list"])
    p_job.add_argument("arg", nargs="?", default=None,
                       help="entrypoint (submit) or job id")
    p_job.add_argument("--working-dir", default=None)
    p_job.add_argument("--wait", action="store_true",
                       help="submit: block until the job finishes")
    args = parser.parse_args(argv)
    if args.command == "status":
        cmd_status(args)
    elif args.command == "metrics":
        cmd_metrics(args)
    elif args.command == "doctor":
        return cmd_doctor(args)
    elif args.command == "autopilot":
        return cmd_autopilot(args)
    elif args.command == "list":
        cmd_list(args)
    elif args.command == "timeline":
        cmd_timeline(args)
    elif args.command == "stacks":
        cmd_stacks(args)
    elif args.command == "profile":
        return cmd_profile(args)
    elif args.command == "memory":
        cmd_memory(args)
    elif args.command == "start":
        return cmd_start(args)
    elif args.command == "up":
        return cmd_up(args)
    elif args.command == "down":
        return cmd_down(args)
    elif args.command == "submit":
        return cmd_submit(args)
    elif args.command == "job":
        return cmd_job(args)
    elif args.command == "serve":
        return cmd_serve(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
