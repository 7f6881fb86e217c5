"""Serve-plane trace demo: ``make trace-demo`` / tier-1's fast gate.

Runs a tiny serve session (debug-model decode deployment, two
replicas, real HTTP proxy), issues traced requests through the proxy
with the client's own span propagated via ``X-Trace-Id`` headers,
merges the task-event spans with every replica's engine step timeline
into one Chrome trace JSON, and VALIDATES it: the file must load as
JSON and contain at least one cross-process parent/child span pair —
the invariant that makes the trace causally linked rather than a pile
of disconnected slices.

Standalone::

    python -m ray_tpu_torch.serve.trace_demo [--output /tmp/serve_trace.json]

Inside an existing cluster (the tier-1 test): call :func:`run_demo`
with ``init=False``; it then deletes only its own deployment, so other
deployments of that cluster keep serving (the JAX demo shuts the serve
plane down). The replicas build their model on ``device`` (``cuda``
unless the caller passes another, as every entry point of the port).
"""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Any, Dict, List, Optional, Tuple


def validate_trace(trace: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Causality audit of a Chrome trace built by
    ``scripts.build_chrome_trace``: span process spread and
    cross-process parent/child links (a child span whose parent span
    was recorded by a DIFFERENT process)."""
    spans = [t for t in trace if t.get("cat") == "span"]
    by_id = {t["args"]["span_id"]: t for t in spans
             if t.get("args", {}).get("span_id")}
    cross: List[Tuple[str, str]] = []
    for t in spans:
        parent = t.get("args", {}).get("parent_span")
        p = by_id.get(parent)
        if p is not None and p["pid"] != t["pid"]:
            cross.append((p["name"], t["name"]))
    return {
        "events": len(trace),
        "spans": len(spans),
        "span_pids": sorted({t["pid"] for t in spans}),
        "engine_slices": sum(1 for t in trace
                             if t.get("cat") == "engine-step"),
        "cross_process_links": cross,
    }


def run_demo(output: Optional[str] = None, init: bool = True,
             replicas: int = 2, requests: int = 3,
             timeout_s: float = 120.0, device=None) -> Dict[str, Any]:
    """Run the demo; returns ``validate_trace``'s report (raises when
    the trace fails validation). ``init=False`` reuses the caller's
    cluster (tests)."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.runtime import get_core_worker
    from ray_tpu_torch.scripts import build_chrome_trace
    from ray_tpu_torch.serve.decode import LlamaDecodeDeployment
    from ray_tpu_torch.util import tracing

    if init:
        ray_tpu_torch.init(num_cpus=4)
    try:
        app = serve.deployment(num_replicas=replicas)(
            LlamaDecodeDeployment).bind(preset="debug", slots=2,
                                        capacity=128, device=device)
        serve.run(app, name="trace_demo")
        host, port = serve.start_http()
        url = f"http://{host}:{port}/trace_demo"
        for i in range(requests):
            with tracing.trace("client-request", i=i):
                ctx = tracing.current()
                req = urllib.request.Request(
                    url,
                    data=json.dumps({"tokens": [1, 2, 3, 4 + i],
                                     "max_new_tokens": 4}).encode(),
                    headers={"Content-Type": "application/json",
                             "X-Trace-Id": ctx[0],
                             "X-Parent-Span": ctx[1]})
                with urllib.request.urlopen(req, timeout=60) as resp:
                    json.loads(resp.read())
        core = get_core_worker()
        # Spans flush on each process's own cadence; poll until the
        # trace validates (or the deadline names what's missing).
        deadline = time.monotonic() + timeout_s
        report: Dict[str, Any] = {}
        trace: List[Dict[str, Any]] = []
        while time.monotonic() < deadline:
            core._flush_task_events()
            events = core.controller.call("list_task_events", 10000)
            trace = build_chrome_trace(events, serve.timelines())
            report = validate_trace(trace)
            if (len(report["span_pids"]) >= 3
                    and report["cross_process_links"]
                    and report["engine_slices"] >= 1):
                break
            time.sleep(0.3)
        if output:
            with open(output, "w") as f:
                json.dump(trace, f)
            with open(output) as f:
                json.load(f)  # the artifact itself must round-trip
            report["output"] = output
        if len(report.get("span_pids", [])) < 3:
            raise AssertionError(
                f"spans from {report.get('span_pids')} — expected >=3 "
                f"processes (client, proxy/router, replica engine)")
        if not report.get("cross_process_links"):
            raise AssertionError(
                "no cross-process parent/child span pair in the trace")
        if report.get("engine_slices", 0) < 1:
            raise AssertionError("no engine step-timeline slices merged")
        return report
    finally:
        if not init:
            serve.delete("trace_demo")
        else:
            try:
                serve.shutdown()
            finally:
                ray_tpu_torch.shutdown()


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.serve.trace_demo")
    parser.add_argument("--output", "-o", default="serve_trace.json")
    args = parser.parse_args(argv)
    report = run_demo(output=args.output)
    print(json.dumps(report, indent=2))
    print(f"trace OK: {report['spans']} spans across "
          f"{len(report['span_pids'])} processes, "
          f"{len(report['cross_process_links'])} cross-process links, "
          f"{report['engine_slices']} engine slices -> {args.output}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
