"""Serve-plane SLO instruments and the one summary the surfaces share (copy
of ``ray_tpu/serve/metrics.py``).

The SLOs a serving deployment is judged by are latency distributions
(TTFT and time per output token), not point gauges. This module registers
them as ``util.metrics`` Counter / Histogram instruments labeled by
deployment, with the JAX package's names, bucket boundaries and tag keys,
recorded by the decode engine, its deployment, the router and the HTTP
proxy per REQUEST (never per token or per step: the decode loop must not
pay a registry lock per step), pushed by each process's metrics flusher to
the cluster controller, and read back through ``slo_summary`` (the
controller's ``list_metrics``, which ``serve.status()`` uses, or one
process's ``{"local": _Registry.get().snapshot()}``).
"""

from __future__ import annotations

from typing import Any, Dict, List

from ray_tpu_torch.util.metrics import (Counter, Gauge, Histogram, counter_totals,
                                  histogram_summary, merge_histograms)

# Latency grids sized for decode serving: TTFT spans admission-queue
# waits (ms) through multi-second prefill backlogs; inter-token spans
# sub-ms device steps through seconds of CPU-host steps.
_TTFT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
_TOKEN_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                  0.1, 0.25, 0.5, 1.0, 2.5)
_HTTP_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                 5.0, 10.0, 30.0, 60.0)

TTFT = Histogram(
    "serve_ttft_s",
    "Time to first token: engine submit -> first emitted token "
    "(includes queue wait and prefill).",
    boundaries=_TTFT_BUCKETS, tag_keys=("deployment",))

INTER_TOKEN = Histogram(
    "serve_inter_token_s",
    "Per-output-token latency of one request's stream: (finish - first "
    "token) / (tokens - 1), observed once per completed request "
    "(robust to chunked emission's bursty raw gaps).",
    boundaries=_TOKEN_BUCKETS, tag_keys=("deployment",))

QUEUE_WAIT = Histogram(
    "serve_queue_wait_s",
    "Engine admission-queue wait: submit -> prefill dispatch.",
    boundaries=_TTFT_BUCKETS, tag_keys=("deployment",))

HTTP_LATENCY = Histogram(
    "serve_http_request_s",
    "HTTP proxy request latency (headers in -> response written), "
    "labeled by resolved deployment.",
    boundaries=_HTTP_BUCKETS, tag_keys=("deployment",))

REQUESTS = Counter(
    "serve_requests_total",
    "Engine request outcomes: completed | cancelled | deadline_exceeded "
    "| shed | error.",
    tag_keys=("deployment", "outcome"))

HTTP_REQUESTS = Counter(
    "serve_http_requests_total",
    "HTTP proxy responses by status code.",
    tag_keys=("deployment", "code"))

RETRIES = Counter(
    "serve_router_retries_total",
    "Router retries after replica death (attempts beyond the first).",
    tag_keys=("deployment",))

PREEMPTIONS = Counter(
    "serve_preemptions_total",
    "Engine recompute-preemptions under page pressure.",
    tag_keys=("deployment",))

# Speculative decoding: proposal volume + acceptance. Counters give the
# fleet-wide accepted/proposed ratio (the speedup predictor); the
# histogram gives the per-request distribution (a bimodal accept rate
# means one traffic class defeats the draft). Observed once per request
# at its terminal step, per the per-REQUEST doctrine above.
SPEC_PROPOSED = Counter(
    "serve_spec_proposed_tokens_total",
    "Draft tokens proposed to the verify forward.",
    tag_keys=("deployment",))

SPEC_ACCEPTED = Counter(
    "serve_spec_accepted_tokens_total",
    "Draft tokens accepted by target verification.",
    tag_keys=("deployment",))

SPEC_ACCEPT = Histogram(
    "serve_spec_accept_rate",
    "Per-request draft acceptance rate (accepted / proposed).",
    boundaries=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0),
    tag_keys=("deployment",))

# Disaggregated prefill/decode handoff. Descriptor bytes
# prove the handoff rides the object plane by reference: the descriptor
# is block-table metadata (~hundreds of bytes), never the KV payload
# itself — a descriptor past a few KiB means someone inlined pages.
# Latency is publish -> adopt (the lease's open interval); the counter's
# event tag closes the books: published == adopted + aborted + expired
# at quiescence, anything else is a leaked lease.
_HANDOFF_BYTE_BUCKETS = (128.0, 256.0, 512.0, 1024.0, 2048.0, 4096.0,
                         8192.0, 16384.0, 65536.0)

HANDOFF_BYTES = Histogram(
    "serve_handoff_bytes",
    "Pickled size of one prefill->decode handoff descriptor (block-table "
    "metadata + ObjectRefs, NOT the KV payload).",
    boundaries=_HANDOFF_BYTE_BUCKETS, tag_keys=("deployment",))

HANDOFF_LATENCY = Histogram(
    "serve_handoff_latency_s",
    "KV-page handoff lease lifetime: publish on the prefill replica -> "
    "adopt acknowledged by the decode side.",
    boundaries=_TTFT_BUCKETS, tag_keys=("deployment",))

HANDOFFS = Counter(
    "serve_handoffs_total",
    "KV-page handoff lease events: published | adopted | aborted | "
    "expired. published - (adopted + aborted + expired) is the number "
    "of leases currently open; nonzero at quiescence means leaked "
    "pages/refs.",
    tag_keys=("deployment", "event"))

PENDING_RELEASES = Gauge(
    "serve_pending_subslice_releases",
    "Sub-slice release RPCs awaiting retry after a head blip "
    "(ServeController._pending_releases depth — growth means chips are "
    "stranded until the reconcile loop gets through).")

CONTROLLER_EPOCH = Gauge(
    "serve_controller_epoch",
    "Monotonic serve-controller epoch (bumped on every controller "
    "(re)start via the core epoch lease). A delta >= 2 over a doctor "
    "window means the controller is crash-looping "
    "(controller-flapping); the max across sources is the OWNING epoch "
    "replicas are checked against.")

REPLICA_EPOCH = Gauge(
    "serve_replica_epoch",
    "The controller epoch that owns this replica (assigned at spawn, "
    "re-pushed at adoption). A replica whose epoch stays below the "
    "live controller epoch — or that reports with no controller series "
    "at all — is serving traffic nobody reconciles (orphan-replica).",
    tag_keys=("deployment",))

# Outcomes worth a counter key even at zero; keeps dashboards stable.
OUTCOMES = ("completed", "cancelled", "deadline_exceeded", "shed", "error")

_HISTOGRAMS = {
    "ttft_s": "serve_ttft_s",
    "inter_token_s": "serve_inter_token_s",
    "queue_wait_s": "serve_queue_wait_s",
    "http_request_s": "serve_http_request_s",
    "spec_accept_rate": "serve_spec_accept_rate",
    "handoff_bytes": "serve_handoff_bytes",
    "handoff_latency_s": "serve_handoff_latency_s",
}


def slo_summary(aggregated: Dict[str, List[Dict[str, Any]]]
                ) -> Dict[str, Dict[str, Any]]:
    """Per-deployment SLO view from aggregated metrics (``{source:
    snapshot}``; in the port one process's ``{"local":
    _Registry.get().snapshot()}``): histogram summaries (count / mean /
    p50 / p99) for TTFT, inter-token, queue-wait and HTTP latency, plus
    outcome / retry / preemption / speculative / handoff counter
    totals."""
    out: Dict[str, Dict[str, Any]] = {}

    def rec(deployment: str) -> Dict[str, Any]:
        return out.setdefault(deployment, {})

    for field, name in _HISTOGRAMS.items():
        for key, entry in merge_histograms(aggregated, name).items():
            dep = dict(key).get("deployment", "-")
            rec(dep)[field] = histogram_summary(entry)
    for key, total in counter_totals(aggregated,
                                     "serve_requests_total").items():
        tags = dict(key)
        dep = tags.get("deployment", "-")
        rec(dep).setdefault("outcomes", {})[
            tags.get("outcome", "?")] = int(total)
    for name, field in (("serve_router_retries_total", "retries"),
                        ("serve_preemptions_total", "preempted"),
                        ("serve_spec_proposed_tokens_total",
                         "spec_proposed_tokens"),
                        ("serve_spec_accepted_tokens_total",
                         "spec_accepted_tokens"),
                        ("serve_http_requests_total", "http_responses")):
        for key, total in counter_totals(aggregated, name).items():
            tags = dict(key)
            dep = tags.get("deployment", "-")
            if name == "serve_http_requests_total":
                rec(dep).setdefault(field, {})[
                    tags.get("code", "?")] = int(total)
            else:
                rec(dep)[field] = rec(dep).get(field, 0) + int(total)
    for key, total in counter_totals(aggregated,
                                     "serve_handoffs_total").items():
        tags = dict(key)
        dep = tags.get("deployment", "-")
        rec(dep).setdefault("handoffs", {})[
            tags.get("event", "?")] = int(total)
    return out
