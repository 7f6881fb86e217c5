"""Core-plane instruments + the one cluster summary the surfaces share.

The serve plane got its SLO instruments in ``serve/metrics.py``; this is
the same pattern for the runtime UNDERNEATH it — the PR 1 non-blocking
RPC write path, the object plane, core pubsub, and the controller's
scheduler/heartbeat loops. A stalled peer filling its outbound queue, a
reconnect storm against a dead address, pubsub subscribers falling
versions behind, or monotonic live-ref growth were all invisible until
they became a hang; these instruments make each one a number a fleet
operator (and ``ray_tpu doctor``) can read.

Cost discipline (stricter than serve's per-request rule, because the
RPC reactor is hotter than any request path): hot paths touch **plain
attribute counters under locks they already hold** — never the registry
lock. Snapshot-time collectors (``util.metrics.add_collector``) publish
those counters as gauges / counter-deltas / batched histogram
observations only when a snapshot is actually pushed (heartbeat
cadence). Client-side paths that already pay a syscall (dialing,
object transfer chunks) record directly. Everything gates on
``config.core_metrics_enabled`` (``make bench-obs`` measures the
on-vs-off delta; bar <2% on the RPC microbench and the decode step
loop).

Read the cluster view back through :func:`core_summary` — the single
aggregation behind ``ray_tpu metrics``, the dashboard's core panel and
the doctor's healthy-cluster baseline, exactly as
``serve.metrics.slo_summary`` backs the serve surfaces.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ray_tpu_torch.util.metrics import (Counter, Gauge, Histogram, counter_totals,
                                  gauge_totals, histogram_summary,
                                  merge_histograms)

# Sub-ms grid: reactor flushes are syscall-scale; anything in the tail
# buckets means the kernel buffer (or chaos pacing) pushed back.
_FLUSH_BUCKETS = (0.00001, 0.00005, 0.0001, 0.0005, 0.001, 0.005, 0.01,
                  0.05, 0.1, 0.5)
# Object put/get spans inline-store hits (us) through chunked
# cross-node pulls (seconds).
_OBJ_BUCKETS = (0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0,
                5.0, 30.0)
# Heartbeat RTTs are ~ms on a healthy localhost control plane; the
# upper buckets exist to make outliers (doctor signature) resolvable.
_RTT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5)
# Pubsub versions-behind grid (a count, not a latency).
_LAG_BUCKETS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 500.0)

# ------------------------------------------------------------ RPC plane

RPC_TX_FRAMES = Counter(
    "rpc_tx_frames_total",
    "Reply frames enqueued on server outbound queues.",
    tag_keys=("server",))
RPC_TX_BYTES = Counter(
    "rpc_tx_bytes_total",
    "Reply bytes (incl. frame headers) enqueued on server outbound "
    "queues.", tag_keys=("server",))
RPC_BACKPRESSURE_DROPS = Counter(
    "rpc_backpressure_drops_total",
    "Connections dropped because their outbound queue hit "
    "rpc_outbound_cap_bytes (the peer stopped reading).",
    tag_keys=("server",))
RPC_CONN_DROPS = Counter(
    "rpc_conn_drops_total",
    "Server connection teardowns through _drop (EOF, read/flush error, "
    "over-cap).", tag_keys=("server",))
RPC_OUT_QUEUE_BYTES = Gauge(
    "rpc_outbound_queue_bytes",
    "Bytes currently queued for send across a server's live "
    "connections (snapshot-time sample).", tag_keys=("server",))
RPC_OUT_QUEUE_CONNS = Gauge(
    "rpc_outbound_queue_conns",
    "Live connections with a non-empty outbound queue.",
    tag_keys=("server",))
RPC_FLUSH_S = Histogram(
    "rpc_flush_s",
    "Reactor-side flush latency (one _flush pass; bounded sample ring, "
    "published at snapshot time).",
    boundaries=_FLUSH_BUCKETS, tag_keys=("server",))
RPC_DIALS = Counter(
    "rpc_dials_total",
    "Successful outbound dials, by peer role (controller | peer).",
    tag_keys=("role",))
RPC_DIAL_FAILURES = Counter(
    "rpc_dial_failures_total",
    "Failed TCP connect attempts (each retry counts — a dead address "
    "under active redial shows as a storm).", tag_keys=("role",))
RPC_RECONNECT_RETRIES = Counter(
    "rpc_reconnect_retries_total",
    "ReconnectingClient call retries after a transport failure "
    "(controller restarts / head blips).", tag_keys=("role",))

# --------------------------------------------------------- object plane

OBJ_PUT_BYTES = Counter(
    "obj_put_bytes_total", "Serialized bytes stored by put().")
OBJ_PUT_S = Histogram(
    "obj_put_s", "put() latency: serialize + store (shm or inline).",
    boundaries=_OBJ_BUCKETS)
OBJ_GET_S = Histogram(
    "obj_get_s",
    "get() latency per ref, by resolution path (local | remote).",
    boundaries=_OBJ_BUCKETS, tag_keys=("path",))
OBJ_TRANSFER_BYTES = Counter(
    "obj_transfer_bytes_total",
    "Bytes pulled over the network (chunked node-to-node reads).")
OBJ_LIVE_REFS = Gauge(
    "obj_live_refs",
    "Live ObjectRef handles tracked by this process (monotonic growth "
    "here is the leak signature ray_tpu doctor looks for).")
OBJ_STORE_ENTRIES = Gauge(
    "obj_store_entries", "Entries in this process's in-process store.")
OBJ_STORE_BYTES = Gauge(
    "obj_store_bytes",
    "Serialized bytes held inline by this process's in-process store "
    "(shm-resident values are counted by the node store, not here).")
OBJ_FLUSH_ABANDONED = Counter(
    "obj_ref_flush_abandoned_total",
    "Ref-count delta batches abandoned because their owner process "
    "could not be dialed (owner gone — its objects died with it).")

# --------------------------------------------------------- pubsub plane

PSUB_PUBLISHES = Counter(
    "psub_publishes_total", "Hub publishes, by channel.",
    tag_keys=("channel",))
PSUB_DELIVER_S = Histogram(
    "psub_deliver_s",
    "publish -> long-poll delivery latency for subscribers that were "
    "parked when the publish landed.",
    boundaries=_FLUSH_BUCKETS, tag_keys=("channel",))
PSUB_SUB_LAG = Histogram(
    "psub_sub_lag",
    "Versions a subscriber skipped per successful poll (1 = fully "
    "caught up; growth means consumers can't keep up with publishes).",
    boundaries=_LAG_BUCKETS, tag_keys=("channel",))
PSUB_DROPPED_NOTIFIES = Counter(
    "psub_dropped_notifies_total",
    "Subscriber-side watch deliveries dropped (callback raised or the "
    "poll RPC failed).", tag_keys=("channel",))

# -------------------------------------------------------- control plane

CTRL_HEARTBEATS = Counter(
    "ctrl_heartbeats_total", "Heartbeats applied by the controller.")
CTRL_PENDING_DEMAND = Gauge(
    "ctrl_pending_demand",
    "Live unmet scheduling-demand shapes (autoscaler signal).")
CTRL_NODE_DEATHS = Counter(
    "ctrl_node_deaths_total",
    "Nodes declared dead (missed heartbeats or unregister).")
CTRL_SCHEDULE_S = Histogram(
    "ctrl_actor_schedule_s",
    "Actor lease-grant latency: placement pick -> worker leased -> "
    "__init__ pushed -> ALIVE.", boundaries=_OBJ_BUCKETS)
NODE_HEARTBEAT_RTT = Histogram(
    "node_heartbeat_rtt_s",
    "Node-observed heartbeat round-trip to the controller; one series "
    "per node.", boundaries=_RTT_BUCKETS, tag_keys=("node",))

# ------------------------------------------------------ multihost plane
#
# Host-group gangs (core/multihost.py). Barrier waits span instant
# rendezvous (everyone already arrived) through straggler-bound stalls;
# the entered/absent split per member is what `ray_tpu doctor`'s
# gang-hang signature reads.

_BARRIER_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                    30.0, 60.0)

MH_GROUPS = Gauge(
    "mh_groups",
    "Host groups currently registered with the controller's group "
    "registry.")
MH_MEMBER_EPOCH = Gauge(
    "mh_member_epoch",
    "Group epoch each gang member last heartbeat under; a member "
    "pinned below its group's current epoch is a fenced zombie.",
    tag_keys=("group", "member"))
MH_BARRIER_ENTERED = Gauge(
    "mh_barrier_entered",
    "1 when the member has arrived at a currently-pending group "
    "barrier, 0 when the gang is waiting on it (uniform 0 when no "
    "barrier is pending). Persistent divergence is the gang-hang "
    "signature.", tag_keys=("group", "member"))
MH_BARRIER_WAIT_S = Histogram(
    "mh_barrier_wait_s",
    "Time a member parked in a group rendezvous barrier before "
    "completion or timeout.", boundaries=_BARRIER_BUCKETS)

# ------------------------------------------------------ pipeline plane
#
# MPMD pipeline training (train/pipeline_plane.py). The driver-side
# scheduler owns these series (it sees every dispatch and completion,
# including the ones a stalled stage never answers): the per-stage idle
# split is what `ray_tpu doctor`'s pipeline-stall signature reads — a
# straggler stage is BUSY (idle ~0) while every stage starved behind it
# idles for the whole window.

# Descriptor sizes: stage RPCs must carry refs + metadata, never
# tensors; anything near the top buckets means activation bytes leaked
# into the control path (tests pin the p99 against the budget).
_DESC_BUCKETS = (128.0, 256.0, 512.0, 1024.0, 2048.0, 4096.0, 8192.0,
                 16384.0)

PIPE_STAGE_IDLE_S = Gauge(
    "pipeline_stage_idle_s",
    "Seconds each pipeline stage has been idle (no dispatched work), "
    "as seen by the driver-side scheduler; 0 while a call is in "
    "flight. One stage busy while the rest idle for a whole doctor "
    "window is the pipeline-stall signature.",
    tag_keys=("pipeline", "stage"))
PIPE_ACTIVATION_BYTES = Gauge(
    "pipeline_activation_bytes",
    "Bytes of activation/gradient tensors currently in flight through "
    "the object plane for a pipeline (driver ref-ledger accounting; "
    "returns to 0 between steps).", tag_keys=("pipeline",))
PIPE_INFLIGHT = Gauge(
    "pipeline_inflight_microbatches",
    "Microbatches admitted but not yet fully backpropagated (the 1F1B "
    "in-flight window actually in use).", tag_keys=("pipeline",))
PIPE_DESC_BYTES = Histogram(
    "pipeline_desc_bytes",
    "Serialized stage-RPC descriptor size (ref + metadata, never "
    "tensor bytes — the tensors ride the object plane).",
    boundaries=_DESC_BUCKETS, tag_keys=("pipeline",))
PIPE_STEP_PHASE_S = Gauge(
    "pipeline_step_breakdown_s",
    "Stage-seconds of the last completed optimizer step by phase "
    "(fwd | bwd | apply | allgather | idle): fwd/bwd sum the driver-"
    "observed dispatch->reply occupancy, apply charges the concurrent "
    "update fan-out to every stage, idle is the remainder of "
    "stages x step wall — the measured 1F1B bubble. The TPU MFU "
    "accounting discipline: every stage-second of a step has a row.",
    tag_keys=("pipeline", "phase"))
PIPE_MODEL_TFLOPS = Gauge(
    "pipeline_model_tflops",
    "Achieved model TFLOP/s of the last completed step "
    "(~8 x params x tokens / wall: 2 fwd + 4 bwd + 2 recompute-fwd — "
    "stage backwards recompute their forward inside jax.vjp).",
    tag_keys=("pipeline",))
PIPE_MFU = Gauge(
    "pipeline_mfu_pct",
    "Model FLOPs utilization estimate: achieved model TFLOP/s over "
    "the gang's configured peak (config.pipe_peak_tflops) x 100. "
    "Absent unless the peak is configured — there is no honest peak "
    "for a time-sliced CPU host.", tag_keys=("pipeline",))

# --------------------------------------------------- autopilot plane
# Closed-loop remediation (autopilot.py): every decision the
# reconciler takes — or declines — has a series. actions_total's
# outcome label distinguishes applied / dry-run / stale-epoch /
# failed; suppressed_total's reason label is WHY nothing happened
# (kill-switch, hysteresis, rate-limit). Both label sets are fixed
# small enums — never ids.

AUTOPILOT_ACTIONS = Counter(
    "autopilot_actions_total",
    "Remediation actions the autopilot decided, by action class "
    "(taint-host | reschedule-gang | shed-tenant | resize-deployment) "
    "and outcome (applied | dry-run | stale-epoch | failed). "
    "stale-epoch is the fence working: the cluster self-healed "
    "between observation and action, so the action no-opped.",
    tag_keys=("action", "outcome"))
AUTOPILOT_SUPPRESSED = Counter(
    "autopilot_suppressed_total",
    "Remediations the autopilot declined, by reason (disabled | "
    "hysteresis | rate-limit). Hysteresis suppressions on a healthy "
    "cluster are the false-remediation guard doing its job.",
    tag_keys=("reason",))
AUTOPILOT_MTTR_S = Gauge(
    "autopilot_mttr_s",
    "Seconds from a signature's FIRST observation to its remediation "
    "action being applied (per action class; last action wins). The "
    "detect->decide->act latency of the closed loop — hysteresis "
    "windows are inside it by design.",
    tag_keys=("action",))


# ----------------------------------------------------- cluster summary


def _tag_map(totals: Dict[tuple, float], tag: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for key, v in totals.items():
        label = dict(key).get(tag, "-")
        out[label] = out.get(label, 0.0) + v
    return out


def _merged_summary(aggregated, name: str, tag: str = None
                    ) -> Dict[str, Any]:
    merged = merge_histograms(aggregated, name)
    if tag is None:
        total = None
        for entry in merged.values():
            if total is None:
                total = dict(entry)
            else:
                total["counts"] = [a + b for a, b in
                                   zip(total["counts"], entry["counts"])]
                total["sum"] += entry["sum"]
                total["count"] += entry["count"]
        return histogram_summary(total) if total else {}
    return {dict(k).get(tag, "-"): histogram_summary(e)
            for k, e in merged.items()}


def core_summary(aggregated: Dict[str, List[Dict[str, Any]]]
                 ) -> Dict[str, Any]:
    """Cluster-wide core-plane view from the controller's aggregated
    metrics (``list_metrics``): the single read path behind
    ``ray_tpu metrics``, the dashboard core panel, and the doctor's
    evidence rendering."""
    out: Dict[str, Any] = {}
    out["rpc"] = {
        "tx_frames": sum(counter_totals(aggregated,
                                        "rpc_tx_frames_total").values()),
        "tx_bytes": sum(counter_totals(aggregated,
                                       "rpc_tx_bytes_total").values()),
        "backpressure_drops": sum(counter_totals(
            aggregated, "rpc_backpressure_drops_total").values()),
        "conn_drops": sum(counter_totals(
            aggregated, "rpc_conn_drops_total").values()),
        "queue_bytes": sum(gauge_totals(
            aggregated, "rpc_outbound_queue_bytes").values()),
        "queued_conns": sum(gauge_totals(
            aggregated, "rpc_outbound_queue_conns").values()),
        "dials": _tag_map(counter_totals(aggregated, "rpc_dials_total"),
                          "role"),
        "dial_failures": _tag_map(
            counter_totals(aggregated, "rpc_dial_failures_total"), "role"),
        "reconnect_retries": sum(counter_totals(
            aggregated, "rpc_reconnect_retries_total").values()),
        "flush_s": _merged_summary(aggregated, "rpc_flush_s"),
    }
    out["objects"] = {
        "put_bytes": sum(counter_totals(aggregated,
                                        "obj_put_bytes_total").values()),
        "transfer_bytes": sum(counter_totals(
            aggregated, "obj_transfer_bytes_total").values()),
        "live_refs": sum(gauge_totals(aggregated, "obj_live_refs").values()),
        "store_entries": sum(gauge_totals(
            aggregated, "obj_store_entries").values()),
        "store_bytes": sum(gauge_totals(
            aggregated, "obj_store_bytes").values()),
        "flush_abandoned": sum(counter_totals(
            aggregated, "obj_ref_flush_abandoned_total").values()),
        "put_s": _merged_summary(aggregated, "obj_put_s"),
        "get_s": _merged_summary(aggregated, "obj_get_s", tag="path"),
    }
    out["pubsub"] = {
        "publishes": _tag_map(counter_totals(
            aggregated, "psub_publishes_total"), "channel"),
        "dropped_notifies": sum(counter_totals(
            aggregated, "psub_dropped_notifies_total").values()),
        "deliver_s": _merged_summary(aggregated, "psub_deliver_s"),
        "sub_lag": _merged_summary(aggregated, "psub_sub_lag",
                                   tag="channel"),
    }
    out["control"] = {
        "heartbeats": sum(counter_totals(
            aggregated, "ctrl_heartbeats_total").values()),
        "pending_demand": sum(gauge_totals(
            aggregated, "ctrl_pending_demand").values()),
        "node_deaths": sum(counter_totals(
            aggregated, "ctrl_node_deaths_total").values()),
        "actor_schedule_s": _merged_summary(aggregated,
                                            "ctrl_actor_schedule_s"),
        "heartbeat_rtt_s": _merged_summary(aggregated,
                                           "node_heartbeat_rtt_s",
                                           tag="node"),
        "pending_subslice_releases": sum(gauge_totals(
            aggregated, "serve_pending_subslice_releases").values()),
    }
    out["multihost"] = {
        "groups": sum(gauge_totals(aggregated, "mh_groups").values()),
        "member_series": len(gauge_totals(aggregated,
                                          "mh_member_epoch")),
        "barrier_wait_s": _merged_summary(aggregated,
                                          "mh_barrier_wait_s"),
    }
    out["pipeline"] = {
        "inflight_microbatches": sum(gauge_totals(
            aggregated, "pipeline_inflight_microbatches").values()),
        "activation_bytes": sum(gauge_totals(
            aggregated, "pipeline_activation_bytes").values()),
        "stage_idle_s": _tag_map(gauge_totals(
            aggregated, "pipeline_stage_idle_s"), "stage"),
        "desc_bytes": _merged_summary(aggregated, "pipeline_desc_bytes"),
        "step_breakdown_s": _tag_map(gauge_totals(
            aggregated, "pipeline_step_breakdown_s"), "phase"),
        "model_tflops": _tag_map(gauge_totals(
            aggregated, "pipeline_model_tflops"), "pipeline"),
        "mfu_pct": _tag_map(gauge_totals(
            aggregated, "pipeline_mfu_pct"), "pipeline"),
    }
    out["autopilot"] = {
        "actions": _tag_map(counter_totals(
            aggregated, "autopilot_actions_total"), "action"),
        "outcomes": _tag_map(counter_totals(
            aggregated, "autopilot_actions_total"), "outcome"),
        "suppressed": _tag_map(counter_totals(
            aggregated, "autopilot_suppressed_total"), "reason"),
        "mttr_s": _tag_map(gauge_totals(
            aggregated, "autopilot_mttr_s"), "action"),
    }
    return out
