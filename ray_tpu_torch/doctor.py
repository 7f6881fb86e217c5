"""``python -m ray_tpu_torch doctor`` — cluster failure-signature
diagnosis (copy of ``ray_tpu/doctor.py``; its remedies name the port's CLI).

The core-plane metrics pipeline (core/coremetrics.py) makes the
runtime's pathologies numbers; this module makes them SENTENCES. It
takes two cluster metric snapshots a few seconds apart (rates and
growth need a window — cumulative counters alone can't distinguish "a
storm right now" from "a storm last Tuesday"), plus the node table for
attribution, and pattern-matches the failure signatures that
historically became hangs:

* **rpc-backpressure** — a peer stopped reading and its outbound queue
  hit ``rpc_outbound_cap_bytes`` (drops observed), or queues are
  sitting near the cap (saturation in progress).
* **reconnect-storm** — some process is burning dial attempts against
  an address that never answers (dead replica/owner still being
  courted).
* **pubsub-lag** — subscribers are skipping versions faster than they
  poll; consumers can't keep up with publishes on a channel.
* **ref-leak** — a process's live ObjectRef handle count grew
  monotonically across the window; with owner attribution (node/pid)
  from the source key and node table.
* **heartbeat-rtt-outlier** — one node's control-plane RTT is far off
  the fleet median (overloaded host or sick link; next stop:
  ``python -m ray_tpu_torch stacks`` / ``profile`` on that node).
* **controller-flapping** — the serve controller epoch gauge advanced
  >= 2 bumps inside the window: every bump is a controller death +
  restart-with-adoption cycle, so repeated bumps mean the control
  plane is crash-looping (routing rides cached snapshots meanwhile).
* **orphan-replica** — a serve replica's owner-epoch series is alive
  with NO owning controller epoch (no controller series at all, or the
  replica's epoch persistently below the live controller's): the
  replica serves traffic nobody reconciles — it will never be healed,
  autoscaled, or drained.
* **gang-hang** — a host group's members' barrier-entered gauges
  diverge for the whole window (some members arrived at a pending
  rendezvous barrier, others never did): the gang is wedged
  pre-collective, and the STRAGGLER hosts are named — the multi-host
  debugging story (a hung collective itself is invisible; the barrier
  in front of it is not).
* **pipeline-stall** — one pipeline stage's idle gauge diverges from
  the rest of its pipeline across the whole window: the busy stage
  (idle ~0 while everyone else starves behind it) IS the straggler,
  and is named — a slow/wedged stage otherwise just reads as "training
  got slower".
* **slo-burn** — a deployment's HTTP latency distribution over THIS
  window (delta histograms, not lifetime averages) violates the p99
  objective: the error budget is burning right now, regardless of raw
  load.

``diagnose`` is a pure function over snapshots so tests inject each
fault into the REAL components and assert the doctor names it; the CLI
(``python -m ray_tpu doctor``) wires it to a live controller.

Every finding also carries a machine-readable ``remediation`` hint —
``{action, target, evidence_keys}`` with ``action`` one of
:data:`REMEDIATION_ACTIONS` or None — the contract the autopilot
reconciler (``ray_tpu/autopilot.py``) executes against.

The second half is :func:`post_mortem`: where ``diagnose``
needs a LIVE cluster, the post-mortem explains a death that already
happened — a pure function over merged flight-recorder dumps
(``util/flightrec.py``; ``--post-mortem`` on the CLI, via the
controller's ``fr_dump`` RPC or ``--fr-dir`` with no cluster at all).
Findings: **gang-death** (first-dying member in detection order,
injected-kill corroboration, the stage it hosted, the surviving
epoch), **stage-clock-stop** (the stage whose clock stopped, and
when), **double-apply-guard** (a replay was about to double-apply and
the snapshot re-push saved it — the loss curve is certifiably
intact), **fault-injection** (every fired rule: chaos runs are
self-documenting).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.util.metrics import (counter_totals, delta_aggregated,
                                  gauge_totals, histogram_quantile,
                                  merge_histograms)

# Tunable detection thresholds (tests tighten/loosen per injection).
DEFAULT_THRESHOLDS = {
    "backpressure_queue_bytes": 32 * 1024 * 1024,
    "dial_failures": 8,            # failed connects over the window
    "psub_lag_versions": 10.0,     # versions skipped per poll
    "psub_lag_count": 3,           # polls that skipped that much
    "ref_growth": 100,             # live handles gained over the window
    "rtt_outlier_floor_s": 0.25,   # never flag RTTs below this
    "rtt_outlier_factor": 5.0,     # x fleet median p99
    "epoch_bumps": 2,              # controller epoch bumps in the window
    "pipe_stall_idle_s": 0.5,      # starved-stage idle floor (both snaps)
    "pipe_stall_ratio": 0.3,       # straggler idle <= ratio * max idle
    "slo_http_p99_s": 5.0,         # HTTP latency objective (slo-burn)
    "slo_min_requests": 8,         # min window requests before burning
}

# Autopilot action classes a remediation hint may name (autopilot.py
# executes exactly these; anything else in a hint is a doctor bug).
REMEDIATION_ACTIONS = ("taint-host", "reschedule-gang", "shed-tenant",
                       "resize-deployment")


def _remediation(action: Optional[str], target: str,
                 evidence_keys) -> Dict[str, Any]:
    """Machine-readable remediation hint — the doctor->autopilot
    contract (tests pin this schema so the two can't drift). ``action``
    is one of :data:`REMEDIATION_ACTIONS` or None (no automated action
    exists; the human ``remedy`` text is all there is), ``target`` is
    the action's object (node hex, group id, source key, deployment
    name), ``evidence_keys`` names the finding's evidence fields the
    decision rests on."""
    assert action is None or action in REMEDIATION_ACTIONS, action
    return {"action": action, "target": target,
            "evidence_keys": sorted(evidence_keys)}


def _per_source(aggregated, name: str, kind: str) -> Dict[str, float]:
    """Sum one metric per SOURCE key (all tag series folded)."""
    out: Dict[str, float] = {}
    for source, metrics in aggregated.items():
        for m in metrics:
            if m.get("name") == name and m.get("kind") == kind:
                out[source] = out.get(source, 0.0) + m.get("value", 0.0)
    return out


def _gauge_series(aggregated, name: str):
    """Yield (source, tags dict, value) for every gauge series named
    ``name`` across sources (no folding — the serve epoch checks need
    per-series values, not sums)."""
    for source, metrics in aggregated.items():
        for m in metrics:
            if m.get("name") == name and m.get("kind") == "gauge":
                yield source, dict(m.get("tags", {})), m.get("value", 0.0)


def _max_controller_epoch(aggregated) -> Optional[float]:
    """The OWNING serve-controller epoch in a snapshot: the max across
    sources (a dead controller's last push lingers until node death, so
    old-epoch series coexist with the live one — only the max owns)."""
    vals = [v for _s, _t, v in _gauge_series(aggregated,
                                             "serve_controller_epoch")]
    return max(vals) if vals else None


def _attribution(source: str, nodes: Optional[List[Dict[str, Any]]]
                 ) -> str:
    """Human-readable owner of a source key, via the node table."""
    parts = source.split("/")
    if len(parts) != 3:
        return source
    node8, role, pid = parts
    where = f"{role} {pid}"
    for n in (nodes or []):
        if str(n.get("node_id", "")).startswith(node8):
            addr = n.get("addr")
            return (f"{where} on node {node8} "
                    f"({addr[0]}:{addr[1]})" if addr else
                    f"{where} on node {node8}")
    return f"{where} on node {node8}"


def diagnose(before: Dict[str, List[Dict[str, Any]]],
             after: Dict[str, List[Dict[str, Any]]],
             interval_s: float,
             nodes: Optional[List[Dict[str, Any]]] = None,
             thresholds: Optional[Dict[str, Any]] = None
             ) -> List[Dict[str, Any]]:
    """Pattern-match failure signatures between two cluster snapshots.

    Returns findings ordered most-severe first; empty = healthy."""
    th = dict(DEFAULT_THRESHOLDS)
    th.update(thresholds or {})
    delta = delta_aggregated(before, after)
    findings: List[Dict[str, Any]] = []

    # ------------------------------------------------ rpc-backpressure
    for source, drops in _per_source(delta, "rpc_backpressure_drops_total",
                                     "counter").items():
        if drops > 0:
            findings.append({
                "signature": "rpc-backpressure", "severity": "critical",
                "source": source,
                "summary": (f"{_attribution(source, nodes)} dropped "
                            f"{int(drops)} connection(s) whose outbound "
                            f"queue hit rpc_outbound_cap_bytes in "
                            f"{interval_s:.0f}s — a peer stopped reading "
                            f"its replies (stalled or wedged process)"),
                "evidence": {"backpressure_drops": drops},
                "remediation": _remediation("shed-tenant", source,
                                            ("backpressure_drops",)),
                "remedy": ("find the stalled peer (it stopped consuming "
                           "replies): `python -m ray_tpu_torch stacks` "
                           "for wedged "
                           "threads; check rpc_outbound_queue_bytes per "
                           "source in `python -m ray_tpu_torch metrics`"),
            })
    for source, qbytes in _per_source(after, "rpc_outbound_queue_bytes",
                                      "gauge").items():
        if qbytes >= th["backpressure_queue_bytes"]:
            findings.append({
                "signature": "rpc-backpressure", "severity": "warning",
                "source": source,
                "summary": (f"{_attribution(source, nodes)} has "
                            f"{qbytes / 1e6:.0f} MB queued for a peer "
                            f"that is not reading — backpressure drop "
                            f"imminent at the outbound cap"),
                "evidence": {"queue_bytes": qbytes},
                "remediation": _remediation("shed-tenant", source,
                                            ("queue_bytes",)),
                "remedy": "identify the slow consumer before the cap "
                          "tears the stream",
            })

    # ------------------------------------------------- reconnect-storm
    for source, fails in _per_source(delta, "rpc_dial_failures_total",
                                     "counter").items():
        if fails >= th["dial_failures"]:
            roles = {dict(k).get("role", "-"): v for k, v in counter_totals(
                {source: delta[source]}, "rpc_dial_failures_total").items()}
            findings.append({
                "signature": "reconnect-storm", "severity": "critical",
                "source": source,
                "summary": (f"{_attribution(source, nodes)} burned "
                            f"{int(fails)} failed dial attempts in "
                            f"{interval_s:.0f}s (roles: {roles}) — it is "
                            f"redialing an address that never answers "
                            f"(dead peer still referenced)"),
                "evidence": {"dial_failures": fails, "by_role": roles},
                "remediation": _remediation(None, source,
                                            ("dial_failures", "by_role")),
                "remedy": ("a dead owner/replica/controller address is "
                           "still in use; check which peers died "
                           "(`python -m ray_tpu_torch list nodes`, serve "
                           "status) and "
                           "whether their clients were invalidated"),
            })

    # ----------------------------------------------------- pubsub-lag
    for key, entry in merge_histograms(delta, "psub_sub_lag").items():
        channel = dict(key).get("channel", "-")
        # counts[i+1] holds observations in (buckets[i], buckets[i+1]];
        # pairing counts[1:] with the edges counts lags STRICTLY above
        # each edge, and the final element is the +Inf overflow bucket.
        hi = sum(n for edge, n in zip(entry["buckets"], entry["counts"][1:])
                 if edge >= th["psub_lag_versions"])
        p99 = histogram_quantile(entry, 0.99)
        if (hi >= th["psub_lag_count"] and p99 is not None
                and p99 >= th["psub_lag_versions"]):
            findings.append({
                "signature": "pubsub-lag", "severity": "warning",
                "source": f"channel:{channel}",
                "summary": (f"pubsub channel {channel!r}: subscribers "
                            f"skipped >= {th['psub_lag_versions']:.0f} "
                            f"versions on {int(hi)} polls in "
                            f"{interval_s:.0f}s (p99 lag ~{p99:.0f}) — "
                            f"consumers poll slower than publishers "
                            f"publish"),
                "evidence": {"lagged_polls": hi, "p99_lag": p99},
                "remediation": _remediation(None, f"channel:{channel}",
                                            ("lagged_polls", "p99_lag")),
                "remedy": ("latest-value semantics means state is "
                           "current but intermediate versions are "
                           "skipped; if consumers NEED every version, "
                           "slow the publisher or speed the watcher "
                           "callbacks (psub_dropped_notifies_total "
                           "shows failing callbacks)"),
            })

    # -------------------------------------------------------- ref-leak
    live_before = _per_source(before, "obj_live_refs", "gauge")
    for source, now_val in _per_source(after, "obj_live_refs",
                                       "gauge").items():
        growth = now_val - live_before.get(source, 0.0)
        if growth >= th["ref_growth"]:
            findings.append({
                "signature": "ref-leak", "severity": "warning",
                "source": source,
                "summary": (f"{_attribution(source, nodes)} gained "
                            f"{int(growth)} live ObjectRef handles in "
                            f"{interval_s:.0f}s (now {int(now_val)}) — "
                            f"monotonic growth here pins objects "
                            f"cluster-wide (leak suspect)"),
                "evidence": {"live_refs": now_val, "growth": growth},
                "remediation": _remediation(None, source,
                                            ("live_refs", "growth")),
                "remedy": ("that process is accumulating refs without "
                           "dropping them; `python -m ray_tpu_torch "
                           "profile <worker> "
                           "--heap` on it, and check obj_store_bytes "
                           "for the bytes it pins"),
            })

    # ------------------------------------------- heartbeat-rtt-outlier
    per_node: Dict[str, float] = {}
    for key, entry in merge_histograms(delta, "node_heartbeat_rtt_s").items():
        if entry.get("count", 0) >= 2:
            node = dict(key).get("node", "-")
            p99 = histogram_quantile(entry, 0.99)
            if p99 is not None:
                per_node[node] = p99
    if len(per_node) >= 2:
        ordered = sorted(per_node.values())
        median = ordered[len(ordered) // 2]
        for node, p99 in per_node.items():
            if (p99 >= th["rtt_outlier_floor_s"]
                    and p99 >= th["rtt_outlier_factor"] * max(median, 1e-9)):
                findings.append({
                    "signature": "heartbeat-rtt-outlier",
                    "severity": "warning", "source": f"node:{node}",
                    "summary": (f"node {node}: heartbeat RTT p99 "
                                f"~{p99 * 1e3:.0f}ms vs fleet median "
                                f"~{median * 1e3:.0f}ms — overloaded "
                                f"host or sick link to the controller"),
                    "evidence": {"p99_s": p99, "fleet_median_s": median},
                    "remediation": _remediation(
                        "taint-host", node, ("p99_s", "fleet_median_s")),
                    "remedy": ("inspect that node: "
                               "`python -m ray_tpu_torch stacks`, "
                               "CPU/memory via the dashboard, and the "
                               "controller's queue (one slow node must "
                               "not set the fleet's lease latency)"),
                })

    # ------------------------------------------- controller-flapping
    ep_before = _max_controller_epoch(before)
    ep_after = _max_controller_epoch(after)
    if (ep_before is not None and ep_after is not None
            and ep_after - ep_before >= th["epoch_bumps"]):
        bumps = int(ep_after - ep_before)
        findings.append({
            "signature": "controller-flapping", "severity": "critical",
            "source": "serve-controller",
            "summary": (f"serve controller epoch advanced {bumps} times "
                        f"in {interval_s:.0f}s (now epoch "
                        f"{int(ep_after)}) — the controller is "
                        f"crash-looping; each bump is a death + "
                        f"restart-with-adoption cycle, and routing is "
                        f"riding cached snapshots between them"),
            "evidence": {"epoch_before": ep_before,
                         "epoch_after": ep_after},
            "remediation": _remediation(None, "serve-controller",
                                        ("epoch_before", "epoch_after")),
            "remedy": ("read the controller worker's log for the crash "
                       "cause (`python -m ray_tpu_torch logs`); check "
                       "whether a fault "
                       "rule / OOM kill / bad deployment config fires "
                       "on every restart path"),
        })

    # ---------------------------------------------- orphan-replica
    # A replica series whose owner epoch has no live controller epoch,
    # in BOTH snapshots: transient adoption lag (the restarted
    # controller re-pushes epochs within its adopt window) never
    # persists across a doctor interval; an orphan does.
    rep_before = {(s, t.get("deployment", "-")): v
                  for s, t, v in _gauge_series(before,
                                               "serve_replica_epoch")}
    for source, tags, val in _gauge_series(after, "serve_replica_epoch"):
        dep = tags.get("deployment", "-")
        prev = rep_before.get((source, dep))
        if prev is None:
            continue  # not persistent across the window
        orphan_now = ep_after is None or val < ep_after
        orphan_then = ep_before is None or prev < ep_before
        if orphan_now and orphan_then:
            owner = ("no controller epoch series exists"
                     if ep_after is None else
                     f"the live controller epoch is {int(ep_after)}")
            findings.append({
                "signature": "orphan-replica", "severity": "warning",
                "source": source,
                "summary": (f"{_attribution(source, nodes)} serves "
                            f"deployment {dep!r} owned by controller "
                            f"epoch {int(val)}, but {owner} — no "
                            f"controller reconciles this replica (it "
                            f"will never be healed, autoscaled, or "
                            f"drained)"),
                "evidence": {"replica_epoch": val,
                             "controller_epoch": ep_after,
                             "deployment": dep},
                "remediation": _remediation(
                    None, source,
                    ("replica_epoch", "controller_epoch", "deployment")),
                "remedy": ("if the serve controller is down, restart "
                           "it (it adopts live replicas from its "
                           "checkpoint); if it is up, this replica "
                           "escaped its checkpoint — kill the replica "
                           "actor and let reconcile respawn it"),
            })

    # ------------------------------------------------------ gang-hang
    # A pending barrier splits a group's members into entered (gauge 1)
    # and absent (gauge 0). Divergence that persists across BOTH
    # snapshots — same members still absent, same gang still parked —
    # is a wedge, not a transient rendezvous in progress.
    def _entered(agg) -> Dict[Tuple[str, str], float]:
        out: Dict[Tuple[str, str], float] = {}
        for _src, tags, val in _gauge_series(agg, "mh_barrier_entered"):
            out[(tags.get("group", "-"),
                 tags.get("member", "-"))] = val
        return out

    ent_before = _entered(before)
    ent_after = _entered(after)
    for grp in sorted({g for g, _m in ent_after}):
        mem_after = {m: v for (g, m), v in ent_after.items()
                     if g == grp}
        mem_before = {m: v for (g, m), v in ent_before.items()
                      if g == grp}
        if not mem_before:
            continue  # group not present across the whole window

        def _split(d):
            return ({m for m, v in d.items() if v >= 1.0},
                    {m for m, v in d.items() if v < 1.0})

        in_a, out_a = _split(mem_after)
        in_b, out_b = _split(mem_before)
        stragglers = sorted(out_a & out_b)
        if not (in_a and in_b and stragglers):
            continue
        findings.append({
            "signature": "gang-hang", "severity": "critical",
            "source": f"group:{grp}",
            "summary": (f"host group {grp!r}: member(s) "
                        f"{', '.join(stragglers)} never entered the "
                        f"rendezvous barrier the rest of the gang "
                        f"({', '.join(sorted(in_a))}) is parked at, "
                        f"across the whole {interval_s:.0f}s window — "
                        f"the group is wedged pre-collective "
                        f"(straggler or partitioned host)"),
            "evidence": {"stragglers": stragglers,
                         "entered": sorted(in_a)},
            "remediation": _remediation("reschedule-gang", grp,
                                        ("stragglers", "entered")),
            "remedy": ("inspect the straggler's worker process "
                       "(`python -m ray_tpu_torch stacks`); if it died, "
                       "the group "
                       "monitor reconciles the whole gang — check "
                       "mh_member_epoch for a fenced zombie. Barrier "
                       "timeouts convert this hang into a typed "
                       "refusal naming the absent members"),
        })

    # -------------------------------------------------- pipeline-stall
    # A healthy pipeline's stages all cycle busy/idle together; a
    # straggler stage stays BUSY (idle ~0) while every stage starved
    # behind it idles. Divergence must hold in BOTH snapshots — a
    # transient bubble (warmup, between steps) never persists across a
    # doctor window, a wedged or delay-injected stage does.
    def _stage_idle(agg) -> Dict[Tuple[str, str], float]:
        out: Dict[Tuple[str, str], float] = {}
        for _src, tags, val in _gauge_series(agg,
                                             "pipeline_stage_idle_s"):
            out[(tags.get("pipeline", "-"),
                 tags.get("stage", "-"))] = val
        return out

    idle_before = _stage_idle(before)
    idle_after = _stage_idle(after)
    for pipe in sorted({p for p, _s in idle_after}):
        st_after = {s: v for (p, s), v in idle_after.items()
                    if p == pipe}
        st_before = {s: v for (p, s), v in idle_before.items()
                     if p == pipe}
        if len(st_after) < 2 or not st_before:
            continue  # 1-stage pipelines / not present all window

        def _split_stall(d):
            mx = max(d.values())
            if mx < th["pipe_stall_idle_s"]:
                return set(), set()
            busy = {s for s, v in d.items()
                    if v <= th["pipe_stall_ratio"] * mx}
            return busy, set(d) - busy

        busy_a, idle_a = _split_stall(st_after)
        busy_b, idle_b = _split_stall(st_before)
        stragglers = sorted(busy_a & busy_b)
        starved = sorted(idle_a & idle_b)
        if not (stragglers and starved):
            continue
        worst = max(st_after.values())
        findings.append({
            "signature": "pipeline-stall", "severity": "critical",
            "source": f"pipeline:{pipe}",
            "summary": (f"pipeline {pipe!r}: stage(s) "
                        f"{', '.join(stragglers)} stayed busy while "
                        f"{', '.join(starved)} idled up to "
                        f"{worst:.1f}s across the whole "
                        f"{interval_s:.0f}s window — "
                        f"{', '.join(stragglers)} is the straggler "
                        f"the rest of the pipeline is starving "
                        f"behind"),
            "evidence": {"stragglers": stragglers, "starved": starved,
                         "stage_idle_s": st_after},
            "remediation": _remediation(
                None, f"pipeline:{pipe}",
                ("stragglers", "starved", "stage_idle_s")),
            "remedy": ("inspect the straggler stage's worker "
                       "(`python -m ray_tpu_torch stacks`; a dead stage "
                       "reconciles "
                       "the whole gang instead — check pipe_state / "
                       "mh_group_state). pipe_step_timeout_s bounds "
                       "the stall: past it the driver raises a typed "
                       "PipelineError naming the schedule state"),
        })

    # -------------------------------------------------------- slo-burn
    # Burn RATE, not raw load: the WINDOW's HTTP latency distribution
    # (delta histograms) against the objective. A deployment can be
    # lightly loaded and still burning (one wedged replica serving
    # every Nth request slowly) — that resizes; a loaded-but-in-SLO
    # deployment does not. Feeds autopilot's resize-deployment action.
    # The serve package loads torch: import it only when the window
    # holds serve series, so a doctor run on a cluster that serves
    # nothing stays light.
    slo = {}
    if any(str(m.get("name", "")).startswith("serve_")
           for ms in delta.values() for m in ms):
        try:
            from ray_tpu_torch.serve.metrics import slo_summary
            slo = slo_summary(delta)
        except Exception:
            slo = {}
    for dep in sorted(slo):
        lat = slo[dep].get("http_request_s") or {}
        p99, count = lat.get("p99"), lat.get("count", 0)
        if (p99 is None or count < th["slo_min_requests"]
                or p99 < th["slo_http_p99_s"]):
            continue
        findings.append({
            "signature": "slo-burn", "severity": "warning",
            "source": f"deployment:{dep}",
            "summary": (f"deployment {dep!r}: HTTP p99 ~{p99:.2f}s over "
                        f"{int(count)} request(s) in this "
                        f"{interval_s:.0f}s window vs the "
                        f"{th['slo_http_p99_s']:.1f}s objective — the "
                        f"error budget is burning now (window "
                        f"distribution, not lifetime average)"),
            "evidence": {"p99_s": p99, "objective_s": th["slo_http_p99_s"],
                         "requests": count},
            "remediation": _remediation(
                "resize-deployment", dep,
                ("p99_s", "objective_s", "requests")),
            "remedy": ("check serve status for replica health first (a "
                       "dead replica mid-heal inflates tails); if the "
                       "deployment is just undersized, raise "
                       "num_replicas / autoscaling max_replicas"),
        })

    order = {"critical": 0, "warning": 1}
    findings.sort(key=lambda f: (order.get(f["severity"], 9),
                                 f["signature"], f["source"]))
    return findings


# ===================================================================
# Post-mortem: forensics over flight-recorder dumps (util/flightrec.py)
# ===================================================================
#
# ``diagnose`` needs a LIVE cluster (two metric snapshots). A gang
# death or a SIGKILLed stage leaves no live gauges to read — but every
# process's flight recorder persisted its last events. ``post_mortem``
# is the pure function over those merged dumps: no cluster queries, no
# metrics — evidence only. Input shape is ``flightrec.dump_all()``
# (``{source: {"pid", "role", "events"}}``); events carry
# ``{"ev", "ts", ...attrs}`` per the catalog in docs/OBSERVABILITY.md.


def _merged_events(dumps: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every dump's events tagged with their source, merged by
    (wall-clock, source) — the one ordering forensics reasons over."""
    out: List[Dict[str, Any]] = []
    for source, doc in (dumps or {}).items():
        for e in doc.get("events") or []:
            if isinstance(e, dict) and "ev" in e:
                out.append({**e, "source": source})
    out.sort(key=lambda e: (float(e.get("ts", 0.0)), e.get("source", "")))
    return out


def _die_site_member(events: List[Dict[str, Any]], group: str
                     ) -> Optional[Dict[str, Any]]:
    """The fault-injection SIGKILL aimed at a member of ``group``
    (site ``multihost.member.<group>.<member>.beat``), if one fired."""
    for e in events:
        if e.get("ev") != "fault.fired" or e.get("action") != "die":
            continue
        site = str(e.get("site", ""))
        prefix = f"multihost.member.{group}."
        if site.startswith(prefix) and site.endswith(".beat"):
            member = site[len(prefix):-len(".beat")]
            return {"member": member, "ts": e.get("ts"),
                    "source": e.get("source")}
    return None


def post_mortem(dumps: Dict[str, Any],
                stall_gap_s: float = 2.0) -> List[Dict[str, Any]]:
    """Explain gang deaths and pipeline stalls from flight-recorder
    dumps alone. Returns findings in the ``diagnose`` shape (severity /
    signature / source / summary / evidence / remedy), most severe
    first; empty = the dumps show an orderly history."""
    events = _merged_events(dumps)
    findings: List[Dict[str, Any]] = []

    # Member -> recorder source (a member's own file goes silent when
    # it dies; its last event timestamp is independent evidence).
    member_source: Dict[Tuple[str, str], str] = {}
    last_ts_by_source: Dict[str, float] = {}
    for e in events:
        last_ts_by_source[e["source"]] = float(e.get("ts", 0.0))
        if e.get("ev") == "gang.member.up":
            member_source[(str(e.get("group")), str(e.get("member")))] \
                = e["source"]

    # ------------------------------------------------------ gang death
    groups = sorted({str(e.get("group")) for e in events
                     if e.get("ev") == "gang.reconcile"})
    for group in groups:
        recs = [e for e in events if e.get("ev") == "gang.reconcile"
                and str(e.get("group")) == group]
        rec = recs[-1]
        dead = [m for m in str(rec.get("dead", "")).split(",") if m]
        first_dying = dead[0] if dead else "?"
        kill = _die_site_member(events, group)
        # Epoch the SURVIVING gang runs under: the newest registration
        # after the reconcile (re-formation bumps it); a gang.dead
        # event instead means nothing survived.
        after = [e for e in events if float(e.get("ts", 0)) >=
                 float(rec.get("ts", 0)) and str(e.get("group")) == group]
        survived = [e for e in after
                    if e.get("ev") in ("gang.register", "gang.form")]
        died = [e for e in after if e.get("ev") == "gang.dead"]
        new_epoch = max((int(e.get("epoch", 0)) for e in survived),
                        default=None)
        src = member_source.get((group, first_dying))
        silent = (f"; its recorder went silent at "
                  f"{last_ts_by_source[src]:.3f}" if src else "")
        cause = (f"faultinject SIGKILL at its beat site "
                 f"(fault.fired die in {kill['source']})"
                 if kill and kill["member"] == first_dying
                 else str(rec.get("cause", "member death")))
        outcome = (f"the gang re-formed and survives under epoch "
                   f"{new_epoch}" if new_epoch is not None else
                   (f"the gang is DEAD ({died[-1].get('cause')})"
                    if died else "no re-formation on record"))
        # Pipeline gangs place stage k on member host-k: name the stage
        # too when the group hosts a pipeline on record.
        stage_note = ""
        if group.endswith("-gang"):
            pipe_name = group[:-len("-gang")]
            if any(str(e.get("pipeline")) == pipe_name for e in events
                   if str(e.get("ev", "")).startswith("pipe.stage.")) \
                    and first_dying.startswith("host-"):
                stage_note = (f" (pipeline {pipe_name!r} stage "
                              f"s{first_dying[len('host-'):]})")
        findings.append({
            "signature": "gang-death", "severity": "critical",
            "source": f"group:{group}",
            "summary": (f"group {group!r}: member {first_dying}"
                        f"{stage_note} died first ({cause}){silent}; "
                        f"the monitor reconciled the whole gang of "
                        f"epoch {int(rec.get('epoch', 0))} "
                        f"(dead: {', '.join(dead)}); {outcome}"),
            "evidence": {"first_dying": first_dying, "dead": dead,
                         "old_epoch": int(rec.get("epoch", 0)),
                         "surviving_epoch": new_epoch,
                         "injected": bool(kill),
                         "stage": (stage_note.strip(" ()") or None)},
            "remediation": _remediation(
                "reschedule-gang", group,
                ("first_dying", "dead", "old_epoch", "surviving_epoch",
                 "injected", "stage")),
            "remedy": ("read the victim's worker log; if the death was "
                       "not injected, check the host (OOM killer, "
                       "preemption). Replays are safe: see the "
                       "double-apply-guard finding if one fired"),
        })

    # ------------------------------------------------ stage clock stop
    pipes = sorted({str(e.get("pipeline")) for e in events
                    if str(e.get("ev", "")).startswith("pipe.stage.")})
    for pipe in pipes:
        by_stage: Dict[int, Dict[str, Any]] = {}
        for e in events:
            if not str(e.get("ev", "")).startswith("pipe.stage."):
                continue
            if str(e.get("pipeline")) != pipe or e.get("stage") is None:
                continue
            s = int(e["stage"])
            cur = by_stage.setdefault(s, {"last_ts": 0.0, "step": -1})
            cur["last_ts"] = max(cur["last_ts"], float(e.get("ts", 0)))
            if e.get("ev") in ("pipe.stage.begin", "pipe.stage.apply"):
                cur["step"] = max(cur["step"], int(e.get("step", -1)))
        if len(by_stage) < 2:
            continue
        live_ts = max(v["last_ts"] for v in by_stage.values())
        max_step = max(v["step"] for v in by_stage.values())
        stopped = sorted(
            s for s, v in by_stage.items()
            if live_ts - v["last_ts"] >= stall_gap_s
            or v["step"] < max_step - 1)
        if not stopped:
            continue
        worst = stopped[0]
        v = by_stage[worst]
        findings.append({
            "signature": "stage-clock-stop", "severity": "critical",
            "source": f"pipeline:{pipe}",
            "summary": (f"pipeline {pipe!r}: stage "
                        f"{', '.join(f's{s}' for s in stopped)} "
                        f"stopped — s{worst}'s clock last moved at "
                        f"step {v['step']} "
                        f"({live_ts - v['last_ts']:.1f}s before the "
                        f"rest of the pipeline went quiet, max step "
                        f"{max_step}) — the stage whose clock stopped "
                        f"is where the step died"),
            "evidence": {"stopped_stages": [f"s{s}" for s in stopped],
                         "stage_clocks": {f"s{s}": v["step"]
                                          for s, v in by_stage.items()},
                         "max_step": max_step},
            "remediation": _remediation(
                None, f"pipeline:{pipe}",
                ("stopped_stages", "stage_clocks", "max_step")),
            "remedy": ("if a gang-death finding names the matching "
                       "member (stage k = host-k), this is its stage-"
                       "side shadow; otherwise the stage process "
                       "wedged without dying — its worker log and "
                       "`python -m ray_tpu_torch stacks` are next"),
        })

    # ------------------------------------------- double-apply guard
    for e in events:
        if e.get("ev") != "pipe.clock.drift":
            continue
        findings.append({
            "signature": "double-apply-guard", "severity": "warning",
            "source": f"pipeline:{e.get('pipeline')}",
            "summary": (f"pipeline {e.get('pipeline')!r}: the replay "
                        f"double-apply guard FIRED at step "
                        f"{int(e.get('step', -1))} (stage clocks "
                        f"{e.get('clocks')}) — an apply reply was "
                        f"lost AFTER stages applied, and the plane "
                        f"re-pushed the snapshot instead of double-"
                        f"applying; the loss curve is intact"),
            "evidence": {"step": int(e.get("step", -1)),
                         "clocks": str(e.get("clocks", ""))},
            "remediation": _remediation(
                None, f"pipeline:{e.get('pipeline')}",
                ("step", "clocks")),
            "remedy": ("none needed — this is the guard working; "
                       "repeated fires point at a lossy link between "
                       "driver and stages"),
        })

    # ----------------------------------------------- injected faults
    fires = [e for e in events if e.get("ev") == "fault.fired"]
    if fires:
        findings.append({
            "signature": "fault-injection", "severity": "warning",
            "source": "faultinject",
            "summary": (f"{len(fires)} fault-injection rule(s) fired "
                        f"during this history: "
                        + "; ".join(f"{e.get('action')}@{e.get('site')}"
                                    for e in fires[:6])
                        + ("…" if len(fires) > 6 else "")),
            "evidence": {"fires": [
                {"site": e.get("site"), "action": e.get("action"),
                 "ts": e.get("ts"), "source": e.get("source")}
                for e in fires]},
            "remediation": _remediation(None, "faultinject", ("fires",)),
            "remedy": ("expected under chaos testing; in production "
                       "this means a rules file is configured — check "
                       "RAY_TPU_FAULTINJECT_PATH"),
        })

    order = {"critical": 0, "warning": 1}
    findings.sort(key=lambda f: (order.get(f["severity"], 9),
                                 f["signature"], f["source"]))
    return findings


def render_post_mortem(findings: List[Dict[str, Any]],
                       dumps: Dict[str, Any]) -> str:
    head = (f"post-mortem over {len(dumps)} recorder dump(s), "
            f"{sum(len(d.get('events') or []) for d in dumps.values())} "
            f"events")
    if not findings:
        return (f"{head}\nno deaths or stalls on record (checked: "
                f"gang-death, stage-clock-stop, double-apply-guard, "
                f"fault-injection)")
    return f"{head}\n{render(findings)}"


def collect(client, interval_s: float = 2.0
            ) -> Tuple[Dict, Dict, List[Dict[str, Any]], float]:
    """Two cluster snapshots ``interval_s`` apart + the node table, off a
    controller RPC client (the CLI's data acquisition)."""
    before = client.call("list_metrics", timeout=10.0)
    time.sleep(interval_s)
    after = client.call("list_metrics", timeout=10.0)
    nodes = client.call("list_nodes", timeout=10.0)
    return before, after, nodes, interval_s


def render(findings: List[Dict[str, Any]]) -> str:
    if not findings:
        return ("no failure signatures detected (checked: "
                "rpc-backpressure, reconnect-storm, pubsub-lag, "
                "ref-leak, heartbeat-rtt-outlier, controller-flapping, "
                "orphan-replica, gang-hang, pipeline-stall, slo-burn)")
    lines = [f"{len(findings)} finding(s):", ""]
    for i, f in enumerate(findings, 1):
        lines.append(f"[{i}] {f['severity'].upper()} {f['signature']} "
                     f"({f['source']})")
        lines.append(f"    {f['summary']}")
        lines.append(f"    remedy: {f['remedy']}")
        lines.append("")
    return "\n".join(lines).rstrip()
