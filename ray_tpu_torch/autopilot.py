"""Autopilot: closed-loop remediation from doctor signatures.

``python -m ray_tpu_torch doctor`` *names* failures; this module *acts* on
them (the port's copy of ``ray_tpu/autopilot.py``). A reconciler polls the same data the doctor reads — two metric
snapshots, the node table, flight-recorder dumps — and converts the
machine-readable ``remediation`` hint on each finding into a control
action through surfaces the cluster already trusts:

* **taint-host** (heartbeat-rtt-outlier) — demote the outlier host
  from gang/replica placement via the topology taint set
  (``taint_host`` RPC; TTL-based untaint with probe-gated re-arm).
* **reschedule-gang** (gang-death / gang-hang) — evict the repeatedly
  dying (or wedged) member through the group registry's FENCED kv:
  the ``autopilot_evict`` key is written at the observed epoch and the
  group monitor funnels it through its own reconcile path. A stale
  epoch is refused server-side — the cluster already self-healed, and
  the autopilot must never double-kill a gang that recovered on its
  own.
* **shed-tenant** (rpc-backpressure) — lower the admission cap of the
  deployment driving sustained backpressure (the engine's bounded-queue
  machinery, pushed through ``autopilot_shed``).
* **resize-deployment** (slo-burn) — raise a deployment's replica
  floor when its HTTP p99 *over the observation window* burns the SLO
  objective (``autopilot_resize``); burn rate, not raw load.

Every action is (i) **fenced** on the epoch observed at diagnosis
time — serve actions carry the controller epoch, gang actions the
group epoch, host actions re-resolve liveness; (ii) **rate-limited**
by a per-action-class token bucket under the global kill switch
``config.autopilot_enabled`` (default OFF: byte-identical legacy
behavior — no RPC is even issued); (iii) **audited** durably — a
flight-recorder ``autopilot.action`` event (flushed immediately) plus
a controller-KV record carrying signature, evidence snapshot, action,
outcome and epoch; (iv) **damped** — a signature must persist for
``autopilot_hysteresis_windows`` consecutive doctor windows before
any action fires, and an applied action re-arms the damper.

The handler idiom is pinned by graftlint (autopilot-unpaired-action):
every ``_act_*`` method pairs a ``_fence_ok`` check with an ``_audit``
record — an action that cannot show its fence and its audit trail is
a lint error, not a code-review nit.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.rpc_stubs import ControllerStub
from ray_tpu_torch.util import flightrec
from ray_tpu_torch.util.ratelimit import log_every

logger = logging.getLogger(__name__)

# Action classes (== doctor.REMEDIATION_ACTIONS): each gets its own
# token bucket so a storm of one signature cannot starve the others.
ACTION_CLASSES = ("taint-host", "reschedule-gang", "shed-tenant",
                  "resize-deployment")

# Terminal outcomes an action can audit.  "stale-epoch" is the fence
# refusing (the cluster moved on — acting now would fight the healed
# state); "dry-run" evaluated the fence but mutated nothing.
OUTCOMES = ("applied", "dry-run", "stale-epoch", "failed")

_AUDIT_KEEP = 64          # in-memory audit ring for status()
_AUDIT_KV_PREFIX = "autopilot:audit"


class TokenBucket:
    """Per-action-class rate limiter: ``rate_per_min`` steady state
    with ``burst`` headroom. Injectable clock for tests."""

    def __init__(self, rate_per_min: float, burst: int,
                 clock: Callable[[], float] = time.monotonic):
        self.rate_per_min = float(rate_per_min)
        self.burst = max(1, int(burst))
        self._clock = clock
        self._tokens = float(self.burst)
        self._last = clock()

    def take(self) -> bool:
        now = self._clock()
        self._tokens = min(
            float(self.burst),
            self._tokens + (now - self._last) * self.rate_per_min / 60.0)
        self._last = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def available(self) -> float:
        now = self._clock()
        return min(float(self.burst),
                   self._tokens
                   + (now - self._last) * self.rate_per_min / 60.0)


class _ServeHandleAdapter:
    """Default serve-plane surface: the named serve-controller actor,
    resolved lazily (serve may not be running; resolution failure is a
    fence failure, not a crash). Tests inject a plain object with the
    same three methods instead."""

    def __init__(self) -> None:
        self._handle = None

    def _h(self):
        if self._handle is None:
            import ray_tpu_torch
            from ray_tpu_torch.serve.controller import CONTROLLER_NAME

            self._handle = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        return self._handle

    def autopilot_resize(self, deployment: str, delta: int,
                         epoch: int) -> Dict[str, Any]:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._h().autopilot_resize.remote(
            deployment, delta, epoch), timeout=30.0)

    def autopilot_shed(self, deployment: str, queue_max: int,
                       epoch: int) -> Dict[str, Any]:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._h().autopilot_shed.remote(
            deployment, queue_max, epoch), timeout=30.0)

    def status(self) -> Dict[str, Any]:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._h().status.remote(), timeout=30.0)


def _default_client():
    from ray_tpu_torch.core.runtime import get_core_worker

    return get_core_worker().controller


class Autopilot:
    """The reconciler. ``step()`` is the pure-ish core (injected
    findings + clock, for tests); ``run_once()`` wires it to a live
    controller; ``start()`` runs the poll loop on a daemon thread."""

    def __init__(self, client=None, serve=None,
                 clock: Callable[[], float] = time.monotonic):
        self._client_factory = (lambda: client) if client is not None \
            else _default_client
        self._serve = serve if serve is not None else _ServeHandleAdapter()
        self._clock = clock
        self._lock = threading.Lock()
        # (signature, source) -> consecutive windows present / first
        # seen: the hysteresis damper and the MTTR clock origin.
        self._streaks: Dict[Tuple[str, str], int] = {}
        self._first_seen: Dict[Tuple[str, str], float] = {}
        # group -> epoch we already evicted at: our own eviction makes
        # a fresh gang.reconcile event which would re-trigger forever.
        self._gang_acted: Dict[str, int] = {}
        self._buckets: Dict[str, TokenBucket] = {
            a: TokenBucket(config.autopilot_rate_per_min,
                           config.autopilot_burst, clock)
            for a in ACTION_CLASSES}
        self._last_fence_fail: Dict[str, str] = {}
        self._suppressed: Dict[str, int] = {}
        self._audits: "deque[Dict[str, Any]]" = deque(maxlen=_AUDIT_KEEP)
        self._audit_seq = 0
        self._steps = 0
        self._handlers: Dict[str, Callable] = {
            "taint-host": self._act_taint_host,
            "reschedule-gang": self._act_reschedule_gang,
            "shed-tenant": self._act_shed_tenant,
            "resize-deployment": self._act_resize_deployment,
        }
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------ plumbing

    def _client(self):
        return self._client_factory()

    def _fence_ok(self, action: str, ok: bool, reason: str = "") -> bool:
        """The single fence gate every action handler passes BEFORE
        mutating anything (graftlint pins the pairing with ``_audit``).
        Records the latest failure per action class for ``status()``."""
        if not ok:
            self._last_fence_fail[action] = reason or "fence-failed"
        return bool(ok)

    def _audit(self, finding: Dict[str, Any], action: str, target: str,
               outcome: str, reason: str = "",
               detail: Optional[Dict[str, Any]] = None,
               epoch: Optional[int] = None) -> Dict[str, Any]:
        """Durable audit append: flight-recorder event (flushed NOW —
        the record must survive the process dying right after the
        decision it records) + controller-KV record with the full
        evidence snapshot, + the actions counter. Returns the record,
        which is also the handler's return value."""
        rec: Dict[str, Any] = {
            "seq": self._audit_seq,
            "signature": str(finding.get("signature", "")),
            "source": str(finding.get("source", "")),
            "action": action,
            "target": str(target),
            "outcome": outcome,
            "reason": reason,
            "epoch": int(epoch) if epoch is not None else None,
            "evidence": finding.get("evidence", {}),
            "detail": detail or {},
        }
        self._audit_seq += 1
        self._audits.append(rec)
        self._metric_action(action, outcome)
        signature = rec["signature"]
        flightrec.audit("autopilot.action", action=action,
                        outcome=outcome, signature=signature,
                        epoch=int(epoch or 0))
        if outcome != "dry-run":
            try:
                key = (f"{_AUDIT_KV_PREFIX}:{os.getpid()}"
                       f":{rec['seq']:06d}")
                # graftlint: disable=unfenced-mutation-in-fenced-class (append-only audit record under a per-process monotonic key — nothing to fence; the ACTION's fencing rides the handler's mh_group_put)
                ControllerStub(self._client()).kv_put(
                    key, json.dumps(rec, default=str).encode(),
                    overwrite=True,
                    timeout=config.ctrl_call_timeout_s)
            except Exception:
                log_every("autopilot.audit_kv", 30.0, logger,
                          "audit KV append failed (flightrec record "
                          "still durable)", exc_info=True)
        return rec

    def _metric_action(self, action: str, outcome: str) -> None:
        if not config.core_metrics_enabled:
            return
        from ray_tpu_torch.core import coremetrics as cm

        cm.AUTOPILOT_ACTIONS.inc(1.0, {"action": action,
                                       "outcome": outcome})

    def _suppress(self, action: str, reason: str) -> None:
        with self._lock:
            self._suppressed[reason] = self._suppressed.get(reason, 0) + 1
        if not config.core_metrics_enabled:
            return
        from ray_tpu_torch.core import coremetrics as cm

        cm.AUTOPILOT_SUPPRESSED.inc(1.0, {"reason": reason})

    # ------------------------------------------------------ the loop

    def step(self, findings: List[Dict[str, Any]],
             post_findings: Tuple[Dict[str, Any], ...] = (),
             serve_epoch: Optional[int] = None) -> List[Dict[str, Any]]:
        """One reconcile pass over a doctor window. Returns the audit
        records of every action DISPATCHED this pass (suppressed
        signatures produce metrics, not records)."""
        self._steps += 1
        actionable: Dict[Tuple[str, str], Dict[str, Any]] = {}
        for f in list(findings) + list(post_findings):
            rem = f.get("remediation") or {}
            if not rem.get("action"):
                continue
            key = (str(f.get("signature", "")), str(f.get("source", "")))
            actionable.setdefault(key, f)

        now = self._clock()
        with self._lock:
            # Hysteresis bookkeeping: CONSECUTIVE windows only — a
            # signature that skips a window was transient; reset it.
            for key in list(self._streaks):
                if key not in actionable:
                    self._streaks.pop(key, None)
                    self._first_seen.pop(key, None)
            for key in actionable:
                self._streaks[key] = self._streaks.get(key, 0) + 1
                self._first_seen.setdefault(key, now)

        records: List[Dict[str, Any]] = []
        for key, finding in actionable.items():
            rec = self._decide(key, finding, serve_epoch)
            if rec is not None:
                records.append(rec)
        return records

    def _decide(self, key: Tuple[str, str], finding: Dict[str, Any],
                serve_epoch: Optional[int]) -> Optional[Dict[str, Any]]:
        rem = finding["remediation"]
        action = rem["action"]
        if not config.autopilot_enabled:
            # Kill switch: no fence probe, no RPC, nothing — the OFF
            # path must be byte-identical to a cluster with no
            # autopilot at all.
            self._suppress(action, "disabled")
            return None
        if self._streaks.get(key, 0) < config.autopilot_hysteresis_windows:
            self._suppress(action, "hysteresis")
            return None
        if not self._buckets[action].take():
            self._suppress(action, "rate-limit")
            return None
        try:
            rec = self._handlers[action](finding, serve_epoch)
        except Exception as exc:
            rec = self._audit(finding, action,
                              str(rem.get("target", "")), "failed",
                              reason=f"{type(exc).__name__}: {exc}")
        if rec.get("outcome") == "applied":
            # MTTR: detection (first window the signature appeared) to
            # remediation applied. Applied also re-arms the damper so
            # the same streak cannot refire next window while the
            # cluster is still converging.
            mttr = max(0.0, self._clock()
                       - self._first_seen.get(key, self._clock()))
            rec["mttr_s"] = round(mttr, 3)
            with self._lock:
                self._streaks[key] = 0
            if config.core_metrics_enabled:
                from ray_tpu_torch.core import coremetrics as cm

                cm.AUTOPILOT_MTTR_S.set(mttr, {"action": action})
        return rec

    # ------------------------------------------------------- actions

    def _act_taint_host(self, finding: Dict[str, Any],
                        serve_epoch: Optional[int]) -> Dict[str, Any]:
        """Demote an RTT-outlier host from placement. The doctor names
        the node by its 8-hex metric-label prefix; resolving it against
        the LIVE node table is the fence — a node that died or was
        replaced since diagnosis must not be re-tainted."""
        prefix = str(finding["remediation"]["target"])
        node_hex, alive = None, False
        try:
            for n in ControllerStub(self._client()).list_nodes(
                    timeout=config.ctrl_call_timeout_s):
                if str(n.get("node_id", "")).startswith(prefix):
                    node_hex, alive = n["node_id"], bool(n.get("alive"))
                    break
        except Exception as exc:
            return self._audit(finding, "taint-host", prefix, "failed",
                               reason=f"list_nodes: {exc}")
        if not self._fence_ok("taint-host", node_hex is not None and alive,
                              "node-gone-or-replaced"):
            return self._audit(finding, "taint-host", prefix,
                               "stale-epoch",
                               reason="node-gone-or-replaced")
        if config.autopilot_dry_run:
            return self._audit(finding, "taint-host", node_hex, "dry-run")
        res = ControllerStub(self._client()).taint_host(
            node_hex, timeout=config.ctrl_call_timeout_s)
        return self._audit(finding, "taint-host", node_hex, "applied",
                           detail=dict(res or {}))

    def _act_reschedule_gang(self, finding: Dict[str, Any],
                             serve_epoch: Optional[int]
                             ) -> Dict[str, Any]:
        """Evict a repeatedly-dying (or barrier-wedged) member through
        the fenced group KV: the write carries the epoch observed NOW;
        the registry refuses a stale one server-side, and the group
        monitor consumes the key through its own reconcile path — the
        same path a detected death takes, so there is exactly one way
        a gang ever gets rebuilt."""
        group = str(finding["remediation"]["target"])
        ev = finding.get("evidence", {})
        victim = str(ev.get("first_dying")
                     or (ev.get("stragglers") or [""])[0])
        state = None
        try:
            state = ControllerStub(self._client()).mh_group_state(
                group, timeout=config.ctrl_call_timeout_s)
        except Exception as exc:
            return self._audit(finding, "reschedule-gang", group,
                               "failed", reason=f"group_state: {exc}")
        epoch = int(state.get("epoch", 0)) if state else 0
        acted = self._gang_acted.get(group, -1)
        ok = (state is not None and victim
              and victim in (state.get("members") or {})
              and epoch > acted)
        if not self._fence_ok("reschedule-gang", ok,
                              "group-gone" if state is None
                              else "already-remediated"):
            return self._audit(finding, "reschedule-gang", group,
                               "stale-epoch", epoch=epoch,
                               reason=("group-gone" if state is None
                                       else "already-remediated"),
                               detail={"victim": victim,
                                       "acted_epoch": acted})
        if config.autopilot_dry_run:
            return self._audit(finding, "reschedule-gang", group,
                               "dry-run", epoch=epoch,
                               detail={"victim": victim})
        res = ControllerStub(self._client()).mh_group_put(
            group, "autopilot_evict", victim, epoch,
            timeout=config.ctrl_call_timeout_s)
        if not (res or {}).get("ok"):
            # The registry's fence fired between observation and write:
            # the gang re-registered under a newer epoch — it healed
            # itself, and this action correctly becomes a no-op.
            return self._audit(finding, "reschedule-gang", group,
                               "stale-epoch", epoch=epoch,
                               reason=str((res or {}).get("reason",
                                                          "refused")),
                               detail={"victim": victim})
        with self._lock:
            self._gang_acted[group] = epoch
        return self._audit(finding, "reschedule-gang", group, "applied",
                           epoch=epoch, detail={"victim": victim})

    def _resolve_shed_target(self, hinted: str
                             ) -> Tuple[Optional[str], int]:
        """rpc-backpressure names a PROCESS, not a deployment — map it
        onto the serve plane: the hinted name if it is a deployment,
        else the deployment carrying the most ongoing load (the tenant
        driving the pressure). queue_max = half its current load."""
        try:
            st = self._serve.status() or {}
        except Exception:
            return None, 0
        if hinted in st:
            dep = hinted
        else:
            dep = max(st, key=lambda d: float(st[d].get("load", 0.0)),
                      default=None)
        if dep is None:
            return None, 0
        load = float(st[dep].get("load", 0.0))
        return dep, max(1, int(load // 2)) if load else 8

    def _act_shed_tenant(self, finding: Dict[str, Any],
                         serve_epoch: Optional[int]) -> Dict[str, Any]:
        """Lower the admission cap of the deployment driving sustained
        rpc backpressure (the bounded queue sheds the excess with typed 503 +
        Retry-After — callers back off instead of piling on)."""
        hinted = str(finding["remediation"]["target"])
        dep, queue_max = self._resolve_shed_target(hinted)
        if not self._fence_ok(
                "shed-tenant", dep is not None and serve_epoch is not None,
                "no-deployment" if dep is None else "no-serve-epoch"):
            return self._audit(finding, "shed-tenant", dep or hinted,
                               "stale-epoch",
                               reason=("no-deployment" if dep is None
                                       else "no-serve-epoch"))
        if config.autopilot_dry_run:
            return self._audit(finding, "shed-tenant", dep, "dry-run",
                               epoch=serve_epoch,
                               detail={"queue_max": queue_max})
        res = self._serve.autopilot_shed(dep, queue_max,
                                         int(serve_epoch))
        if not (res or {}).get("ok"):
            return self._audit(finding, "shed-tenant", dep,
                               "stale-epoch", epoch=serve_epoch,
                               reason=str((res or {}).get("reason",
                                                          "refused")))
        return self._audit(finding, "shed-tenant", dep, "applied",
                           epoch=serve_epoch, detail=dict(res))

    def _act_resize_deployment(self, finding: Dict[str, Any],
                               serve_epoch: Optional[int]
                               ) -> Dict[str, Any]:
        """Raise a deployment's replica floor on SLO burn (window p99
        past the objective) — the serve controller fences on its own
        live epoch, so a restarted controller refuses evidence gathered
        against its predecessor."""
        dep = str(finding["remediation"]["target"])
        if not self._fence_ok("resize-deployment",
                              serve_epoch is not None, "no-serve-epoch"):
            return self._audit(finding, "resize-deployment", dep,
                               "stale-epoch", reason="no-serve-epoch")
        if config.autopilot_dry_run:
            return self._audit(finding, "resize-deployment", dep,
                               "dry-run", epoch=serve_epoch,
                               detail={"delta": 1})
        res = self._serve.autopilot_resize(dep, 1, int(serve_epoch))
        if not (res or {}).get("ok"):
            return self._audit(finding, "resize-deployment", dep,
                               "stale-epoch", epoch=serve_epoch,
                               reason=str((res or {}).get("reason",
                                                          "refused")))
        return self._audit(finding, "resize-deployment", dep, "applied",
                           epoch=serve_epoch, detail=dict(res))

    # ------------------------------------------------------ wiring

    def run_once(self, interval_s: float = 2.0) -> List[Dict[str, Any]]:
        """One live pass: doctor snapshots -> diagnose + post-mortem ->
        step. The serve epoch is observed FROM the window's second
        snapshot (the same evidence the findings came from), not from a
        separate later read — fencing on fresher state than the
        evidence would defeat the point."""
        from ray_tpu_torch import doctor as doctor_mod

        client = self._client()
        before, after, nodes, dt = doctor_mod.collect(client, interval_s)
        findings = doctor_mod.diagnose(before, after, dt, nodes=nodes)
        epoch = doctor_mod._max_controller_epoch(after)
        post: List[Dict[str, Any]] = []
        try:
            dumps = ControllerStub(client).fr_dump(
                timeout=config.ctrl_call_timeout_s)
            post = doctor_mod.post_mortem(dumps or {})
        except Exception:
            log_every("autopilot.fr_dump", 30.0, logger,
                      "flight-recorder dump unavailable this pass",
                      exc_info=True)
        return self.step(findings, tuple(post),
                         serve_epoch=(int(epoch) if epoch is not None
                                      else None))

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="ray-tpu-autopilot",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception:
                log_every("autopilot.loop", 30.0, logger,
                          "autopilot pass failed", exc_info=True)
            self._stop.wait(config.autopilot_poll_s)

    # ------------------------------------------------------ status

    def status(self) -> Dict[str, Any]:
        with self._lock:
            streaks = {f"{sig}@{src}": n
                       for (sig, src), n in self._streaks.items()}
            out: Dict[str, Any] = {
                "enabled": bool(config.autopilot_enabled),
                "dry_run": bool(config.autopilot_dry_run),
                "steps": self._steps,
                "streaks": streaks,
                "gang_acted": dict(self._gang_acted),
                "suppressed": dict(self._suppressed),
                "last_fence_fail": dict(self._last_fence_fail),
                "buckets": {a: round(b.available(), 2)
                            for a, b in self._buckets.items()},
                "audit": list(self._audits),
            }
        try:
            out["taints"] = ControllerStub(self._client()).taint_state(
                timeout=config.ctrl_call_timeout_s)
        except Exception:
            out["taints"] = {}
        return out
