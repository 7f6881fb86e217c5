"""Deterministic, config-gated fault injection for chaos tests.

PR 3's chaos test reached for a raw ``os.kill(pid, SIGKILL)`` — fine for
one test, but every new fault scenario (kill the controller mid-deploy,
fail exactly the third ``release_subslice`` RPC, pause a node's
heartbeats, partition one peer) re-invents its own ad-hoc monkeypatching
that only works inside the test's own process. This module is the shared
harness: product code declares named INJECTION POINTS with
:func:`check`, and tests activate RULES against them — across process
boundaries — via a JSON rules file.

Design constraints, in order:

* **Zero cost when off.** ``check(site)`` is one config-attribute read
  when ``config.faultinject_path`` is empty (the default). No stat, no
  allocation: product hot paths gate the f-string building the site name
  behind the same flag.
* **Cross-process.** The serve controller, replicas and proxies are
  actor WORKER processes; a registry in the test process can't reach
  them. Rules live in a file (``config.faultinject_path``, set through
  the ``RAY_TPU_FAULTINJECT_PATH`` env var *before* ``ray_tpu_torch.init`` so
  every spawned worker inherits it) and are re-read on mtime change, so
  a test can install/remove rules while workers run.
* **Deterministic.** Rules fire on the Nth matching pass (``after``
  skips, ``times`` caps, both counted per process), not on wall-clock
  raciness. ``once_global: true`` adds a cross-process fuse (an
  ``O_EXCL`` marker file next to the rules file) so "SIGKILL the
  controller once" can't become a kill loop when the restarted process
  reaches the same site.

Rule shape (one JSON object per rule, in a top-level list)::

    {"site": "serve.controller.reconcile_tick",  # fnmatch glob
     "action": "die",          # die | error | delay | drop
     "after": 0,               # skip the first N matches (per process)
     "times": -1,              # fire at most N times (-1 = unlimited)
     "once_global": true,      # cross-process single fire (marker file)
     "delay_s": 0.5,           # delay action only
     "id": "kill-ctl"}         # optional; defaults to site+action

Actions:

* ``die`` — ``SIGKILL`` the calling process at the site (no cleanup, no
  atexit: the honest crash).
* ``error`` — raise :class:`FaultInjected` (a ``RuntimeError``): the
  typed "this RPC/endpoint failed" signal. Deliberately NOT an
  ``OSError`` so ``ReconnectingClient`` surfaces it immediately instead
  of burning its retry window.
* ``delay`` — ``time.sleep(delay_s)``: pause heartbeats, stall a
  handler, stretch a restart into a measurable outage window.
* ``drop`` — raise :class:`FaultDropped`. At the RPC client it behaves
  like a torn connection (it subclasses ``ConnectionError``, so
  reconnect/retry paths engage — that's a network partition); inside
  ``RpcServer._handle`` it is caught and the reply is silently never
  sent (the caller's timeout governs — that's a lost reply).

Sites instrumented in-tree: ``rpc.server.<server>.<method>``,
``rpc.client.<method>``, ``rpc.dial.<host>:<port>``,
``node.heartbeat``, the serve controller lifecycle points
(``serve.controller.init`` / ``.restore`` / ``.save_state`` /
``.reconcile_tick`` / ``.retry_pending_releases`` / ``.deploy``), and
the multihost gang (``multihost.barrier.<group>.<member>`` at member-
side barrier entry — a delay/drop rule manufactures a straggler for
the doctor's gang-hang signature — and
``multihost.member.<group>.<member>.beat`` in the member heartbeat
loop, where a ``die`` rule SIGKILLs exactly that host's worker).
"""

from __future__ import annotations

import fnmatch
import json
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["FaultInjected", "FaultDropped", "check", "Faults",
           "reset_counters"]


class FaultInjected(RuntimeError):
    """An injected endpoint/operation failure (typed, non-transport)."""


class FaultDropped(ConnectionError):
    """An injected drop: torn connection client-side, eaten reply
    server-side (``RpcServer._handle`` catches it and never replies)."""


_lock = threading.Lock()
# Rules cache keyed by (path, mtime_ns, size): a test rewriting the file
# is picked up on the next check without a per-check parse.
_cache: Dict[str, Any] = {"path": None, "stamp": None, "rules": []}
# Per-process match counters per rule id (determinism: "the Nth pass").
_counts: Dict[str, int] = {}


def _rule_id(rule: Dict[str, Any]) -> str:
    return str(rule.get("id") or
               f"{rule.get('site', '')}#{rule.get('action', 'error')}")


def _load(path: str) -> List[Dict[str, Any]]:
    try:
        st = os.stat(path)
    except OSError:
        return []
    stamp = (st.st_mtime_ns, st.st_size)
    with _lock:
        if _cache["path"] == path and _cache["stamp"] == stamp:
            return _cache["rules"]
    try:
        with open(path) as f:
            rules = json.load(f)
        if not isinstance(rules, list):
            rules = []
    except (OSError, ValueError):
        # Mid-rewrite read (the writer uses os.replace, but a foreign
        # writer might not): treat as "no rules this pass", the next
        # stat sees the settled file.
        return []
    with _lock:
        _cache.update(path=path, stamp=stamp, rules=rules)
    return rules


def check(site: str) -> None:
    """Product-code injection point. No-op unless a rules file is
    configured AND a rule matches ``site``; see the module docstring
    for rule semantics. May raise :class:`FaultInjected` /
    :class:`FaultDropped`, sleep, or SIGKILL the process."""
    from ray_tpu_torch.core.config import config

    path = config.faultinject_path
    if not path:
        return
    for rule in _load(path):
        if not fnmatch.fnmatchcase(site, str(rule.get("site", ""))):
            continue
        rid = _rule_id(rule)
        with _lock:
            n = _counts.get(rid, 0) + 1
            _counts[rid] = n
        after = int(rule.get("after", 0))
        if n <= after:
            continue
        times = int(rule.get("times", -1))
        if times >= 0 and n > after + times:
            continue
        if rule.get("once_global"):
            marker = f"{path}.{rid}.fired"
            try:
                os.close(os.open(marker,
                                 os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            except FileExistsError:
                continue  # already fired in some process: fuse blown
            except OSError:
                continue  # marker dir unwritable: fail safe (don't fire)
        _fire(rule, site)


def _fire(rule: Dict[str, Any], site: str) -> None:
    action = rule.get("action", "error")
    from ray_tpu_torch.util import flightrec

    # The flight recorder is the one witness an injected crash leaves
    # behind: record the fire, and for `die` flush synchronously — the
    # SIGKILL gives the background flusher no chance.
    flightrec.record("fault.fired", site=site, action=action)
    if action == "die":
        # SIGKILL self: no cleanup, no atexit, no further flush — the
        # honest crash the control plane must tolerate (the recorder
        # file written above is evidence, not cleanup: the process
        # state it describes still evaporates).
        flightrec.flush_now()
        os.kill(os.getpid(), signal.SIGKILL)
    elif action == "delay":
        time.sleep(float(rule.get("delay_s", 0.1)))
    elif action == "drop":
        raise FaultDropped(f"faultinject: dropped at {site}")
    else:
        raise FaultInjected(f"faultinject: injected failure at {site}")


def reset_counters() -> None:
    """Forget this process's per-rule match counters (test isolation)."""
    with _lock:
        _counts.clear()


class Faults:
    """Test-side owner of a rules file.

    ::

        with Faults(path) as f:
            f.add("rpc.client.release_subslice", "error")
            kill = f.add("serve.controller.reconcile_tick", "die",
                         once_global=True)
            ...
            f.remove(kill)      # live update: workers re-read on mtime

    ``path`` must equal ``config.faultinject_path`` in every process
    under test — set ``RAY_TPU_FAULTINJECT_PATH`` before
    ``ray_tpu_torch.init`` (workers inherit the environment) and the config
    flag in the test process. Exit clears the file and any
    ``once_global`` marker files."""

    def __init__(self, path: str):
        self.path = path
        self._rules: List[Dict[str, Any]] = []

    # ------------------------------------------------------------ rules

    def add(self, site: str, action: str = "error",
            after: int = 0, times: int = -1, once_global: bool = False,
            delay_s: float = 0.1, rule_id: Optional[str] = None
            ) -> Dict[str, Any]:
        rule = {"site": site, "action": action, "after": after,
                "times": times, "once_global": once_global,
                "delay_s": delay_s}
        if rule_id:
            rule["id"] = rule_id
        self._rules.append(rule)
        self._write()
        return rule

    def remove(self, rule: Dict[str, Any]) -> None:
        self._rules = [r for r in self._rules if r is not rule]
        self._write()

    def clear(self) -> None:
        self._rules = []
        self._write()

    def _write(self) -> None:
        # Atomic replace: a worker's _load never sees a torn file.
        tmp = f"{self.path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self._rules, f)
        os.replace(tmp, self.path)

    def marker_fired(self, rule: Dict[str, Any]) -> bool:
        """Whether a ``once_global`` rule's cross-process fuse blew —
        i.e. some process reached the site and fired the action."""
        return os.path.exists(f"{self.path}.{_rule_id(rule)}.fired")

    # ------------------------------------------------------- lifecycle

    def __enter__(self) -> "Faults":
        self._write()
        return self

    def __exit__(self, *exc) -> None:
        for rule in list(self._rules):
            try:
                os.unlink(f"{self.path}.{_rule_id(rule)}.fired")
            except OSError:
                pass
        self._rules = []
        try:
            self._write()
            os.unlink(self.path)
        except OSError:
            pass
