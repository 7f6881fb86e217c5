"""Cluster flight recorder: a bounded, always-on ring of structured
events per process, persisted for post-mortem forensics.

The metrics pipeline (``core/coremetrics.py``) answers "how much / how
fast"; the tracing spans (``util/tracing.py``) answer "where did this
request's time go". Neither survives the interesting failure: a
SIGKILLed stage actor takes its gauges with it, and the doctor is left
inferring a gang death from metric *deltas*. This module records the
few dozen discrete control-plane facts that explain a crash — gang
epochs and reconciles, barrier entries, pipeline stage clocks,
snapshot pushes/pulls, fault-injection fires, actor death causes — in
a ring cheap enough to never turn off, and makes them outlive the
process that recorded them.

Design constraints, in order:

* **Cheap enough to be always-on.** :func:`record` is one config
  attribute read plus a ``deque.append`` (atomic under the GIL — no
  lock is taken that the caller did not already hold). Event dicts are
  built by the caller only after the enabled check; sites on hot paths
  gate their f-strings the same way the faultinject sites do.
  ``make bench-obs`` pins the recorder-on-vs-off delta on the pipeline
  step loop (<2% bar).
* **Survives the process.** A daemon flusher writes the ring to
  ``<flightrec_dir>/fr-<pid>.json`` (atomic replace) every
  ``flightrec_flush_s`` while events keep arriving, plus an ``atexit``
  final flush for orderly deaths. A SIGKILL keeps everything up to the
  last flush — and the one SIGKILL source this repo aims at itself
  (``util/faultinject.py`` ``die`` rules) flushes synchronously right
  before the kill, so an injected crash is fully recorded.
* **Merged after the fact.** :func:`dump_all` reads every per-process
  file back into ``{source: {"pid", "role", "events"}}``;
  ``ray_tpu doctor --post-mortem`` (``doctor.post_mortem``) merges the
  sources by wall-clock and explains the death from evidence. The
  controller exposes the same merge as the ``fr_dump`` RPC. The dir is
  per-HOST: on a real multi-host rig, collect each host's
  ``flightrec_dir`` (the post-mortem takes any merged dict).

Event shape: ``{"ev": <name>, "ts": <wall-clock>, **attrs}`` with flat,
JSON-safe attrs. Event names are literal at every call site and go
through the same graftlint family-#10 checks as metric names (one name,
one attr schema; id-shaped attr VALUES flagged — bounded schedule ints
like ``step``/``mb``/``stage`` are exempt). The in-tree catalog lives
in docs/OBSERVABILITY.md.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["record", "dump", "dump_all", "cluster_dump", "flush_now",
           "reset"]

# The ring itself: created lazily on first record so importing this
# module costs nothing. deque.append is the only hot-path operation.
_ring: Optional[deque] = None
# Flusher bookkeeping (slow path only).
_lock = threading.Lock()
_flusher_started = False
_written = 0          # events appended since the last flush (approx)


def record(ev: str, **attrs: Any) -> None:
    """Append one event to this process's ring. One attribute read when
    the recorder is off; a plain deque append when on. Never raises."""
    from ray_tpu_torch.core.config import config

    if not config.flightrec_enabled:
        return
    global _ring, _written
    ring = _ring
    if ring is None:
        with _lock:
            if _ring is None:
                _ring = deque(maxlen=max(16, int(config.flightrec_ring)))
            ring = _ring
        _ensure_flusher()
    event = {"ev": ev, "ts": time.time()}
    event.update(attrs)
    ring.append(event)
    _written += 1


def audit(ev: str, **attrs: Any) -> Optional[str]:
    """Durable append: :func:`record` + an immediate :func:`flush_now`.
    For events that must survive the process dying right after the
    decision they capture (the autopilot's control actions) — the
    normal ring only reaches disk on the background flush cadence.
    Returns the flushed path (None when the recorder is off or the dir
    is unwritable); like ``record``, never raises."""
    record(ev, **attrs)
    return flush_now()


def dump() -> List[Dict[str, Any]]:
    """This process's events, oldest first."""
    ring = _ring
    return list(ring) if ring is not None else []


def reset() -> None:
    """Drop this process's ring and its persisted file (test isolation)."""
    global _ring, _written
    with _lock:
        _ring = None
        _written = 0
    try:
        os.unlink(_path())
    except OSError:
        pass


# ------------------------------------------------------------ persistence


def _dir() -> str:
    from ray_tpu_torch.core.config import config

    return config.flightrec_dir


def _path() -> str:
    return os.path.join(_dir(), f"fr-{os.getpid()}.json")


def _role() -> str:
    try:
        from ray_tpu_torch.core import runtime

        core = runtime._core_worker
        if core is not None:
            return getattr(core, "mode", "worker")
    except Exception:  # graftlint: disable=swallowed-exception (role is cosmetic; the recorder must never take a process down)
        pass
    return "proc"


def flush_now() -> Optional[str]:
    """Write the ring to this process's recorder file (atomic replace).
    Returns the path, or None when there is nothing to write or the dir
    is unwritable (the recorder must never take a process down)."""
    global _written
    ring = _ring
    if ring is None:
        return None
    events = list(ring)
    path = _path()
    try:
        os.makedirs(_dir(), exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"pid": os.getpid(), "role": _role(),
                       "flushed_at": time.time(), "events": events}, f,
                      default=str)
        os.replace(tmp, path)
    except OSError:
        return None
    _written = 0
    return path


def _ensure_flusher() -> None:
    global _flusher_started
    with _lock:
        if _flusher_started:
            return
        _flusher_started = True
    t = threading.Thread(target=_flush_loop, name="flightrec-flush",
                         daemon=True)
    t.start()
    atexit.register(flush_now)


def _flush_loop() -> None:
    from ray_tpu_torch.core.config import config

    while True:
        time.sleep(max(0.05, config.flightrec_flush_s))
        if _written:
            flush_now()


# ------------------------------------------------------------ collection


def dump_all(fr_dir: Optional[str] = None,
             max_age_s: Optional[float] = None) -> Dict[str, Any]:
    """Read every persisted recorder file under ``fr_dir`` (default:
    the configured ``flightrec_dir``) back into
    ``{source: {"pid", "role", "events"}}`` — the post-mortem's input.
    Unreadable/torn files are skipped (a crash mid-replace leaves the
    previous complete file). ``max_age_s`` drops files whose last flush
    is older (stale pids from a previous session on a shared dir)."""
    fr_dir = fr_dir or _dir()
    out: Dict[str, Any] = {}
    try:
        names = sorted(os.listdir(fr_dir))
    except OSError:
        return out
    now = time.time()
    for name in names:
        if not (name.startswith("fr-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(fr_dir, name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(doc, dict) or "events" not in doc:
            continue
        if (max_age_s is not None
                and now - float(doc.get("flushed_at", 0)) > max_age_s):
            continue
        source = f"{doc.get('role', 'proc')}-pid{doc.get('pid', '?')}"
        out[source] = {"pid": doc.get("pid"), "role": doc.get("role"),
                       "events": list(doc.get("events") or [])}
    return out


def cluster_dump() -> Dict[str, Any]:
    """Flush this process's ring, then merge every recorder file on
    this host — the ``fr_dump`` controller RPC body. (Per-host: on a
    real rig, run it on each host or collect the dirs.)"""
    flush_now()
    return dump_all()
