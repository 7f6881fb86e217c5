"""Engine step timeline (copy of ``ray_tpu/serve/steplog.py``): a bounded
ring answering "why was THIS token slow?".

One row per ``DecodeEngine.step()`` with the step's phases (full and
suffix prefill waves, the interleaved prefill chunk, decode, and in spec
mode ``draft``/``verify``, the verify phase carrying the round's
accepted-token count) and batch occupancy, plus the discrete events that
explain latency cliffs: page alloc/free, recompute preemption, draft-seat
demotions (``spec-draftless``) and the first dispatch of each program key
(``jit-compile``).

Recording is a deque append and a few clock reads per STEP (never per
token). The ring is host memory only; ``engine.timeline()`` dumps it and
``timeline_chrome_events`` renders a dump as Chrome trace events.

Timestamps are host wall clock (``time.time``). On a card a phase's
``t1`` is when the host got past it: a phase that ends in a device-to-host
copy has waited for the card, one that ends in a launch has not. In the
engine, ``prefill``, ``suffix-prefill``, ``decode``, ``draft`` and a
published ``handoff`` end in a copy to the host; ``prefill-chunk``,
``draft-prefill`` and an adopted ``handoff`` end at a launch, and
``verify`` after its closing cursor writes (launches). So a chunk's device
time lands in the host times of the phase whose copy follows it.

With device spans on (``util/tracing.py``, the ``trace_device_spans``
flag) a row records the card's time too. Each timed phase carries
``dev_ms``: the device time between a CUDA event recorded just before its
first launch and one just after its last, the token copy included. A
phase whose work holds ``attn`` spans (``decode``, ``verify``, ``draft``,
``prefill-chunk``, a paged ``suffix-prefill``: each layer's page gather
and masked attention) carries
``attn_ms``, their sum, and every prefill phase carries ``tokens``, the
real prompt tokens it processed. The host-only phases ``admit`` (reaping
and admission up to the step's first launch) and ``emit`` (the loop over
slots after the token copy) time the host between launches. The train
step (``parallel/train_step.py``) keeps rows of its own: ``forward`` and
``backward`` a microbatch and ``optimizer``, each with ``dev_ms``, and
``lm_head_ce_ms`` on the row. A phase's keys appear once its end event
has completed: at a later row's close or at ``dump()``; nothing waits for
the card. With device spans off, rows hold only host times.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple


class StepTimeline:
    """Bounded per-engine step recorder. Not thread-safe by design: only
    the engine's decode-loop thread records; ``dump()`` may read from
    another thread. A row changes after it is appended only as its device
    spans resolve, under ``_lock``, and ``dump()`` copies the rows and
    their phases under it."""

    __slots__ = ("capacity", "_rows", "_events", "dropped", "_spans",
                 "_lock")

    def __init__(self, capacity: int = 256):
        self.capacity = max(0, int(capacity))
        self._rows: deque = deque(maxlen=self.capacity or None)
        self._events: List[Dict[str, Any]] = []  # pending, next row's
        self.dropped = 0
        self._spans: List[Tuple[Dict[str, Any], Any]] = []  # unresolved
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    @property
    def pending_events(self) -> bool:
        return bool(self._events)

    # ------------------------------------------------------------ events

    def event(self, kind: str, **attrs: Any) -> None:
        """Queue a discrete event (page alloc/free, preempt, first
        dispatch); it attaches to the next recorded step row."""
        if not self.capacity:
            return
        e = {"kind": kind, "ts": time.time()}
        if attrs:
            e.update(attrs)
        self._events.append(e)

    # -------------------------------------------------------------- rows

    def record(self, step: int, t0: float, t1: float, phases:
               List[Dict[str, Any]], active: int, prefilling: int,
               queued: int, pages_free: Optional[int] = None,
               spans: Sequence[Tuple[Dict[str, Any], Any]] = (),
               row_span: Any = None) -> None:
        """One engine step: ``phases`` are the step's timed sub-slices
        ([{phase, t0, t1, ...attrs}]); occupancy is sampled at the step
        boundary; queued events ride along and clear. ``spans`` pairs
        phases with the closed device spans (``util.tracing.DeviceSpan``)
        that timed them, ``row_span`` times the whole row: each phase (or
        the row) gains ``dev_ms`` and ``<name>_ms`` for the summed spans
        of each name nested in it once they resolve."""
        if not self.capacity:
            self._events.clear()
            return
        if len(self._rows) == self._rows.maxlen:
            self.dropped += 1
        row = {"step": step, "t0": t0, "t1": t1, "phases": phases,
               "active": active, "prefilling": prefilling,
               "queued": queued}
        if pages_free is not None:
            row["pages_free"] = pages_free
        if self._events:
            row["events"] = self._events
            self._events = []
        self._rows.append(row)
        if spans or row_span is not None or self._spans:
            with self._lock:
                self._spans.extend(spans)
                if row_span is not None:
                    self._spans.append((row, row_span))
                self._settle()

    def _settle(self) -> None:
        """Write the times of the spans whose events have completed, in
        order, up to the first still running (spans complete in stream
        order). Holds ``_lock``."""
        done = 0
        for target, span in self._spans:
            if not span.resolve():
                break
            target["dev_ms"] = span.dev_ms
            for name, ms in span.totals().items():
                target[f"{name}_ms"] = ms
            done += 1
        del self._spans[:done]

    def dump(self) -> Dict[str, Any]:
        with self._lock:
            self._settle()
            rows = [dict(r, phases=[dict(p) for p in r["phases"]])
                    for r in list(self._rows)]
        return {"capacity": self.capacity, "dropped": self.dropped,
                "rows": rows}


def timeline_chrome_events(dump: Dict[str, Any], pid: str
                           ) -> List[Dict[str, Any]]:
    """Render one engine's timeline dump as Chrome trace events: phase
    slices on an ``engine-step`` track, occupancy as counters, discrete
    events as instants."""
    out: List[Dict[str, Any]] = []
    for row in dump.get("rows", []):
        for ph in row.get("phases", []):
            out.append({
                "name": ph.get("phase", "step"),
                "cat": "engine-step", "ph": "X",
                "ts": ph["t0"] * 1e6,
                "dur": max(0.0, (ph["t1"] - ph["t0"]) * 1e6),
                "pid": pid, "tid": "engine-step",
                "args": {k: v for k, v in ph.items()
                         if k not in ("phase", "t0", "t1")},
            })
        out.append({
            "name": "occupancy", "ph": "C", "pid": pid,
            "ts": row["t0"] * 1e6,
            "args": {"active": row.get("active", 0),
                     "prefilling": row.get("prefilling", 0),
                     "queued": row.get("queued", 0)},
        })
        for e in row.get("events", []):
            out.append({
                "name": e.get("kind", "event"), "cat": "engine-event",
                "ph": "i", "s": "t", "ts": e.get("ts", row["t0"]) * 1e6,
                "pid": pid, "tid": "engine-step",
                "args": {k: v for k, v in e.items()
                         if k not in ("kind", "ts")},
            })
    return out
