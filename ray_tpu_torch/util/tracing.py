"""Distributed tracing: span propagation through remote calls + profile
events.

Reference analogues (SURVEY §5.1): the OpenTelemetry task-span wrapper
(``util/tracing/tracing_helper.py`` — spans around ``remote()`` calls with
context propagated in task metadata) and per-task ``profile_event``
instrumentation (``_raylet.pyx:4031`` -> ``TaskEventBuffer``). OTel is not
in this image, so the context itself is native: a (trace_id, span_id) pair
carried by a contextvar, shipped inside task specs, and re-entered on the
executing worker — every task event and profile event records its trace,
so ``ray_tpu timeline`` renders a causally-linked Chrome trace across
processes.

Usage::

    with tracing.trace("ingest"):          # root span on the driver
        ref = f.remote()                   # span ctx rides the task spec

    def f():
        with tracing.profile_event("load-shard"):   # nested timing slice
            ...
"""

from __future__ import annotations

import contextvars
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

# (trace_id_hex, span_id_hex) of the active span, or None.
_ctx: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "ray_tpu_torch_trace", default=None)


def current() -> Optional[tuple]:
    """(trace_id, span_id) of the active span, if any."""
    return _ctx.get()


def traced() -> bool:
    """True when a trace context is active in this task/thread — the
    one-contextvar-read gate hot-ish paths use before building span
    names/attrs (the pipeline stage actors emit fwd/bwd/apply spans
    only while the driver's step span is propagated to them; an
    untraced step pays exactly this read per stage call)."""
    return _ctx.get() is not None


def _new_id() -> str:
    return os.urandom(8).hex()


def context_for_spec() -> Optional[Dict[str, str]]:
    """Serializable span context to embed in an outgoing task spec."""
    cur = _ctx.get()
    if cur is None:
        return None
    return {"trace_id": cur[0], "parent_span": cur[1]}


@contextmanager
def activate(spec_ctx: Optional[Dict[str, str]], name: Optional[str] = None):
    """Worker-side: enter the caller's trace (new child span) for the
    duration of a task's execution. With ``name``, the execution itself
    is recorded as a SPAN parented under the caller's span — the link
    that makes a cross-process trace causally connected (caller-side
    attempt span -> this execution span -> spans the task opens)."""
    if not spec_ctx:
        yield
        return
    span_id = _new_id()
    token = _ctx.set((spec_ctx["trace_id"], span_id))
    start = time.time()
    try:
        yield
    finally:
        _ctx.reset(token)
        if name is not None:
            _record({
                "task_id": span_id,
                "desc": name,
                "state": "SPAN",
                "trace_id": spec_ctx["trace_id"],
                "span_id": span_id,
                "parent_span": spec_ctx.get("parent_span"),
                "lease_ts": start,
                "end_ts": time.time(),
                "attrs": None,
            })


@contextmanager
def resume(ctx: Optional[tuple]):
    """Re-enter a previously captured :func:`current` tuple on another
    thread (e.g. a router pool thread running work submitted under a
    live span). Unlike :func:`activate` this CONTINUES the captured span
    rather than opening a child."""
    if ctx is None:
        yield
        return
    token = _ctx.set(ctx)
    try:
        yield
    finally:
        _ctx.reset(token)


def record_span(name: str, start_ts: float, end_ts: float,
                ctx: Optional[tuple] = None, **attrs: Any) -> Optional[str]:
    """Record a completed span with EXPLICIT wall-clock timestamps,
    parented under ``ctx`` (a captured :func:`current` tuple; defaults
    to the active context). The decode engine uses this to attribute
    work it performed on its own loop thread — queue wait, prefill
    chunks, decode — back to the request's trace after the fact.
    Returns the new span id (None when there is no trace to attach to)."""
    parent = ctx if ctx is not None else _ctx.get()
    if parent is None:
        return None
    span_id = _new_id()
    _record({
        "task_id": span_id,
        "desc": name,
        "state": "SPAN",
        "trace_id": parent[0],
        "span_id": span_id,
        "parent_span": parent[1],
        "lease_ts": start_ts,
        "end_ts": end_ts,
        "attrs": attrs or None,
    })
    return span_id


@contextmanager
def trace(name: str, **attrs: Any):
    """Open a span; the first span in a process starts a new trace. The
    span is recorded as a task event (state=SPAN) so it lands in the
    timeline alongside the tasks it caused."""
    parent = _ctx.get()
    trace_id = parent[0] if parent else _new_id()
    span_id = _new_id()
    token = _ctx.set((trace_id, span_id))
    start = time.time()
    try:
        yield (trace_id, span_id)
    finally:
        _ctx.reset(token)
        _record({
            "task_id": span_id,
            "desc": name,
            "state": "SPAN",
            "trace_id": trace_id,
            "span_id": span_id,
            "parent_span": parent[1] if parent else None,
            "lease_ts": start,
            "end_ts": time.time(),
            "attrs": attrs or None,
        })


@contextmanager
def profile_event(name: str, **attrs: Any):
    """Record a timed slice inside the current task/span (reference:
    ``ray.profiling.profile`` / ``_raylet.pyx profile_event``)."""
    with trace(f"profile:{name}", **attrs):
        yield


def _record(event: Dict[str, Any]) -> None:
    from ray_tpu_torch.core.runtime import get_core_worker

    try:
        core = get_core_worker()
    except Exception:
        core = None  # not connected: spans still nest, just unrecorded
    if core is None:
        return
    cur = _ctx.get()
    if cur is not None:
        event.setdefault("trace_id", cur[0])
    event.setdefault("owner", core.addr)
    event.setdefault("worker", getattr(core, "worker_id", None) and
                     core.worker_id.hex()[:8])
    core.record_task_event(event)


def dump_stacks() -> str:
    """All thread stacks of THIS process, formatted — the py-spy-equivalent
    introspection primitive (reference: dashboard reporter's py-spy shell
    out, ``profile_manager.py:79``; here native via sys._current_frames so
    it needs no external binary or ptrace rights)."""
    import sys
    import threading
    import traceback

    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sorted(sys._current_frames().items()):
        out.append(f"--- thread {tid} ({names.get(tid, '?')}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "\n".join(out)
