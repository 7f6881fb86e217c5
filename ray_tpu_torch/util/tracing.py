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

Device spans (:func:`device_span`) time the card's share of a piece of
host code with a CUDA event pair: the engine's step phases, the decode
attention, the train step's phases. They are off unless the
``trace_device_spans`` flag or :func:`set_device_spans` turns them on,
and they are read through the step timelines (``serve/steplog.py``), not
the task-event buffer.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.config import config as _config

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


# ----------------------------------------------------------- device spans

# The process-wide switch. Read it as ``tracing.device_spans_on`` (a
# ``from ... import`` would copy the value of the moment).
device_spans_on: bool = bool(_config.trace_device_spans)

# Idle timing events by device index: an event returns here once the span
# that recorded it has read its time.
_EVENTS: Dict[int, List[Any]] = {}
_tls = threading.local()


def set_device_spans(on: bool) -> None:
    """Turn device spans on or off for the whole process. Spans opened
    before a switch close as they were opened."""
    global device_spans_on
    device_spans_on = bool(on)


def _new_event():
    import torch

    return torch.cuda.Event(enable_timing=True)


def _stream(index: int):
    import torch

    return torch.cuda.current_stream(index)


def _take_event(index: int):
    try:
        return _EVENTS[index].pop()
    except (KeyError, IndexError):
        return _new_event()


def _stack() -> List["DeviceSpan"]:
    """This thread's open device spans, innermost last."""
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


def _cuda_index(device) -> Optional[int]:
    if device is None:
        return None
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    return (device.index if device.index is not None
            else torch.cuda.current_device())


class DeviceSpan:
    """One span: host start and end (``time.time``, the step timelines'
    clock) and, on a CUDA device, a timing event on the current stream at
    each end. Opening attaches it to ``parent``, or else to the span open
    on this thread. ``dev_ms`` is known once the end event has completed
    (:meth:`resolve`, which never waits); on the CPU it stays ``None``."""

    __slots__ = ("name", "t0", "t1", "dev_ms", "children", "_index",
                 "_parent", "_ev", "_stack", "_done")

    def __init__(self, name: str, device=None,
                 parent: Optional["DeviceSpan"] = None):
        self.name = name
        self.t0 = self.t1 = None
        self.dev_ms: Optional[float] = None
        self.children: List[DeviceSpan] = []
        self._index = _cuda_index(device)
        self._parent = parent
        self._ev = None
        self._stack = None
        self._done = False

    def __enter__(self) -> "DeviceSpan":
        self.open()
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def open(self) -> None:
        stack = _stack()
        parent = self._parent if self._parent is not None else (
            stack[-1] if stack else None)
        if parent is not None:
            parent.children.append(self)
        stack.append(self)
        self._stack = stack
        self.t0 = time.time()
        if self._index is not None:
            start = _take_event(self._index)
            start.record(_stream(self._index))
            self._ev = (start, None)

    def close(self) -> None:
        if self._ev is not None:
            end = _take_event(self._index)
            end.record(_stream(self._index))
            self._ev = (self._ev[0], end)
        self.t1 = time.time()
        if self._stack is not None:
            self._stack.remove(self)
            self._stack = None

    def resolve(self) -> bool:
        """True once this span's and its children's times are known.
        Reads ``dev_ms`` only after the end event has completed (a query,
        never a wait) and returns the events to the pool."""
        if self._done:
            return True
        if self.t1 is None:
            return False
        if self._ev is not None:
            start, end = self._ev
            if end is None or not end.query():
                return False
        for c in self.children:
            if c.t1 is None:  # never closed (a raise, a backward cut
                # short): no time to read, and no stall of what follows
                c._ev, c._done = None, True
            elif not c.resolve():
                return False
        if self._ev is not None:
            self.dev_ms = start.elapsed_time(end)
            _EVENTS.setdefault(self._index, []).extend((start, end))
            self._ev = None
        self._done = True
        return True

    def totals(self) -> Dict[str, Optional[float]]:
        """Summed ``dev_ms`` of the resolved descendants by name (``None``
        where one has no device time)."""
        out: Dict[str, Optional[float]] = {}
        todo = list(self.children)
        while todo:
            c = todo.pop()
            prev = out.get(c.name, 0.0)
            out[c.name] = (None if prev is None or c.dev_ms is None
                           else prev + c.dev_ms)
            todo.extend(c.children)
        return out


class _NoSpan:
    """What :func:`device_span` returns with the switch off: records
    nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def open(self) -> None:
        pass

    def close(self) -> None:
        pass


_NO_SPAN = _NoSpan()


def device_span(name: str, device=None,
                parent: Optional[DeviceSpan] = None):
    """A :class:`DeviceSpan` named ``name`` on ``device`` (a CUDA device
    gets events; anything else host times only), as a context manager or
    through ``open()`` / ``close()``. It nests under ``parent``, or else
    under the span open on this thread; a span opened with none open is
    its opener's to read. With the switch off this is one global read
    and returns a shared span that records nothing."""
    if not device_spans_on:
        return _NO_SPAN
    return DeviceSpan(name, device, parent)


def current_span_stack() -> List[DeviceSpan]:
    """This thread's stack of open device spans (the list itself, so work
    that runs later on another thread, such as autograd's backward, can
    nest under whatever this thread has open by then)."""
    return _stack()


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
