"""The traced run: ``torch.profiler`` over the end of the window, reduced
to the device's busy time, the device time inside the benchmark's own
ranges, and a breakdown.

The profiler starts ``LEAD_S`` before the part of the window it counts
(:meth:`Tracer.count`): starting it stalls the host, and the first launch
of each kernel under it pays a one-time load, so neither lands in what is
counted. Stopping it builds its events, which holds the interpreter for
seconds, so it stops only once the window has closed. Host-clock readings
of a traced run are taken where the profiler does not run: a serving run
profiles after its window, its open loop going on; a training run
profiles the window's last steps and reads its rate from the steps
before them.

The benchmark opens its ranges itself (``record_function``) around calls
into the program's entries (:func:`wrap`): every kernel launched while a
range is open on the host counts toward it, whatever implements the
call. The profiler records every thread of the process
(the engine's loop runs on its own thread).
"""

from __future__ import annotations

import bisect
import functools
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

import torch

LEAD_S = 8.0
LABELLED = 400
_ORIGIN = "bench::origin"


class Tracer:
    """Starts and stops the profiler and keeps what was traced. With
    ``enabled`` False every call is a no-op and nothing is recorded."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self.calls: Dict[str, List[Tuple[float, Dict[str, Any]]]] = \
            defaultdict(list)
        self._prof = None
        self.origin = self.t0 = self.t1 = 0.0

    def start(self) -> None:
        if not self.enabled:
            return
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(
            activities=acts,
            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self._prof.__enter__()
        with record_function(_ORIGIN):
            self.origin = time.monotonic()
        self.t0 = self.origin
        self.active = True

    def count(self) -> None:
        """The counted part of the trace starts now."""
        self.t0 = time.monotonic()

    def stop(self) -> None:
        if not self.active:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self.active = False
        self._prof.__exit__(None, None, None)

    def record(self, rng: str, call: Dict[str, Any]) -> None:
        if self.active:
            self.calls[rng].append((time.monotonic(), call))

    def reduce(self, ranges) -> Dict[str, Any]:
        """Over the counted part: ``busy_s`` (the union of device
        operations' intervals), ``window_s``, ``ranges`` (each range's
        device seconds and the calls recorded in it) and ``breakdown``."""
        calls = {rng: [c for t, c in self.calls.get(rng, [])
                       if self.t0 <= t <= self.t1] for rng in ranges}
        return reduce_events(self._prof.events(), self.origin, self.t0,
                             self.t1, ranges, calls)


def wrap(tracer: Tracer, module, attr: str, rng: str,
         shapes: Callable[..., Dict[str, Any]]) -> Callable[[], None]:
    """Replace ``module.attr`` with a version that opens the range
    ``bench::<rng>`` around each call and records ``shapes(*args,
    **kwargs)`` while the tracer is active. Returns the undo. Without a
    trace nothing is replaced. The replacement carries the original's
    attributes (the program keeps launch counters on its entries)."""
    from torch.profiler import record_function

    orig = getattr(module, attr)
    if not tracer.enabled:
        return lambda: None

    def traced(*args, **kwargs):
        if not tracer.active:
            return orig(*args, **kwargs)
        tracer.record(rng, shapes(*args, **kwargs))
        with record_function(f"bench::{rng}"):
            return orig(*args, **kwargs)

    functools.update_wrapper(traced, orig)
    setattr(module, attr, traced)
    return lambda: setattr(module, attr, orig)


def attention_shapes(q, k, *args, **kwargs) -> Dict[str, Any]:
    """The shapes of an attention call on (B, S, heads, D) tensors (the
    flash entries' layout), its mask from the ``causal`` and ``q_offset``
    keywords the program passes."""
    return {"b": q.shape[0], "sq": q.shape[1], "sk": k.shape[1],
            "h": q.shape[2], "hkv": k.shape[2], "d": q.shape[3],
            "causal": bool(kwargs.get("causal", True)),
            "q_offset": int(kwargs.get("q_offset", 0)),
            "itemsize": q.element_size()}


def _is_device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("bench::"))


def _host_at(host: List[Tuple[float, float, str]], starts: List[float],
             t: float, back: int = 2000) -> str:
    """The innermost host operation open at ``t`` (any thread), or that
    the host was between operations (in Python)."""
    best = None
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - back), -1):
        s, e, name = host[j]
        if e >= t and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else "host between operations"


def reduce_events(events, origin: float, t0: float, t1: float, ranges,
                  calls: Dict[str, List[Dict[str, Any]]]) -> Dict[str, Any]:
    """Reduce profiler ``events`` to the host interval ``[t0, t1]``
    (``time.monotonic``); ``origin`` is the host time of the
    ``bench::origin`` range, which ties the two clocks.

    A range's device time is the span the profiler gives it on the
    device (from the start of the first kernel launched inside it to the
    end of the last). The idle gaps are labelled by the innermost host
    operation open in their middle, the longest ``LABELLED`` of them."""
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type != cuda]
    marks = [e for e in host if e.name == _ORIGIN]
    base = marks[0].time_range.start if marks else 0.0
    lo = base + (t0 - origin) * 1e6
    hi = base + (t1 - origin) * 1e6
    dev = sorted(((max(e.time_range.start, lo), min(e.time_range.end, hi), e)
                  for e in events if _is_device(e)
                  and e.time_range.end > lo and e.time_range.start < hi),
                 key=lambda t: t[0])
    busy_us = 0.0
    gaps: List[Tuple[float, float]] = []
    ops: Dict[str, float] = defaultdict(float)
    cur_s = cur_e = None
    for s, t, e in dev:
        ops[e.name[:96]] += (t - s) / 1e6
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                gaps.append((cur_e, s))
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in host if not e.name.startswith("bench::"))
    starts = [s for s, _, _ in spans]
    by_host: Dict[str, float] = defaultdict(float)
    gaps.sort(key=lambda g: g[0] - g[1])
    for a, b in gaps[:LABELLED]:
        by_host[_host_at(spans, starts, (a + b) / 2)] += (b - a) / 1e6
    rest = sum(b - a for a, b in gaps[LABELLED:]) / 1e6
    if rest:
        by_host[f"gaps shorter than the {LABELLED} longest"] += rest
    out_ranges = {}
    for rng in ranges:
        name = f"bench::{rng}"
        span = sum(e.time_range.end - e.time_range.start for e in events
                   if e.device_type == cuda and e.name == name
                   and lo <= e.time_range.start <= hi) / 1e6
        out_ranges[rng] = {"device_s": span,
                           "calls": list(calls.get(rng, []))}

    def top(d):
        return [[k, v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:10]]

    return {"busy_s": busy_us / 1e6, "window_s": t1 - t0,
            "ranges": out_ranges,
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(by_host)}}
