"""The end-to-end numbers of a serving window, from each request's due
time and the host times its tokens reached the client."""

from __future__ import annotations

from typing import Any, Dict, List

from benchmark.harness import stats
from benchmark.harness.traffic import Request


def summarize(reqs: List[Request], t0: float, seconds: float,
              t_wait: float, held: List[Request] = ()) -> Dict[str, Any]:
    """Over every request the window sent (all were due in it), and for
    tokens and gaps also the requests ``held`` in the engine when it
    opened:

    * ``ttft_p95_ms``: from when each was due to its first token. A
      request with no first token by ``t_wait`` (the end of the wait
      after the window) is missing, and counts as the wait: later than
      any answered one.
    * ``itl_p95_ms``: every gap between consecutive tokens of a request
      whose later token came inside the window.
    * ``serve_tokens_per_s``: every token that came inside the window,
      over the window.
    * ``failed``: requests of the window with no first token, and
      requests refused or ended by an error.
    """
    t_end = t0 + seconds
    ttft, itl, tokens = [], [], 0
    for r in reqs:
        ttft.append((r.times[0] if r.times else t_wait) - r.due)
    for r in list(reqs) + list(held):
        tokens += sum(t0 <= t <= t_end for t in r.times)
        itl += [b - a for a, b in zip(r.times, r.times[1:])
                if t0 <= b <= t_end]
    def broken(r):
        return r.error is not None or (r.handle is not None
                                       and r.handle.status == "error")

    failed = (sum(1 for r in reqs if not r.times or broken(r))
              + sum(1 for r in held if broken(r)))
    late = [r.sent - r.due for r in reqs if r.sent is not None]
    return {
        "ttft_p95_ms": 1e3 * stats.percentile(ttft, 95),
        "itl_p95_ms": 1e3 * stats.percentile(itl, 95) if itl else None,
        "serve_tokens_per_s": tokens / seconds,
        "failed": failed,
        "ttft_samples": len(ttft),
        "itl_samples": len(itl),
        "ttft_p50_ms": 1e3 * stats.percentile(ttft, 50),
        "client_late_p50_ms": 1e3 * stats.percentile(late, 50) if late
        else None,
        "client_late_max_ms": 1e3 * max(late) if late else None,
    }
