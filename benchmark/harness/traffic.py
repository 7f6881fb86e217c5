"""One general generator for every traffic mix.

A mix is a data file (``benchmark/traffic/<mix>.json``). Serving mixes
give ``arrivals`` (an open loop: ``{"process": "poisson", "rate_per_s":
r}``), ``prompt_tokens`` and ``output_tokens`` (``{"dist": "lognormal",
"median": m, "sigma": s, "min": a, "max": b}`` or ``{"dist": "fixed",
"value": n}``), ``order_seed``, and optionally ``shared_prefix``
(``{"documents": d, "tokens": <length>}``: ``d`` documents, each the
start of an equal share of the prompts) and ``residents``
(``{"seconds": t}``: see :func:`residents`). Training mixes give
``batch`` (``{"rows": b, "seq_len": s}``).

Every seed gets the same schedule: the sizes and gaps are the
distribution's quantiles at ``(i + 0.5) / n``, in the order the mix's
``order_seed`` draws (one fixed replay); the run's seed draws the token
ids. So two seeds do the same work, and the spread between seeds is the
system's, not the draw's. (With the order drawn from the run's seed, the
chat cell's tokens a second spread 10-12% between seeds and 0.5% between
two runs of one seed, on one H100 80GB HBM3.)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import Any, Dict, List, Optional

import numpy as np

_MASK63 = (1 << 63) - 1


def mix_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed from ``seed`` (any size of int) and ``salt``, for
    ``torch.Generator.manual_seed`` and numpy alike."""
    x = int(seed) & ((1 << 64) - 1)
    for s in salt:
        x = (x * 6364136223846793005 + 1442695040888963407 + int(s)) \
            & ((1 << 64) - 1)
        x ^= x >> 29
    return x & _MASK63


def quantiles(dist: Dict[str, Any], n: int) -> np.ndarray:
    """``n`` sizes: the distribution's quantiles at ``(i + 0.5) / n``,
    rounded and clipped, in increasing order."""
    kind = dist["dist"]
    if kind == "fixed":
        return np.full(n, int(dist["value"]), np.int64)
    if kind != "lognormal":
        raise ValueError(f"unknown size distribution {kind!r}")
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    sizes = np.rint(dist["median"] * np.exp(dist["sigma"] * z))
    return np.clip(sizes, dist["min"], dist["max"]).astype(np.int64)


def arrival_gaps(rate: float, n: int) -> np.ndarray:
    """``n`` exponential inter-arrival gaps of a Poisson process at
    ``rate``: the quantiles at ``(i + 0.5) / n``, scaled to a mean of
    exactly ``1 / rate``."""
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u)
    return gaps / gaps.mean() / rate


@dataclass
class Request:
    """One request of an open loop: due ``due_s`` after the window
    opens."""

    index: int
    due_s: float
    prompt: np.ndarray
    max_new_tokens: int
    # Filled while the request is served.
    sent: Optional[float] = None       # monotonic time of submit
    due: Optional[float] = None        # monotonic time it was due
    times: List[float] = field(default_factory=list)  # each token's
    tokens: List[int] = field(default_factory=list)
    error: Optional[str] = None
    handle: Any = None


def serve_schedule(mix: Dict[str, Any], seconds: float, seed: int,
                   vocab: int) -> List[Request]:
    """The requests an open loop sends in a window of ``seconds``: every
    one is due inside it. The count is ``floor(rate * seconds)``."""
    arr = mix["arrivals"]
    if arr["process"] != "poisson":
        raise ValueError(f"unknown arrival process {arr['process']!r}")
    rate = float(arr["rate_per_s"])
    n = max(1, int(math.floor(rate * seconds)))
    order = np.random.default_rng(mix_seed(mix["order_seed"], 1))
    rng = np.random.default_rng(mix_seed(seed, 1))
    gaps = order.permutation(arrival_gaps(rate, n))
    prompts = order.permutation(quantiles(mix["prompt_tokens"], n))
    outputs = order.permutation(quantiles(mix["output_tokens"], n))
    due = np.cumsum(gaps) - gaps[0] * 0.5
    docs = None
    share = mix.get("shared_prefix")
    if share:
        ndoc = int(share["documents"])
        lens = order.permutation(quantiles(share["tokens"], ndoc))
        docs = [rng.integers(0, vocab, int(m), dtype=np.int64)
                for m in lens]
        which = order.permutation(np.arange(n) % ndoc)
    out = []
    for i in range(n):
        body = rng.integers(0, vocab, int(prompts[i]), dtype=np.int64)
        if docs is not None:
            body = np.concatenate([docs[which[i]], body])
        out.append(Request(i, float(due[i]), body.astype(np.int32),
                           int(outputs[i])))
    return out


def residents(mix: Dict[str, Any], seed: int, vocab: int) -> List[Request]:
    """The requests already in the engine when the window opens, so that
    it opens on the steady state of its rate and not on an empty engine:
    ``rate * seconds`` of them (Little's law, ``seconds`` the mean time a
    request spends in the engine at that rate, measured when the cell was
    defined). A request in progress is drawn by its length (a long one is
    more often in progress), part way through it: its output so far joins
    its prompt (fresh token ids stand in for it), and what is left is its
    budget. The sizes are quantiles, as for the window's requests."""
    spec = mix.get("residents")
    if not spec:
        return []
    n = int(round(float(mix["arrivals"]["rate_per_s"])
                  * float(spec["seconds"])))
    if n <= 0:
        return []
    order = np.random.default_rng(mix_seed(mix["order_seed"], 5))
    rng = np.random.default_rng(mix_seed(seed, 5))
    sizes = quantiles(mix["output_tokens"], 4 * n).astype(np.float64)
    cdf = np.cumsum(sizes) / sizes.sum()
    picks = sizes[np.searchsorted(cdf, (np.arange(n) + 0.5) / n)]
    picks = order.permutation(picks.astype(np.int64))
    done = np.floor(order.permutation((np.arange(n) + 0.5) / n)
                    * picks).astype(np.int64)
    prompts = order.permutation(quantiles(mix["prompt_tokens"], n))
    out = []
    for i in range(n):
        body = rng.integers(0, vocab, int(prompts[i] + done[i]),
                            dtype=np.int64).astype(np.int32)
        out.append(Request(-1 - i, 0.0, body, int(picks[i] - done[i])))
    return out


def train_batch(mix: Dict[str, Any], seed: int, step: int, vocab: int,
                device) -> "torch.Tensor":
    """Step ``step``'s token rows, ``(rows, seq_len + 1)`` on ``device``:
    every row of every step differs (its own draw from the seed)."""
    import torch

    b = mix["batch"]
    g = torch.Generator(device=device)
    g.manual_seed(mix_seed(seed, 2, step))
    return torch.randint(0, vocab, (int(b["rows"]), int(b["seq_len"]) + 1),
                         generator=g, device=device)
