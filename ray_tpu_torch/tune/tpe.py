"""Native TPE (tree-structured Parzen estimator) searcher (copy of
``ray_tpu/tune/tpe.py``).

The reference wraps external libraries for model-based search (Optuna /
HyperOpt — ``tune/search/optuna``, ``tune/search/hyperopt``; both are TPE
under the hood). None of those ship in this image, so the searcher itself
is native: classic 1-D TPE (Bergstra et al., NeurIPS 2011) per parameter —
split observations into good/bad quantiles, model each with a Parzen
(kernel) density, and propose the candidate maximizing l(x)/g(x).

Plugs into :class:`ray_tpu_torch.tune.Tuner` via ``TuneConfig(search_alg=...)``:
the tuner asks ``suggest()`` for each new trial (instead of pre-sampling
the whole sweep) and feeds results back through ``on_trial_complete``, so
later trials concentrate where earlier ones scored well.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.search import (
    Categorical,
    Domain,
    GridSearch,
    LogUniform,
    RandInt,
    Uniform,
)


class TPESearcher:
    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 n_startup_trials: int = 8,
                 gamma: float = 0.25,
                 n_candidates: int = 24,
                 seed: int = 0):
        self.metric = metric      # default: the TuneConfig's metric
        self.mode = mode
        self.n_startup = n_startup_trials
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._space: Dict[str, Any] = {}
        self._live: Dict[str, Dict[str, Any]] = {}   # trial id -> config
        self._obs: List[Tuple[Dict[str, Any], float]] = []

    # -- tuner protocol

    def set_search_properties(self, metric: str, mode: str,
                              param_space: Dict[str, Any]) -> None:
        self.metric = self.metric or metric
        self.mode = self.mode or mode
        for k, v in param_space.items():
            if isinstance(v, GridSearch):
                raise ValueError(
                    "TPESearcher does not combine with grid_search axes; "
                    "use choice(...) instead")
        self._space = dict(param_space)

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        cfg = {}
        for name, dom in self._space.items():
            if not isinstance(dom, Domain):
                cfg[name] = dom  # constant
            elif len(self._obs) < self.n_startup:
                cfg[name] = dom.sample(self._rng)
            else:
                cfg[name] = self._suggest_one(name, dom)
        self._live[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str,
                          metrics: Optional[Dict[str, Any]]) -> None:
        cfg = self._live.pop(trial_id, None)
        if cfg is None or not metrics or self.metric not in metrics:
            return
        value = float(metrics[self.metric])
        if self.mode == "max":
            value = -value  # internal convention: lower is better
        self._obs.append((cfg, value))

    # -- TPE core

    def _split(self) -> Tuple[list, list]:
        ordered = sorted(self._obs, key=lambda o: o[1])
        n_good = max(1, int(math.ceil(self.gamma * len(ordered))))
        return ordered[:n_good], ordered[n_good:]

    def _suggest_one(self, name: str, dom: Domain):
        good, bad = self._split()
        gvals = [o[0][name] for o in good if name in o[0]]
        bvals = [o[0][name] for o in bad if name in o[0]]
        if isinstance(dom, Categorical):
            return self._categorical(dom, gvals, bvals)
        if isinstance(dom, LogUniform):
            lo, hi = dom.log_low, dom.log_high
            g = [math.log(v) for v in gvals]
            b = [math.log(v) for v in bvals]
            x = self._parzen_pick(lo, hi, g, b)
            return math.exp(x)
        if isinstance(dom, RandInt):
            lo, hi = float(dom.low), float(dom.high - 1)
            x = self._parzen_pick(lo, hi, [float(v) for v in gvals],
                                  [float(v) for v in bvals])
            return int(min(dom.high - 1, max(dom.low, round(x))))
        if isinstance(dom, Uniform):
            return self._parzen_pick(dom.low, dom.high,
                                     [float(v) for v in gvals],
                                     [float(v) for v in bvals])
        return dom.sample(self._rng)

    def _parzen_pick(self, lo: float, hi: float,
                     good: List[float], bad: List[float]) -> float:
        """Draw candidates from the good-density, keep the argmax of
        l(x)/g(x). Bandwidth: range-scaled Scott-ish heuristic with a
        floor, per the original TPE prior smoothing."""
        if not good:
            return self._rng.uniform(lo, hi)
        span = max(hi - lo, 1e-12)
        n = len(good) + len(bad)
        # Scott-flavored bandwidth shrinking with the TOTAL observation
        # count (a lone good point early on must not blow bw up to the
        # whole span), floored for exploration.
        bw = max(span * 0.05, span * 0.5 * max(n, 2) ** -0.4)

        def draw(center):
            # Truncated gaussian by rejection: clamping instead would pile
            # candidate mass onto the bounds and the ratio score would pin
            # suggestions to the boundary.
            for _ in range(20):
                x = self._rng.gauss(center, bw)
                if lo <= x <= hi:
                    return x
            return self._rng.uniform(lo, hi)

        def density(x, centers):
            # + a uniform prior component so unexplored regions keep mass.
            p = 1.0 / span
            for c in centers:
                z = (x - c) / bw
                p += math.exp(-0.5 * z * z) / (bw * 2.5066282746310002)
            return p / (len(centers) + 1)

        best_x, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            x = draw(self._rng.choice(good))
            score = density(x, good) / max(density(x, bad), 1e-12)
            if score > best_score:
                best_x, best_score = x, score
        return best_x

    def _categorical(self, dom: Categorical, gvals, bvals):
        def probs(vals):
            counts = {c: 1.0 for c in dom.categories}  # +1 smoothing
            for v in vals:
                counts[v] = counts.get(v, 1.0) + 1.0
            total = sum(counts.values())
            return {c: counts[c] / total for c in dom.categories}

        pg, pb = probs(gvals), probs(bvals)
        scored = [(pg[c] / max(pb[c], 1e-12), c) for c in dom.categories]
        # Sample proportionally to the likelihood ratio (keeps exploration).
        total = sum(s for s, _c in scored)
        r = self._rng.uniform(0, total)
        for s, c in scored:
            r -= s
            if r <= 0:
                return c
        return scored[-1][1]
