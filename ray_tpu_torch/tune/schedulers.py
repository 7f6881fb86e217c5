"""Trial schedulers: FIFO, ASHA, PBT, PB2, median stopping (copy of
``ray_tpu/tune/schedulers.py``).

Analogues of the reference's ``tune/schedulers/``: ``FIFOScheduler``,
``AsyncHyperBandScheduler`` (``async_hyperband.py`` — asynchronous successive
halving), ``PopulationBasedTraining`` (``pbt.py`` — exploit best trials'
checkpoints + perturb their hyperparams), ``PB2`` (``pb2.py`` — PBT whose
perturbation is GP-UCB-guided instead of random, the better variant for
small populations) and ``MedianStoppingRule`` (``median_stopping_rule.py``).
The controller calls ``on_result(trial, metrics)`` after every report and
acts on the decision.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"
EXPLOIT = "EXPLOIT"  # PBT: restart from another trial's checkpoint


class FIFOScheduler:
    def on_result(self, trial, metrics: Dict[str, Any]) -> str:
        return CONTINUE


class ASHAScheduler:
    """Asynchronous successive halving (reference:
    ``tune/schedulers/async_hyperband.py``): rungs at
    ``grace_period * reduction_factor**k``; a trial reaching a rung stops
    unless it is in the top ``1/reduction_factor`` of results recorded at
    that rung so far (async — no waiting for full brackets)."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4,
                 time_attr: str = "training_iteration"):
        assert mode in ("min", "max")
        self.metric, self.mode = metric, mode
        self.max_t, self.grace = max_t, grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        # rung milestone -> recorded metric values
        self._recorded: Dict[int, List[float]] = defaultdict(list)

    def on_result(self, trial, metrics: Dict[str, Any]) -> str:
        t = metrics.get(self.time_attr, 0)
        value = metrics.get(self.metric)
        if value is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        decision = CONTINUE
        for rung in self.rungs:
            if t == rung:
                recorded = self._recorded[rung]
                recorded.append(float(value))
                cutoff_idx = max(0, len(recorded) // self.rf)
                ranked = sorted(recorded, reverse=(self.mode == "max"))
                cutoff = ranked[cutoff_idx] if cutoff_idx < len(ranked) \
                    else ranked[-1]
                good = (value <= cutoff if self.mode == "min"
                        else value >= cutoff)
                if not good and len(recorded) >= self.rf:
                    decision = STOP
        return decision


class PopulationBasedTraining:
    """PBT (reference: ``tune/schedulers/pbt.py``): every
    ``perturbation_interval`` iterations, bottom-quantile trials clone a
    top-quantile trial's latest checkpoint and continue with perturbed
    hyperparameters (multiply by 0.8/1.2, or resample from
    ``hyperparam_mutations``)."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 time_attr: str = "training_iteration", seed: int = 0):
        self.metric, self.mode = metric, mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.time_attr = time_attr
        self._rng = random.Random(seed)
        self._latest: Dict[Any, Dict[str, Any]] = {}  # trial -> last metrics
        self._last_perturb: Dict[Any, int] = {}

    def on_result(self, trial, metrics: Dict[str, Any]) -> str:
        self._latest[trial] = metrics
        t = metrics.get(self.time_attr, 0)
        if t - self._last_perturb.get(trial, 0) < self.interval:
            return CONTINUE
        self._last_perturb[trial] = t
        ranked = self._ranked_trials()
        if len(ranked) < 2:
            return CONTINUE
        n_q = max(1, int(len(ranked) * self.quantile))
        bottom = ranked[-n_q:]
        if trial in bottom:
            return EXPLOIT
        return CONTINUE

    def _ranked_trials(self):
        scored = [(tr, m.get(self.metric)) for tr, m in self._latest.items()
                  if m.get(self.metric) is not None]
        return [tr for tr, v in sorted(
            scored, key=lambda kv: kv[1], reverse=(self.mode == "max"))]

    def exploit_target(self, trial):
        """Pick a top-quantile trial to clone from."""
        ranked = self._ranked_trials()
        n_q = max(1, int(len(ranked) * self.quantile))
        top = [t for t in ranked[:n_q] if t is not trial]
        return self._rng.choice(top) if top else None

    def perturb_config(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from ray_tpu_torch.tune.search import Domain

        out = dict(config)
        for key, spec in self.mutations.items():
            if key not in out:
                continue
            if isinstance(spec, Domain):
                out[key] = spec.sample(self._rng)
            elif isinstance(spec, list):
                out[key] = self._rng.choice(spec)
            elif isinstance(out[key], (int, float)):
                out[key] = out[key] * self._rng.choice([0.8, 1.2])
        return out


class MedianStoppingRule:
    """Stop a trial at step t when its best result so far is worse than the
    median of the other trials' RUNNING AVERAGES at comparable steps
    (reference: ``tune/schedulers/median_stopping_rule.py`` — the
    Vizier-style performance-curve gate). ``grace_period`` results are
    always allowed; the rule arms only once ``min_samples_required`` trials
    have reported."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 grace_period: int = 1, min_samples_required: int = 3,
                 time_attr: str = "training_iteration",
                 hard_stop: bool = True):
        assert mode in ("min", "max")
        self.metric, self.mode = metric, mode
        self.grace = grace_period
        self.min_samples = min_samples_required
        self.time_attr = time_attr
        self.hard_stop = hard_stop
        # trial -> list of metric values in report order
        self._results: Dict[Any, List[float]] = defaultdict(list)

    def _running_avg(self, values: List[float], upto: int) -> float:
        vals = values[:max(1, upto)]
        return sum(vals) / len(vals)

    def on_result(self, trial, metrics: Dict[str, Any]) -> str:
        value = metrics.get(self.metric)
        if value is None:
            return CONTINUE
        self._results[trial].append(float(value))
        t = len(self._results[trial])
        if t <= self.grace:
            return CONTINUE
        others = [v for tr, v in self._results.items()
                  if tr is not trial and v]
        if len(others) + 1 < self.min_samples:
            return CONTINUE
        medians = sorted(self._running_avg(v, t) for v in others)
        if not medians:
            return CONTINUE
        median = medians[len(medians) // 2]
        mine = self._results[trial]
        best = min(mine) if self.mode == "min" else max(mine)
        worse = best > median if self.mode == "min" else best < median
        return STOP if (worse and self.hard_stop) else CONTINUE


class PB2(PopulationBasedTraining):
    """PBT with GP-UCB-guided perturbation (reference:
    ``tune/schedulers/pb2.py``, Parker-Holder et al. 2020): instead of
    resampling/multiplying hyperparams at random, fit a Gaussian process
    over (hyperparams, time) -> metric IMPROVEMENT observed across the
    whole population, and pick the exploiting trial's new config by
    maximizing the UCB acquisition within ``hyperparam_bounds``. With
    4-8 trials (this repo's regime) random perturbation wastes the few
    exploits available; the GP routes them.

    Continuous hyperparams only (the reference's PB2 has the same
    constraint); bounds are {key: (low, high)}. ``log_scale`` keys are
    modeled in log10 space (the right space for learning rates)."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 perturbation_interval: int = 4,
                 hyperparam_bounds: Optional[Dict[str, Any]] = None,
                 log_scale: Optional[Iterable[str]] = None,
                 quantile_fraction: float = 0.25,
                 time_attr: str = "training_iteration", seed: int = 0,
                 ucb_kappa: float = 1.5):
        super().__init__(metric=metric, mode=mode,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations={},
                         quantile_fraction=quantile_fraction,
                         time_attr=time_attr, seed=seed)
        if not hyperparam_bounds:
            raise ValueError("PB2 requires hyperparam_bounds")
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self.log_keys = set(log_scale or ())
        self.kappa = ucb_kappa
        # Observations: (normalized config vector + time, improvement).
        self._obs_x: List[List[float]] = []
        self._obs_y: List[float] = []
        self._prev: Dict[Any, Dict[str, float]] = {}  # trial -> last point

    # ------------------------------------------------------- observations

    def _encode(self, config: Dict[str, Any], t: float) -> List[float]:
        x = []
        for k, (lo, hi) in sorted(self.bounds.items()):
            v = float(config.get(k, lo))
            if k in self.log_keys:
                import math

                v, lo, hi = (math.log10(max(v, 1e-300)),
                             math.log10(max(lo, 1e-300)),
                             math.log10(max(hi, 1e-300)))
            x.append((v - lo) / max(hi - lo, 1e-12))
        x.append(t)
        return x

    def on_result(self, trial, metrics: Dict[str, Any]) -> str:
        value = metrics.get(self.metric)
        t = metrics.get(self.time_attr, 0)
        if value is not None:
            prev = self._prev.get(trial)
            if prev is not None and t > prev["t"]:
                delta = float(value) - prev["value"]
                if self.mode == "min":
                    delta = -delta  # improvement is positive either way
                self._obs_x.append(self._encode(trial.config, prev["t"]))
                self._obs_y.append(delta / max(1.0, t - prev["t"]))
            self._prev[trial] = {"t": t, "value": float(value)}
        return super().on_result(trial, metrics)

    def exploit_target(self, trial):
        donor = super().exploit_target(trial)
        if donor is not None:
            # The exploiting trial's next report jumps to the donor's
            # cloned value — that delta is checkpoint copying, not the
            # new config's merit. Skip one observation interval so the
            # GP never attributes the jump to the perturbed config.
            self._prev.pop(trial, None)
        return donor

    # --------------------------------------------------------- GP + UCB

    def _gp_posterior(self, X, y, Xq):
        """Tiny exact-GP posterior (RBF kernel, unit signal, fixed noise)
        — population-scale data is dozens of points, numpy is plenty."""
        import numpy as np

        X = np.asarray(X, float)
        y = np.asarray(y, float)
        Xq = np.asarray(Xq, float)
        # Normalize time column to [0, 1] so one lengthscale fits all.
        tmax = max(X[:, -1].max(), Xq[:, -1].max(), 1.0)
        X = X.copy()
        Xq = Xq.copy()
        X[:, -1] /= tmax
        Xq[:, -1] /= tmax
        y_mu, y_sd = y.mean(), max(y.std(), 1e-9)
        yn = (y - y_mu) / y_sd
        ls = 0.3

        def k(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-d2 / (2 * ls * ls))

        K = k(X, X) + 1e-2 * np.eye(len(X))
        Kq = k(Xq, X)
        sol = np.linalg.solve(K, yn)
        mu = Kq @ sol
        var = 1.0 - np.einsum("ij,ji->i", Kq, np.linalg.solve(K, Kq.T))
        return mu * y_sd + y_mu, np.sqrt(np.maximum(var, 1e-12)) * y_sd

    def perturb_config(self, config: Dict[str, Any]) -> Dict[str, Any]:
        import numpy as np

        out = dict(config)
        keys = sorted(self.bounds)
        t_now = max((p["t"] for p in self._prev.values()), default=0.0)
        n_cand = 64
        rng = np.random.default_rng(self._rng.randrange(2 ** 31))
        cand_unit = rng.uniform(size=(n_cand, len(keys)))
        if len(self._obs_y) >= 4:
            Xq = np.concatenate(
                [cand_unit, np.full((n_cand, 1), t_now)], axis=1)
            mu, sd = self._gp_posterior(self._obs_x, self._obs_y, Xq)
            best = int(np.argmax(mu + self.kappa * sd))
        else:  # cold start: uniform random within bounds (like reference)
            best = 0
        for j, key in enumerate(keys):
            lo, hi = self.bounds[key]
            u = float(cand_unit[best, j])
            if key in self.log_keys:
                import math

                val = 10 ** (math.log10(lo) + u * (math.log10(hi)
                                                   - math.log10(lo)))
            else:
                val = lo + u * (hi - lo)
            out[key] = val
        return out
