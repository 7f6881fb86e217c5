"""Search spaces + variant generation (copy of ``ray_tpu/tune/search.py``).

Analogue of the reference's sample domains (``tune/search/sample.py``) and
``BasicVariantGenerator`` (grid + random sampling,
``tune/search/basic_variant.py``). Advanced searchers (Optuna/HyperOpt/...)
are external-library wrappers in the reference; the native core is this.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Uniform(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low, high):
        import math

        self.log_low, self.log_high = math.log(low), math.log(high)

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self.log_low, self.log_high))


class RandInt(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


def choice(categories) -> Categorical:
    return Categorical(categories)


def uniform(low, high) -> Uniform:
    return Uniform(low, high)


def loguniform(low, high) -> LogUniform:
    return LogUniform(low, high)


def randint(low, high) -> RandInt:
    return RandInt(low, high)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


def generate_variants(param_space: Dict[str, Any], num_samples: int,
                      seed: int = 0) -> List[Dict[str, Any]]:
    """Expand grid axes (cross product), then draw ``num_samples`` of the
    random domains for each grid point (reference semantics: num_samples
    multiplies the grid)."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in param_space.items()
                 if isinstance(v, GridSearch)]
    grids: List[Dict[str, Any]] = [{}]
    for k in grid_keys:
        grids = [dict(g, **{k: val}) for g in grids
                 for val in param_space[k].values]
    variants = []
    for g in grids:
        for _ in range(num_samples):
            cfg = dict(g)
            for k, v in param_space.items():
                if k in cfg:
                    continue
                cfg[k] = v.sample(rng) if isinstance(v, Domain) else v
            variants.append(cfg)
    return variants
