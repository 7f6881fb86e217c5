"""AdamW (port of ``ray_tpu/ops/optim.py``).

``adamw`` returns an ``(init, update)`` pair with the JAX function's math:
bias correction from the step count, a learning rate that may be a
callable of that count, decoupled weight decay applied with the learning
rate (``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``), mu kept in
``mu_dtype`` and nu in the param dtype. The JAX package has no Pallas
kernel here (XLA fuses the elementwise pass), so the port is plain tensor
code, one loop over the leaves (the Llama params are a dozen stacked
tensors, so the loop costs nothing beside the elementwise work).

Where the JAX ``update`` returns updates and new state and leaves the
params to ``optax.apply_updates`` under buffer donation, ``update`` here
writes params, mu and nu in place and returns the state: no second copy
of the model or of the optimizer state is ever allocated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import torch

Params = Dict[str, Any]


class AdamWState(NamedTuple):
    count: int               # updates applied so far
    mu: Params               # first moments, in mu_dtype (or the param's)
    nu: Params               # second moments, in the param dtype


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict, in sorted key order."""
    if not isinstance(tree, dict):
        return [tree]
    return [t for k in sorted(tree) for t in tree_leaves(tree[k])]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure,
    called in ``tree_leaves`` order."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            for k in sorted(tree)}


@dataclass(frozen=True)
class AdamW:
    """The ``init`` / ``update`` pair that :func:`adamw` returns."""

    learning_rate: Union[float, Callable[[int], float]]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    mu_dtype: Optional[torch.dtype] = None

    def init(self, params: Params) -> AdamWState:
        return AdamWState(
            count=0,
            mu=tree_map(lambda p: torch.zeros_like(
                p, dtype=self.mu_dtype or p.dtype), params),
            nu=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState,
               params: Params) -> AdamWState:
        """One AdamW step: ``params``, ``state.mu`` and ``state.nu`` are
        updated in place; returns the state with the count advanced."""
        count = state.count + 1
        lr = (self.learning_rate(count) if callable(self.learning_rate)
              else self.learning_rate)
        c1 = 1.0 - self.b1 ** count
        c2 = 1.0 - self.b2 ** count
        ps, gs = tree_leaves(params), tree_leaves(grads)
        ms, vs = tree_leaves(state.mu), tree_leaves(state.nu)
        for p, g, m, v in zip(ps, gs, ms, vs):
            # Each leaf's math runs in nu's (the param's) dtype, as the JAX
            # leaf casts g and m to v.dtype.
            g = g.to(v.dtype)
            m32 = m.to(v.dtype) if m.dtype != v.dtype else m
            m32.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            if m32 is not m:
                m.copy_(m32)
            upd = (m32 / c1).div_(torch.sqrt(v / c2).add_(self.eps))
            if self.weight_decay:
                upd.add_(p.to(v.dtype), alpha=self.weight_decay)
            p.add_(upd.mul_(-lr).to(p.dtype))
        return AdamWState(count=count, mu=state.mu, nu=state.nu)


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          mu_dtype: Optional[torch.dtype] = None) -> AdamW:
    """AdamW with the JAX package's math (see the module docstring);
    ``learning_rate`` is a float or a callable of the step count."""
    return AdamW(learning_rate, b1, b2, eps, weight_decay, mu_dtype)
