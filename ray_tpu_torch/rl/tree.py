"""Tree helpers of the RL plane: the stand-ins for ``jax.tree.map``,
``jax.value_and_grad``, ``jax.device_get`` / ``device_put`` and
``optax.adam`` that the JAX package's RL modules use.

A tree is nested dicts, lists and tuples (NamedTuples keep their type)
with tensors (or other values) at the leaves; dict keys are walked in
sorted order, as ``jax.tree`` walks them. Params trees hold only tensors.
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch

from ray_tpu_torch.ops.optim import AdamWState, adamw


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _on(device):
    return lambda x: x.to(device) if isinstance(x, torch.Tensor) else x


def to_device(tree, device):
    """Every tensor of ``tree`` on ``device`` (other leaves as they are)."""
    return tree_map(_on(device), tree)


def host(tree):
    """A CPU copy of every tensor of ``tree`` (``jax.device_get``)."""
    return tree_map(lambda x: x.detach().to("cpu", copy=True)
                    if isinstance(x, torch.Tensor) else x, tree)


def clone(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


def own(tree):
    """A private CPU copy of a weights tree that arrived through the object
    store (read-only views of the sealed object) or as numpy leaves."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        return torch.from_numpy(np.array(x))

    return tree_map(one, tree)


def as_tensor(x, device) -> torch.Tensor:
    """A batch leaf on ``device``: numpy keeps its dtype except float64,
    which lands as float32 (the JAX package runs with x64 off)."""
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.asarray(x)
        if not (a.flags.writeable and a.flags.c_contiguous):
            a = np.array(a)
        t = torch.from_numpy(a)
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t.to(device)


def batch_to(batch: dict, device) -> dict:
    return {k: as_tensor(v, device) for k, v in batch.items()}


def value_and_grad(fn: Callable, params, *args, has_aux: bool = False):
    """``jax.value_and_grad(fn, has_aux=...)(params, *args)``: the loss
    (and detached aux) and the gradient tree of ``params`` alone. Leaves
    the loss does not reach get zero gradients, as in JAX."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    out = fn(unflatten(params, live), *args)
    loss, aux = out if has_aux else (out, None)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    aux = tree_map(lambda x: x.detach() if isinstance(x, torch.Tensor)
                   else x, aux)
    value = (loss.detach(), aux) if has_aux else loss.detach()
    return value, unflatten(params, grads)


def _flat(tree) -> dict:
    return {f"{i:06d}": t for i, t in enumerate(tree_leaves(tree))}


class Adam:
    """``optax.adam(lr)``: the port's ``adamw(lr)`` with no weight decay
    over the leaves of a tree (lists included). ``update`` writes the
    params in place and returns the new state."""

    def __init__(self, learning_rate: float):
        self._opt = adamw(learning_rate, weight_decay=0.0)

    def init(self, params) -> AdamWState:
        return self._opt.init(_flat(params))

    def update(self, grads, state: AdamWState, params) -> AdamWState:
        return self._opt.update(_flat(grads), state, _flat(params))


def adam(learning_rate: float) -> Adam:
    return Adam(learning_rate)
