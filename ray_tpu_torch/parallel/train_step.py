"""Train-step builder (port of ``ray_tpu/parallel/train_step.py``).

``build_train_step(loss_fn, optimizer)`` returns ``step(params, opt_state,
batch) -> (params, opt_state, metrics)``: gradients of ``loss_fn`` by
autograd, one optimizer update, and ``{"loss", "grad_norm", ...}``. The
JAX package jits the step with donated state; here the step runs eagerly
and the optimizer updates params and state in place (``ops/optim.py``),
which is what donation buys. Everything runs where the params live: the
builder picks no device itself.

One device only. The JAX builder runs the step under a mesh's axis rules
(DP/FSDP/TP/SP); a non-None ``mesh`` and the ZeRO-1 builders raise until
the meshes are ported (ROADMAP.md queue 1, item 3).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ray_tpu_torch.core.device import not_ported, resolve_device
from ray_tpu_torch.ops.optim import tree_leaves, tree_map

Params = Dict[str, Any]
_MESH_ITEM = "item 3, meshes with ring, Ulysses and MoE"


def _no_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise not_ported(f"{what} on a mesh", _MESH_ITEM)


def init_sharded_params(init_fn: Callable[[Any], Params], axes_tree: Any,
                        mesh=None, key: Any = None, rules=None) -> Params:
    """``init_fn(key)`` on one device (``key``: whatever ``init_fn`` takes
    for its randomness, e.g. a seed or a ``torch.Generator``). The device
    is ``init_fn``'s to choose (``init_params`` picks ``cuda`` unless told
    otherwise). ``axes_tree`` (``param_axes``) is accepted for the JAX
    signature and not read: with no mesh there is nothing to shard."""
    _no_mesh(mesh, "init_sharded_params")
    return init_fn(key)


def init_optimizer_state(optimizer, params: Params):
    """``optimizer.init(params)``: the state lives beside the params."""
    return optimizer.init(params)


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every leaf of ``tree``, in fp32."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(t.float().square().sum() for t in leaves))


def value_and_grad(loss_fn, params: Params, batch) -> Tuple[torch.Tensor,
                                                             Params]:
    """(loss, d loss / d params) with the grads in the params' tree, each
    in its param's dtype (as ``jax.value_and_grad``)."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, tree_leaves(live))
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def _check_device(params: Params) -> None:
    leaves = tree_leaves(params)
    dev = leaves[0].device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the train step runs on cuda or cpu, not {dev}")
    for t in leaves:
        if t.device != dev:
            raise ValueError(f"params are on {dev} and {t.device}")


def build_train_step(loss_fn: Callable[[Params, Dict[str, torch.Tensor]],
                                       torch.Tensor],
                     optimizer, mesh=None, rules=None,
                     extra_metrics: Optional[Callable] = None,
                     accum_steps: int = 1):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; params and opt_state are updated in place and returned.

    ``accum_steps > 1`` splits the batch's leading axis into that many
    microbatches and accumulates fp32 gradients before ONE optimizer
    update, as the JAX builder does: the fp32 params are cast to bf16 once,
    outside the microbatch loop (so each microbatch differentiates with
    respect to the bf16 copies), the fp32 sums are divided by
    ``accum_steps``, and the loss is the microbatches' mean.
    ``metrics["grad_norm"]`` is the global L2 norm of the gradients the
    update used. ``rules`` (the mesh's axis rules) has nothing to apply
    to without a mesh."""
    _no_mesh(mesh, "build_train_step")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def _grads_accum(params, batch):
        pbf = tree_map(lambda p: p.to(torch.bfloat16)
                       if p.dtype == torch.float32 else p, params)
        mbs = tree_map(lambda x: x.reshape(
            (accum_steps, x.shape[0] // accum_steps) + x.shape[1:]), batch)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        losses = []
        for i in range(accum_steps):
            loss, g = value_and_grad(loss_fn, pbf,
                                      tree_map(lambda x: x[i], mbs))
            tree_map(lambda a, b: a.add_(b.to(a.dtype)), grads, g)
            del g
            losses.append(loss)
        del pbf
        for g in tree_leaves(grads):
            g.div_(accum_steps)
        return torch.stack(losses).mean(), grads

    def step(params, opt_state, batch):
        _check_device(params)
        if accum_steps > 1:
            lead = {x.shape[0] for x in tree_leaves(batch)}
            if any(n % accum_steps for n in lead):
                raise ValueError(f"batch size {sorted(lead)} is not a "
                                 f"multiple of accum_steps {accum_steps}")
            loss, grads = _grads_accum(params, batch)
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        opt_state = optimizer.update(grads, opt_state, params)
        del grads
        if extra_metrics is not None:
            with torch.no_grad():
                metrics.update(extra_metrics(params, batch))
        return params, opt_state, metrics

    return step


def build_eval_step(loss_fn, mesh=None, rules=None):
    """``eval_step(params, batch) -> loss`` without autograd."""
    _no_mesh(mesh, "build_eval_step")

    def eval_step(params, batch):
        with torch.no_grad():
            return loss_fn(params, batch)

    return eval_step


def shard_batch(batch: Dict[str, Any], mesh=None, rules=None,
                device=None) -> Dict[str, torch.Tensor]:
    """Move every leaf of ``batch`` to ``device`` (``cuda`` unless the
    caller passes another; numpy arrays become tensors). With no mesh
    there is nothing to shard."""
    _no_mesh(mesh, "shard_batch")
    dev = resolve_device(device)
    return tree_map(lambda x: torch.as_tensor(x).to(dev), batch)


def init_zero1_opt_state(*args, **kwargs):
    raise not_ported("ZeRO-1 (init_zero1_opt_state)", _MESH_ITEM)


def build_zero1_train_step(*args, **kwargs):
    raise not_ported("ZeRO-1 (build_zero1_train_step)", _MESH_ITEM)
