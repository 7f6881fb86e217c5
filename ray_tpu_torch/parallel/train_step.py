"""Train-step builder (port of ``ray_tpu/parallel/train_step.py``).

``build_train_step(loss_fn, optimizer)`` returns ``step(params, opt_state,
batch) -> (params, opt_state, metrics)``: gradients of ``loss_fn`` by
autograd, one optimizer update, and ``{"loss", "grad_norm", ...}``. The
JAX package jits the step with donated state; here the step runs eagerly
and the optimizer updates params and state in place (``ops/optim.py``),
which is what donation buys. Everything runs where the params live: the
builder picks no device itself.

With a ``mesh`` (``parallel.mesh``) params, optimizer state and batches
are DTensors placed by the rule tables (``init_sharded_params``,
``shard_batch``), and the step runs the model under ``axis_rules`` on the
mesh's ``compute_mesh``: DTensor inserts the collectives XLA inserts in
the JAX package (the all-gather of fsdp-sharded weights, the all-reduce
after a row-parallel product), the gradients are reduced onto the params'
placements, and the update runs on each rank's shards. ZeRO-1
(``build_zero1_train_step``) keeps the params replicated and shards the
optimizer state over the ``data`` axis: the gradients are reduce-scattered
onto the state's shards, each rank updates its shard, and the update is
all-gathered once a step into the replicated params.

The step keeps a step timeline (``serve.steplog.StepTimeline``, the
engine's class): with device spans on (``util.tracing``) one row a step,
its phases ``forward`` and ``backward`` a microbatch and ``optimizer``
(the gradient norm and the update), each with ``dev_ms``, and on the row
``lm_head_ce_ms``, the LM head and cross entropy forward, recompute and
backward. ``step.timeline()`` dumps it.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ray_tpu_torch.core.device import resolve_device
from ray_tpu_torch.ops.optim import tree_leaves, tree_map
from ray_tpu_torch.parallel.mesh import axis_sizes
from ray_tpu_torch.parallel.sharding import (
    ZERO1_STATE_RULES,
    NamedSharding,
    Rules,
    axis_rules,
    compute_mesh,
    distribute,
    on_mesh,
    placements_for,
    shard_tree,
    spec_for,
    tree_shardings,
)
from ray_tpu_torch.serve.steplog import StepTimeline
from ray_tpu_torch.util import tracing

Params = Dict[str, Any]
# Rows of a train step's timeline.
_TIMELINE_ROWS = 256
_PHASES = ("forward", "backward", "optimizer")


def _is_dtensor(t) -> bool:
    return hasattr(t, "device_mesh")


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value as a plain tensor (plain tensors pass)."""
    return t.full_tensor() if _is_dtensor(t) else t


def _map_state(fn: Callable, state):
    """``fn`` over the leaves of an optimizer state: NamedTuples (such as
    ``AdamWState``) and dicts are walked, anything else is a leaf."""
    if isinstance(state, dict):
        return {k: _map_state(fn, v) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_map_state(fn, v) for v in state))
    return fn(state)


def _tree_on_mesh(tree, mesh):
    """Every DTensor leaf of a params, batch or state tree on ``mesh``."""
    return _map_state(lambda t: on_mesh(t, mesh), tree)


def _redistribute(t, sharding: NamedSharding):
    """``t`` (a DTensor) with ``sharding``'s placements on its own mesh."""
    if not _is_dtensor(t):
        return t
    placements = placements_for(t.device_mesh, sharding.spec, t.shape)
    if tuple(t.placements) == placements:
        return t
    return t.redistribute(t.device_mesh, placements)


def init_sharded_params(init_fn: Callable[[Any], Params], axes_tree: Any,
                        mesh=None, key: Any = None, rules=None) -> Params:
    """``init_fn(key)`` (``key``: whatever ``init_fn`` takes for its
    randomness, e.g. a seed or a ``torch.Generator``), placed on ``mesh``
    by ``axes_tree`` (``param_axes``) under ``rules``: each rank keeps
    only its shards (the full tensors are dropped leaf by leaf). Without
    a mesh the params stay where ``init_fn`` put them."""
    params = init_fn(key)
    if mesh is None:
        return params
    return shard_tree(params, tree_shardings(mesh, axes_tree, rules))


def init_optimizer_state(optimizer, params: Params):
    """``optimizer.init(params)``: the state lives beside the params, with
    their placements on a mesh."""
    leaves = tree_leaves(params)
    if not leaves or not _is_dtensor(leaves[0]):
        return optimizer.init(params)
    mesh = leaves[0].device_mesh
    cmesh = compute_mesh(mesh)
    state = optimizer.init(_tree_on_mesh(params, cmesh))
    return _tree_on_mesh(state, mesh)


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
        leaves = tree_leaves(live)
        with tracing.device_span("forward", leaves[0].device):
            loss = loss_fn(live, batch)
        # A param the loss does not use (the MoE tree's dense w_down) gets
        # zeros, as in JAX.
        with tracing.device_span("backward", leaves[0].device):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
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


def _microbatches(batch, accum_steps: int):
    """The batch split on its leading axis into ``accum_steps`` global
    microbatches, rows ``[i * n, (i + 1) * n)`` as in the JAX builder
    (MoE routing fills its capacity per microbatch, so which rows meet
    matters); a DTensor leaf is gathered whole onto every rank once a
    step and each microbatch is placed as the leaf was (each rank slices
    its rows)."""
    def split(x):
        if not _is_dtensor(x):
            return x.reshape((accum_steps, x.shape[0] // accum_steps)
                             + x.shape[1:])
        full = x.full_tensor()
        n = full.shape[0] // accum_steps
        return [distribute(full[i * n:(i + 1) * n], x.device_mesh,
                           x.placements) for i in range(accum_steps)]

    return tree_map(split, batch)


def build_train_step(loss_fn: Callable[[Params, Dict[str, torch.Tensor]],
                                       torch.Tensor],
                     optimizer, mesh=None, rules: Optional[Rules] = None,
                     extra_metrics: Optional[Callable] = None,
                     accum_steps: int = 1, out_shardings=None):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; params and opt_state are updated in place and returned.

    ``accum_steps > 1`` splits the batch's leading axis into that many
    microbatches and accumulates fp32 gradients before ONE optimizer
    update, as the JAX builder does: the fp32 params are cast to bf16 once,
    outside the microbatch loop (so each microbatch differentiates with
    respect to the bf16 copies), the fp32 sums are divided by
    ``accum_steps``, and the loss is the microbatches' mean.
    ``metrics["grad_norm"]`` is the global L2 norm of the gradients the
    update used; both metrics are plain tensors.

    With ``mesh``, the step body runs under ``axis_rules(mesh, rules)``;
    the gradients are reduced onto the params' own placements before the
    update, and ``out_shardings`` (a ``(params, opt_state, metrics)``
    triple of trees of ``NamedSharding`` or None, as in the JAX builder)
    pins the layouts the step returns."""
    return _build_step(loss_fn, optimizer, mesh, rules, extra_metrics,
                       accum_steps, out_shardings, None)


def _build_step(loss_fn, optimizer, mesh, rules, extra_metrics, accum_steps,
                out_shardings, grad_shardings):
    """:func:`build_train_step`'s body, with the gradients reduced onto
    ``grad_shardings`` (a tree like the params') when it is given: the
    ZeRO-1 builder's reduce-scatter onto the state's shards."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    cmesh = None if mesh is None else compute_mesh(mesh)

    def _grads_accum(params, batch):
        pbf = tree_map(lambda p: p.to(torch.bfloat16)
                       if p.dtype == torch.float32 else p, params)
        mbs = _microbatches(batch, accum_steps)
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        losses = []
        for i in range(accum_steps):
            loss, g = value_and_grad(loss_fn, pbf,
                                      tree_map(lambda x: x[i], mbs))
            tree_map(lambda a, b: a.add_(_like(b.to(a.dtype), a)), grads, g)
            del g
            losses.append(_full(loss))
        del pbf
        for g in tree_leaves(grads):
            g.div_(accum_steps)
        return torch.stack(losses).mean(), grads

    def _body(params, opt_state, batch):
        _check_device(params)
        if accum_steps > 1:
            lead = {x.shape[0] for x in tree_leaves(batch)}
            if any(n % accum_steps for n in lead):
                raise ValueError(f"batch size {sorted(lead)} is not a "
                                 f"multiple of accum_steps {accum_steps}")
            loss, grads = _grads_accum(params, batch)
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        if grad_shardings is not None:
            grads = tree_map(_redistribute, grads, grad_shardings)
        else:
            grads = tree_map(_like, grads, params)
        with tracing.device_span("optimizer", tree_leaves(params)[0].device):
            metrics = {"loss": _full(loss),
                       "grad_norm": _full(global_norm(grads))}
            opt_state = optimizer.update(grads, opt_state, params)
        del grads
        if extra_metrics is not None:
            with torch.no_grad():
                metrics.update(extra_metrics(params, batch))
        return params, opt_state, metrics

    if mesh is None:
        if out_shardings is not None:
            raise ValueError("out_shardings needs a mesh")
        return _timed(_body)

    def step(params, opt_state, batch):
        from torch.distributed.tensor.experimental import implicit_replication

        with axis_rules(cmesh, rules), implicit_replication():
            _, state, metrics = _body(
                _tree_on_mesh(params, cmesh),
                _tree_on_mesh(opt_state, cmesh),
                _tree_on_mesh(batch, cmesh))
            opt_state = _tree_on_mesh(state, mesh)
            if out_shardings is not None:
                params = _pin(params, out_shardings[0])
                opt_state = _pin(opt_state, out_shardings[1])
        return params, opt_state, metrics

    return _timed(step)


def _timed(run):
    """``run`` with a step timeline: while device spans are on, each call
    is one row of ``forward`` / ``backward`` / ``optimizer`` phases (the
    spans ``run`` opens), read through ``timed.timeline()``."""
    timeline = StepTimeline(_TIMELINE_ROWS)
    count = itertools.count()

    def timed(params, opt_state, batch):
        if not tracing.device_spans_on:
            return run(params, opt_state, batch)
        t0 = time.time()
        with tracing.device_span("step", tree_leaves(params)[0].device) as row:
            out = run(params, opt_state, batch)
        phases, spans, forwards = [], [], 0
        for span in row.children:
            if span.name not in _PHASES:
                continue
            phase = {"phase": span.name, "t0": span.t0, "t1": span.t1}
            forwards += span.name == "forward"
            if span.name != "optimizer":
                phase["microbatch"] = forwards - 1
            phases.append(phase)
            spans.append((phase, span))
        timeline.record(next(count), t0, time.time(), phases,
                        active=len(tree_leaves(batch)[0]), prefilling=0,
                        queued=0, spans=spans, row_span=row)
        return out

    timed.timeline = timeline.dump
    return timed


def _like(g, p):
    """Gradient ``g`` reduced onto param ``p``'s placements."""
    if not _is_dtensor(g) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(g.device_mesh, p.placements)


def _pin(tree, shardings):
    """``tree``'s DTensor leaves moved to ``shardings`` (None: as they
    are); the JAX ``out_shardings``."""
    if shardings is None:
        return tree
    if isinstance(shardings, NamedSharding):
        return _map_state(lambda t: _redistribute(t, shardings), tree)
    if isinstance(tree, dict):
        return {k: _pin(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_pin(v, s) for v, s in zip(tree, shardings)))
    return _redistribute(tree, shardings)


# --------------------------------------------------------------- ZeRO-1


def zero1_state_shardings(mesh, opt_state: Any,
                          zero1_rules: Optional[Rules] = None):
    """``NamedSharding``s for an optimizer-state tree (concrete tensors or
    ``meta`` ones): each tensor leaf shards its FIRST dim divisible by the
    ZeRO-1 axis over it; leaves with no such dim (the step count, tiny
    norms) replicate. ``zero1_rules`` is the ZeRO-1 STATE table (default
    ``ZERO1_STATE_RULES``); a table without ``zero1_shard`` (a model-axis
    table passed by mistake) is rejected rather than silently
    replicating the state."""
    table = zero1_rules or ZERO1_STATE_RULES
    if "zero1_shard" not in table:
        raise ValueError(
            "ZeRO-1 state table has no 'zero1_shard' key — this looks "
            "like a model-axis rules table passed where the state "
            "table belongs (the state would silently replicate); pass "
            "it as rules=, and the state table as zero1_rules=")
    mesh_ax = table.get("zero1_shard")
    n = axis_sizes(mesh).get(mesh_ax, 1) if isinstance(mesh_ax, str) else 1

    def leaf(x):
        if n > 1:
            for dim, size in enumerate(getattr(x, "shape", ())):
                if size >= n and size % n == 0:
                    return NamedSharding(mesh, (None,) * dim + (mesh_ax,))
        return NamedSharding(mesh, ())

    return _map_state(leaf, opt_state)


def _replicated_on(params: Params, mesh) -> Params:
    """The params as DTensors on ``mesh``: plain tensors become replicated
    ones (sharing memory); DTensors must be on ``mesh`` already."""
    from torch.distributed.tensor import Replicate

    def one(t):
        if _is_dtensor(t):
            return t
        return distribute(t, mesh, [Replicate()] * mesh.ndim)

    return tree_map(one, params)


def init_zero1_opt_state(optimizer, params: Params, mesh,
                         zero1_rules: Optional[Rules] = None):
    """``optimizer.init`` with every state leaf created already sharded
    over the ZeRO-1 axis: the init runs on each rank's slices of the
    replicated params, so no rank ever holds the full state."""
    params = _replicated_on(params, mesh)
    cmesh = compute_mesh(mesh)
    shardings = zero1_state_shardings(mesh, params, zero1_rules)
    shards = tree_map(lambda p, s: _redistribute(on_mesh(p, cmesh), s),
                      params, shardings)
    state = optimizer.init(shards)
    return _tree_on_mesh(
        _pin(state, zero1_state_shardings(cmesh, state, zero1_rules)), mesh)


def build_zero1_train_step(loss_fn, optimizer, mesh, params: Params,
                           rules: Optional[Rules] = None,
                           zero1_rules: Optional[Rules] = None,
                           extra_metrics: Optional[Callable] = None,
                           accum_steps: int = 1):
    """ZeRO-1 twin of :func:`build_train_step`: the same step body, with
    the gradients reduce-scattered onto the state's ZeRO-1 shards and the
    outputs pinned: params REPLICATED (the update all-gathered once a
    step), optimizer state sharded per :func:`zero1_state_shardings`.
    ``params`` is only read for its structure and shapes.

    ``rules`` (the model-axis table the step body runs under) and
    ``zero1_rules`` (the state table, default ``ZERO1_STATE_RULES``) are
    distinct namespaces, as in the JAX package."""
    meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), params)
    opt_shardings = zero1_state_shardings(mesh, optimizer.init(meta),
                                          zero1_rules)
    rep = NamedSharding(mesh, ())
    param_shardings = tree_map(lambda _: rep, params)
    step = _build_step(
        loss_fn, optimizer, mesh, rules, extra_metrics, accum_steps,
        (param_shardings, opt_shardings, None),
        zero1_state_shardings(mesh, params, zero1_rules))

    def zero1_step(params, opt_state, batch):
        return step(_replicated_on(params, mesh), opt_state, batch)

    return zero1_step


def per_replica_state_bytes(opt_state) -> int:
    """The WORST rank's resident optimizer-state bytes: each rank sums the
    bytes of its local shards over every state leaf (a replicated leaf
    charges its full size, a ZeRO-1 leaf 1/N), and the maximum over the
    ranks is returned on every rank."""
    import torch.distributed as dist

    total, device, sharded = 0, None, False
    for leaf in _leaves(opt_state):
        if not isinstance(leaf, torch.Tensor):
            continue
        local = leaf.to_local() if _is_dtensor(leaf) else leaf
        sharded = sharded or _is_dtensor(leaf)
        total += local.numel() * local.element_size()
        device = local.device
    if sharded and dist.is_initialized() and dist.get_world_size() > 1:
        t = torch.tensor([total], dtype=torch.int64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        total = int(t.item())
    return total


def _leaves(state):
    out = []
    _map_state(out.append, state)
    return out


def build_eval_step(loss_fn, mesh=None, rules: Optional[Rules] = None):
    """``eval_step(params, batch) -> loss`` without autograd (under the
    mesh's ``axis_rules`` when there is one; the loss comes back as a
    plain tensor)."""
    if mesh is None:
        def eval_step(params, batch):
            with torch.no_grad():
                return loss_fn(params, batch)

        return eval_step
    cmesh = compute_mesh(mesh)

    def mesh_eval_step(params, batch):
        from torch.distributed.tensor.experimental import implicit_replication

        with torch.no_grad(), axis_rules(cmesh, rules), \
                implicit_replication():
            return _full(loss_fn(_tree_on_mesh(params, cmesh),
                                 _tree_on_mesh(batch, cmesh)))

    return mesh_eval_step


def batch_spec(ndim: int, rules: Optional[Rules] = None):
    """(batch, length) for rank >= 2 leaves, batch only for rank-1 ones
    (labels, weights: image batches mix ranks)."""
    return spec_for(("batch",) if ndim <= 1 else ("batch", "length"), rules)


def shard_batch(batch: Dict[str, Any], mesh=None, rules=None,
                device=None) -> Dict[str, torch.Tensor]:
    """Batch-shard every leaf over ``mesh`` (each leaf holds the full
    global batch on every rank; each rank keeps its rows, with no
    communication). Without a mesh, move every leaf to ``device``
    (``cuda`` unless the caller passes another; numpy arrays become
    tensors)."""
    if mesh is None:
        dev = resolve_device(device)
        return tree_map(lambda x: torch.as_tensor(x).to(dev), batch)

    def put(x):
        x = torch.as_tensor(x)
        return distribute(x, mesh, placements_for(
            mesh, batch_spec(x.ndim, rules), x.shape))

    return tree_map(put, batch)
