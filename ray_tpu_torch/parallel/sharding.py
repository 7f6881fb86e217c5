"""Logical-axis sharding rules (port of ``ray_tpu/parallel/sharding.py``).

Tensors carry logical axis names (``("vocab", "embed")``); a rule table
maps each to a mesh axis, a tuple of mesh axes or None (replicate). The
JAX package turns the result into a ``NamedSharding``; here it becomes
DTensor placements on a ``DeviceMesh`` (``placements_for``), ``constrain``
is a ``redistribute`` and ``shard_map`` is an explicit ``to_local`` /
``from_local`` pair around a function of local tensors.

Two rules carry over exactly: a tuple axis such as ``batch -> ("data",
"fsdp")`` shards data-major (DTensor splits a tensor dim over several
mesh dims in mesh order, and ``data`` comes first), and a mesh axis that
does not divide the dim replicates it, where DTensor would accept an
uneven shard.

The model runs on DTensors of the mesh's ``compute_mesh``: the same ranks
with only the axes larger than one. Sharding propagation enumerates its
strategies over every mesh dim, so size-1 axes would cost it time for
nothing; ``on_mesh`` moves a DTensor between the two meshes without a
copy.

Serving on a decode mesh takes no DTensor: each rank keeps its local
shard of every weight and of the KV state as a plain tensor
(``shard_local``), and the model gathers at the points where the JAX
package's ``constrain`` sites replicate a dim (``LocalShards``,
``gather_local``), a no-op outside ``local_shards``.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from ray_tpu_torch.parallel.mesh import axis_sizes

Rules = Dict[str, Union[str, Tuple[str, ...], None]]
Spec = Tuple[Any, ...]

# Megatron-style transformer rules: batch over (data, fsdp), weights'
# embed dim over fsdp (ZeRO-3), heads / mlp / vocab over tensor, length
# over seq (ring attention), experts over expert. ``attn_heads`` and
# ``mlp_hidden`` anchor the inputs of the two row-parallel contractions.
DEFAULT_RULES: Rules = {
    "batch": ("data", "fsdp"),
    "length": "seq",
    "vocab": "tensor",
    "embed": "fsdp",
    "act_embed": None,
    "heads": "tensor",
    "kv_heads": "tensor",
    "head_dim": None,
    "mlp": "tensor",
    "attn_heads": "tensor",
    "mlp_hidden": "tensor",
    "experts": "expert",
    "expert": "expert",
    "expert_dim": None,
    "layers": None,
    "norm": None,
    "patch": None,
}

# Serving rules over the 2-axis decode mesh (``mesh.DECODE_AXES``): no
# contraction dim is ever partitioned; the pre-contraction anchors
# replicate, so sharded logits keep the single-chip reduction order.
DECODE_RULES: Rules = {
    "batch": "batch",
    "length": None,
    "vocab": "model",
    "embed": None,
    "act_embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "attn_heads": None,
    "mlp_hidden": None,
    "layers": None,
    "norm": None,
    "patch": None,
}

# ZeRO-1 optimizer-state overlay: the state shards over ``data`` under a
# state-only logical name, so it can never partition a model contraction.
ZERO1_STATE_RULES: Rules = {
    "zero1_shard": "data",
}


def spec_for(logical_axes: Optional[Sequence[Optional[str]]],
             rules: Optional[Rules] = None) -> Spec:
    """The JAX ``PartitionSpec`` entries for ``logical_axes`` as a tuple
    (trailing Nones trimmed); ``None`` (the whole tuple) is replicated."""
    if logical_axes is None:
        return ()
    rules = rules or DEFAULT_RULES
    parts = []
    for ax in logical_axes:
        if ax is None:
            parts.append(None)
        else:
            if ax not in rules:
                raise KeyError(f"no sharding rule for logical axis {ax!r}")
            parts.append(rules[ax])
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements_for(mesh, spec: Spec,
                   shape: Optional[Sequence[int]] = None) -> tuple:
    """DTensor placements on ``mesh`` for a ``spec_for`` spec: ``Shard(d)``
    on every mesh dim that tensor dim ``d`` is split over, ``Replicate()``
    elsewhere. Mesh axes the mesh lacks, or has at size 1, replicate (the
    same layout, and DTensor reshapes a replicated dim freely). With
    ``shape``, a dim whose mesh axes do not divide it replicates."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = axis_sizes(mesh)
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = [a for a in (part if isinstance(part, tuple) else (part,))
                if sizes.get(a, 1) > 1]
        if shape is not None and shape[dim] % math.prod(
                sizes[a] for a in axes):
            continue
        for a in axes:
            out[names.index(a)] = Shard(dim)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: the JAX ``NamedSharding``. Its placements depend
    on the tensor's shape (``placements``), through the divisibility
    rule."""

    mesh: Any
    spec: Spec

    def placements(self, shape: Sequence[int]) -> tuple:
        return placements_for(self.mesh, self.spec, shape)


def _is_axes(x) -> bool:
    return x is None or isinstance(x, tuple)


def tree_shardings(mesh, axes_tree: Any, rules: Optional[Rules] = None):
    """Map a tree of logical-axis tuples to ``NamedSharding``s."""
    if _is_axes(axes_tree):
        return NamedSharding(mesh, spec_for(axes_tree, rules))
    return {k: tree_shardings(mesh, v, rules) for k, v in axes_tree.items()}


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def distribute(x, mesh, placements):
    """A DTensor of ``x`` (a tensor or array, the same full value on every
    rank) with ``placements``: each rank keeps its own slice, with no
    communication."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    t = torch.as_tensor(x).to(mesh_device(mesh))
    d = distribute_tensor(t, mesh, placements, src_data_rank=None)
    local = d.to_local()
    if local.numel() == t.numel():
        return d
    # A shard may be a view of the full tensor: keep only the shard.
    return DTensor.from_local(local.clone(), mesh, d.placements,
                              run_check=False, shape=d.shape,
                              stride=d.stride())


def shard_tree(tree: Any, shardings: Any):
    """Place every leaf of ``tree`` with the matching ``NamedSharding``."""
    if isinstance(tree, dict):
        return {k: shard_tree(tree[k], shardings[k]) for k in tree}
    return distribute(tree, shardings.mesh,
                      shardings.placements(tuple(tree.shape)))


def decode_rules(config, mesh) -> Rules:
    """``DECODE_RULES`` for a config and a decode mesh (or a mapping of
    axis sizes): a dim shards over "model" only when its size divides the
    axis, and indivisible kv heads replicate the heads with them."""
    model = axis_sizes(mesh).get("model", 1)
    rules = dict(DECODE_RULES)
    if model > 1:
        for axis, size in (("heads", config.n_heads),
                           ("kv_heads", config.n_kv_heads),
                           ("mlp", config.mlp_dim),
                           ("vocab", config.vocab_size)):
            if size % model:
                rules[axis] = None
        if rules["kv_heads"] is None:
            rules["heads"] = None
    return rules


_ctx = threading.local()


@contextmanager
def axis_rules(mesh, rules: Optional[Rules] = None):
    """The (mesh, rules) context under which ``constrain`` resolves logical
    axes; the train step runs the model inside it."""
    prev = getattr(_ctx, "value", None)
    _ctx.value = (mesh, rules or DEFAULT_RULES)
    try:
        yield
    finally:
        _ctx.value = prev


def current_rules() -> Optional[Rules]:
    ctx = getattr(_ctx, "value", None)
    return None if ctx is None else ctx[1]


def current_mesh():
    ctx = getattr(_ctx, "value", None)
    return None if ctx is None else ctx[0]


def constrain(x, logical_axes: Sequence[Optional[str]]):
    """Redistribute a DTensor to the placements of ``logical_axes`` under
    the active rules; a no-op outside ``axis_rules`` and on plain tensors
    (one device, or the local body of ``shard_map``). A mesh axis that
    does not divide the tensor's dim replicates that dim."""
    ctx = getattr(_ctx, "value", None)
    if ctx is None or not hasattr(x, "device_mesh"):
        return x
    placements = placements_for(x.device_mesh,
                                spec_for(logical_axes, ctx[1]), x.shape)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def batch_sharding(mesh, rules: Optional[Rules] = None) -> NamedSharding:
    """Sharding for (batch, length, ...) input batches."""
    return NamedSharding(mesh, spec_for(("batch", "length"), rules))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


# ------------------------------------------------------- compute mesh


def compute_mesh(mesh):
    """The sub-mesh of ``mesh``'s axes larger than one (its first axis
    when none is): the mesh the model's DTensors live on. Cached on the
    mesh, since slicing makes process groups."""
    cached = getattr(mesh, "_rtt_compute_mesh", None)
    if cached is not None:
        return cached
    names = tuple(n for n, s in zip(mesh.mesh_dim_names, mesh.shape) if s > 1)
    names = names or mesh.mesh_dim_names[:1]
    out = mesh if names == tuple(mesh.mesh_dim_names) else mesh[names]
    mesh._rtt_compute_mesh = out
    return out


def on_mesh(t, mesh):
    """DTensor ``t`` on ``mesh`` (the same ranks, a subset or superset of
    its axes; the axes in one and not the other have size 1), sharing its
    local tensor. Plain tensors pass through."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor) or t.device_mesh is mesh:
        return t
    src = dict(zip(t.device_mesh.mesh_dim_names, t.placements))
    placements = [src.get(n, Replicate()) for n in mesh.mesh_dim_names]
    return DTensor.from_local(t.to_local(), mesh, placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def shard_map(fn: Callable, mesh, in_specs: Sequence[Spec],
              out_specs: Union[Spec, Sequence[Spec]]):
    """The JAX ``shard_map``: ``fn`` of local tensors over ``mesh``
    (``out_specs`` a list of specs when ``fn`` returns several tensors).
    Each input is redistributed to its spec's placements and handed over
    as its local shard; each output shard becomes a DTensor with its
    spec's placements, on ``compute_mesh(mesh)``. Plain-tensor inputs are
    taken as the same full value on every rank, and then the outputs come
    back as full plain tensors. Every step is differentiable. The specs
    must divide the shapes (as in the JAX package, where they must)."""
    from torch.distributed.tensor import DTensor, Replicate

    multi = isinstance(out_specs, list)
    mesh = compute_mesh(mesh)

    def wrapped(*args):
        plain = not any(isinstance(a, DTensor) for a in args)
        local = []
        for a, spec in zip(args, in_specs):
            if isinstance(a, DTensor):
                d = on_mesh(a, mesh)
            else:
                d = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
            placements = placements_for(mesh, spec)
            if tuple(d.placements) != placements:
                d = d.redistribute(mesh, placements)
            local.append(d.to_local())
        out = fn(*local)
        outs = list(out) if multi else [out]
        specs = out_specs if multi else [out_specs]
        res = [DTensor.from_local(o, mesh, placements_for(mesh, s),
                                  run_check=False)
               for o, s in zip(outs, specs)]
        if plain:
            res = [r.full_tensor() for r in res]
        return tuple(res) if multi else res[0]

    return wrapped


# ------------------------------------------------ local shards (serving)
#
# The decode mesh runs the serving functions on plain local tensors: each
# rank holds its block of every sharded dim, and the model all-gathers
# where the rules replicate a dim the tensor is sharded on (before ``wo``,
# before ``w_down``, over the vocab before sampling, over the batch for
# outputs every rank needs). No contraction dim is ever split, so every
# output element is computed in the single-device order, and a gather
# only moves bits.

# Decode-state layouts, the JAX ``decode_shardings``: contiguous KV rows
# shard slots over "batch" and kv heads over "model"; the paged pool and
# the contiguous prefix pool shard only kv heads, so every batch rank
# holds every page; the per-slot ``length`` cursor is replicated.
KV_ROW_AXES = ("layers", "batch", None, "kv_heads", "head_dim")
POOL_AXES = ("layers", None, None, "kv_heads", "head_dim")
LENGTH_AXES: Spec = ()


def decode_state_shardings(mesh, rules: Rules) -> Dict[str, Any]:
    """``NamedSharding``s of the decode state on ``mesh``: the contiguous
    cache, the paged pool, the contiguous prefix pool and the replicated
    host-facing outputs."""
    def ns(axes):
        return NamedSharding(mesh, spec_for(axes, rules))

    rep = NamedSharding(mesh, ())
    return {"cache": {"k": ns(KV_ROW_AXES), "v": ns(KV_ROW_AXES),
                      "length": rep},
            "pool": {"k": ns(POOL_AXES), "v": ns(POOL_AXES),
                     "length": rep},
            "prefix_pool": {"k": ns(POOL_AXES), "v": ns(POOL_AXES)},
            "replicated": rep}


class LocalShards:
    """This rank's view of a decode mesh under a rule table: the mesh axis
    each logical axis shards over (axes of size one never shard), this
    rank's block of such a dim, and the collectives over that axis's
    process group. Dims split into equal blocks in mesh order, as
    ``Shard(d)`` splits them; a dim the axis does not divide stays whole
    (``block``), and is never padded."""

    def __init__(self, mesh, rules: Rules):
        self.mesh = mesh
        self.rules = rules
        self.sizes = axis_sizes(mesh)
        self.index = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        self._groups = {a: mesh.get_group(a)
                        for a, s in self.sizes.items() if s > 1}

    def axis(self, logical: Optional[str]) -> Optional[str]:
        """The mesh axis (larger than one) ``logical`` shards over."""
        part = None if logical is None else self.rules[logical]
        if isinstance(part, tuple):
            raise ValueError(f"local shards take one mesh axis a logical "
                             f"axis, {logical!r} maps to {part}")
        return part if part is not None and self.sizes[part] > 1 else None

    def parts(self, logical: Optional[str], n: Optional[int] = None) -> int:
        """How many blocks ``logical`` splits a dim of ``n`` into."""
        a = self.axis(logical)
        if a is None or (n is not None and n % self.sizes[a]):
            return 1
        return self.sizes[a]

    def block(self, n: int, logical: Optional[str]) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of a dim of ``n`` split by ``logical``."""
        p = self.parts(logical, n)
        if p == 1:
            return 0, n
        i = self.index[self.axis(logical)]
        return i * n // p, (i + 1) * n // p

    def local_shape(self, shape: Sequence[int],
                    axes: Sequence[Optional[str]]) -> Tuple[int, ...]:
        """This rank's shard shape of a tensor of ``shape`` laid out by
        ``axes``."""
        return tuple(hi - lo for lo, hi in (
            self.block(n, a) for n, a in zip(shape, axes)))

    def take(self, x: torch.Tensor, dim: int,
             logical: Optional[str]) -> torch.Tensor:
        """This rank's block of the full ``x`` along ``dim`` (a view)."""
        lo, hi = self.block(x.shape[dim], logical)
        return x if hi - lo == x.shape[dim] else x.narrow(dim, lo, hi - lo)

    def gather(self, x: torch.Tensor, dim: int,
               logical: Optional[str]) -> torch.Tensor:
        """The whole dim from each rank's block along ``dim``."""
        a = self.axis(logical)
        if a is None:
            return x
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(self.sizes[a])]
        dist.all_gather(parts, x.contiguous(), group=self._groups[a])
        return torch.cat(parts, dim)

    def gather_rows(self, x: torch.Tensor, logical: Optional[str],
                    counts: Sequence[int]) -> torch.Tensor:
        """Dim 0 from blocks of ``counts[j]`` rows on the ``j``-th rank of
        ``logical``'s axis (uneven, some possibly empty): each block is
        padded to the largest, gathered and cut back."""
        a = self.axis(logical)
        if a is None:
            return x
        import torch.distributed as dist

        most = max(counts)
        pad = x.new_zeros((most,) + tuple(x.shape[1:]))
        pad[:x.shape[0]] = x
        parts = [torch.empty_like(pad) for _ in counts]
        dist.all_gather(parts, pad, group=self._groups[a])
        return torch.cat([p[:n] for p, n in zip(parts, counts)])

    def sum(self, x: torch.Tensor, logical: Optional[str]) -> torch.Tensor:
        """The sum over ``logical``'s axis (in place)."""
        a = self.axis(logical)
        if a is not None:
            import torch.distributed as dist

            dist.all_reduce(x, group=self._groups[a])
        return x

    def broadcast(self, x: torch.Tensor, logical: Optional[str],
                  src: int) -> torch.Tensor:
        """``x`` from the rank at index ``src`` of ``logical``'s axis (in
        place, on every rank of the axis)."""
        a = self.axis(logical)
        if a is not None:
            import torch.distributed as dist

            group = self._groups[a]
            dist.broadcast(x, src=dist.get_global_rank(group, src),
                           group=group)
        return x


_local = threading.local()


@contextmanager
def local_shards(shards: Optional[LocalShards]):
    """Run the serving functions on this rank's local shards."""
    prev = getattr(_local, "value", None)
    _local.value = shards
    try:
        yield
    finally:
        _local.value = prev


def current_shards() -> Optional[LocalShards]:
    return getattr(_local, "value", None)


def gather_local(x: torch.Tensor, dim: int,
                 logical: Optional[str]) -> torch.Tensor:
    """All-gather ``x``'s ``dim``, sharded by ``logical``, under
    ``local_shards``; ``x`` itself outside it (one device, or DTensors)."""
    shards = current_shards()
    return x if shards is None else shards.gather(x, dim, logical)


def shard_local(tree: Any, axes_tree: Any, shards: LocalShards,
                take: Optional[Callable] = None) -> Any:
    """This rank's shard of every leaf of a tree of full tensors, by the
    matching tree of logical axes. A leaf that is a strict block of its
    tensor is copied, so the full tensor can be freed; a whole one is
    returned as is. ``take(path, leaf, axes)`` may return a leaf's shard
    itself (fused projections), or None for the default."""
    def go(t, axes, path):
        if isinstance(t, dict):
            return {k: go(t[k], axes[k], f"{path}{k}/") for k in t}
        x = take(path[:-1], t, axes) if take is not None else None
        if x is None:
            x = t
            for dim, logical in enumerate(axes or ()):
                x = shards.take(x, dim, logical)
        return x.clone() if x.numel() < t.numel() else x

    return go(tree, axes_tree, "")
