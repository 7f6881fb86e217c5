"""Streaming distributed datasets on object-store blocks (port of
``ray_tpu/data/dataset.py``).

Analogue of the reference's Ray Data core (``data/dataset.py``:
``map_batches`` :368, ``iter_batches`` :3599, ``streaming_split`` :1211,
``materialize`` :4479 over the lazy logical plan + ``StreamingExecutor``,
``_internal/execution/streaming_executor.py:48``): a ``Dataset`` is a lazy
chain of operators over *blocks* (dicts of numpy column arrays) stored as
object refs; execution streams blocks through tasks with a bounded in-flight
window (backpressure), so datasets larger than memory flow through the
shared-memory store block by block.

Batch iteration can pad to static shapes (``iter_batches(..., pad_to=...)``)
so a train step sees one batch shape. Blocks and the ops over them stay
numpy: data tasks run on CPU workers that see no card, and nothing here
touches CUDA but ``iter_device_batches``, which hands the batches to
``data/ingest.py::device_prefetch``.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    Block,
    Schema,
    block_len as _block_len,
    block_nbytes as _block_nbytes,
    concat_blocks as _concat_blocks,
    slice_block as _slice_block,
    wrap_batch_fn,
)


# ----------------------------------------- shuffle/repartition exchanges

@ray_tpu_torch.remote
def _count_block(block: Block) -> int:
    return _block_len(block)


@ray_tpu_torch.remote
def _slice_for_ranges(block: Block, offset: int, bounds: List[int]):
    """Map half of the repartition exchange: this block covers global rows
    [offset, offset+n); emit its intersection with each output range."""
    n = _block_len(block)
    out = []
    for lo, hi in zip(bounds, bounds[1:]):
        s = max(lo - offset, 0)
        e = min(hi - offset, n)
        out.append(_slice_block(block, s, max(s, e)))
    return tuple(out) if len(out) != 1 else out[0]


@ray_tpu_torch.remote
def _concat_parts(*parts: Block) -> Block:
    live = [p for p in parts if _block_len(p)]
    if not live:
        return {k: v[:0] for k, v in parts[0].items()} if parts else {}
    return _concat_blocks(live)


@ray_tpu_torch.remote
def _shuffle_scatter(block: Block, num_parts: int, seed: int):
    """Map half of the shuffle exchange: scatter rows to partitions."""
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, num_parts, _block_len(block))
    out = [{k: v[assign == p] for k, v in block.items()}
           for p in range(num_parts)]
    return tuple(out) if num_parts != 1 else out[0]


@ray_tpu_torch.remote
def _shuffle_combine(seed: int, *parts: Block) -> Block:
    live = [p for p in parts if _block_len(p)]
    if not live:
        return {k: v[:0] for k, v in parts[0].items()} if parts else {}
    block = _concat_blocks(live)
    perm = np.random.default_rng(seed).permutation(_block_len(block))
    return {k: v[perm] for k, v in block.items()}


@ray_tpu_torch.remote
def _sample_keys(block: Block, key: str, cap: int = 128):
    v = block[key]
    if len(v) <= cap:
        return np.asarray(v)
    idx = np.random.default_rng(0).choice(len(v), cap, replace=False)
    return np.asarray(v)[idx]


@ray_tpu_torch.remote
def _range_scatter(block: Block, key: str, boundaries):
    """Map half of the sort exchange: route rows to range partitions by
    searchsorted against the sampled quantile boundaries."""
    assign = np.searchsorted(boundaries, block[key], side="right")
    out = [{k: v[assign == p] for k, v in block.items()}
           for p in range(len(boundaries) + 1)]
    return tuple(out) if len(out) != 1 else out[0]


@ray_tpu_torch.remote
def _sorted_combine(key: str, descending: bool, *parts: Block) -> Block:
    live = [p for p in parts if _block_len(p)]
    if not live:
        return {k: v[:0] for k, v in parts[0].items()} if parts else {}
    block = _concat_blocks(live)
    order = np.argsort(block[key], kind="stable")
    if descending:
        order = order[::-1]
    return {k: v[order] for k, v in block.items()}


@ray_tpu_torch.remote
def _hash_scatter(block: Block, key: str, num_parts: int):
    """Map half of the groupby exchange: hash-partition rows on the key so
    equal keys land in the same reduce partition."""
    keys = block[key]
    if keys.dtype.kind in "US":
        # Deterministic across processes (Python hash() is seed-randomized
        # per interpreter; scatter tasks run in different workers).
        import zlib

        hashes = np.array([zlib.crc32(str(x).encode()) for x in
                           keys.tolist()], np.int64)
    else:
        hashes = keys.astype(np.int64, copy=False)
    assign = np.abs(hashes) % num_parts
    out = [{k: v[assign == p] for k, v in block.items()}
           for p in range(num_parts)]
    return tuple(out) if num_parts != 1 else out[0]


_AGG_FNS = {
    "count": lambda v: len(v),
    "sum": np.sum,
    "min": np.min,
    "max": np.max,
    "mean": np.mean,
    "std": lambda v: np.std(v, ddof=1) if len(v) > 1 else 0.0,
}


@ray_tpu_torch.remote
def _group_combine(key: str, aggs, *parts: Block) -> Block:
    """Reduce half of the groupby exchange: group this partition's rows by
    key and compute the aggregate columns. ``aggs``: [(kind, col, out)]."""
    live = [p for p in parts if _block_len(p)]
    if not live:
        empty = {key: np.empty(0)}
        empty.update({out: np.empty(0) for _kind, _c, out in aggs})
        return empty
    block = _concat_blocks(live)
    keys = block[key]
    order = np.argsort(keys, kind="stable")
    keys_sorted = keys[order]
    uniq, starts = np.unique(keys_sorted, return_index=True)
    bounds = list(starts) + [len(keys_sorted)]
    out_cols: Dict[str, list] = {out: [] for _kind, _c, out in aggs}
    for gi in range(len(uniq)):
        rows = order[bounds[gi]:bounds[gi + 1]]
        for kind, col, out in aggs:
            vals = block[col][rows] if col is not None else rows
            out_cols[out].append(_AGG_FNS[kind](vals))
    result = {key: uniq}
    result.update({out: np.asarray(v) for out, v in out_cols.items()})
    return result


@ray_tpu_torch.remote
def _map_groups_part(key: str, fn_blob: bytes, *parts: Block) -> Block:
    from ray_tpu_torch.core import serialization

    fn = serialization.loads_function(fn_blob)
    live = [p for p in parts if _block_len(p)]
    if not live:
        return parts[0] if parts else {}
    block = _concat_blocks(live)
    keys = block[key]
    order = np.argsort(keys, kind="stable")
    keys_sorted = keys[order]
    uniq, starts = np.unique(keys_sorted, return_index=True)
    bounds = list(starts) + [len(keys_sorted)]
    outs = []
    for gi in range(len(uniq)):
        rows = order[bounds[gi]:bounds[gi + 1]]
        outs.append(fn({k: v[rows] for k, v in block.items()}))
    return _concat_blocks(outs) if outs else block


@ray_tpu_torch.remote
def _zip_blocks(left: Block, right: Block) -> Block:
    merged = dict(left)
    for k, v in right.items():
        name, i = k, 1
        while name in merged:
            name = f"{k}_{i}"
            i += 1
        merged[name] = v
    return merged


@ray_tpu_torch.remote
def _head_block(block: Block, n: int) -> Block:
    return _slice_block(block, 0, n)


# ----------------------------------------------------------------- plan

class _Op:
    """Logical operator: transforms a stream of blocks."""

    def apply_block(self, block: Block) -> Optional[Block]:
        raise NotImplementedError


class _MapBatches(_Op):
    def __init__(self, fn: Callable[[Block], Block], compute: str = "tasks",
                 concurrency: int = 2, fn_constructor_args: tuple = ()):
        self.fn = fn
        self.compute = compute  # "tasks" | "actors"
        self.concurrency = concurrency
        self.fn_constructor_args = fn_constructor_args

    def apply_block(self, block):
        return self.fn(block)


class _ActorMapWorker:
    """Stateful map worker: a callable-class op instantiates ONCE per actor
    (reference: ``actor_pool_map_operator.py`` — the pattern for expensive
    per-worker setup like loading a model for batch inference)."""

    def __init__(self, fn_blob: bytes, fn_constructor_args: tuple):
        import inspect

        from ray_tpu_torch.core import serialization

        fn = serialization.loads_function(fn_blob)
        self._fn = (fn(*fn_constructor_args) if inspect.isclass(fn)
                    else fn)

    def apply(self, block: Block) -> Block:
        return self._fn(block)


class _Filter(_Op):
    def __init__(self, pred: Callable[[Dict[str, Any]], bool]):
        self.pred = pred

    def apply_block(self, block):
        n = _block_len(block)
        keep = np.array([self.pred({k: v[i] for k, v in block.items()})
                         for i in range(n)], dtype=bool)
        return {k: v[keep] for k, v in block.items()}


def _stage_desc(ops: List[_Op]) -> str:
    """Stable per-stage task name: execution stats aggregate task events
    by this desc (reference: per-operator stats in _internal/stats.py)."""
    names = "+".join(type(op).__name__.lstrip("_") for op in ops) or "Read"
    return f"data::{names}"


def _fuse_ops(ops: List[_Op]) -> Callable[[Block], Block]:
    """Operator fusion: one task applies the whole chain to a block
    (the reference's physical-plan fusion rule — MapOperator chaining)."""

    def fused(block: Block) -> Block:
        for op in ops:
            block = op.apply_block(block)
        return block

    fused.__qualname__ = _stage_desc(ops)
    return fused


class Dataset:
    """Lazy dataset: input block refs + a chain of operators."""

    def __init__(self, block_refs: List[Any], ops: Optional[List[_Op]] = None,
                 exec_log: Optional[List[str]] = None):
        self._block_refs = list(block_refs)
        self._ops = list(ops or [])
        # Stage descs this dataset's lineage has EXECUTED (stats() joins
        # them against the cluster's task events for per-op wall times).
        self._exec_log: List[str] = list(exec_log or [])

    # ---------------------------------------------------- transformations

    def map_batches(self, fn: Callable[[Block], Block],
                    compute: str = "tasks", concurrency=2,
                    fn_constructor_args: tuple = (),
                    batch_format: str = "numpy",
                    **_compat) -> "Dataset":
        """``compute="actors"`` runs this op on a pool of stateful actors;
        ``concurrency`` is a fixed size or a ``(min, max)`` autoscaling
        range (reference: ``ActorPoolStrategy(min_size, max_size)``); ``fn``
        may be a callable CLASS constructed once per actor.
        ``batch_format`` selects what ``fn`` sees: ``"numpy"`` (dict of
        column arrays, the canonical zero-copy block), ``"pyarrow"``
        (``pa.Table``) or ``"pandas"`` (``pd.DataFrame``); the return value
        may be any of the three."""
        from ray_tpu_torch.data.block import BATCH_FORMATS

        if batch_format not in BATCH_FORMATS:
            raise ValueError(f"batch_format must be one of {BATCH_FORMATS}, "
                             f"got {batch_format!r}")
        if batch_format != "numpy":
            import inspect

            if inspect.isclass(fn):
                # Wrap the *instance* call, preserving once-per-actor
                # construction semantics.
                orig_cls = fn

                class _Formatted:
                    def __init__(self, *a):
                        self._wrapped = wrap_batch_fn(orig_cls(*a),
                                                      batch_format)

                    def __call__(self, block):
                        return self._wrapped(block)

                fn = _Formatted
            else:
                fn = wrap_batch_fn(fn, batch_format)
        return Dataset(self._block_refs, self._ops + [_MapBatches(
            fn, compute, concurrency, fn_constructor_args)],
                       exec_log=self._exec_log)

    def map(self, fn: Callable[[Dict[str, Any]], Dict[str, Any]]) -> "Dataset":
        def batch_fn(block: Block) -> Block:
            rows = [fn({k: v[i] for k, v in block.items()})
                    for i in range(_block_len(block))]
            if not rows:
                return block
            return {k: np.asarray([r[k] for r in rows]) for k in rows[0]}

        return self.map_batches(batch_fn)

    def filter(self, pred: Callable[[Dict[str, Any]], bool]) -> "Dataset":
        return Dataset(self._block_refs, self._ops + [_Filter(pred)],
                       exec_log=self._exec_log)

    def repartition(self, num_blocks: int) -> "Dataset":
        """Task-based repartition exchange: map tasks slice each block by
        global row range, reduce tasks concatenate — the driver only touches
        refs, never rows (reference: ``_internal/planner/exchange/``)."""
        mat = self.materialize()
        if not mat._block_refs:
            return mat
        counts = ray_tpu_torch.get([_count_block.remote(r)
                                    for r in mat._block_refs])
        total = sum(counts)
        if total == 0:
            return mat
        per = math.ceil(total / num_blocks)
        bounds = [min(i * per, total) for i in range(num_blocks + 1)]
        parts = []  # parts[b][p] = ref to the slice of block b for output p
        offset = 0
        for ref, count in zip(mat._block_refs, counts):
            out = _slice_for_ranges.options(
                num_returns=num_blocks,
                inline_results=False).remote(ref, offset, bounds)
            parts.append(out if isinstance(out, list) else [out])
            offset += count
        live = [p for p, (lo, hi) in enumerate(zip(bounds, bounds[1:]))
                if hi > lo]
        out_refs = [
            _concat_parts.remote(*[parts[b][p]
                                   for b in range(len(parts))])
            for p in live]
        return Dataset(out_refs, exec_log=self._exec_log)

    def random_shuffle(self, seed: Optional[int] = None) -> "Dataset":
        """Distributed all-to-all shuffle: map tasks scatter each block's
        rows to P partitions at random; reduce tasks concatenate and permute
        within the partition. No rows ever land on the driver (reference:
        the shuffle exchange, ``_internal/planner/exchange/
        shuffle_task_scheduler.py``); O(dataset) memory total stays spread
        over the cluster's stores."""
        mat = self.materialize()
        num_parts = len(mat._block_refs)
        if num_parts == 0:
            return mat
        if seed is None:  # unseeded shuffles must differ run to run
            seed = int(np.random.SeedSequence().entropy % (2 ** 31))
        base_seed = seed
        parts = []
        for i, ref in enumerate(mat._block_refs):
            out = _shuffle_scatter.options(num_returns=num_parts,
                                         inline_results=False).remote(
                ref, num_parts, base_seed + 7919 * i)
            parts.append(out if isinstance(out, list) else [out])
        out_refs = [
            _shuffle_combine.remote(base_seed + 104729 * p,
                                    *[parts[b][p]
                                      for b in range(len(parts))])
            for p in range(num_parts)]
        return Dataset(out_refs, exec_log=self._exec_log)

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Distributed sort via a range-partition exchange: sample keys,
        pick quantile boundaries, scatter rows to range partitions, sort
        each partition locally — globally ordered by block index, no rows
        on the driver (reference: ``_internal/planner/exchange/
        sort_task_spec.py`` SortTaskSpec sample->boundaries->exchange)."""
        mat = self.materialize()
        num_parts = len(mat._block_refs)
        if num_parts <= 1:
            if not mat._block_refs:
                return mat
            out = _sorted_combine.remote(key, descending, mat._block_refs[0])
            return Dataset([out], exec_log=self._exec_log)
        samples = np.concatenate(ray_tpu_torch.get(
            [_sample_keys.remote(r, key) for r in mat._block_refs]))
        if len(samples) == 0:
            return mat
        # Order-statistic boundaries (not np.quantile: no interpolation, so
        # string/order-only key dtypes sort too).
        samples = np.sort(samples)
        idx = np.linspace(0, len(samples) - 1,
                          num_parts + 1)[1:-1].astype(int)
        boundaries = samples[idx]
        parts = []
        for ref in mat._block_refs:
            out = _range_scatter.options(num_returns=num_parts,
                                       inline_results=False).remote(
                ref, key, boundaries)
            parts.append(out if isinstance(out, list) else [out])
        order = range(num_parts - 1, -1, -1) if descending else range(
            num_parts)
        out_refs = [
            _sorted_combine.remote(key, descending,
                                   *[parts[b][p] for b in range(len(parts))])
            for p in order]
        return Dataset(out_refs, exec_log=self._exec_log)

    def groupby(self, key: str) -> "GroupedData":
        """Hash-partition exchange + per-partition grouping (reference:
        ``Dataset.groupby`` -> aggregate exchange)."""
        return GroupedData(self, key)

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip of two datasets with identical row counts; the
        right side is repartitioned to the left's block layout and block
        pairs merge in tasks (duplicate columns get a ``_1`` suffix,
        reference: ``Dataset.zip``)."""
        left = self.materialize()
        counts = ray_tpu_torch.get([_count_block.remote(r)
                                    for r in left._block_refs])
        right = other.materialize()
        r_counts = ray_tpu_torch.get([_count_block.remote(r)
                                      for r in right._block_refs])
        if sum(counts) != sum(r_counts):
            raise ValueError(
                f"zip needs equal row counts ({sum(counts)} vs "
                f"{sum(r_counts)})")
        # Repartition the right side to the left's exact row boundaries.
        bounds = [0]
        for c in counts:
            bounds.append(bounds[-1] + c)
        parts = []
        offset = 0
        n_out = len(counts)
        for ref, count in zip(right._block_refs, r_counts):
            out = _slice_for_ranges.options(num_returns=n_out,
                                          inline_results=False).remote(
                ref, offset, bounds)
            parts.append(out if isinstance(out, list) else [out])
            offset += count
        right_refs = [
            _concat_parts.remote(*[parts[b][p] for b in range(len(parts))])
            for p in range(n_out)]
        return Dataset(exec_log=self._exec_log, block_refs=[_zip_blocks.remote(l, r) for l, r in
                        zip(left._block_refs, right_refs)])

    def union(self, *others: "Dataset") -> "Dataset":
        """Concatenate datasets (block-level, zero data movement)."""
        refs = list(self.materialize()._block_refs)
        for other in others:
            refs.extend(other.materialize()._block_refs)
        return Dataset(refs)

    def limit(self, n: int) -> "Dataset":
        """First ``n`` rows; trailing blocks are dropped unread, the
        boundary block is sliced in a task."""
        mat = self.materialize()
        counts = ray_tpu_torch.get([_count_block.remote(r)
                                    for r in mat._block_refs])
        refs, have = [], 0
        for ref, count in zip(mat._block_refs, counts):
            if have + count <= n:
                refs.append(ref)
                have += count
            else:
                if n - have > 0:
                    refs.append(_head_block.remote(ref, n - have))
                break
        return Dataset(refs)

    def schema(self) -> Optional[Schema]:
        """Arrow-typed schema from the first block (reference:
        ``Dataset.schema()``): iterable of names, ``[name] -> (np dtype,
        element shape)``, ``.types[name]`` -> Arrow type."""
        for block in self._streamed_blocks(max_in_flight=1):
            return Schema(block)
        return None

    # ------------------------------------------------- global aggregates

    def _column_agg(self, kind: str, col: str):
        if self._has_actor_ops():
            # Actor-pool ops can't run inside the plain fused-task path.
            return self.materialize()._column_agg(kind, col)
        fused = _fuse_ops(self._ops) if self._ops else None

        def part(block: Block):
            if fused is not None:
                block = fused(block)
            v = block[col]
            if len(v) == 0:
                return None
            return (_AGG_FNS[kind](v), len(v), float(np.sum(v)))

        task = ray_tpu_torch.remote(part)
        outs = [o for o in ray_tpu_torch.get(
            [task.remote(r) for r in self._block_refs]) if o is not None]
        if not outs:
            return None
        vals = [o[0] for o in outs]
        if kind == "sum":
            return np.sum(vals)
        if kind == "min":
            return np.min(vals)
        if kind == "max":
            return np.max(vals)
        if kind == "mean":  # weighted by block size
            total_rows = sum(o[1] for o in outs)
            return sum(o[2] for o in outs) / total_rows
        raise ValueError(kind)

    def sum(self, col: str):
        return self._column_agg("sum", col)

    def min(self, col: str):
        return self._column_agg("min", col)

    def max(self, col: str):
        return self._column_agg("max", col)

    def mean(self, col: str):
        return self._column_agg("mean", col)

    def stats(self) -> str:
        """Human-readable execution summary (reference:
        ``Dataset.stats()`` backed by per-operator stats,
        ``_internal/stats.py``): block count, rows, bytes, the pending
        operator chain, and PER-EXECUTED-STAGE wall-time aggregates
        (count/total/mean/p50/p99 + scheduling latency) joined from the
        cluster's task events by stage desc."""
        counts = ray_tpu_torch.get([_count_block.remote(r)
                                    for r in self._block_refs])
        sizer = ray_tpu_torch.remote(
            lambda b: int(sum(v.nbytes for v in b.values())))
        sizes = ray_tpu_torch.get([sizer.remote(r) for r in self._block_refs])
        ops = " -> ".join(type(op).__name__.lstrip("_")
                          for op in self._ops) or "Read"
        lines = [f"Dataset: {len(self._block_refs)} blocks, "
                 f"{sum(counts)} rows, {sum(sizes) / 1e6:.2f} MB "
                 f"(pending ops: {ops})"]
        for stage, row in self._stage_stats().items():
            lines.append(
                f"  stage {stage}: {row['tasks']} tasks, wall "
                f"total={row['total_s']:.2f}s mean={row['mean_s'] * 1e3:.0f}ms "
                f"p50={row['p50_s'] * 1e3:.0f}ms p99={row['p99_s'] * 1e3:.0f}ms, "
                f"sched p50={row['sched_p50_ms']:.0f}ms")
        return "\n".join(lines)

    def _stage_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-executed-stage aggregates from the controller's task-event
        table (the same events `ray_tpu_torch timeline` exports)."""
        if not self._exec_log:
            return {}
        try:
            from ray_tpu_torch.core.runtime import get_core_worker

            core = get_core_worker()
            core._flush_task_events()
            events = core.controller.call("list_task_events", 20000)
        except Exception:
            return {}
        out: Dict[str, Dict[str, float]] = {}
        for stage in self._exec_log:
            runs, scheds = [], []
            for e in events:
                if e.get("desc") != stage or e.get("state") != "FINISHED":
                    continue
                if e.get("end_ts") and e.get("lease_ts"):
                    runs.append(e["end_ts"] - e["lease_ts"])
                if e.get("lease_ts") and e.get("submitted_ts"):
                    scheds.append(e["lease_ts"] - e["submitted_ts"])
            if not runs:
                continue
            runs.sort()
            out[stage] = {
                "tasks": len(runs),
                "total_s": float(np.sum(runs)),
                "mean_s": float(np.mean(runs)),
                "p50_s": runs[len(runs) // 2],
                "p99_s": runs[min(len(runs) - 1, int(len(runs) * 0.99))],
                "sched_p50_ms": (1e3 * sorted(scheds)[len(scheds) // 2]
                                 if scheds else 0.0),
            }
        return out

    # --------------------------------------------------------- execution

    def _has_actor_ops(self) -> bool:
        return any(isinstance(op, _MapBatches) and op.compute == "actors"
                   for op in self._ops)

    @staticmethod
    def _memory_budget_bytes() -> int:
        """Streaming-window memory budget: a fraction of the local node's
        FREE object-store capacity (reference: the streaming executor's
        resource-manager budget, ``execution/resource_manager.py`` — the
        window must shrink when the store is tight, not use a constant)."""
        try:
            from ray_tpu_torch.core.runtime import get_core_worker

            core = get_core_worker()
            info = core.clients.get(core.node_addr).call("get_info",
                                                         timeout=5.0)
            free = info["store_capacity_bytes"] - info["store_used_bytes"]
            return max(32 * 1024 * 1024, free // 4)
        except Exception:
            return 256 * 1024 * 1024

    def _streamed_blocks(self,
                         max_in_flight: Optional[int] = None
                         ) -> Iterator[Block]:
        """Pull-based streaming execution with a memory-aware in-flight
        window (the backpressure half of the reference's StreamingExecutor):
        the window targets ``budget / block_bytes`` blocks, sized after the
        first block and clamped to [2, 32]."""
        if self._has_actor_ops():
            # Actor segments materialize via the pool executor.
            for ref in self.materialize()._block_refs:
                yield ray_tpu_torch.get(ref)
            return
        if not self._ops:
            for ref in self._block_refs:
                yield ray_tpu_torch.get(ref)
            return
        import uuid as _uuid

        fused = _fuse_ops(self._ops)
        fused.__qualname__ += f"#{_uuid.uuid4().hex[:6]}"
        self._exec_log.append(fused.__qualname__)
        del self._exec_log[:-20]  # bounded: epoch loops re-execute forever
        process = ray_tpu_torch.remote(fused)
        ref_iter = iter(self._block_refs)
        pending: List[Any] = []
        fixed = max_in_flight is not None
        window = max_in_flight if fixed else 2

        def refill():
            while len(pending) < window:
                try:
                    pending.append(process.remote(next(ref_iter)))
                except StopIteration:
                    return

        refill()
        sized = fixed
        while pending:
            block = ray_tpu_torch.get(pending.pop(0))
            if not sized:
                sized = True
                size = max(1, _block_nbytes(block))
                window = int(np.clip(
                    self._memory_budget_bytes() // size, 2, 32))
            refill()
            yield block

    def materialize(self) -> "Dataset":
        if not self._ops:
            return Dataset(self._block_refs, exec_log=self._exec_log)
        refs = list(self._block_refs)
        # Consecutive task ops fuse into one task per block; an actor op
        # breaks fusion and runs on a stateful pool (operator grouping, as
        # the reference's physical planner does).
        segment: List[_Op] = []
        executed: List[str] = list(self._exec_log)

        def flush_tasks(refs):
            if not segment:
                return refs
            import uuid as _uuid

            fused = _fuse_ops(list(segment))
            # Unique per EXECUTION: stats() joins task events by this
            # desc, and two datasets running the same op chain must not
            # pollute each other's aggregates.
            fused.__qualname__ += f"#{_uuid.uuid4().hex[:6]}"
            executed.append(fused.__qualname__)
            del executed[:-20]  # bounded lineage (epoch loops)
            process = ray_tpu_torch.remote(fused)
            segment.clear()
            return [process.remote(r) for r in refs]

        for op in self._ops:
            if isinstance(op, _MapBatches) and op.compute == "actors":
                refs = flush_tasks(refs)
                refs = self._actor_map(op, refs)
                # Actor-pool stages run through actor calls, which do not
                # land in the task-event table under a stage desc — no
                # exec-log entry (stats() would join the wrong events).
            else:
                segment.append(op)
        refs = flush_tasks(refs)
        ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=None)
        return Dataset(refs, exec_log=executed)

    def _actor_map(self, op: "_MapBatches", refs: List[Any]) -> List[Any]:
        """Actor-pool execution with min/max autoscaling (reference:
        ``actor_pool_map_operator.py`` + ``ActorPoolStrategy(min_size,
        max_size)``): start ``min`` workers, submit with bounded per-actor
        in-flight, and add workers (up to ``max``) while a backlog remains.
        Results stay as refs — the data plane never routes through the
        driver."""
        from ray_tpu_torch.core import serialization

        if isinstance(op.concurrency, (tuple, list)):
            min_size, max_size = op.concurrency
        else:
            min_size = max_size = int(op.concurrency)
        min_size = max(1, min_size)
        max_size = max(min_size, max_size)
        per_actor_in_flight = 2

        worker_cls = ray_tpu_torch.remote(_ActorMapWorker)
        fn_blob = serialization.dumps_function(op.fn)
        actors = [worker_cls.options(num_cpus=1).remote(
            fn_blob, op.fn_constructor_args) for _ in range(min_size)]
        try:
            out_refs: List[Any] = [None] * len(refs)
            in_flight: Dict[Any, int] = {}  # result ref -> actor index
            load = [0] * len(actors)
            queue = list(enumerate(refs))
            while queue or in_flight:
                # Scale up: backlog beyond what the pool can absorb.
                backlog = len(queue) - sum(
                    per_actor_in_flight - l for l in load if
                    l < per_actor_in_flight)
                if backlog > 0 and len(actors) < max_size:
                    actors.append(worker_cls.options(num_cpus=1).remote(
                        fn_blob, op.fn_constructor_args))
                    load.append(0)
                # Submit to the least-loaded actors up to the cap.
                while queue:
                    ai = min(range(len(actors)), key=lambda i: load[i])
                    if load[ai] >= per_actor_in_flight:
                        break
                    i, ref = queue.pop(0)
                    out = actors[ai].apply.remote(ref)
                    out_refs[i] = out
                    in_flight[out] = ai
                    load[ai] += 1
                if in_flight:
                    ready, _ = ray_tpu_torch.wait(list(in_flight),
                                                  num_returns=1,
                                                  timeout=None)
                    for r in ready:
                        load[in_flight.pop(r)] -= 1
            self.last_actor_pool_size = len(actors)
            return out_refs
        finally:
            for actor in actors:
                try:
                    ray_tpu_torch.kill(actor)
                except Exception:
                    import logging

                    from ray_tpu_torch.util.ratelimit import log_every

                    # A map actor that survives this kill keeps its
                    # resources leased until the cluster reaps it.
                    log_every("dataset.actor_kill", 10.0,
                              logging.getLogger(__name__),
                              "kill of dataset map actor failed",
                              exc_info=True)

    # -------------------------------------------------------- consumption

    def iter_batches(self, batch_size: int = 256,
                     drop_last: bool = False,
                     pad_to: Optional[int] = None) -> Iterator[Block]:
        """Stream fixed-size batches. ``pad_to`` pads the final partial batch
        to a static size (repeating rows), so a step sees one shape."""
        carry: Optional[Block] = None
        for block in self._streamed_blocks():
            if carry is not None:
                block = _concat_blocks([carry, block])
                carry = None
            n = _block_len(block)
            start = 0
            while n - start >= batch_size:
                yield _slice_block(block, start, start + batch_size)
                start += batch_size
            if start < n:
                carry = _slice_block(block, start, n)
        if carry is not None and not drop_last:
            if pad_to:
                n = _block_len(carry)
                reps = math.ceil(pad_to / n)
                carry = {k: np.concatenate([v] * reps)[:pad_to]
                         for k, v in carry.items()}
            yield carry

    def iter_device_batches(self, batch_size: int = 256, *, mesh=None,
                            rules=None, prefetch: int = 2,
                            drop_last: bool = False, device=None):
        """``iter_batches`` + device-side prefetch (reference
        ``prefetch_batches``, ``dataset.py:3599``): a background thread pads
        the next batch to the static ``batch_size`` and copies it to
        ``device`` (``cuda`` unless the caller passes another; without a
        card that raises), batch-sharded when ``mesh`` is given, while the
        caller's step runs — fetch wait leaves the step budget."""
        from ray_tpu_torch.data.ingest import device_prefetch

        return device_prefetch(
            self.iter_batches(batch_size, drop_last=drop_last,
                              pad_to=batch_size),
            mesh=mesh, rules=rules, prefetch=prefetch, device=device)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for block in self._streamed_blocks():
            for i in range(_block_len(block)):
                yield {k: v[i] for k, v in block.items()}

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        return list(itertools.islice(self.iter_rows(), n))

    def count(self) -> int:
        counter = ray_tpu_torch.remote(lambda block: _block_len(block))
        if self._ops:
            fused = _fuse_ops(self._ops)
            counter = ray_tpu_torch.remote(
                lambda block: _block_len(fused(block)))
        return sum(ray_tpu_torch.get([counter.remote(r)
                                      for r in self._block_refs]))

    def num_blocks(self) -> int:
        return len(self._block_refs)

    def _write_blocks(self, path: str, ext: str, write_block) -> List[str]:
        """One output file per block via tasks (the shared write fan-out
        behind write_parquet/csv/json); returns the written paths."""
        import os

        os.makedirs(path, exist_ok=True)
        mat = self.materialize()
        task = ray_tpu_torch.remote(write_block)
        refs = [task.remote(r, os.path.join(path, f"part-{i:05d}.{ext}"))
                for i, r in enumerate(mat._block_refs)]
        return ray_tpu_torch.get(refs)

    def write_parquet(self, path: str) -> List[str]:
        """Write one parquet file per block via tasks (reference:
        ``Dataset.write_parquet``); returns the written paths."""
        def write_one(block: Block, out_path: str) -> str:
            import pyarrow.parquet as pq

            # Tensor-aware conversion (block.py to_arrow): ndim>1 columns
            # become FixedSizeList with shape metadata, so e.g. stacked
            # observations round-trip through parquet (plain pa.table()
            # rejects multi-dimensional numpy columns).
            from ray_tpu_torch.data.block import to_arrow

            pq.write_table(to_arrow(block), out_path)
            return out_path

        return self._write_blocks(path, "parquet", write_one)

    def write_csv(self, path: str) -> List[str]:
        """One CSV file per block via tasks (reference:
        ``Dataset.write_csv``)."""
        def write_one(block: Block, out_path: str) -> str:
            import csv

            cols = list(block.keys())
            with open(out_path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(cols)
                for i in range(_block_len(block)):
                    w.writerow([block[c][i] for c in cols])
            return out_path

        return self._write_blocks(path, "csv", write_one)

    def write_json(self, path: str) -> List[str]:
        """One JSON-lines file per block via tasks (reference:
        ``Dataset.write_json``)."""
        def write_one(block: Block, out_path: str) -> str:
            import json

            cols = list(block.keys())
            with open(out_path, "w") as f:
                for i in range(_block_len(block)):
                    row = {c: block[c][i] for c in cols}
                    f.write(json.dumps(
                        {k: (v.item() if hasattr(v, "item") else v)
                         for k, v in row.items()}) + "\n")
            return out_path

        return self._write_blocks(path, "json", write_one)

    def write_tfrecords(self, path: str, column: str = "record"
                        ) -> List[str]:
        """One TFRecord container per block; rows of ``column`` must be
        bytes (reference: ``Dataset.write_tfrecords`` — payloads are the
        caller's serialized protos). Framing matches ``read_tfrecords``."""
        def write_one(block: Block, out_path: str) -> str:
            import struct as _struct

            from ray_tpu_torch.data.read_api import _tfrecord_crc

            with open(out_path, "wb") as f:
                for rec in block[column]:
                    payload = bytes(rec)
                    header = _struct.pack("<Q", len(payload))
                    f.write(header)
                    f.write(_struct.pack("<I", _tfrecord_crc(header)))
                    f.write(payload)
                    f.write(_struct.pack("<I", _tfrecord_crc(payload)))
            return out_path

        return self._write_blocks(path, "tfrecords", write_one)

    def split(self, n: int) -> List["Dataset"]:
        """Split into n datasets by whole blocks."""
        chunks: List[List[Any]] = [[] for _ in range(n)]
        for i, ref in enumerate(self._block_refs):
            chunks[i % n].append(ref)
        return [Dataset(c, self._ops, exec_log=self._exec_log)
                for c in chunks]

    def streaming_split(self, n: int, equal: bool = True) -> List["DataIterator"]:
        """Per-consumer iterators for distributed ingest (reference:
        ``streaming_split`` feeding Train workers, ``data_config.py:112``).
        Blocks are assigned round-robin by a coordinator actor so consumers
        pull independently and in parallel."""
        coordinator = _SplitCoordinator.options(num_cpus=0).remote(
            self._block_refs, n)
        fused = _fuse_ops(self._ops) if self._ops else None
        return [DataIterator(coordinator, i, fused) for i in range(n)]


class GroupedData:
    """Grouped view of a Dataset (reference: ``GroupedData`` in
    ``data/grouped_data.py``): hash-exchange rows on the key, then compute
    per-group aggregates or apply ``map_groups`` per partition."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _exchange(self):
        mat = self._ds.materialize()
        num_parts = max(1, len(mat._block_refs))
        parts = []
        for ref in mat._block_refs:
            out = _hash_scatter.options(num_returns=num_parts,
                                      inline_results=False).remote(
                ref, self._key, num_parts)
            parts.append(out if isinstance(out, list) else [out])
        return parts, num_parts

    def aggregate(self, *aggs: Tuple[str, Optional[str], str]) -> Dataset:
        """``aggs``: (kind, column, output_name) with kind in
        count/sum/min/max/mean/std. Returns a Dataset with one row per
        group."""
        for kind, _col, _out in aggs:
            if kind not in _AGG_FNS:
                raise ValueError(f"unknown aggregate {kind!r}")
        parts, num_parts = self._exchange()
        if not parts:
            return Dataset([])
        out_refs = [
            _group_combine.remote(self._key, list(aggs),
                                  *[parts[b][p] for b in range(len(parts))])
            for p in range(num_parts)]
        return Dataset(out_refs, exec_log=self._ds._exec_log)

    def count(self) -> Dataset:
        return self.aggregate(("count", None, "count"))

    def sum(self, col: str) -> Dataset:
        return self.aggregate(("sum", col, f"sum({col})"))

    def min(self, col: str) -> Dataset:
        return self.aggregate(("min", col, f"min({col})"))

    def max(self, col: str) -> Dataset:
        return self.aggregate(("max", col, f"max({col})"))

    def mean(self, col: str) -> Dataset:
        return self.aggregate(("mean", col, f"mean({col})"))

    def std(self, col: str) -> Dataset:
        return self.aggregate(("std", col, f"std({col})"))

    def map_groups(self, fn: Callable[[Block], Block]) -> Dataset:
        """Apply ``fn`` to each group's rows (as one block); groups of one
        key never span partitions thanks to the hash exchange."""
        from ray_tpu_torch.core import serialization

        parts, num_parts = self._exchange()
        if not parts:
            return Dataset([])
        fn_blob = serialization.dumps_function(fn)
        out_refs = [
            _map_groups_part.remote(self._key, fn_blob,
                                    *[parts[b][p] for b in range(len(parts))])
            for p in range(num_parts)]
        return Dataset(out_refs, exec_log=self._ds._exec_log)


@ray_tpu_torch.remote
class _SplitCoordinator:
    def __init__(self, block_refs: List[Any], n: int):
        self._queues: List[List[Any]] = [[] for _ in range(n)]
        for i, ref in enumerate(block_refs):
            self._queues[i % n].append(ref)

    def next_block(self, consumer: int):
        queue = self._queues[consumer]
        return queue.pop(0) if queue else None


class DataIterator:
    def __init__(self, coordinator, index: int, fused):
        self._coordinator = coordinator
        self._index = index
        self._fused = fused

    def iter_batches(self, batch_size: int = 256,
                     drop_last: bool = False,
                     pad_to: Optional[int] = None) -> Iterator[Block]:
        carry: Optional[Block] = None
        while True:
            ref = ray_tpu_torch.get(
                self._coordinator.next_block.remote(self._index))
            if ref is None:
                break
            block = ray_tpu_torch.get(ref)
            if self._fused is not None:
                block = self._fused(block)
            if carry is not None:
                block = _concat_blocks([carry, block])
                carry = None
            n = _block_len(block)
            start = 0
            while n - start >= batch_size:
                yield _slice_block(block, start, start + batch_size)
                start += batch_size
            if start < n:
                carry = _slice_block(block, start, n)
        if carry is not None and not drop_last:
            if pad_to:
                n = _block_len(carry)
                reps = math.ceil(pad_to / n)
                carry = {k: np.concatenate([v] * reps)[:pad_to]
                         for k, v in carry.items()}
            yield carry

    def iter_device_batches(self, batch_size: int = 256, *, mesh=None,
                            rules=None, prefetch: int = 2,
                            drop_last: bool = False, device=None):
        """Per-worker device-prefetched ingest (see
        ``Dataset.iter_device_batches``): the form train loops consume via
        ``train.get_dataset_shard(...)``. In a train worker the default
        device is the card its runner thread set (its local rank)."""
        from ray_tpu_torch.data.ingest import device_prefetch

        return device_prefetch(
            self.iter_batches(batch_size, drop_last=drop_last,
                              pad_to=batch_size),
            mesh=mesh, rules=rules, prefetch=prefetch, device=device)
