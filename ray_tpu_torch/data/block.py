"""Block format + interchange: numpy-columnar blocks with Arrow interop
(copy of ``ray_tpu/data/block.py``).

The reference's Ray Data blocks are Arrow tables
(``data/_internal/arrow_block.py``); here the canonical in-store block is a
**dict of numpy column arrays**, because every block's terminal consumer is
the host-to-device copy (``data/ingest.py``), which wants contiguous numpy,
and the shm store already ships numpy zero-copy via pickle5 buffers. Blocks
hold numpy, never tensors: data tasks run on CPU workers that see no card.
Arrow remains the *interchange* format: blocks convert to/from
``pyarrow.Table`` (zero-copy for primitive columns in both directions —
Arrow buffers wrap the numpy memory and ``to_numpy(zero_copy_only=...)``
wraps back) for schema typing, parquet IO, and ``map_batches``
``batch_format="pyarrow"|"pandas"``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

Block = Dict[str, np.ndarray]


def block_len(block: Block) -> int:
    if not block:
        return 0
    return len(next(iter(block.values())))


def block_nbytes(block: Block) -> int:
    return int(sum(getattr(v, "nbytes", 0) for v in block.values()))


def concat_blocks(blocks: List[Block]) -> Block:
    keys = blocks[0].keys()
    return {k: np.concatenate([b[k] for b in blocks]) for k in keys}


def slice_block(block: Block, start: int, end: int) -> Block:
    return {k: v[start:end] for k, v in block.items()}


# ------------------------------------------------------------------ schema


class Schema:
    """Column name -> Arrow type (+ numpy dtype and element shape), derived
    without copying data (reference: ``Dataset.schema()`` returning the
    Arrow schema)."""

    def __init__(self, block: Block):
        import pyarrow as pa

        self.names: List[str] = list(block.keys())
        self.types: Dict[str, Any] = {}
        self.dtypes: Dict[str, np.dtype] = {}
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        for name, col in block.items():
            self.dtypes[name] = col.dtype
            self.shapes[name] = tuple(col.shape[1:])
            if col.ndim == 1:
                try:
                    self.types[name] = pa.from_numpy_dtype(col.dtype)
                except (pa.ArrowNotImplementedError, TypeError):
                    self.types[name] = pa.binary()
            else:  # tensor column
                self.types[name] = pa.list_(
                    pa.from_numpy_dtype(col.dtype)
                    if col.dtype.kind not in "OUS" else pa.string())

    def __repr__(self) -> str:
        cols = ", ".join(
            f"{n}: {self.types[n]}"
            + (f"{list(self.shapes[n])}" if self.shapes[n] else "")
            for n in self.names)
        return f"Schema({cols})"

    def __iter__(self) -> Iterator[str]:
        return iter(self.names)

    def __getitem__(self, name: str) -> Tuple[np.dtype, Tuple[int, ...]]:
        """Back-compat mapping view: name -> (numpy dtype, element shape)."""
        return self.dtypes[name], self.shapes[name]

    def __contains__(self, name: str) -> bool:
        return name in self.dtypes

    def __len__(self) -> int:
        return len(self.names)


# ------------------------------------------------------- format conversion


def to_arrow(block: Block):
    """Block -> pyarrow.Table. 1-D primitive columns wrap the numpy memory
    (zero-copy); tensor columns (ndim > 1) flatten into fixed-size-list
    arrays over the same buffer."""
    import pyarrow as pa

    import json

    def wrap_1d(col: np.ndarray):
        """Numeric contiguous arrays wrap their buffer (no copy); strings
        and objects go through pa.array (copy — Arrow's layout differs)."""
        if col.dtype.kind in "iuf" and col.flags.c_contiguous:
            typ = pa.from_numpy_dtype(col.dtype)
            return pa.Array.from_buffers(
                typ, len(col), [None, pa.py_buffer(col)])
        return pa.array(col)

    arrays, fields = [], []
    for name, col in block.items():
        if col.ndim == 1:
            arr = wrap_1d(col)
            fields.append(pa.field(name, arr.type))
        else:
            inner = int(np.prod(col.shape[1:]))
            flat = wrap_1d(np.ascontiguousarray(col).reshape(-1))
            arr = pa.FixedSizeListArray.from_arrays(flat, inner)
            # Arrow's FixedSizeList is rank-1: the true element shape rides
            # in field metadata so >2-D tensors round-trip unflattened.
            fields.append(pa.field(
                name, arr.type,
                metadata={b"tensor_shape":
                          json.dumps(list(col.shape[1:])).encode()}))
        arrays.append(arr)
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


def from_arrow(table) -> Block:
    """pyarrow.Table -> Block. Primitive columns come back zero-copy when
    Arrow's layout allows (single chunk, no nulls); strings and nested
    lists copy."""
    import json

    import pyarrow as pa

    out: Block = {}
    for name in table.column_names:
        col = table.column(name)
        field = table.schema.field(name)
        if isinstance(col, pa.ChunkedArray):
            # Single-chunk columns stay zero-copy (combine_chunks would
            # reallocate even for one chunk).
            col = (col.chunk(0) if col.num_chunks == 1
                   else col.combine_chunks())
        if pa.types.is_fixed_size_list(col.type):
            inner = col.type.list_size
            # flatten() honors the slice offset; .values would return the
            # unsliced child buffer.
            values = col.flatten().to_numpy(zero_copy_only=False)
            shape: Any = (inner,)
            meta = field.metadata or {}
            if b"tensor_shape" in meta:
                shape = tuple(json.loads(meta[b"tensor_shape"]))
            out[name] = values.reshape((len(col),) + tuple(shape))
        else:
            try:
                out[name] = col.to_numpy(zero_copy_only=True)
            except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
                out[name] = col.to_numpy(zero_copy_only=False)
    return out


def to_pandas(block: Block):
    import pandas as pd

    return pd.DataFrame({
        k: (list(v) if v.ndim > 1 else v) for k, v in block.items()})


def from_pandas(df) -> Block:
    out: Block = {}
    for name in df.columns:
        col = df[name].to_numpy()
        if len(col) and isinstance(col[0], np.ndarray):
            col = np.stack(col)
        out[name] = col
    return out


BATCH_FORMATS = ("numpy", "pyarrow", "pandas")


def wrap_batch_fn(fn, batch_format: str):
    """Adapt a user batch fn operating in ``batch_format`` to the canonical
    numpy block (reference: ``map_batches(batch_format=...)``,
    ``_internal/block_batching``). The fn may return any of the three
    formats regardless of its input format. Callers validate
    ``batch_format`` against :data:`BATCH_FORMATS` up front."""
    if batch_format == "numpy":
        convert_in = None
    elif batch_format == "pyarrow":
        convert_in = to_arrow
    else:
        convert_in = to_pandas

    def wrapped(block: Block) -> Block:
        out = fn(convert_in(block) if convert_in else block)
        return normalize_batch(out)

    return wrapped


def normalize_batch(out) -> Block:
    """Coerce a user-returned batch (numpy dict / Table / DataFrame) to the
    canonical block."""
    import pyarrow as pa

    if isinstance(out, dict):
        return {k: np.asarray(v) for k, v in out.items()}
    if isinstance(out, pa.Table):
        return from_arrow(out)
    try:
        import pandas as pd

        if isinstance(out, pd.DataFrame):
            return from_pandas(out)
    except ImportError:
        pass
    raise TypeError(
        f"map_batches fn must return a dict of arrays, pyarrow.Table or "
        f"pandas.DataFrame, got {type(out).__name__}")
