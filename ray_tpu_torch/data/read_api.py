"""Dataset creation APIs (copy of ``ray_tpu/data/read_api.py``; reference:
``python/ray/data/read_api.py``)."""

from __future__ import annotations

import builtins
import glob as _glob
import math
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.dataset import Dataset


def _rows_to_block(rows: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    if not rows:
        return {}
    return {k: np.asarray([r[k] for r in rows]) for k in rows[0]}


def from_items(items: List[Any], num_blocks: int = 8) -> Dataset:
    rows = [it if isinstance(it, dict) else {"item": it} for it in items]
    per = max(1, math.ceil(len(rows) / num_blocks))
    refs = [ray_tpu_torch.put(_rows_to_block(rows[i:i + per]))
            for i in builtins.range(0, len(rows), per)]
    return Dataset(refs)


def range(n: int, num_blocks: int = 8) -> Dataset:
    per = max(1, math.ceil(n / num_blocks))
    refs = [ray_tpu_torch.put({"id": np.arange(i, min(i + per, n))})
            for i in builtins.range(0, n, per)]
    return Dataset(refs)


def from_numpy(arrays: Dict[str, np.ndarray], num_blocks: int = 8) -> Dataset:
    """Columns of numpy arrays, ``num_blocks`` blocks of equal rows. A CPU
    tensor becomes its numpy view; a CUDA tensor is refused (``TypeError``):
    blocks are numpy, read by workers that see no card."""
    if not arrays:
        return Dataset([])
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    n = len(next(iter(arrays.values())))
    per = max(1, math.ceil(n / num_blocks))
    refs = [ray_tpu_torch.put({k: v[i:i + per] for k, v in arrays.items()})
            for i in builtins.range(0, n, per)]
    return Dataset(refs)


def _read_files(paths, reader) -> Dataset:
    """One read task per file — parallel IO through the object store
    (reference: one read task per file fragment)."""
    if isinstance(paths, str):
        paths = sorted(_glob.glob(paths)) or [paths]
    read_task = ray_tpu_torch.remote(reader)
    return Dataset([read_task.remote(p) for p in paths])


def read_parquet(paths) -> Dataset:
    def reader(path: str):
        import pyarrow.parquet as pq

        from ray_tpu_torch.data.block import from_arrow

        # Tensor-aware: FixedSizeList columns with tensor_shape metadata
        # (written by write_parquet) come back as n-d numpy columns.
        return from_arrow(pq.read_table(path))

    return _read_files(paths, reader)


def read_csv(paths) -> Dataset:
    def reader(path: str):
        import csv

        with open(path) as f:
            rows = list(csv.DictReader(f))
        return _rows_to_block(rows)

    return _read_files(paths, reader)


def read_json(paths) -> Dataset:
    def reader(path: str):
        import json

        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        return _rows_to_block(rows)

    return _read_files(paths, reader)


def read_text(paths) -> Dataset:
    """One row per line, column ``text`` (reference: ``read_text``)."""
    def reader(path: str):
        with open(path) as f:
            lines = [line.rstrip("\r\n") for line in f]  # CRLF-safe
        return {"text": np.asarray(lines, dtype=object)}

    return _read_files(paths, reader)


def read_numpy(paths, column: str = "data") -> Dataset:
    """One .npy file per block (reference: ``read_numpy``)."""
    def reader(path: str):
        return {column: np.load(path, allow_pickle=False)}

    return _read_files(paths, reader)


def from_pandas(df, num_blocks: int = 8) -> Dataset:
    """A pandas DataFrame -> column-block Dataset (reference:
    ``from_pandas``)."""
    return from_numpy({c: df[c].to_numpy() for c in df.columns},
                      num_blocks=num_blocks)


def from_arrow(table, num_blocks: int = 8) -> Dataset:
    """A pyarrow Table -> column-block Dataset (reference:
    ``from_arrow``)."""
    return from_numpy(
        {name: table[name].to_numpy(zero_copy_only=False)
         for name in table.column_names}, num_blocks=num_blocks)


def read_binary_files(paths, include_paths: bool = False) -> Dataset:
    """One row per file with its raw ``bytes`` (reference:
    ``read_binary_files`` / ``datasource/binary_datasource.py``)."""
    def reader(path: str):
        with open(path, "rb") as f:
            data = f.read()
        block: Dict[str, Any] = {"bytes": np.array([data], dtype=object)}
        if include_paths:
            block["path"] = np.array([path])
        return block

    return _read_files(paths, reader)


def read_images(paths, size: Optional[tuple] = None,
                mode: str = "RGB", include_paths: bool = False) -> Dataset:
    """Decode image files into an ``image`` tensor column (reference:
    ``read_images`` / ``datasource/image_datasource.py``). ``size``
    resizes to (H, W) — a train step wants the static shape."""
    def reader(path: str):
        from PIL import Image

        img = Image.open(path).convert(mode)
        if size is not None:
            img = img.resize((size[1], size[0]))
        arr = np.asarray(img)
        block: Dict[str, Any] = {"image": arr[None, ...]}
        if include_paths:
            block["path"] = np.array([path])
        return block

    return _read_files(paths, reader)


_CRC32C_TABLE: Optional[List[int]] = None


try:  # a C-speed wheel when one exists; per-byte Python otherwise
    from crc32c import crc32c as _crc32c_native  # type: ignore
except ImportError:
    try:
        from google_crc32c import value as _crc32c_native  # type: ignore
    except ImportError:
        _crc32c_native = None


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected poly 0x82F63B78). `zlib.crc32` is
    the WRONG polynomial (IEEE): TensorFlow verifies the length-CRC
    unconditionally, so only real CRC32C interoperates. Uses a crc32c
    wheel when installed; falls back to a table-driven pure-Python loop
    (fine for small records, slow for MB-scale payloads)."""
    if _crc32c_native is not None:
        return _crc32c_native(data) & 0xFFFFFFFF
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        # NB: plain `range` here would hit this module's Dataset-factory
        # `range()` shadowing the builtin.
        table = []
        for i in builtins.range(256):
            c = i
            for _ in builtins.range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    tab = _CRC32C_TABLE
    crc = 0xFFFFFFFF
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _tfrecord_crc(data: bytes) -> int:
    """Masked CRC32C exactly as the TFRecord spec defines it — files we
    write round-trip through standard TFRecord readers and vice versa."""
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _tfrecord_crc_legacy(data: bytes) -> int:
    """Masked crc32 (zlib) — what this repo's writer emitted before the
    CRC32C fix; the reader still ACCEPTS it so old files stay readable."""
    import zlib

    crc = zlib.crc32(data) & 0xFFFFFFFF
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def read_tfrecords(paths, verify: bool = False) -> Dataset:
    """Read TFRecord containers into one ``bytes``-typed ``record`` row
    per record (reference: ``read_tfrecords`` — there each record is
    parsed as tf.train.Example; without TF in the image the payload stays
    raw bytes for the caller's proto parser). Wire format: u64 length,
    u32 masked length-crc, payload, u32 masked payload-crc."""
    import struct as _struct

    def reader(path: str):
        records = []
        file_size = __import__("os").path.getsize(path)
        with open(path, "rb") as f:
            while True:
                header = f.read(8)
                if len(header) < 8:
                    break
                (length,) = _struct.unpack("<Q", header)
                lcrc = f.read(4)
                if len(lcrc) < 4:
                    raise ValueError(f"truncated TFRecord file {path}")
                # The length field is attacker/corruption-controlled: a
                # flipped bit must produce a clean error, not a 2^60-byte
                # read. Bound by the file size, and check the length-crc
                # (that is what it exists for) before trusting it.
                if length > file_size:
                    raise ValueError(
                        f"TFRecord length {length} exceeds file size in "
                        f"{path} (corrupt length field)")
                if verify:
                    (want,) = _struct.unpack("<I", lcrc)
                    if (_tfrecord_crc(header) != want
                            and _tfrecord_crc_legacy(header) != want):
                        raise ValueError(
                            f"TFRecord length-crc mismatch in {path}")
                payload = f.read(length)
                pcrc = f.read(4)
                if len(payload) < length or len(pcrc) < 4:
                    raise ValueError(f"truncated TFRecord file {path}")
                if verify:
                    (want,) = _struct.unpack("<I", pcrc)
                    if (_tfrecord_crc(payload) != want
                            and _tfrecord_crc_legacy(payload) != want):
                        raise ValueError(
                            f"TFRecord crc mismatch in {path}")
                records.append(payload)
        return {"record": np.array(records, dtype=object)}

    return _read_files(paths, reader)
