"""One user program for the Dataset API and Train's dataset ingest, run on
``ray_tpu`` and then on ``ray_tpu_torch`` by ``tests/test_torch_data.py``.

``data_program`` holds one result for each case of ``tests/test_data.py``
that runs on one node, plus the device batches, the trainer's
``datasets=`` ingest, a Tuner over such a trainer and what a data task's
process sees. ``store_program`` holds the two cases that the JAX tests run
on a ``cluster_utils.Cluster``, on one node with a 48 MiB store;
``shuffle_case`` and ``bounded_case`` are its halves, which
``tests/test_torch_data.py`` also runs on each package's ``Cluster``.
Every result is plain values: numpy arrays become their
dtype, shape and values, so results compare exactly, order included.

Every function takes the package's name and imports it, so the same code
drives both runtimes. This module imports neither package, nor JAX, nor
torch at import: the cluster's workers import it to run the functions and
train loops defined here.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import sys

import numpy as np

TRAINERS = {"ray_tpu": "JaxTrainer", "ray_tpu_torch": "TorchTrainer"}
# Store cap and data sizes of the JAX package's larger-than-store test.
STORE_BYTES = 48 * 1024 * 1024
BIG_BLOCKS, BIG_ROWS_PER = 30, 500_000


def _data(pkg: str):
    return importlib.import_module(f"{pkg}.data")


def _train(pkg: str):
    return importlib.import_module(f"{pkg}.train")


def plain(x):
    """``x`` with numpy arrays and scalars made plain values (dtype, shape
    and values), recursively."""
    if isinstance(x, np.ndarray):
        vals = x.tolist()
        if x.dtype == object:
            vals = [plain(v) for v in x.ravel().tolist()]
        return {"dtype": str(x.dtype), "shape": list(x.shape),
                "values": vals}
    if isinstance(x, np.generic):
        return (type(x).__name__, x.item())
    if isinstance(x, dict):
        return {str(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def _rows(ds) -> list:
    return plain(list(ds.iter_rows()))


def _raised(fn):
    """(class name, message) of what ``fn`` raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the class is the result
        return type(e).__name__, str(e)
    return None


def _host(batch) -> dict:
    """A device batch's leaves (a jax.Array or a CPU tensor) as their
    dtype names and values. The dtypes differ by design: JAX (x64 off)
    lands int64 as int32, the port keeps torch's index dtype."""
    return {k: (str(np.asarray(v).dtype), np.asarray(v).tolist())
            for k, v in batch.items()}


# ------------------------------------------------- functions the tasks run


def _env_block(block):
    """One row per block: the process a data task runs in, its card
    variable, and whether it loaded torch or created a CUDA context."""
    torch = sys.modules.get("torch")
    return {"pid": np.array([os.getpid()]),
            "cuda_visible": np.array(
                [os.environ.get("CUDA_VISIBLE_DEVICES", "<unset>")]),
            "torch_loaded": np.array([torch is not None]),
            "cuda_initialized": np.array(
                [torch is not None and torch.cuda.is_initialized()])}


class EnvActor:
    def __call__(self, block):
        return _env_block(block)


class AddBias:
    """Stateful callable: constructed once per pool actor."""

    def __init__(self, bias):
        self.bias = bias
        self.pid = os.getpid()

    def __call__(self, block):
        return {"id": block["id"] + self.bias,
                "pid": np.full(len(block["id"]), self.pid)}


class SlowId:
    def __call__(self, block):
        import time

        time.sleep(0.3)
        return {**block, "pid": np.full(len(block["x"]), os.getpid())}


def _demean(block):
    return {"g": block["g"], "v": block["v"] - block["v"].mean()}


def _arrow_fn(table):
    import pyarrow as pa
    import pyarrow.compute as pc

    assert isinstance(table, pa.Table)
    return table.append_column("y", pc.multiply(table.column("x"), 2))


def _pandas_fn(df):
    import pandas as pd

    assert isinstance(df, pd.DataFrame)
    df["z"] = df["x"] + 1
    return df


# ---------------------------------------------------------- the train loops


def iters_loop(config):
    """``test_train_ingest_path``: the DataIterators travel in the loop's
    config; each rank sums its own."""
    train = _train(config["pkg"])
    it = config["iters"][train.get_world_rank()]
    total = 0
    for batch in it.iter_batches(batch_size=8):
        total += int(batch["id"].sum())
    train.report({"total": total})


def shard_loop(config):
    """``test_trainer_dataset_shard_ingest``: each rank reads its shard
    through ``get_dataset_shard`` and device batches, and writes the rows it
    saw, in order, to a file of its own."""
    train = _train(config["pkg"])
    shard = train.get_dataset_shard("train")
    values = []
    for batch in shard.iter_device_batches(batch_size=8,
                                           **config["device_kw"]):
        values.extend(np.asarray(batch["x"]).tolist())
    rank = train.get_world_rank()
    with open(os.path.join(config["out"], f"rank{rank}.json"), "w") as f:
        json.dump(values, f)
    train.report({"n": len(values),
                  "sum": float(np.sum(np.unique(values)))})


def trial_loop(config):
    """A Tuner trial: every row of its shard, in order."""
    train = _train(config["pkg"])
    rows = []
    for batch in train.get_dataset_shard("train").iter_batches(batch_size=4):
        rows.extend(batch["x"].tolist())
    train.report({"rows": rows, "lr": config["lr"]})


def leased_loop(config):
    """A GPU-leased worker (a freshly spawned interpreter): its shard's
    rows, with the map op the DataIterator carries applied here, and its
    parent's pid."""
    train = _train(config["pkg"])
    rows = []
    for batch in train.get_dataset_shard("train").iter_device_batches(
            batch_size=5, device="cpu"):
        rows.extend(np.asarray(batch["x"]).tolist())
    train.report({"rows": rows, "ppid": os.getppid()})


# ------------------------------------------------------------- the program


def _device_kw(pkg: str) -> dict:
    """The port lands batches on the card unless told otherwise."""
    return {"device": "cpu"} if pkg == "ray_tpu_torch" else {}


def data_env(pkg: str) -> dict:
    """Run first, before anything in the cluster loads torch: the process
    of a fused map task, of a pool actor, and of a groupby exchange task."""
    rdata = _data(pkg)
    ds = rdata.range(8, num_blocks=4)
    envs = list(ds.map_batches(_env_block).iter_rows())
    envs += list(ds.map_batches(EnvActor, compute="actors",
                                concurrency=1).iter_rows())
    groups = rdata.from_numpy({"g": np.arange(4) % 2, "v": np.ones(4)},
                              num_blocks=2)
    envs += list(groups.groupby("g").map_groups(_env_block).iter_rows())
    return {"rows": [{k: v.item() for k, v in r.items()} for r in envs],
            "program_pid": os.getpid()}


def data_program(pkg: str, tmp: str) -> dict:
    rdata = _data(pkg)
    train = _train(pkg)
    tmp = os.path.join(tmp, pkg)
    os.makedirs(tmp, exist_ok=True)
    out = {"env": data_env(pkg)}

    ds = rdata.range(100)
    out["range_count_take"] = (ds.count(), plain(ds.take(5)))

    ds = rdata.range(100).map_batches(
        lambda b: {"id": b["id"], "sq": b["id"] ** 2})
    out["map_batches"] = (plain(ds.take(3)), ds.count())

    ds = (rdata.range(50)
          .map(lambda r: {"id": r["id"], "even": r["id"] % 2 == 0})
          .filter(lambda r: r["even"]))
    out["map_and_filter"] = (ds.count(), _rows(ds))

    ds = rdata.range(100)
    out["iter_batches_fixed_size"] = (
        plain(list(ds.iter_batches(batch_size=32))),
        plain(list(ds.iter_batches(batch_size=32, pad_to=32))),
        plain(list(ds.iter_batches(batch_size=32, drop_last=True))))

    ds = rdata.range(40).map_batches(
        lambda b: {"id": b["id"] + 1}).materialize()
    out["materialize_and_chain"] = (ds.num_blocks(), _rows(ds))

    out["random_shuffle"] = _rows(rdata.range(100).random_shuffle(seed=0))

    iters = rdata.range(96).streaming_split(3)
    out["streaming_split"] = [
        plain(list(it.iter_batches(batch_size=16))) for it in iters]

    ds = rdata.from_items([{"x": i, "y": -i} for i in range(10)])
    ds2 = rdata.from_numpy({"a": np.arange(20)})
    out["from_items_and_numpy"] = (ds.count(), _rows(ds), ds2.count(),
                                   _rows(ds2))

    d = os.path.join(tmp, "csv_json_parquet")
    os.makedirs(d)
    with open(os.path.join(d, "t.csv"), "w") as f:
        f.write("a,b\n1,x\n2,y\n")
    with open(os.path.join(d, "t.jsonl"), "w") as f:
        f.write('{"a": 1}\n{"a": 2}\n{"a": 3}\n')
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(pa.table({"v": list(range(7))}),
                   os.path.join(d, "t.parquet"))
    pq_ds = rdata.read_parquet(os.path.join(d, "t.parquet"))
    out["read_csv_json_parquet"] = (
        _rows(rdata.read_csv(os.path.join(d, "t.csv"))),
        _rows(rdata.read_json(os.path.join(d, "t.jsonl"))),
        pq_ds.count(), _rows(pq_ds))

    ds = rdata.range(64).map_batches(lambda b: {"id": b["id"] * 2})
    res = getattr(train, TRAINERS[pkg])(
        iters_loop,
        train_loop_config={"pkg": pkg, "iters": ds.streaming_split(2)},
        scaling_config=train.ScalingConfig(
            num_workers=2, resources_per_worker={"CPU": 1})).fit()
    out["train_ingest_path"] = (res.error, res.metrics)

    ds = rdata.range(100, num_blocks=8).map_batches(
        AddBias, compute="actors", concurrency=2,
        fn_constructor_args=(1000,))
    rows = list(ds.iter_rows())
    pids = {int(r["pid"]) for r in ds.materialize().iter_rows()}
    out["actor_pool_map_batches"] = ([int(r["id"]) for r in rows],
                                     1 <= len(pids) <= 2)

    ds = rdata.from_numpy({"x": np.arange(50), "y": np.arange(50) * 2.0},
                          num_blocks=4)
    paths = ds.write_parquet(os.path.join(tmp, "pq_out"))
    back = rdata.read_parquet(os.path.join(tmp, "pq_out", "*.parquet"))
    out["write_and_read_parquet_roundtrip"] = (
        [os.path.basename(p) for p in paths], _rows(back))

    vals = np.random.default_rng(0).permutation(500).astype(np.int64)
    ds = rdata.from_numpy({"x": vals, "y": vals * 2.0}, num_blocks=7)
    out["sort_range_partition_exchange"] = (
        plain(list(ds.sort("x").iter_batches(batch_size=100))),
        plain(list(ds.sort("x", descending=True).iter_batches(
            batch_size=100))))

    n = 300
    ds = rdata.from_numpy({"g": (np.arange(n) % 3).astype(np.int64),
                           "v": np.arange(n, dtype=np.float64)},
                          num_blocks=5)
    grouped = ds.groupby("g")
    out["groupby_aggregates"] = [
        _rows(grouped.sum("v")), _rows(grouped.count()),
        _rows(grouped.mean("v")), _rows(grouped.min("v")),
        _rows(grouped.max("v")), _rows(grouped.std("v")),
        _raised(lambda: grouped.aggregate(("median", "v", "m")))]

    ds = rdata.from_numpy({"g": np.array([0, 1, 0, 1, 2], np.int64),
                           "v": np.array([1.0, 2.0, 3.0, 4.0, 5.0])},
                          num_blocks=2)
    out["groupby_map_groups"] = _rows(ds.groupby("g").map_groups(_demean))

    a = rdata.from_numpy({"x": np.arange(100)}, num_blocks=4)
    b = rdata.from_numpy({"x": np.arange(100) * 10, "y": np.ones(100)},
                         num_blocks=3)
    sch = b.schema()
    out["zip_union_limit_schema"] = (
        _rows(a.zip(b)), a.union(a, a).count(), _rows(a.limit(42)),
        [str(sch[c][0]) for c in sch], repr(sch),
        _raised(lambda: a.zip(a.limit(10))))

    vals = np.arange(1, 101, dtype=np.float64)
    ds = rdata.from_numpy({"v": vals}, num_blocks=6)
    stats = ds.stats()
    out["global_aggregates_and_stats"] = (
        plain([ds.sum("v"), ds.min("v"), ds.max("v"), ds.mean("v")]),
        plain(ds.filter(lambda r: r["v"] <= 50).mean("v")),
        stats.splitlines()[0])

    names = np.array(["alpha", "beta", "gamma"] * 40)
    ds = rdata.from_numpy({"name": names,
                           "v": np.arange(120, dtype=np.float64)},
                          num_blocks=6)
    out["groupby_string_keys_across_processes"] = _rows(
        ds.groupby("name").count())

    rng = np.random.default_rng(3)
    words = np.array([f"w{int(i):04d}" for i in rng.permutation(200)])
    ds = rdata.from_numpy({"w": words}, num_blocks=5)
    out["sort_string_keys"] = plain(list(
        ds.sort("w").iter_batches(batch_size=64)))

    d = os.path.join(tmp, "text_numpy_csv_json")
    os.makedirs(d)
    with open(os.path.join(d, "a.txt"), "w") as f:
        f.write("hello\nworld\n")
    np.save(os.path.join(d, "x.npy"), np.arange(10))
    src = rdata.from_numpy({"a": np.arange(20), "b": np.arange(20) * 2.0},
                           num_blocks=3)
    csv_paths = src.write_csv(os.path.join(d, "csvout"))
    src.write_json(os.path.join(d, "jsonout"))
    out["read_write_text_numpy_csv_json"] = (
        _rows(rdata.read_text(os.path.join(d, "a.txt"))),
        plain(rdata.read_numpy(os.path.join(d, "x.npy"), column="x")
              .sum("x")),
        [os.path.basename(p) for p in csv_paths],
        _rows(rdata.read_csv(os.path.join(d, "csvout", "*.csv"))),
        _rows(rdata.read_json(os.path.join(d, "jsonout", "*.json"))))

    import pandas as pd

    df = pd.DataFrame({"x": [1, 2, 3], "y": ["a", "b", "c"]})
    ds = rdata.from_pandas(df, num_blocks=2)
    ds2 = rdata.from_arrow(pa.table({"x": [10, 20]}))
    out["from_pandas_arrow"] = (ds.count(), plain(ds.sum("x")), _rows(ds),
                                plain(ds2.sum("x")), _rows(ds2))

    ds = rdata.from_numpy({"x": np.arange(100, dtype=np.int64)},
                          num_blocks=4)
    out["map_batches_pyarrow_and_pandas_formats"] = (
        _rows(ds.map_batches(_arrow_fn, batch_format="pyarrow")),
        _rows(ds.map_batches(_pandas_fn, batch_format="pandas")),
        _raised(lambda: ds.map_batches(lambda b: b,
                                       batch_format="polars")))

    out["arrow_zero_copy_roundtrip"] = arrow_zero_copy(pkg)

    ds = rdata.from_numpy({"i": np.arange(10, dtype=np.int32),
                           "f": np.ones(10),
                           "v": np.zeros((10, 3), np.float32)})
    sch = ds.schema()
    out["schema_arrow_types"] = (
        {c: str(sch.types[c]) for c in sch}, plain(sch["v"]),
        sorted(sch), len(sch), "v" in sch, repr(sch))

    ds = rdata.from_numpy({"x": np.arange(24, dtype=np.int64)},
                          num_blocks=12)
    pool = ds.map_batches(SlowId, compute="actors", concurrency=(1, 3))
    rows = list(pool.materialize().iter_rows())
    out["actor_pool_autoscales_between_min_max"] = (
        [int(r["x"]) for r in rows], len({int(r["pid"]) for r in rows}) >= 2,
        pool.last_actor_pool_size <= 3)

    out["arrow_tensor_shapes_and_slices_roundtrip"] = arrow_tensors(pkg)

    ds = rdata.range(2000, num_blocks=8).map_batches(
        lambda b: {"id": b["id"] * 2}).filter(lambda r: r["id"] % 4 == 0)
    mat = ds.materialize()
    text = mat.stats()
    out["stats_reports_executed_stages"] = (
        mat.count(), text.splitlines()[0],
        "stage data::MapBatches+Filter" in text,
        "8 tasks" in text and "p50=" in text and "sched p50=" in text)

    out["read_binary_and_images"] = binary_and_images(pkg, tmp)
    out["tfrecords_roundtrip"] = tfrecords(pkg, tmp)
    out["device_batches"] = device_batches(pkg)
    out["shard_ingest"] = shard_ingest(pkg, tmp)
    out["tuner_fresh_splits"] = tuner_fresh_splits(pkg, tmp)
    return out


def arrow_zero_copy(pkg: str):
    block_mod = importlib.import_module(f"{pkg}.data.block")
    block = {"a": np.arange(1000, dtype=np.float32),
             "m": np.ones((1000, 4), dtype=np.int32)}
    table = block_mod.to_arrow(block)
    back = block_mod.from_arrow(table)
    return (type(table).__name__, plain(back),
            back["a"].__array_interface__["data"][0]
            == block["a"].__array_interface__["data"][0])


def arrow_tensors(pkg: str):
    block_mod = importlib.import_module(f"{pkg}.data.block")
    block = {"m": np.arange(60, dtype=np.float32).reshape(10, 2, 3),
             "x": np.arange(10, dtype=np.int64)}
    table = block_mod.to_arrow(block)
    return (plain(block_mod.from_arrow(table)),
            plain(block_mod.from_arrow(table.slice(4, 3))))


def binary_and_images(pkg: str, tmp: str):
    from PIL import Image

    rdata = _data(pkg)
    d = os.path.join(tmp, "binary_images")
    os.makedirs(d)
    with open(os.path.join(d, "a.bin"), "wb") as f:
        f.write(b"\x00\x01payload")
    with open(os.path.join(d, "b.bin"), "wb") as f:
        f.write(b"other")
    ds = rdata.read_binary_files(os.path.join(d, "*.bin"),
                                 include_paths=True)
    rows = [(bytes(b["bytes"][0]), os.path.basename(str(b["path"][0])))
            for b in ds.iter_batches(batch_size=1)]
    for i, color in enumerate([(255, 0, 0), (0, 255, 0)]):
        Image.new("RGB", (12, 10), color).save(
            os.path.join(d, f"img{i}.png"))
    ids = rdata.read_images(os.path.join(d, "*.png"), size=(8, 8))
    batch = next(iter(ids.materialize().iter_batches(batch_size=4)))
    return rows, plain(batch)


def tfrecords(pkg: str, tmp: str):
    """The round trip, the written files' bytes, and the reader's refusal
    of a corrupt payload."""
    rdata = _data(pkg)
    payloads = [f"record-{i}".encode() for i in range(10)]
    src = rdata.from_numpy({"record": np.array(payloads, dtype=object)},
                           num_blocks=2)
    d = os.path.join(tmp, "tfr")
    paths = src.write_tfrecords(d)
    digests = []
    for p in paths:
        with open(p, "rb") as f:
            digests.append(hashlib.sha256(f.read()).hexdigest())
    back = rdata.read_tfrecords(os.path.join(d, "*"), verify=True)
    got = [bytes(r) for b in back.iter_batches(batch_size=100)
           for r in b["record"]]
    with open(paths[0], "rb") as f:
        raw = bytearray(f.read())
    raw[16] ^= 0xFF  # a byte of the first payload
    bad = os.path.join(tmp, "tfr_bad")
    os.makedirs(bad)
    with open(os.path.join(bad, "part.tfrecords"), "wb") as f:
        f.write(bytes(raw))
    corrupt = _raised(lambda: list(rdata.read_tfrecords(
        os.path.join(bad, "*"), verify=True).iter_rows()))
    return ([os.path.basename(p) for p in paths], digests, got,
            corrupt is not None and "crc mismatch" in corrupt[1])


def device_batches(pkg: str):
    """``iter_device_batches`` of a Dataset and of a streaming split: the
    values of every batch, the last one padded by repeating rows."""
    rdata = _data(pkg)
    ds = rdata.from_numpy({"x": np.arange(100, dtype=np.float32),
                           "i": np.arange(100, dtype=np.int64)},
                          num_blocks=4)
    kw = _device_kw(pkg)
    whole = [_host(b) for b in ds.iter_device_batches(
        batch_size=32, **kw)]
    split = [[_host(b) for b in it.iter_device_batches(
        batch_size=16, **kw)] for it in ds.streaming_split(2)]
    dropped = [_host(b) for b in ds.iter_device_batches(
        batch_size=32, drop_last=True, **kw)]
    return whole, split, dropped


def shard_ingest(pkg: str, tmp: str):
    """``test_trainer_dataset_shard_ingest`` with two CPU workers: the rows
    each rank saw, in order."""
    rdata = _data(pkg)
    train = _train(pkg)
    d = os.path.join(tmp, "shards")
    os.makedirs(d)
    ds = rdata.from_numpy({"x": np.arange(64, dtype=np.float32)},
                          num_blocks=8)
    res = getattr(train, TRAINERS[pkg])(
        shard_loop,
        train_loop_config={"pkg": pkg, "out": d,
                           "device_kw": _device_kw(pkg)},
        scaling_config=train.ScalingConfig(num_workers=2),
        run_config=train.RunConfig(storage_path=os.path.join(d, "run")),
        datasets={"train": ds}).fit()
    ranks = {}
    for r in range(2):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            ranks[r] = json.load(f)
    return {"error": res.error, "metrics": res.metrics, "ranks": ranks}


def tuner_fresh_splits(pkg: str, tmp: str):
    """Two trials of a one-worker trainer with ``datasets=``: each trial
    reads a split of its own, so each sees every row."""
    rdata = _data(pkg)
    train = _train(pkg)
    tune = importlib.import_module(f"{pkg}.tune")
    ds = rdata.from_numpy({"x": np.arange(24, dtype=np.int64)},
                          num_blocks=4)
    trainer = getattr(train, TRAINERS[pkg])(
        trial_loop, train_loop_config={"pkg": pkg},
        scaling_config=train.ScalingConfig(num_workers=1),
        run_config=train.RunConfig(
            storage_path=os.path.join(tmp, "tune_splits")),
        datasets={"train": ds})
    grid = tune.Tuner(
        trainer, param_space={"lr": tune.grid_search([1.0, 2.0])},
        tune_config=tune.TuneConfig(metric="lr", mode="max")).fit()
    return sorted((r.config["lr"], r.error, r.metrics["rows"])
                  for r in grid)


def store_program(pkg: str) -> dict:
    """The cluster cases of ``tests/test_data.py`` on one node whose store
    holds ``STORE_BYTES``: the shuffle exchange, then a dataset about 2.5x
    the store shuffled and iterated with this process's RSS bounded."""
    return {**shuffle_case(pkg), **bounded_case(pkg)}


def shuffle_case(pkg: str) -> dict:
    """``test_distributed_shuffle_multinode``: 5000 rows in 8 blocks
    shuffled twice with one seed."""
    rdata = _data(pkg)
    ds = rdata.range(5000).repartition(8)
    vals = [int(r["id"]) for r in ds.random_shuffle(seed=3).iter_rows()]
    again = [int(r["id"]) for r in ds.random_shuffle(seed=3).iter_rows()]
    return {"distributed_shuffle_multinode": (
        vals, sorted(vals) == list(range(5000)),
        vals != list(range(5000)), vals == again)}


def bounded_case(pkg: str) -> dict:
    """``test_shuffle_iterate_larger_than_store_bounded_memory``: a dataset
    about 2.5x the store shuffled and iterated, this process's RSS growth
    kept."""
    import psutil

    rdata = _data(pkg)
    out = {}
    n = BIG_BLOCKS * BIG_ROWS_PER
    ds = rdata.from_numpy({"x": np.arange(n, dtype=np.int64)},
                          num_blocks=BIG_BLOCKS)
    shuffled = ds.random_shuffle(seed=7)
    proc = psutil.Process()
    start_rss = proc.memory_info().rss
    peak_extra, total, count, heads = 0, 0, 0, []
    for batch in shuffled.map_batches(
            lambda b: {"x": b["x"]}).iter_batches(batch_size=250_000):
        total += int(batch["x"].sum())
        count += len(batch["x"])
        heads.append(batch["x"][:4].tolist())
        peak_extra = max(peak_extra, proc.memory_info().rss - start_rss)
    out["shuffle_iterate_larger_than_store_bounded_memory"] = (
        count, total, heads, total == n * (n - 1) // 2,
        peak_extra < 90 * 1024 * 1024)
    out["peak_extra_rss"] = peak_extra
    return out


def main(argv) -> int:
    """``python torch_data_program.py <pkg> <tmp> <out>``: run
    ``data_program`` on a node of 4 CPUs, then ``store_program`` on a node
    of 2 CPUs with a ``STORE_BYTES`` store, each in a cluster of its own,
    and pickle their results into ``out``."""
    import pickle

    pkg, tmp, out_path = argv
    rt = importlib.import_module(pkg)
    rt.init(num_cpus=4)
    try:
        out = data_program(pkg, tmp)
    finally:
        rt.shutdown()
    rt.init(num_cpus=2, _system_config={
        "object_store_memory_bytes": STORE_BYTES})
    try:
        out.update(store_program(pkg))
    finally:
        rt.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
