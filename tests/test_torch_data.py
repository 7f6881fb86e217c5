"""The port's Dataset API (``ray_tpu_torch.data``) and Train's dataset
ingest held against the JAX package's on the CPU.

One user program (``torch_data_program``) runs on ``ray_tpu`` and then on
``ray_tpu_torch``, each in a process and a cluster of its own (init, run,
shutdown; never both up; a run that dies of a signal fails the cases that
read it, naming the signal): ``data_program`` on a node of 4 CPUs holds
a result for each of ``tests/test_data.py``'s one-node cases, and ``store_program`` on a node
of 2 CPUs with a 48 MiB store holds its two ``cluster_utils.Cluster``
cases, which run again on each package's ``Cluster`` as the JAX tests run
them (the shuffle on two such nodes). Results are plain values of numpy
blocks and must be equal, rows in order where the JAX package is
deterministic. Error classes are
compared by name. Beside that: device batches on ``device="cpu"``,
``TorchTrainer(datasets=...)`` with two workers, a Tuner over it, and no
data task's process loading torch or creating a CUDA context."""

import numpy as np
import pytest
import torch

import torch_data_program as prog

RUNS = ("ray_tpu", "ray_tpu_torch")

# One key per case of tests/test_data.py.
ONE_NODE_CASES = [
    "range_count_take", "map_batches", "map_and_filter",
    "iter_batches_fixed_size", "materialize_and_chain", "random_shuffle",
    "streaming_split", "from_items_and_numpy", "read_csv_json_parquet",
    "train_ingest_path", "actor_pool_map_batches",
    "write_and_read_parquet_roundtrip", "sort_range_partition_exchange",
    "groupby_aggregates", "groupby_map_groups", "zip_union_limit_schema",
    "global_aggregates_and_stats", "groupby_string_keys_across_processes",
    "sort_string_keys", "read_write_text_numpy_csv_json",
    "from_pandas_arrow", "map_batches_pyarrow_and_pandas_formats",
    "arrow_zero_copy_roundtrip", "schema_arrow_types",
    "actor_pool_autoscales_between_min_max",
    "arrow_tensor_shapes_and_slices_roundtrip",
    "stats_reports_executed_stages", "read_binary_and_images",
    "tfrecords_roundtrip"]
STORE_CASES = ["distributed_shuffle_multinode",
               "shuffle_iterate_larger_than_store_bounded_memory"]


class _Died:
    """The result of a run whose process died of a signal: every case that
    reads it fails and names the signal."""

    def __init__(self, pkg: str, sig: str, stderr: str):
        self.message = (f"the {pkg} run of torch_data_program died of {sig}"
                        f"; its stderr ends:\n{stderr}")

    def __getitem__(self, key):
        pytest.fail(self.message)


def _run_program(pkg: str, tmp: str):
    """``torch_data_program.main`` for ``pkg`` in a process of its own, so
    that a crash of one package's runtime cannot take down the test
    worker that holds the other's results."""
    import os
    import pickle
    import signal
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(tmp, f"{pkg}.pkl")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(here), here]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "torch_data_program.py"), pkg,
         tmp, out], env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode < 0:
        return _Died(pkg, signal.Signals(-proc.returncode).name,
                     proc.stderr[-3000:])
    if proc.returncode != 0:
        raise RuntimeError(f"the {pkg} run of torch_data_program exited "
                           f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("data"))
    return {pkg: _run_program(pkg, tmp) for pkg in RUNS}


@pytest.fixture(scope="module")
def cluster_results():
    """The two ``ray_start_cluster`` cases of ``tests/test_data.py`` on each
    package's ``cluster_utils.Cluster`` (never both up), as the JAX tests
    run them: the shuffle on two nodes of 2 CPUs, the bounded iteration on
    one node of 2 CPUs, each node's store holding ``STORE_BYTES`` (set
    before the nodes start). Run on two nodes, the bounded case's RSS
    bound failed on both packages (both nodes' stores live in this
    process), so it keeps the JAX test's one node."""
    import importlib

    out = {}
    for pkg in RUNS:
        rt = importlib.import_module(pkg)
        cluster_utils = importlib.import_module(f"{pkg}.cluster_utils")
        config = importlib.import_module(f"{pkg}.core.config").config
        old = config.object_store_memory_bytes
        config.object_store_memory_bytes = prog.STORE_BYTES
        out[pkg] = {}
        try:
            for n_nodes, case in ((2, prog.shuffle_case),
                                  (1, prog.bounded_case)):
                cluster = cluster_utils.Cluster(initialize_head=False)
                try:
                    nodes = [cluster.add_node(num_cpus=2)
                             for _ in range(n_nodes)]
                    cluster.wait_for_nodes()
                    rt.init(address=cluster.address)
                    out[pkg].update(case(pkg))
                    out[pkg][f"alive_nodes_{case.__name__}"] = (
                        sorted(n["node_id"] for n in rt.nodes()
                               if n["alive"]),
                        sorted(n.node_id.hex() for n in nodes))
                finally:
                    if rt.is_initialized():
                        rt.shutdown()
                    cluster.shutdown()
        finally:
            config.object_store_memory_bytes = old
    return out


def test_every_case_of_the_jax_tests_has_a_counterpart():
    import ast
    from pathlib import Path

    src = Path(__file__).with_name("test_data.py").read_text()
    names = [n.name.removeprefix("test_") for n in ast.parse(src).body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]
    assert len(names) == 31
    assert sorted(names) == sorted(ONE_NODE_CASES + STORE_CASES)


@pytest.mark.parametrize("key", ONE_NODE_CASES + STORE_CASES)
def test_case_matches_jax(results, key):
    assert results["ray_tpu_torch"][key] == results["ray_tpu"][key]


def test_case_values(results):
    """What the JAX tests assert, on the port's results."""
    got = results["ray_tpu_torch"]
    count, rows = got["range_count_take"]
    assert count == 100 and [r["id"][1] for r in rows] == [0, 1, 2, 3, 4]
    padded = got["iter_batches_fixed_size"][1]
    assert [b["id"]["shape"] for b in padded] == [[32]] * 4
    assert padded[-1]["id"]["values"] == [96, 97, 98, 99] * 8
    ids = [r["id"][1] for r in got["random_shuffle"]]
    assert sorted(ids) == list(range(100)) and ids != list(range(100))
    split = got["streaming_split"]
    seen = [v for it in split for b in it for v in b["id"]["values"]]
    assert sorted(seen) == list(range(96))
    assert got["train_ingest_path"] == (None, {"total": 2 * sum(
        v for blk in (0, 2, 4, 6) for v in range(8 * blk, 8 * blk + 8))})
    assert got["actor_pool_map_batches"] == (list(range(1000, 1100)), True)
    assert got["zip_union_limit_schema"][1] == 300
    assert got["zip_union_limit_schema"][3] == ["int64", "float64"]
    assert got["zip_union_limit_schema"][5][0] == "ValueError"
    assert got["groupby_aggregates"][-1] == (
        "ValueError", "unknown aggregate 'median'")
    assert got["map_batches_pyarrow_and_pandas_formats"][2][0] == \
        "ValueError"
    assert got["arrow_zero_copy_roundtrip"][2] is True
    assert got["stats_reports_executed_stages"][2:] == (True, True)
    tfr = got["tfrecords_roundtrip"]
    assert tfr[2] == [f"record-{i}".encode() for i in range(10)] and tfr[3]
    shuffle = got["distributed_shuffle_multinode"]
    assert shuffle[1:] == (True, True, True)
    big = got["shuffle_iterate_larger_than_store_bounded_memory"]
    assert big[0] == prog.BIG_BLOCKS * prog.BIG_ROWS_PER
    assert big[3:] == (True, True), got["peak_extra_rss"]


@pytest.mark.parametrize("key", STORE_CASES)
def test_two_node_cluster_case_matches_jax(cluster_results, key):
    """The cluster cases on a ``Cluster``: the port's results equal the
    JAX package's on the same cluster, every node of it alive."""
    got = cluster_results["ray_tpu_torch"]
    assert got[key] == cluster_results["ray_tpu"][key]
    for case, nodes in (("shuffle_case", 2), ("bounded_case", 1)):
        alive, started = got[f"alive_nodes_{case}"]
        assert alive == started and len(alive) == nodes


def test_two_node_cluster_case_values(cluster_results, results):
    got = cluster_results["ray_tpu_torch"]
    assert got["distributed_shuffle_multinode"][1:] == (True, True, True)
    assert got["distributed_shuffle_multinode"] == \
        results["ray_tpu_torch"]["distributed_shuffle_multinode"]
    big = got["shuffle_iterate_larger_than_store_bounded_memory"]
    assert big[0] == prog.BIG_BLOCKS * prog.BIG_ROWS_PER
    assert big[3:] == (True, True), got["peak_extra_rss"]


def test_device_batches_match_jax_values_and_padding(results):
    """``iter_device_batches(device="cpu")`` of a Dataset and of its
    streaming splits: the JAX package's values and padding, int64 kept
    where JAX (x64 off) gives int32."""
    got = results["ray_tpu_torch"]["device_batches"]
    want = results["ray_tpu"]["device_batches"]

    def values(runs):
        return [[{k: v[1] for k, v in b.items()} for b in run]
                for run in runs]

    whole, split, dropped = got
    assert values([whole, *split, dropped]) == values(
        [want[0], *want[1], want[2]])
    assert whole[-1]["x"][1] == [96.0, 97.0, 98.0, 99.0] * 8
    assert len(dropped) == 3
    assert {k: v[0] for k, v in whole[0].items()} == {
        "x": "float32", "i": "int64"}
    assert {k: v[0] for k, v in want[0][0].items()} == {
        "x": "float32", "i": "int32"}


def test_device_batches_need_a_card_unless_told():
    import ray_tpu_torch as rt
    from ray_tpu_torch import data

    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    rt.init(num_cpus=1)
    try:
        ds = data.from_numpy({"x": np.arange(4)}, num_blocks=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ds.iter_device_batches(batch_size=2)
    finally:
        rt.shutdown()


def test_trainer_dataset_shard_ingest_matches_jax(results):
    """Two CPU workers each read their own streaming shard through
    ``get_dataset_shard`` and device batches: each rank's rows, in order,
    are the JAX package's, and together they are every row once."""
    got = results["ray_tpu_torch"]["shard_ingest"]
    assert got == results["ray_tpu"]["shard_ingest"]
    assert got["error"] is None and got["metrics"]["n"] == 32
    assert sorted(got["ranks"][0] + got["ranks"][1]) == list(range(64))


def test_tuner_trials_get_fresh_splits(results):
    got = results["ray_tpu_torch"]["tuner_fresh_splits"]
    assert got == results["ray_tpu"]["tuner_fresh_splits"]
    assert got == [(lr, None, list(range(24))) for lr in (1.0, 2.0)]


def test_data_tasks_load_no_torch_and_see_no_card(results):
    """Fused map tasks, pool actors and exchange tasks run in CPU workers
    that see ``CUDA_VISIBLE_DEVICES=""``, never load torch and so create
    no CUDA context; nor does the process that runs the program."""
    env = results["ray_tpu_torch"]["env"]
    rows = env["rows"]
    assert len(rows) == 4 + 4 + 2  # 4 blocks, 4 blocks, 2 groups
    assert all(r["pid"] != env["program_pid"] for r in rows)
    assert all(r["cuda_visible"] == "" for r in rows)
    assert not any(r["torch_loaded"] or r["cuda_initialized"] for r in rows)
    assert not torch.cuda.is_initialized()


def test_gpu_leased_worker_reads_a_lazy_shard():
    """The DataIterator, its split coordinator's handle and the pending
    map op cross into a GPU-leased worker, which the node spawns fresh
    (its parent is the process that called ``init``): the rows arrive mapped, in
    order, the last batch padded by repeating rows."""
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch import data, train

    rt.init(num_cpus=2, resources={"GPU": 1})
    try:
        ds = data.from_numpy({"x": np.arange(12)}, num_blocks=3).map_batches(
            lambda b: {"x": b["x"] * 10})
        res = train.TorchTrainer(
            prog.leased_loop, train_loop_config={"pkg": "ray_tpu_torch"},
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            datasets={"train": ds}).fit()
    finally:
        rt.shutdown()
    assert res.error is None, res.error
    assert res.metrics["rows"] == [10 * i for i in range(12)] + [100, 110,
                                                                 100]
    assert res.metrics["ppid"] == os.getpid()


def test_from_numpy_takes_a_cpu_tensor_as_numpy():
    """Blocks stay numpy: a CPU tensor becomes its numpy view."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data

    rt.init(num_cpus=1)
    try:
        ds = data.from_numpy({"x": torch.arange(6)}, num_blocks=2)
        batch = next(iter(ds.iter_batches(batch_size=6)))
        assert isinstance(batch["x"], np.ndarray)
        assert batch["x"].tolist() == list(range(6))
    finally:
        rt.shutdown()
