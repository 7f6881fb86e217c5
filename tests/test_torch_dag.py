"""Compiled DAGs and shared-memory channels on the port
(``ray_tpu_torch.dag``, ``ray_tpu_torch.core.channel``): the 10 cases of
``tests/test_dag.py`` under the same names and settings, and five of the
port's own.

- ``test_llama_pipeline_parallel_matches_dense`` runs the port's Llama at
  the ``debug`` preset (bf16, as in the reference) on ``device="cpu"``,
  with the JAX package's ``init_params(key(0))`` carried in by
  ``llama.params_from_numpy``. Its pipelined logits are held against the
  JAX ``llama.forward`` on the same weights within 2e-2 of their max
  |value| (activations round to bf16 between ops on both sides, after
  sums in another order: the bf16 stage-output rule of
  ``tests/test_torch_pipeline.py``), and against the port's own
  ``llama.forward`` to the last bit (the same bf16 layers in the same
  order, cut at a stage boundary that hands the hidden state across
  unchanged; at this size the CPU forward is bit-equal at 1, 2 and 8
  torch threads, so the stage actors' thread count does not matter).
  Unlike the reference's, it is not marked slow: it takes a few seconds
  here.
- ``test_channel_header_matches_jax``: a channel made and written by each
  package holds the same bytes, header and slot.
- ``test_one_slot_ring_keeps_every_item``: a ring of one slot between
  three stages that return their input tensor itself (a CPU view of the
  slot): every result reaches the driver intact, so the middle stage's
  result leaves the slot before its ack and the terminal stage copies
  its input before the ack.
- ``test_channel_path_uses_port_name``: channel files live under
  ``<object_store_fallback_dir>/ray_tpu_torch/channels``.
- ``test_results_outlive_their_objects``: a result the collector read
  from the store stays intact while later items fill the store (the JAX
  package's runtime frees the object under it; the port's ``get`` value
  keeps its object, ``tests/test_torch_get_pin.py``).
"""

import os
import struct
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.dag import CompiledDAG, InputNode, MultiOutputNode  # noqa: F401,E501
from torch_fixtures import ray_start_regular  # noqa: F401


@ray_tpu_torch.remote
def plus_one(x):
    return x + 1


@ray_tpu_torch.remote
def times_ten(x):
    return x * 10


def test_interpreted_dag(ray_start_regular):
    with InputNode() as inp:
        dag = times_ten.bind(plus_one.bind(inp))
    ref = dag.execute(4)
    assert ray_tpu_torch.get(ref, timeout=60) == 50


def test_compiled_pipeline_results_in_order(ray_start_regular):
    with InputNode() as inp:
        dag = times_ten.bind(plus_one.bind(inp))
    cdag = dag.experimental_compile(max_in_flight=4)
    try:
        futs = [cdag.execute(i) for i in range(10)]
        assert [f.result(timeout=60) for f in futs] == [
            (i + 1) * 10 for i in range(10)]
    finally:
        cdag.teardown()


def test_compiled_pipeline_overlaps_stages(ray_start_regular):
    """Prove true pipelining structurally (not by wall time, which is
    load-sensitive on a 1-core CI host): stage A's work on item i+1 must
    overlap stage B's work on item i — each stage records its execution
    window and the windows must interleave."""
    @ray_tpu_torch.remote
    def slow_a(x):
        t0 = time.monotonic()
        time.sleep(0.3)
        return {"v": x, "a": (t0, time.monotonic())}

    @ray_tpu_torch.remote
    def slow_b(item):
        t0 = time.monotonic()
        time.sleep(0.3)
        item["b"] = (t0, time.monotonic())
        return item

    with InputNode() as inp:
        dag = slow_b.bind(slow_a.bind(inp))
    cdag = dag.experimental_compile(max_in_flight=8)
    try:
        futs = [cdag.execute(i) for i in range(2)]  # warm both stage actors
        [f.result(timeout=60) for f in futs]
        futs = [cdag.execute(i) for i in range(6)]
        out = sorted((f.result(timeout=120) for f in futs),
                     key=lambda r: r["v"])
        assert [r["v"] for r in out] == list(range(6))
        # Pipelined: for some consecutive pair, A(i+1) ran while B(i) ran.
        overlaps = [
            out[i + 1]["a"][0] < out[i]["b"][1]
            and out[i]["b"][0] < out[i + 1]["a"][1]
            for i in range(len(out) - 1)
        ]
        assert any(overlaps), f"stages never overlapped: {out}"
    finally:
        cdag.teardown()


def _close_rel(got, want, tol, name=""):
    """max |got - want| within ``tol`` of max |want|."""
    err = float(np.abs(np.asarray(got, np.float64)
                       - np.asarray(want, np.float64)).max())
    assert err <= tol * float(np.abs(want).max()), (name, err)


@pytest.mark.timeout_s(300)
def test_llama_pipeline_parallel_matches_dense(ray_start_regular):
    """PP end to end: the debug Llama split into 2 pipeline stages hosted
    by compiled-DAG actors; microbatches stream through with stage overlap
    and the pipelined logits match the single-process forward."""
    import jax
    import torch

    from ray_tpu.models import llama as jl
    from ray_tpu_torch import dag
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.pipeline import (make_stage_worker,
                                                 split_llama_stages)

    cfg = llama.PRESETS["debug"]  # remat stays ON: stage fns must support it
    jcfg = jl.PRESETS["debug"]
    jparams = jl.init_params(jcfg, jax.random.key(0))
    params = llama.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    stages = split_llama_stages(params, cfg, n_stages=2)
    host_params = [{k: v for k, v in p.items()} for p, _fn in stages]

    workers = [
        ray_tpu_torch.remote(make_stage_worker(cfg, i, 2, host_params[i],
                                               device="cpu"))
        for i in range(2)
    ]

    with dag.InputNode() as inp:
        node = workers[0].bind(inp)
        node = workers[1].bind(node)
    pipe = node.experimental_compile(max_in_flight=4)
    try:
        rng = np.random.default_rng(0)
        microbatches = [rng.integers(0, cfg.vocab_size, (2, 16))
                        for _ in range(4)]
        futs = [pipe.execute(mb) for mb in microbatches]
        outs = [f.result(timeout=180) for f in futs]
        for mb, out in zip(microbatches, outs):
            assert isinstance(out, torch.Tensor)
            assert out.dtype == torch.float32
            assert tuple(out.shape) == (2, 16, cfg.vocab_size)
            ref_logits = np.asarray(jl.forward(jparams, mb, jcfg))
            _close_rel(out.numpy(), ref_logits, 2e-2, "vs jax")
            with torch.no_grad():
                own = llama.forward(params, torch.as_tensor(mb), cfg)
            assert torch.equal(out, own)
    finally:
        pipe.teardown()


def test_stage_boundaries_balanced():
    from ray_tpu_torch.parallel.pipeline import stage_boundaries

    assert stage_boundaries(8, 2) == [(0, 4), (4, 8)]
    assert stage_boundaries(7, 3) == [(0, 3), (3, 5), (5, 7)]
    assert stage_boundaries(2, 2) == [(0, 1), (1, 2)]


# --------------------------------------------- mutable shm channels
# (reference: experimental_mutable_object_manager.h,
# shared_memory_channel.py:169)


def test_mutable_channel_protocol(tmp_path):
    """Depth-1 write/read/ack handshake with zero-copy payloads (the
    strict-backpressure configuration)."""
    import numpy as np

    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.core.channel import ChannelTimeout, MutableChannel

    path = str(tmp_path / "edge.chan")
    reader = MutableChannel(path, create=True, capacity=1 << 20, nslots=1)
    writer = MutableChannel(path)
    assert writer.nslots == 1  # opener reads the ring shape from header

    arr = np.arange(1000, dtype=np.float64)
    assert writer.write((7, arr))
    view = reader.read(timeout=5.0)
    seq, got = serialization.deserialize(view)
    assert seq == 7
    np.testing.assert_array_equal(got, arr)
    # Writer blocks until ack: a second write times out while unacked.
    with pytest.raises(ChannelTimeout):
        writer.write((8, arr), timeout=0.3)
    del got, view
    reader.ack()
    assert writer.write((8, arr * 2))
    _seq2, got2 = serialization.deserialize(bytes(reader.read(timeout=5.0)))
    reader.ack()
    np.testing.assert_array_equal(got2, arr * 2)
    # Oversized payloads are refused (caller falls back to RPC).
    assert not writer.write((9, np.zeros(1 << 20)))
    writer.close()
    reader.close()


def test_mutable_channel_ring_overlap(tmp_path):
    """Ring depth N: the writer runs N items ahead of the ack (overlap),
    blocks on N+1, and every item survives slot reuse across wraps
    (reference: buffered shared-memory channels,
    shared_memory_channel.py:169)."""
    import numpy as np

    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.core.channel import ChannelTimeout, MutableChannel

    path = str(tmp_path / "ring.chan")
    reader = MutableChannel(path, create=True, capacity=1 << 16, nslots=3)
    writer = MutableChannel(path)

    # 3 writes land without any ack...
    for i in range(3):
        assert writer.write((i, np.full(64, i, dtype=np.int64)))
    # ...the 4th needs a free slot.
    with pytest.raises(ChannelTimeout):
        writer.write((3, np.zeros(64)), timeout=0.3)
    # Reader holds item 0's view UNACKED: contents stay intact (the
    # writer is blocked out of this slot). Ack only after consuming —
    # past the ack the slot is the writer's again.
    view0 = reader.read(timeout=5.0)
    seq0, got0 = serialization.deserialize(view0)
    assert seq0 == 0 and got0[0] == 0
    del got0, view0
    reader.ack()  # frees slot 0
    assert writer.write((3, np.full(64, 3, dtype=np.int64)))
    # Drain in order through two full wraps of the ring.
    expect = 1
    for i in range(4, 10):
        seq, got = serialization.deserialize(bytes(reader.read(timeout=5.0)))
        reader.ack()
        assert seq == expect and got[0] == expect
        expect += 1
        assert writer.write((i, np.full(64, i, dtype=np.int64)))
    while expect < 10:
        seq, got = serialization.deserialize(bytes(reader.read(timeout=5.0)))
        reader.ack()
        assert seq == expect and got[0] == expect
        expect += 1
    writer.close()
    reader.close()


@pytest.mark.timeout_s(240)
def test_compiled_dag_channels_correct_under_load(ray_start_regular):
    """Many items through a 3-stage channeled pipeline: every result
    correct and matched to its sequence despite bounded in-flight."""
    import numpy as np

    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote
    def scale(x):
        return x * 2

    @ray_tpu_torch.remote
    def shift(x):
        return x + 1

    @ray_tpu_torch.remote
    def total(x):
        return float(np.sum(x))

    with InputNode() as inp:
        dag = total.bind(shift.bind(scale.bind(inp)))
    compiled = dag.experimental_compile(max_in_flight=4)
    try:
        futs = [compiled.execute(np.full(1000, i, np.float64))
                for i in range(40)]
        for i, fut in enumerate(futs):
            assert fut.result(timeout=120) == 1000 * (2 * i + 1)
        # Same-host stages really did get channel edges.
        assert len(compiled._channel_paths) == 2
    finally:
        compiled.teardown()
    import os

    assert not any(os.path.exists(p) for p in compiled._channel_paths)


@pytest.mark.timeout_s(240)
def test_compiled_dag_oversized_items_fall_back(ray_start_regular):
    """Items larger than the channel slot ride the RPC fallback and still
    arrive correctly (mixed with small channeled items)."""
    import numpy as np

    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.dag import InputNode

    old = config.dag_channel_capacity_bytes
    config.dag_channel_capacity_bytes = 64 * 1024
    try:
        @ray_tpu_torch.remote
        def double(x):
            return x * 2

        @ray_tpu_torch.remote
        def head(x):
            return float(x[0])

        with InputNode() as inp:
            dag = head.bind(double.bind(inp))
        compiled = dag.experimental_compile(max_in_flight=2)
        try:
            sizes = [100, 50_000, 100, 50_000, 100]  # floats: 400B..400KB
            futs = [compiled.execute(np.full(n, i + 1, np.float64))
                    for i, n in enumerate(sizes)]
            for i, fut in enumerate(futs):
                assert fut.result(timeout=120) == 2.0 * (i + 1)
        finally:
            compiled.teardown()
    finally:
        config.dag_channel_capacity_bytes = old


@pytest.mark.timeout_s(240)
def test_compiled_dag_stage_error_reaches_future(ray_start_regular):
    """A raising stage fn resolves that item's Future with the error and
    the pipeline keeps processing later items (the ack still happens)."""
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote
    def maybe_fail(x):
        if x == 13:
            raise ValueError("unlucky")
        return x * 2

    @ray_tpu_torch.remote
    def plus(x):
        return x + 1

    with InputNode() as inp:
        dag = plus.bind(maybe_fail.bind(inp))
    compiled = dag.experimental_compile(max_in_flight=2)
    try:
        ok1 = compiled.execute(1)
        bad = compiled.execute(13)
        ok2 = compiled.execute(2)
        assert ok1.result(timeout=120) == 3
        with pytest.raises(Exception, match="unlucky"):
            bad.result(timeout=120)
        assert ok2.result(timeout=120) == 5
    finally:
        compiled.teardown()


# ------------------------------------------------------ the port's own


def test_channel_header_matches_jax(tmp_path):
    """The same ring made by each package: the file's bytes (the 64-byte
    header, then the slots) agree after the create, after a write of the
    same item, and after the reader's ack."""
    from ray_tpu.core.channel import MutableChannel as JaxChannel
    from ray_tpu_torch.core.channel import HEADER_SIZE, MutableChannel

    item = (7, np.arange(1000, dtype=np.float64), {"k": [1, 2.5, "v"]})
    files = {}
    for name, cls in (("jax", JaxChannel), ("port", MutableChannel)):
        path = str(tmp_path / f"{name}.chan")
        reader = cls(path, create=True, capacity=1 << 16, nslots=3)
        writer = cls(path)
        snaps = [open(path, "rb").read()]
        assert writer.write(item)
        snaps.append(open(path, "rb").read())
        reader.read(timeout=5.0)
        reader.ack()
        snaps.append(open(path, "rb").read())
        writer.close()
        reader.close()
        files[name] = snaps
    for got, want in zip(files["port"], files["jax"]):
        assert len(got) == len(want) == HEADER_SIZE + 3 * (1 << 16)
        assert got[:HEADER_SIZE] == want[:HEADER_SIZE]
        assert got == want
    header = files["port"][2][:HEADER_SIZE]
    write_seq, read_ack, nslots, cap, len0 = struct.unpack_from(
        "<5Q", header)
    assert (write_seq, read_ack, nslots, cap) == (1, 1, 3, 1 << 16)
    assert len0 > 8000


def test_channel_path_uses_port_name(tmp_path, monkeypatch):
    from ray_tpu_torch.core.channel import channel_path
    from ray_tpu_torch.core.config import config

    monkeypatch.setattr(config, "object_store_fallback_dir", str(tmp_path))
    path = channel_path("run-e0")
    assert path == os.path.join(str(tmp_path), "ray_tpu_torch", "channels",
                                "run-e0.chan")
    assert os.path.isdir(os.path.dirname(path))


@pytest.mark.timeout_s(240)
def test_one_slot_ring_keeps_every_item(ray_start_regular, monkeypatch):
    import torch

    from ray_tpu_torch.core.config import config

    monkeypatch.setattr(config, "dag_channel_slots", 1)

    @ray_tpu_torch.remote
    def make(i):
        return torch.full((16384,), float(i), dtype=torch.float32)

    @ray_tpu_torch.remote
    def same(x):
        return x  # a CPU view of this stage's input slot

    @ray_tpu_torch.remote
    def last(x):
        return x  # the terminal stage: its copy must outlive the ack

    with InputNode() as inp:
        dag = last.bind(same.bind(make.bind(inp)))
    compiled = dag.experimental_compile(max_in_flight=8)
    try:
        assert len(compiled._channel_paths) == 2
        futs = [compiled.execute(i) for i in range(24)]
        outs = [f.result(timeout=120) for f in futs]
    finally:
        compiled.teardown()
    for i, out in enumerate(outs):
        assert isinstance(out, torch.Tensor) and out.shape == (16384,)
        assert torch.equal(out, torch.full_like(out, float(i))), i
    assert not any(os.path.exists(p) for p in compiled._channel_paths)


@pytest.mark.timeout_s(240)
def test_results_outlive_their_objects(ray_start_regular, monkeypatch):
    """A pipelined result stays intact while later items fill the store:
    the collector's ``get`` returns a view of the store, which keeps its
    object after the collector drops the reference. In the JAX package
    the object is freed ``ref_free_grace_s`` later and its first results
    are overwritten here."""
    import torch

    from ray_tpu_torch.core.config import config

    monkeypatch.setattr(config, "dag_channel_capacity_bytes", 64 * 1024)

    @ray_tpu_torch.remote
    def make(i):
        return torch.full((1 << 18,), float(i))  # 1 MiB: the RPC push

    @ray_tpu_torch.remote
    def grow(x):
        return torch.cat([x] * 4)  # 4 MiB through the store

    with InputNode() as inp:
        dag = grow.bind(make.bind(inp))
    compiled = dag.experimental_compile(max_in_flight=4)
    try:
        first = [f.result(timeout=120)
                 for f in [compiled.execute(i) for i in range(6)]]
        time.sleep(3 * config.ref_free_grace_s)  # their objects are freed
        later = [f.result(timeout=120)
                 for f in [compiled.execute(100 + i) for i in range(6)]]
    finally:
        compiled.teardown()
    for i, out in enumerate(first):
        assert torch.equal(out, torch.full((1 << 20,), float(i))), i
    for i, out in enumerate(later):
        assert torch.equal(out, torch.full((1 << 20,), 100.0 + i)), i

