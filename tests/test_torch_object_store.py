"""The port's shared-memory object store (``ray_tpu_torch._native.objstore``
and the store behind ``put``/``get``): the 9 cases of
``tests/test_object_store.py`` under the same names, the cluster case on
the port's ``cluster_utils.Cluster``."""

import os

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._native.objstore import ShmStore
from torch_fixtures import ray_start_cluster, ray_start_regular  # noqa: F401


@pytest.fixture
def store(tmp_path):
    s = ShmStore.create(str(tmp_path / "test.store"), 8 << 20)
    yield s
    s.close()


def test_put_get_roundtrip(store):
    oid = os.urandom(16)
    assert store.put_bytes(oid, b"x" * 1000)
    with store.get_view(oid) as view:
        assert bytes(view.data) == b"x" * 1000


def test_missing_object(store):
    assert store.get_view(os.urandom(16)) is None
    assert not store.contains(os.urandom(16))


def test_duplicate_create_fails(store):
    oid = os.urandom(16)
    assert store.put_bytes(oid, b"a")
    assert not store.put_bytes(oid, b"b")


def test_eviction_under_pressure(store):
    ids = [os.urandom(16) for _ in range(20)]
    for oid in ids:
        assert store.put_bytes(oid, bytes(1 << 20))
    # 20 MB into an 8 MB store: early objects evicted, store stays bounded.
    assert store.used_bytes() <= store.capacity()
    assert not store.contains(ids[0])
    assert store.contains(ids[-1])


def test_pinned_survives_eviction(store):
    pinned = os.urandom(16)
    store.put_bytes(pinned, b"keep me")
    view = store.get_view(pinned)
    for _ in range(20):
        store.put_bytes(os.urandom(16), bytes(1 << 20))
    assert store.contains(pinned)
    view.release()


def test_delete_frees_space(store):
    oid = os.urandom(16)
    store.put_bytes(oid, bytes(1 << 20))
    used = store.used_bytes()
    assert store.delete(oid)
    assert store.used_bytes() < used


def test_oversized_object_rejected(store):
    assert not store.put_bytes(os.urandom(16), bytes(64 << 20))


def test_large_results_cross_node(ray_start_cluster):
    """A large result produced on node A is readable from node B via the
    node object server (reference: ObjectManager pull path)."""
    cluster = ray_start_cluster
    a = cluster.add_node(num_cpus=1, resources={"A": 1})
    b = cluster.add_node(num_cpus=1, resources={"B": 1})
    cluster.wait_for_nodes()
    ray_tpu_torch.init(address=cluster.address)

    @ray_tpu_torch.remote
    def produce():
        return np.arange(1 << 20, dtype=np.float64)  # 8 MB

    @ray_tpu_torch.remote
    def consume(arr):
        return float(arr[-1])

    ref = produce.options(num_cpus=0, resources={"A": 1}).remote()
    out = ray_tpu_torch.get(
        consume.options(num_cpus=0, resources={"B": 1}).remote(ref))
    assert out == float((1 << 20) - 1)


def test_zero_copy_numpy_view(ray_start_regular):
    """Local gets of shm-resident arrays are zero-copy views of the store."""
    arr = np.ones(1 << 20, dtype=np.float32)  # 4 MB => shm path
    ref = ray_tpu_torch.put(arr)
    out = ray_tpu_torch.get(ref)
    np.testing.assert_array_equal(out, arr)
    # A zero-copy view is read-only (backed by the store mmap).
    assert not out.flags.writeable
