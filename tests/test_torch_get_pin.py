"""A value that ``get`` reads from the port's shared-memory store is a view
of the store's bytes. It keeps its object alive: the owner frees the object
only after the value is gone too, so the store never hands the bytes under
a live value to another object. Values are compared exactly. The JAX
package's store has the fault these cases catch (its values read another
object's bytes once their reference has gone)."""

import time

import numpy as np
import pytest

import ray_tpu_torch
from torch_fixtures import ray_start_regular  # noqa: F401

N = 1 << 20  # 4 MiB of float32: well past the inline limit, so in the store


def _make(kind: str, fill: float):
    if kind == "tensor":
        import torch

        return torch.full((N,), fill)
    return np.full((N,), fill, np.float32)


@ray_tpu_torch.remote
def _produce(kind: str, fill: float):
    return _make(kind, fill)


def _read_store(kind: str, fill: float, source: str):
    """A value from ``get`` whose only reference is gone, and the id of its
    object."""
    if source == "put":
        ref = ray_tpu_torch.put(_make(kind, fill))
    else:
        ref = _produce.remote(kind, fill)
    out = ray_tpu_torch.get(ref)
    oid = ref.binary()
    del ref
    return out, oid


GRACE_S = 0.5  # ``ref_free_grace_s`` here, for shorter waits


@pytest.fixture
def short_grace(monkeypatch):
    from ray_tpu_torch.core.config import config

    monkeypatch.setattr(config, "ref_free_grace_s", GRACE_S)


def _wait_past_grace():
    time.sleep(3 * GRACE_S + 1.0)


def _node_store(core):
    from ray_tpu_torch.core.node import shm_store_path

    return core._open_shm(shm_store_path(core.node_id))


@pytest.mark.timeout_s(120)
@pytest.mark.parametrize("source", ["put", "task"])
@pytest.mark.parametrize("kind", ["tensor", "ndarray"])
def test_value_outlives_its_reference(short_grace, ray_start_regular, kind,
                                      source):
    """Values whose references have gone stay intact while later objects of
    the same size fill the store (first fit would hand them the same
    bytes), and each later value is its own."""
    firsts = [_read_store(kind, float(i), source)[0] for i in range(4)]
    _wait_past_grace()
    later = [ray_tpu_torch.get(ray_tpu_torch.put(_make(kind, 100.0 + i)))
             for i in range(8)]
    for i, out in enumerate(firsts):
        assert np.array_equal(np.asarray(out), np.full((N,), float(i))), i
    for i, out in enumerate(later):
        assert np.array_equal(np.asarray(out),
                              np.full((N,), 100.0 + i)), i


@pytest.mark.timeout_s(120)
@pytest.mark.parametrize("kind", ["tensor", "ndarray"])
def test_object_freed_once_value_goes(short_grace, ray_start_regular, kind):
    """The object stays in the store while its value lives, and is freed
    once the value has gone as well (no leak)."""
    import gc

    out, oid = _read_store(kind, 7.0, "put")
    _wait_past_grace()
    store = _node_store(ray_start_regular)
    assert store.contains(oid)
    part = out[: N // 2]  # a view of the value keeps the object too
    del out
    gc.collect()
    _wait_past_grace()
    assert store.contains(oid)
    assert float(part[0]) == 7.0
    del part
    gc.collect()
    _wait_past_grace()
    assert not store.contains(oid)
