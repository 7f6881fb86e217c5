"""The port's ``device_prefetch`` (``ray_tpu_torch/data/ingest.py``)
against the JAX package's on the same host batches (numpy from a seed),
on the CPU: values and order, the exception surfaced after the batches
before it, the queue bound, the dtype rule, the refusals, and a ViT train
loop fed by it. Values compare exactly: both sides copy the same numbers.
The pinned / side-stream path runs on a card only
(``tests/test_torch_ingest_cuda.py``)."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu.data.ingest import device_prefetch as jax_prefetch
from ray_tpu_torch.data import device_prefetch
from ray_tpu_torch.ops.optim import tree_leaves
from torch_parity import world_of_one  # noqa: F401
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.ops.optim import adamw, tree_leaves
from ray_tpu_torch.parallel import train_step as tts
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _host_batches(n=5, seed=0, b=4):
    rng = np.random.default_rng(seed)
    return [{"images": rng.standard_normal((b, 8, 8, 3), dtype=np.float32),
             "labels": rng.integers(0, 10, b).astype(np.int64),
             "meta": {"w": rng.standard_normal(b),
                      "i": np.arange(b, dtype=np.int32)}}
            for _ in range(n)]


def _leaves(batch):
    return [batch["images"], batch["labels"], batch["meta"]["i"],
            batch["meta"]["w"]]


def test_values_and_order_match_jax():
    host = _host_batches()
    got = list(device_prefetch(iter(host), device="cpu"))
    want = list(jax_prefetch(iter(host)))
    assert len(got) == len(want) == len(host)
    for g, w, h in zip(got, want, host):
        for gl, wl, hl in zip(_leaves(g), _leaves(w), _leaves(h)):
            assert isinstance(gl, torch.Tensor) and gl.device.type == "cpu"
            np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
            np.testing.assert_array_equal(gl.numpy(),
                                          hl.astype(gl.numpy().dtype))


def test_dtype_rule():
    """float64 lands as float32 on both sides; int64 stays int64 in the
    port where JAX (x64 off) gives int32 (a deliberate difference: torch
    indexes with int64); the other dtypes keep theirs."""
    host = {"f64": np.linspace(0, 1, 6), "f32": np.ones(3, np.float32),
            "i64": np.array([1, 2**40], np.int64),
            "i32": np.arange(3, dtype=np.int32),
            "u8": np.arange(3, dtype=np.uint8), "b": np.array([True, False]),
            "t": torch.arange(4, dtype=torch.float64)}
    got = next(device_prefetch(iter([host]), device="cpu"))
    want = next(jax_prefetch(iter([{k: v for k, v in host.items()
                                    if k != "t"}])))
    assert got["f64"].dtype == torch.float32 == got["t"].dtype
    assert str(want["f64"].dtype) == "float32"
    assert got["i64"].dtype == torch.int64
    assert str(want["i64"].dtype) == "int32"
    assert int(got["i64"][1]) == 2**40
    for k, dt in (("f32", torch.float32), ("i32", torch.int32),
                  ("u8", torch.uint8), ("b", torch.bool)):
        assert got[k].dtype == dt
        assert str(want[k].dtype) == str(dt).removeprefix("torch.")
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_list_leaves_are_refused():
    with pytest.raises(TypeError, match="dict tree"):
        next(device_prefetch(iter([{"x": (np.ones(2), np.ones(2))}]),
                             device="cpu"))


def test_batches_are_copies():
    arr = np.zeros(4, np.float32)
    it = device_prefetch(iter([{"x": arr}]), device="cpu")
    got = next(it)
    arr[:] = 7
    assert float(got["x"].sum()) == 0.0


def _failing(n_good):
    for i in range(n_good):
        yield {"x": np.full(2, i, np.float32)}
    raise ValueError("host reader broke")


@pytest.mark.parametrize("prefetch", [1, 3])
def test_exception_after_earlier_batches(prefetch):
    for make in (lambda: device_prefetch(_failing(3), prefetch=prefetch,
                                         device="cpu"),
                 lambda: jax_prefetch(_failing(3), prefetch=prefetch)):
        seen = []
        with pytest.raises(ValueError, match="host reader broke"):
            for b in make():
                seen.append(float(np.asarray(b["x"])[0]))
        assert seen == [0.0, 1.0, 2.0]


def test_stream_ends_for_good():
    it = device_prefetch(iter(_host_batches(2)), device="cpu")
    assert len(list(it)) == 2
    with pytest.raises(StopIteration):
        next(it)


@pytest.mark.parametrize("prefetch", [0, 1, 2, 3])
def test_producer_stays_within_prefetch_plus_one(prefetch):
    """The producer pulls at most ``max(1, prefetch)`` batches into the
    queue plus the one it is blocked putting: never more than that many
    ahead of the consumer, on both sides; and it does fill that far."""
    bound = max(1, prefetch) + 1      # queue slots + the producer's hand
    for wrap in (lambda h: device_prefetch(h, prefetch=prefetch,
                                           device="cpu"),
                 lambda h: jax_prefetch(h, prefetch=prefetch)):
        pulled = []
        lock = threading.Lock()

        def host():
            for i in range(12):
                with lock:
                    pulled.append(i)
                yield {"x": np.full(1, i, np.float32)}

        ahead = []
        for n, b in enumerate(wrap(host()), start=1):
            deadline = time.monotonic() + 2.0
            while time.monotonic() < deadline:   # let the producer run
                with lock:
                    k = len(pulled)
                if k >= min(12, n + bound):
                    break
                time.sleep(0.001)
            time.sleep(0.005)
            with lock:
                ahead.append(len(pulled) - n)
            assert float(np.asarray(b["x"])[0]) == n - 1
        assert max(ahead) == bound, ahead


def test_many_prefetchers_keep_order_under_fast_switching():
    """Stress: more producer threads than cores, a switch interval of a
    microsecond; every stream arrives whole and in order."""
    n_streams, n_batches = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def stream(i):
            for j in range(n_batches):
                yield {"x": np.full(1, i * 1000 + j, np.int64)}

        its = [device_prefetch(stream(i), prefetch=1 + i % 3, device="cpu")
               for i in range(n_streams)]
        got = [[] for _ in its]
        deadline = time.monotonic() + 60
        for _ in range(n_batches):
            for i, it in enumerate(its):
                got[i].append(int(next(it)["x"][0]))
            assert time.monotonic() < deadline
        for i, it in enumerate(its):
            with pytest.raises(StopIteration):
                next(it)
            assert got[i] == [i * 1000 + j for j in range(n_batches)]
    finally:
        sys.setswitchinterval(old)


def test_wait_is_recorded_per_batch():
    it = device_prefetch(iter(_host_batches(3)), device="cpu")
    list(it)
    s = it.stats()
    assert s["batches"] == 3 and len(s["wait_s"]) == 3
    assert all(w >= 0 for w in s["wait_s"])


def test_mesh_lands_batches_through_shard_batch(world_of_one):
    """``device_prefetch(mesh=...)`` yields DTensors placed as
    ``shard_batch`` places them, in order, with the host batches' values
    (the JAX prefetch with a mesh, on a one-rank CPU mesh)."""
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.train_step import shard_batch

    mesh = MeshSpec(fsdp=-1).build(device_type="cpu")
    host = _host_batches(3)
    got = list(device_prefetch(iter(host), mesh=mesh))
    assert len(got) == 3
    for g, h in zip(got, host):
        want = tree_leaves(shard_batch(h, mesh))
        for gl, wl in zip(tree_leaves(g), want):
            assert gl.placements == wl.placements
            np.testing.assert_allclose(gl.full_tensor().numpy(),
                                       wl.full_tensor().numpy(), rtol=1e-7)


def test_refuses_without_card_and_device():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_prefetch(iter(_host_batches(1)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvit.init_params(tvit.PRESETS["debug"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvit.params_from_numpy({}, tvit.PRESETS["debug"])


def test_vit_train_loop_fed_by_prefetch_matches_direct():
    """Three AdamW steps of the debug ViT fed by ``device_prefetch`` equal
    the same steps on the same batches handed over directly, bit for
    bit."""
    cfg = tvit.PRESETS["debug"]
    rng = np.random.default_rng(7)
    host = [{"images": rng.standard_normal((4, 16, 16, 3)),   # float64
             "labels": rng.integers(0, 10, 4)} for _ in range(3)]
    runs = []
    for feed in ("prefetch", "direct"):
        params = tvit.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
        params["head"].normal_(generator=torch.Generator().manual_seed(1))
        opt = adamw(3e-4, weight_decay=0.1)
        state = tts.init_optimizer_state(opt, params)
        step = tts.build_train_step(lambda p, b: tvit.loss_fn(p, b, cfg)[0],
                                    opt)
        batches = (device_prefetch(iter(host), device="cpu")
                   if feed == "prefetch" else
                   [{"images": torch.from_numpy(h["images"]).float(),
                     "labels": torch.from_numpy(h["labels"])}
                    for h in host])
        losses = []
        for b in batches:
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
        runs.append((losses, params))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])):
        assert torch.equal(a, b)
