"""The port's gang half of ``core/multihost.py`` and its process-group
bootstrap, against the JAX package on the CPU.

``GroupRegistry`` is driven by one call sequence side by side with
``ray_tpu.core.multihost.GroupRegistry``, in process (register, the
re-register epoch bump, a completed barrier, a timed-out one, a stale
epoch, the fenced KV, beats, state, drop): the replies must be equal.
Then, on the port's runtime: a bootstrap-fingerprint mismatch raises
``ProgramHashMismatch`` on every member; two gloo workers through
``TorchTrainer(TorchConfig(distributed=True, device_type="cpu"))`` run an
``all_reduce`` across the process boundary (the counterpart of
``tests/test_multihost.py:106``, skipped on this image's jaxlib), each on
its local rank from the placement, and the gang's record drops at
teardown; without a card, ``TorchConfig(distributed=True)`` raises."""

import threading

import pytest
import torch

import torch_train_program as prog
from ray_tpu.core import multihost as jmh
from ray_tpu_torch.core import multihost as tmh


@pytest.fixture
def fresh_metrics(monkeypatch):
    """Fresh metrics registries of both packages: each GroupRegistry
    registers a collector on its package's."""
    from ray_tpu.util import metrics as jm
    from ray_tpu_torch.util import metrics as tm

    monkeypatch.setattr(jm._Registry, "_instance", jm._Registry())
    monkeypatch.setattr(tm._Registry, "_instance", tm._Registry())


def _no_ages(state):
    """A ``group_state`` reply without the beat ages (wall-clock reads)."""
    if not isinstance(state, dict):
        return state
    if "members" in state:
        return {**state, "members": {m: {"epoch": i["epoch"]}
                                     for m, i in state["members"].items()}}
    return {g: _no_ages(s) for g, s in state.items()}


def _in_threads(calls):
    """Run each call in its own thread (barrier members park); their
    replies in order."""
    out = [None] * len(calls)

    def run(i, fn):
        out[i] = fn()

    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return out


def _sequence(reg):
    """One call sequence; every reply in order."""
    out = [reg.register_group("g", 2, "res-1", owner="train")]
    out.append(reg.register_group("g", 2, "res-2", owner="train"))
    out.append(reg.member_beat("g", "host-0", 2))
    out.append(reg.member_beat("g", "host-1", 1))      # deposed epoch
    out.append(reg.member_beat("nope", "host-0", 1))   # unknown group
    out.append(_in_threads([
        lambda: reg.barrier("g", "boot", "host-0", 2, "fp-a", 10.0),
        lambda: reg.barrier("g", "boot", "host-1", 2, "fp-b", 10.0)]))
    out.append(reg.barrier("g", "lonely", "host-0", 2, "x", 0.2))
    out.append(reg.barrier("g", "boot", "host-0", 1, "fp-a", 1.0))
    out.append(reg.barrier("nope", "boot", "host-0", 1, None, 1.0))
    out.append(reg.group_put("g", "coordinator", "host-0", 2))
    out.append(reg.group_put("g", "coordinator", "zombie", 1))
    out.append(reg.group_get("g", "coordinator"))
    out.append(reg.group_get("g", "absent"))
    out.append(reg.group_put("nope", "k", 1, 1))
    out.append(_no_ages(reg.group_state("g")))
    out.append(reg.register_group("h", 3))
    out.append(_no_ages(reg.group_state()))
    out.append(reg.drop_group("h"))
    out.append(reg.drop_group("h"))
    out.append(reg.group_state("h"))
    # A drop wakes a parked member with a refusal.
    out.append(_in_threads([
        lambda: reg.barrier("g", "dropped", "host-0", 2, None, 10.0),
        lambda: (__import__("time").sleep(0.3), reg.drop_group("g"))[1]]))
    return out


def test_group_registry_replies_match_jax(fresh_metrics):
    got = _sequence(tmh.GroupRegistry())
    want = _sequence(jmh.GroupRegistry())
    assert got == want
    assert got[1] == {"epoch": 2}
    assert got[5][0] == {"ok": True, "payloads": {"host-0": "fp-a",
                                                  "host-1": "fp-b"}}
    assert got[6] == {"ok": False, "reason": "timeout",
                      "arrived": ["host-0"], "absent": ["host-1"]}
    assert got[7] == {"ok": False, "reason": "stale_epoch", "epoch": 2}
    assert got[-1][0] == {"ok": False, "reason": "group_dropped"}


@pytest.mark.parametrize("mod", [jmh, tmh], ids=["jax", "torch"])
def test_errors_and_member_names_match(mod):
    assert mod.member_name(3) == "host-3"
    for name in ("GangPlacementError", "ProgramHashMismatch",
                 "GroupEpochFenced", "BarrierTimeout"):
        assert issubclass(getattr(mod, name), mod.MultihostError)


def test_program_fingerprints():
    """``text`` hashes verbatim, as in JAX; ``fn`` hashes the function's
    name and code with the arguments' shapes and dtypes (no jaxpr)."""
    assert tmh.program_fingerprint(text="torch.distributed|a|2|None") == \
        jmh.program_fingerprint(text="torch.distributed|a|2|None")

    def step(x, y):
        def inner(z):
            return z * 2
        return inner(x) + y

    def other(x, y):
        return x - y

    a, b = torch.zeros(2, 3), torch.zeros(3)
    fp = tmh.program_fingerprint(step, (a, b))
    assert fp == tmh.program_fingerprint(step, (torch.ones(2, 3), b))
    assert fp != tmh.program_fingerprint(step, (torch.zeros(4, 3), b))
    assert fp != tmh.program_fingerprint(step, (a.double(), b))
    assert fp != tmh.program_fingerprint(other, (a, b))
    # Nested code objects enter by content, not by their address.
    assert "0x" not in tmh._code_text(step.__code__)


@pytest.fixture(scope="module")
def cluster():
    import ray_tpu_torch as rt

    rt.init(num_cpus=4)
    try:
        yield rt
    finally:
        rt.shutdown()


def test_fingerprint_mismatch_refuses_every_member(cluster):
    """Two workers whose world sizes disagree: both raise
    ``ProgramHashMismatch`` at the bootstrap barrier, before any
    rendezvous, and the group drops."""
    from ray_tpu_torch.train.worker_group import TrainWorker

    gid, epoch = tmh.register_gang(2, owner="test")
    cls = cluster.remote(TrainWorker).options(num_cpus=0)
    workers = [cls.remote({"world_rank": r, "world_size": 2}, None, "t",
                          None) for r in range(2)]
    addr = cluster.get(workers[0].reserve_coordinator.remote(0))
    refs = [w.join_gang_runtime.remote(gid, epoch, tmh.member_name(r),
                                       addr, 2 + r, r, 0, "cpu")
            for r, w in enumerate(workers)]
    causes = []
    for ref in refs:
        with pytest.raises(cluster.TaskError) as e:
            cluster.get(ref, timeout=60)
        causes.append(type(e.value.cause).__name__)
    assert causes == ["ProgramHashMismatch", "ProgramHashMismatch"]
    assert tmh.drop_gang(gid) and tmh.registry_state(gid) is None
    for w in workers:
        cluster.kill(w)


def test_two_gloo_workers_all_reduce_through_the_trainer(cluster):
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.torch_backend import TorchConfig

    before = cluster.available_resources()
    seen = []
    result = TorchTrainer(
        prog.collective_loop, train_loop_config={},
        scaling_config=ScalingConfig(
            num_workers=2, torch_config=TorchConfig(
                distributed=True, device_type="cpu")),
        result_callback=seen.append).fit()
    assert result.error is None, result.error
    m = result.metrics
    assert m["sum"] == [3.0] * 4          # 1 + 2, from both processes
    assert m["backend"] == "gloo" and m["world"] == 2
    assert m["groups"] == [("train-worker-group", 2, 1)]
    assert m["local_rank"] == 0 and m["pid"] != __import__("os").getpid()
    assert tmh.registry_state() == {}      # the record dropped with the gang
    assert prog._poll(cluster.available_resources, before) == before


def test_local_ranks_follow_the_placement(cluster):
    """Each worker's local rank is its index among the gang's workers on
    its node (the JAX package sets 0: one process per TPU-VM host)."""
    from ray_tpu_torch.core.placement import (placement_group,
                                              remove_placement_group)
    from ray_tpu_torch.train.worker_group import local_ranks

    pg = placement_group([{"CPU": 1}] * 3)
    try:
        assert pg.ready(30)
        assert local_ranks(pg, 3) == [0, 1, 2]
    finally:
        remove_placement_group(pg)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal without a card")
def test_distributed_without_a_card_raises(cluster):
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.torch_backend import TorchConfig, init_process

    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_process("127.0.0.1:1", 1, 0)
    result = TorchTrainer(
        prog.collective_loop, train_loop_config={},
        scaling_config=ScalingConfig(
            num_workers=1, torch_config=TorchConfig(distributed=True))).fit()
    assert result.metrics is None
    assert "no CUDA device" in result.error
    assert tmh.registry_state() == {}
