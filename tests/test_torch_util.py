"""``ray_tpu_torch.util``'s ``ActorPool`` and ``Queue`` and its host
collectives (``util/collective.py``) against the JAX package's: one
program (``tests/torch_host_program.util_program``) runs on ``ray_tpu``,
then on ``ray_tpu_torch`` (``init(num_cpus=4)`` each, never both up), and
every output must be equal, exactly: the pool's ordered and unordered
results and its refusal past its idle actors, the queue's FIFO order,
``Full`` and ``Empty`` with and without a timeout, 20 items through a
``Queue(maxsize=4)`` between a producer task and a consumer task, and
``allreduce`` (sum, mean, max, min), ``allgather``, ``broadcast`` and
``barrier`` over 4 actors on float32 arrays (the same numpy reductions on
both sides, so no tolerance). Each output is also held to its expected
value, so the two cannot agree on a wrong answer."""

import numpy as np
import pytest

import torch_host_program as prog


@pytest.fixture(scope="module")
def runs():
    import ray_tpu
    import ray_tpu_torch

    out = {}
    for name, pkg in (("ray_tpu", ray_tpu), ("ray_tpu_torch", ray_tpu_torch)):
        pkg.init(num_cpus=4)
        try:
            out[name] = prog.util_program(name)
        finally:
            pkg.shutdown()
    return out


def _both(runs, key):
    got, want = runs["ray_tpu_torch"][key], runs["ray_tpu"][key]
    assert got == want, (key, got, want)
    return got


def test_exports_match_jax():
    import ray_tpu.util as ju
    import ray_tpu_torch.util as tu

    for name in ("ActorPool", "Queue", "Empty", "Full"):
        assert hasattr(tu, name) and hasattr(ju, name)
    assert issubclass(tu.Empty, Exception) and issubclass(tu.Full, Exception)


def test_actor_pool_map_in_order(runs):
    assert _both(runs, "map") == [v * v for v in range(12)]


def test_actor_pool_unordered_and_refusal(runs):
    assert _both(runs, "unordered_sorted") == [v * v for v in range(4)]
    assert _both(runs, "submit_past_idle") == \
        "no idle actors; call get_next first"
    assert _both(runs, "drain") == [v * v for v in range(4)]


def test_queue_full_and_empty_under_timeouts(runs):
    assert _both(runs, "errors") == ["full_nowait", "full_timeout",
                                     "empty_nowait", "empty_timeout"]
    assert _both(runs, "full_waited") is True
    assert _both(runs, "qsize") == 2
    assert _both(runs, "fifo") == ["a", "b"]
    assert _both(runs, "empty") is True


def test_queue_between_tasks(runs):
    assert _both(runs, "through") == list(range(20))
    assert _both(runs, "produced") == 20


def test_collectives_over_four_actors(runs):
    got = _both(runs, "collective")
    n, world = 256, 4
    ranks = [np.arange(n, dtype=np.float32) + r for r in range(world)]
    stack = np.stack(ranks)
    for rank_out in got:
        np.testing.assert_array_equal(rank_out["sum"], stack.sum(0))
        np.testing.assert_array_equal(rank_out["mean"], stack.mean(0))
        np.testing.assert_array_equal(rank_out["max"], stack.max(0))
        np.testing.assert_array_equal(rank_out["min"], stack.min(0))
        np.testing.assert_array_equal(rank_out["gather"],
                                      np.stack([r[:4] for r in ranks]))
        np.testing.assert_array_equal(rank_out["bcast"], ranks[2] * 10)
        np.testing.assert_array_equal(rank_out["sum2"], stack.sum(0) * 2)
