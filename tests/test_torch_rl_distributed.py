"""The port's distributed RL plane (``ray_tpu_torch.rl.distributed``) on the
CPU: a counterpart of each case of ``tests/test_rl_distributed.py`` (same
names and settings, ``device="cpu"``; the two slow ones stay ``slow``; the
two graftlint mutation cases lint ``ray_tpu/`` only and are not carried;
``test_rl_offpolicy.py``'s DQN soak on this plane is
``tests/test_torch_rl.py``'s), the build wiring, and parity with
``ray_tpu.rl.distributed``.

The JAX package's half of each parity case runs first, under its own
``ray_tpu.init``, which is shut down before the port's ``init`` (never
both up). Inputs are seeded numpy; params come from the JAX package's own
inits, carried across by ``rl.models.params_from_numpy``.

Tolerances (float32 on both sides):
- ``PolicyInference``: each reply's value and the log-prob of its action
  within 1e-5 relative of a JAX forward of the same params on the same
  rows; at epsilon 0, actions equal JAX's argmax where JAX's top-2 margin
  exceeds 1e-4 (draws cannot equal JAX's threefry ones, so sampled
  actions are checked by their log-probs and by determinism: two services
  given the same seeds reply the same);
- ``LearnerState``: three IMPALA updates with Adam, losses at rtol 1e-4,
  params within 3 x lr x updates (Adam's first steps are near sign(g)),
  the fan-out version equal, and ``plane_stats``' staleness, shards and
  env steps equal;
- ``RolloutActor.collect()`` greedy (epsilon 0): the descriptor's fields
  equal, both under ``DESCRIPTOR_BYTE_BUDGET``, and the rollout behind the
  ref equal (obs, actions, rewards, dones, valids), values at rtol 1e-5.
"""

import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.rl import APPO, APPOConfig, DQNConfig, IMPALAConfig
from ray_tpu_torch.rl.distributed import (
    DESCRIPTOR_BYTE_BUDGET,
    DistributedDQN,
    DistributedIMPALA,
    ShardQueue,
    ShardQueueClosed,
    TrajectoryShard,
)
from ray_tpu_torch.rl.distributed.fanout import (
    WEIGHTS_CHANNEL,
    WeightFanout,
    WeightReceiver,
)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = dict(device="cpu")
LR = 5e-4                 # IMPALAConfig's default
ADAM_BOUND = 3.0
VALUE_TOL = 1e-5
MARGIN_TOL = 1e-4
ROLLOUT_KEYS = ("obs", "actions", "logp", "rewards", "dones", "valids",
                "last_value")


def _shard(i: int) -> TrajectoryShard:
    return TrajectoryShard(ref=None, weights_version=i, env_steps=1,
                           actor_index=0, seq=i)


# ----------------------------------------------------------- ShardQueue


def test_shard_queue_bounded_put_and_fifo():
    q = ShardQueue(2)
    assert q.put(_shard(1), timeout=0.1)
    assert q.put(_shard(2), timeout=0.1)
    # Full: bounded put blocks, then times out (the backpressure edge).
    t0 = time.monotonic()
    assert not q.put(_shard(3), timeout=0.2)
    assert time.monotonic() - t0 >= 0.15
    assert q.get(timeout=0.1).weights_version == 1
    assert q.put(_shard(3), timeout=0.1)  # slot freed
    assert [q.get(timeout=0.1).weights_version for _ in range(2)] == [2, 3]
    assert q.get(timeout=0.05) is None
    assert q.counters() == {"put": 3, "got": 3, "depth": 0}


def test_shard_queue_close_unsticks_blocked_put():
    q = ShardQueue(1)
    q.put(_shard(1))
    errs = []

    def blocked_put():
        try:
            q.put(_shard(2))  # no timeout: parks until close
        except ShardQueueClosed as e:
            errs.append(e)

    t = threading.Thread(target=blocked_put)
    t.start()
    time.sleep(0.1)
    leftover = q.close()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert len(errs) == 1
    assert [s.weights_version for s in leftover] == [1]
    with pytest.raises(ShardQueueClosed):
        q.get()
    with pytest.raises(ShardQueueClosed):
        q.put(_shard(4))


# ------------------------------------------------------ shutdown hygiene
# First in the file: it runs its own init, before the module's runtime.


@pytest.mark.timeout_s(240)
@pytest.mark.slow
def test_distributed_shutdown_frees_objects():
    """Zero leaked ObjectRefs: after stop(), the published weights
    object is freed from the driver-side store (the hub's pinned handle
    is dropped by psub_drop; shard refs die with their actors)."""
    core = rt.init(num_cpus=4, _system_config={
        "ref_free_grace_s": 0.3, "ref_flush_interval_s": 0.05})
    try:
        algo = DQNConfig(**CPU).environment(
            "CartPole-v1").distributed_rollouts(
            4, num_envs_per_actor=2).training(
            rollout_length=8, learning_starts=32,
            batch_size=32, train_batches_per_iter=2).build()
        algo.train()
        weights_oid = algo.state.fanout.latest_ref.id
        assert core.store.contains(weights_oid)
        algo.stop()
        report = algo.last_leak_report
        assert report["queue_depth"] == 0
        assert report["intake_alive"] is False
        from ray_tpu_torch.core.rpc_stubs import ControllerStub

        snap = ControllerStub(core.controller).psub_snapshot(
            WEIGHTS_CHANNEL)
        assert algo.state.plane_key not in snap
        del algo
        deadline = time.monotonic() + 15.0
        while True:
            entry = core.store._entries.get(weights_oid)
            if entry is None or entry.freed:
                break
            assert time.monotonic() < deadline, \
                "published weights object never freed after shutdown " \
                f"(refcount={entry.refcount})"
            time.sleep(0.1)
    finally:
        rt.shutdown()


# ------------------------------------------------- the JAX package's side


def _rollouts(n: int, T: int = 16, N: int = 4, seed: int = 7):
    """``n`` seeded CartPole-shaped (T, N) rollouts with the fields the
    IMPALA update reads: dones at ~8%, the row after a done synthetic."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        dones = (rng.random((T, N)) < 0.08).astype(np.float32)
        valids = np.ones((T, N), np.float32)
        valids[1:] = 1.0 - dones[:-1]
        out.append({
            "obs": rng.normal(size=(T, N, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
            "logp": np.log(rng.uniform(0.3, 0.7, (T, N))).astype(
                np.float32),
            "rewards": valids.copy(),
            "dones": dones, "valids": valids,
            "last_value": rng.normal(size=(N,)).astype(np.float32)})
    return out


SHARD_VERSIONS = (1, 1, 2)   # the version each shard was sampled with


def _jax_learner(rollouts):
    """Three IMPALA updates through the JAX ``LearnerState`` (no mesh),
    publishing after each: init and final params, each update's aux,
    ``plane_stats`` and the fan-out's version."""
    import jax
    import jax.numpy as jnp
    import optax

    import ray_tpu
    from ray_tpu.rl.distributed.learner import (LearnerState,
                                                new_plane_key, plane_stats)
    from ray_tpu.rl.impala import IMPALAConfig as JConfig
    from ray_tpu.rl.impala import make_impala_update
    from ray_tpu.rl.models import build_policy

    cfg = JConfig()
    init_fn, forward = build_policy((4,), 2, cfg.hidden)
    params = init_fn(jax.random.key(0))
    init = jax.tree.map(np.asarray, params)
    opt = optax.adam(cfg.lr)
    opt_state = opt.init(params)
    update = jax.jit(make_impala_update(forward, opt, cfg))
    state = LearnerState(new_plane_key("parity"), use_mesh=False)
    state.publish(jax.device_get(params), version=1)
    auxes = []
    for i, (ro, ver) in enumerate(zip(rollouts, SHARD_VERSIONS)):
        ref = ray_tpu.put(ro)
        shard = TrajectoryShard(ref=ref, weights_version=ver,
                                env_steps=int(ro["valids"].sum()),
                                actor_index=i % 2, seq=i)
        state.record_staleness(shard)
        got = ray_tpu.get(shard.ref)
        batch = {k: jnp.asarray(v) for k, v in state.shard_batch(
            {k: got[k] for k in ROLLOUT_KEYS}).items()}
        params, opt_state, aux = state.timed_update(
            lambda b=batch: update(params, opt_state, b))
        auxes.append({k: float(v) for k, v in aux.items()})
        state.publish(jax.device_get(params), version=i + 2)
    out = {"init": init, "params": jax.tree.map(np.asarray, params),
           "aux": auxes, "stats": plane_stats(state.plane_key),
           "version": state.version}
    state.close()
    return out


def _jax_collect():
    """A greedy (epsilon 0) JAX ``RolloutActor.collect()`` in this
    process: (params, descriptor fields, its serialized size, the rollout
    behind the ref)."""
    import jax

    import ray_tpu
    from ray_tpu.core.serialization import serialized_size
    from ray_tpu.rl.distributed.fanout import WeightFanout as JFanout
    from ray_tpu.rl.distributed.rollout import RolloutActor as JActor
    from ray_tpu.rl.models import build_policy

    init_fn, _ = build_policy((4,), 2)
    params = jax.tree.map(np.asarray, init_fn(jax.random.key(3)))
    fan = JFanout("parity-collect")
    fan.publish(params, {"epsilon": 0.0})
    try:
        actor = JActor("CartPole-v1", 1, "parity-collect", num_envs=2,
                       rollout_length=8, seed=5,
                       policy_mode="epsilon_greedy")
        desc = actor.collect()
        ro = ray_tpu.get(desc["ref"])
        size = serialized_size(desc)
        fields = {k: v for k, v in desc.items() if k != "ref"}
        ro = {k: np.asarray(v) for k, v in ro.items()}
        actor.envs.close()
    finally:
        fan.close()
    return params, fields, size, ro


@pytest.fixture(scope="module")
def runtime():
    """The JAX package's halves under ``ray_tpu.init`` (shut down after),
    then the port's ``init(num_cpus=4)`` for the module."""
    import ray_tpu

    rollouts = _rollouts(len(SHARD_VERSIONS))
    ray_tpu.init(num_cpus=2)
    try:
        jax_side = {"learner": _jax_learner(rollouts),
                    "collect": _jax_collect(), "rollouts": rollouts}
    finally:
        ray_tpu.shutdown()
    core = rt.init(num_cpus=4)
    yield {"core": core, "jax": jax_side}
    rt.shutdown()


# ------------------------------------------------------ weight fan-out


def test_weight_fanout_versions_monotonic(runtime):
    fan = WeightFanout("t-fan")
    recv = WeightReceiver("t-fan")
    assert recv.poll(0.0) is None  # nothing published yet
    params = {"w": np.arange(4.0)}
    assert fan.publish(params) == 1
    got = recv.poll(0.0)
    assert got is not None
    version, value, extras = got
    assert version == 1 and extras == {}
    np.testing.assert_allclose(value["w"], params["w"])
    # Receiver never re-applies the same version.
    assert recv.poll(0.0) is None
    fan.publish({"w": np.arange(4.0) * 2}, {"epsilon": 0.5})
    fan.publish({"w": np.arange(4.0) * 3})
    # A lagging receiver sees only the NEWEST version (latest-value hub).
    version, value, _ = recv.poll(0.0)
    assert version == 3
    np.testing.assert_allclose(value["w"], params["w"] * 3)
    # Explicit version clocks must move strictly forward.
    with pytest.raises(ValueError):
        fan.publish(params, version=2)
    fan.close()
    with pytest.raises(RuntimeError):
        fan.publish(params)
    # close() dropped the hub key (no pinned ref left controller-side).
    from ray_tpu_torch.core.rpc_stubs import ControllerStub

    snap = ControllerStub(runtime["core"].controller).psub_snapshot(
        WEIGHTS_CHANNEL)
    assert "t-fan" not in snap


# --------------------------------------------------- end-to-end: DQN


@pytest.mark.timeout_s(240)
def test_distributed_dqn_inference_mode(runtime):
    """The sebulba split: rollout actors hold NO weights; every policy
    forward rides the shared batched inference service."""
    algo = DQNConfig(**CPU).environment(
        "CartPole-v1").distributed_rollouts(
        3, num_envs_per_actor=2, mode="inference").training(
        rollout_length=8, learning_starts=32, batch_size=32,
        train_batches_per_iter=2).build()
    try:
        m = algo.train()
        assert m["env_steps_this_iter"] > 0
        stats = rt.get(algo.plane.inference.stats.remote())
        # Every rollout step of every actor went through the service.
        assert stats["requests"] > 0
        assert stats["forward_calls"] > 0
        assert stats["weights_version"] >= 1
        # Coalescing happened: with 3 actors stepping concurrently the
        # service served fewer forwards than requests.
        assert stats["forward_calls"] <= stats["requests"]
        assert m["rl"]["shards"] >= 3
    finally:
        algo.stop()
    assert algo.last_leak_report["queue_depth"] == 0


def test_policy_inference_coalesces_requests(runtime):
    """Direct service test: concurrent submitters coalesce into one
    forward (the serve-batching idiom), replies split per request."""
    from ray_tpu_torch.rl.distributed.inference import PolicyInference
    from ray_tpu_torch.rl.models import build_policy

    fan = WeightFanout("t-infer")
    init_fn, _ = build_policy((4,), 2)
    fan.publish(init_fn(torch.Generator().manual_seed(0)))
    try:
        svc = PolicyInference((4,), 2, "t-infer", **CPU)
        results = []
        barrier = threading.Barrier(3)

        def submit(seed):
            obs = np.zeros((2, 4), np.float32)
            barrier.wait()
            results.append(svc.infer((obs, seed)))

        threads = [threading.Thread(target=submit, args=(s,))
                   for s in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert len(results) == 3
        for action, logp, value, version in results:
            assert action.shape == (2,)
            assert logp.shape == (2,) and value.shape == (2,)
            assert version == 1
        stats = svc.stats()
        assert stats["requests"] == 3
        # At least two of the three rendezvoused into one forward.
        assert stats["max_batch"] >= 2
    finally:
        fan.close()


def test_policy_inference_first_batches_share_one_initial_wait(runtime):
    """Thirty-two requests before any forward: four full batches flush at
    once, and each finds the first version; a receiver hands a version
    to one caller only, so a second initial wait would park until the
    next publish."""
    from ray_tpu_torch.rl.distributed.inference import PolicyInference
    from ray_tpu_torch.rl.models import build_policy

    fan = WeightFanout("t-infer-first")
    init_fn, _ = build_policy((4,), 2)
    fan.publish(init_fn(torch.Generator().manual_seed(0)))
    try:
        svc = PolicyInference((4,), 2, "t-infer-first", **CPU)
        results = []
        barrier = threading.Barrier(32)

        def submit(seed):
            obs = np.zeros((1, 4), np.float32)
            barrier.wait()
            results.append(svc.infer((obs, seed)))

        threads = [threading.Thread(target=submit, args=(s,))
                   for s in range(32)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert time.monotonic() - t0 < 15.0
        assert len(results) == 32
        assert {r[3] for r in results} == {1}
        assert svc.stats()["forward_calls"] >= 4
    finally:
        fan.close()


# ------------------------------------------------ end-to-end: IMPALA


@pytest.mark.timeout_s(420)
@pytest.mark.slow
def test_distributed_impala_learns_cartpole(runtime):
    """4 RolloutActors sampling continuously + one learner train CartPole
    to the reference's reward bar."""
    algo = IMPALAConfig(**CPU).environment(
        "CartPole-v1").distributed_rollouts(
        4, num_envs_per_actor=4).training(
        rollout_length=64, entropy_coeff=0.01, seed=1).build()
    try:
        m = algo.train(min_rollouts=4)
        assert m["rollouts_consumed"] >= 4
        assert "total_loss" in m
        assert m["mean_policy_lag"] >= 0
        assert m["rl"]["staleness"]["count"] >= 4
        best = 0.0
        for _ in range(100):
            m = algo.train(min_rollouts=4)
            best = max(best, m.get("episode_return_mean", 0.0))
            if best >= 120.0:
                break
        assert best >= 100.0, f"IMPALA failed to learn: best={best}"
        assert m["weights_version"] > 1
        assert algo.plane.monotonic_violations == 0
        desc = m["rl"]["shard_desc_bytes"]
        assert desc["p99"] <= DESCRIPTOR_BYTE_BUDGET
    finally:
        algo.stop()
    report = algo.last_leak_report
    assert report["queue_depth"] == 0
    assert report["intake_alive"] is False


# -------------------------------------------------------------- wiring


@pytest.mark.timeout_s(240)
def test_configs_build_the_distributed_classes(runtime):
    """``IMPALAConfig(distributed=True)`` and ``distributed_rollouts``
    build the distributed learners (their learner state on the config's
    device); APPO, an ``IMPALAConfig`` subclass, keeps its own learner."""
    small = dict(num_rollout_actors=1, num_envs_per_runner=1,
                 rollout_length=4, **CPU)
    builds = [
        (IMPALAConfig(distributed=True, **small), DistributedIMPALA),
        (IMPALAConfig(**CPU).distributed_rollouts(1, num_envs_per_actor=1),
         DistributedIMPALA),
        (DQNConfig(**small).distributed_rollouts(1, num_envs_per_actor=1),
         DistributedDQN),
        (APPOConfig(num_env_runners=1, **small).distributed_rollouts(1),
         APPO),
    ]
    for cfg, cls in builds:
        algo = cfg.build()
        try:
            assert type(algo) is cls, (cfg, type(algo))
            if cls is not APPO:
                assert algo.state.device == torch.device("cpu")
                assert algo.plane.mode == "local"
                assert len(algo.plane.actors) == 1
        finally:
            algo.stop()


# -------------------------------------------------------------- parity


def _jax_forward(obs_shape, num_actions, params_np, obs):
    """JAX logits and values of ``params_np`` on ``obs``."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.rl.models import build_policy

    _init, forward = build_policy(obs_shape, num_actions)
    logits, value = forward(jax.tree.map(jnp.asarray, params_np),
                            jnp.asarray(obs))
    return np.asarray(logits), np.asarray(value)


def _jax_params(obs_shape, num_actions, seed):
    import jax

    from ray_tpu.rl.models import build_policy

    init_fn, _ = build_policy(obs_shape, num_actions)
    return jax.tree.map(np.asarray, init_fn(jax.random.key(seed)))


def _carry(params_np, obs_shape, num_actions):
    from ray_tpu_torch.rl.models import build_policy, params_from_numpy

    init_fn, _ = build_policy(obs_shape, num_actions)
    return params_from_numpy(params_np, init_fn, **CPU)


def _obs(obs_shape, rows, seed):
    rng = np.random.default_rng(seed)
    if len(obs_shape) == 3:
        return rng.integers(0, 256, (rows,) + obs_shape).astype(np.uint8)
    return rng.normal(size=(rows,) + obs_shape).astype(np.float32)


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


SHAPES = {"mlp": ((4,), 2), "cnn": ((84, 84, 4), 6)}


def _serve_requests(key, obs_shape, num_actions, params_np, mode, seeds,
                    epsilon=None):
    """A fresh in-process service on the CPU given ``params_np``; each
    (rows, seed) request is served alone, in order."""
    from ray_tpu_torch.rl.distributed.inference import PolicyInference

    fan = WeightFanout(key)
    fan.publish(_carry(params_np, obs_shape, num_actions),
                {} if epsilon is None else {"epsilon": epsilon})
    try:
        svc = PolicyInference(obs_shape, num_actions, key, mode, **CPU)
        return [svc.infer((_obs(obs_shape, rows, seed), seed))
                for rows, seed in seeds]
    finally:
        fan.close()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_policy_inference_logp_and_values_match_jax(runtime, shape):
    obs_shape, num_actions = SHAPES[shape]
    params = _jax_params(obs_shape, num_actions, seed=1)
    seeds = [(4, 11), (3, 12), (9, 13)]     # 9 rows pad to the 16 bucket
    replies = _serve_requests(f"parity-{shape}", obs_shape, num_actions,
                              params, "categorical", seeds)
    again = _serve_requests(f"parity-{shape}-again", obs_shape,
                            num_actions, params, "categorical", seeds)
    for (rows, seed), (action, logp, value, version), rerun in zip(
            seeds, replies, again):
        logits, want_value = _jax_forward(obs_shape, num_actions, params,
                                          _obs(obs_shape, rows, seed))
        m = logits.max(-1, keepdims=True)
        logp_all = logits - m - np.log(np.exp(logits - m).sum(
            -1, keepdims=True))
        want_logp = np.take_along_axis(logp_all, action[:, None], -1)[:, 0]
        assert version == 1 and action.shape == (rows,)
        assert _max_rel(value, want_value) <= VALUE_TOL
        assert _max_rel(logp, want_logp) <= VALUE_TOL
        # Same seeds, same grouping: the same draws.
        np.testing.assert_array_equal(rerun[0], action)
        np.testing.assert_array_equal(rerun[1], logp)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_policy_inference_greedy_actions_match_jax(runtime, shape):
    obs_shape, num_actions = SHAPES[shape]
    params = _jax_params(obs_shape, num_actions, seed=2)
    seeds = [(4, 21), (8, 22)]
    replies = _serve_requests(f"greedy-{shape}", obs_shape, num_actions,
                              params, "epsilon_greedy", seeds, epsilon=0.0)
    compared = 0
    for (rows, seed), (action, logp, value, _v) in zip(seeds, replies):
        q, _ = _jax_forward(obs_shape, num_actions, params,
                            _obs(obs_shape, rows, seed))
        top2 = np.sort(q, -1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > MARGIN_TOL
        np.testing.assert_array_equal(action[clear],
                                      q.argmax(-1)[clear])
        compared += int(clear.sum())
        assert _max_rel(value, q.max(-1)) <= VALUE_TOL
        assert not logp.any()
    assert compared >= 6


def test_learner_state_updates_and_stats_match_jax(runtime):
    """The same shard sequence through the port's ``LearnerState`` on the
    CPU: update, publish, ``plane_stats``."""
    from ray_tpu_torch.rl.distributed.learner import (LearnerState,
                                                      new_plane_key,
                                                      plane_stats)
    from ray_tpu_torch.rl.impala import make_impala_update
    from ray_tpu_torch.rl.models import build_policy, params_from_numpy
    from ray_tpu_torch.rl.tree import adam, tree_leaves

    want = runtime["jax"]["learner"]
    cfg = IMPALAConfig(**CPU)
    init_fn, forward = build_policy((4,), 2, cfg.hidden)
    params = params_from_numpy(want["init"], init_fn, **CPU)
    opt = adam(cfg.lr)
    opt_state = opt.init(params)
    update = make_impala_update(forward, opt, cfg)
    state = LearnerState(new_plane_key("parity"), **CPU)
    state.publish(params, version=1)
    try:
        for i, (ro, ver) in enumerate(zip(runtime["jax"]["rollouts"],
                                          SHARD_VERSIONS)):
            ref = rt.put(ro)
            shard = TrajectoryShard(ref=ref, weights_version=ver,
                                    env_steps=int(ro["valids"].sum()),
                                    actor_index=i % 2, seq=i)
            state.record_staleness(shard)
            got = rt.get(shard.ref)
            batch = state.shard_batch({k: got[k] for k in ROLLOUT_KEYS})
            assert all(v.device == torch.device("cpu")
                       for v in batch.values())
            params, opt_state, aux = state.timed_update(
                lambda b=batch: update(params, opt_state, b))
            for k, v in want["aux"][i].items():
                np.testing.assert_allclose(float(aux[k]), v, rtol=1e-4,
                                           atol=1e-6, err_msg=k)
            state.publish(params, version=i + 2)
        stats = plane_stats(state.plane_key)
        assert state.version == want["version"] == 4
    finally:
        state.close()
    carried = params_from_numpy(want["params"], init_fn, **CPU)
    bound = ADAM_BOUND * LR * len(SHARD_VERSIONS)
    for g, w in zip(tree_leaves(params), tree_leaves(carried)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=bound)
    jstats = want["stats"]
    assert stats["staleness"] == jstats["staleness"]
    assert stats["shards"] == jstats["shards"] == len(SHARD_VERSIONS)
    assert stats["env_steps"] == jstats["env_steps"]
    assert stats["learner_update_s"]["count"] == \
        jstats["learner_update_s"]["count"] == len(SHARD_VERSIONS)


def test_rollout_actor_collect_descriptor_matches_jax(runtime):
    """A greedy port ``RolloutActor.collect()`` in this process against
    the JAX one on the same env seed and params."""
    from ray_tpu_torch.core.serialization import serialized_size
    from ray_tpu_torch.rl.distributed.rollout import RolloutActor

    params, want, want_size, want_ro = runtime["jax"]["collect"]
    fan = WeightFanout("parity-collect")
    fan.publish(_carry(params, (4,), 2), {"epsilon": 0.0})
    try:
        actor = RolloutActor("CartPole-v1", 1, "parity-collect",
                             num_envs=2, rollout_length=8, seed=5,
                             policy_mode="epsilon_greedy")
        desc = actor.collect()
        size = serialized_size(desc)
        ro = rt.get(desc["ref"])
        actor.envs.close()
    finally:
        fan.close()
    assert set(desc) == set(want) | {"ref"}
    assert {k: v for k, v in desc.items() if k != "ref"} == want
    assert want["env_steps"] > 0 and want["seq"] == 1
    assert size <= DESCRIPTOR_BYTE_BUDGET and \
        want_size <= DESCRIPTOR_BYTE_BUDGET
    for k in ("obs", "actions", "rewards", "dones", "valids"):
        np.testing.assert_array_equal(np.asarray(ro[k]), want_ro[k],
                                      err_msg=k)
    np.testing.assert_allclose(ro["values"], want_ro["values"], rtol=1e-5)
