"""The port's RL plane (``ray_tpu_torch.rl``) through its entry points on
the CPU: one counterpart of each tier-1 case of ``tests/test_rl.py``,
``test_rl_offpolicy.py``, ``test_rl_multiagent.py`` and
``test_rl_checkpoint.py`` (same names, same settings, ``device="cpu"``),
under one module-scoped ``init(num_cpus=4)``; the reference's
run-to-reward soaks are ported too and stay ``slow``, as there. Plus the
checks the port adds: learner state on the config's device after restore,
and the distributed plane's exports and config fields against the JAX
package's (its behaviour is ``tests/test_torch_rl_distributed.py``'s)."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.rl import (BCConfig, DQNConfig, PPO, PPOConfig,
                              ReplayBuffer, SumTree, as_trainable,
                              compute_gae)
from ray_tpu_torch.rl.dqn import rollout_to_transitions
from ray_tpu_torch.rl.multi_agent import GuideFollowEnv, MultiAgentPPOConfig
from ray_tpu_torch.rl.tree import host, tree_leaves
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = dict(device="cpu")
REFERENCE_FILES = ("test_rl.py", "test_rl_offpolicy.py",
                   "test_rl_multiagent.py", "test_rl_checkpoint.py")


@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def _tier1_cases(name):
    tree = ast.parse(Path(__file__).with_name(name).read_text())
    out = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith(
                "test_"):
            slow = any("slow" in ast.unparse(d) for d in node.decorator_list)
            out.append((node.name, slow))
    return out


def test_every_tier1_reference_case_has_a_counterpart():
    here = {n for n, _ in _tier1_cases(Path(__file__).name)}
    tier1, soaks = [], []
    for f in REFERENCE_FILES:
        for name, slow in _tier1_cases(f):
            (soaks if slow else tier1).append(name)
    assert len(tier1) == 24
    assert not set(tier1 + soaks) - here


def _tree_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x.cpu(), y.cpu()) if isinstance(x, torch.Tensor)
        else x == y for x, y in zip(la, lb))


# ---------------------------------------------------------------- test_rl


def test_gae_simple():
    T, N = 4, 1
    rollout = {
        "rewards": np.ones((T, N), np.float32),
        "values": np.zeros((T, N), np.float32),
        "dones": np.zeros((T, N), np.float32),
        "last_value": np.zeros((N,), np.float32),
    }
    out = compute_gae(rollout, gamma=1.0, lam=1.0)
    np.testing.assert_allclose(out["advantages"][:, 0], [4, 3, 2, 1])


def test_gae_resets_at_done():
    T, N = 3, 1
    rollout = {
        "rewards": np.array([[1.0], [1.0], [1.0]], np.float32),
        "values": np.zeros((T, N), np.float32),
        "dones": np.array([[0.0], [1.0], [0.0]], np.float32),
        "last_value": np.zeros((N,), np.float32),
    }
    out = compute_gae(rollout, gamma=1.0, lam=1.0)
    np.testing.assert_allclose(out["advantages"][:, 0], [2, 1, 1])


def test_ppo_single_iteration(runtime):
    algo = PPOConfig(**CPU).environment("CartPole-v1").env_runners(
        2, num_envs_per_runner=2).training(
        rollout_length=32, minibatch_size=64).build()
    try:
        metrics = algo.train()
        assert 0 < metrics["env_steps_this_iter"] <= 2 * 2 * 32
        assert "total_loss" in metrics
        metrics2 = algo.train()
        assert metrics2["env_steps_total"] > metrics["env_steps_this_iter"]
        assert all(t.device.type == "cpu" for t in tree_leaves(algo.params))
    finally:
        algo.stop()


@pytest.mark.slow
@pytest.mark.timeout_s(420)
def test_ppo_learns_cartpole(runtime):
    algo = PPOConfig(**CPU).environment("CartPole-v1").env_runners(
        2, num_envs_per_runner=4).training(
        rollout_length=128, minibatch_size=256, lr=3e-4, seed=7).build()
    try:
        first, best = None, 0.0
        for _ in range(30):
            ret = algo.train().get("episode_return_mean")
            if ret is not None:
                first = ret if first is None else first
                best = max(best, ret)
            if best >= 120.0:
                break
        assert first is not None
        assert best >= 100.0, f"PPO failed to learn: first={first}, " \
                              f"best={best}"
    finally:
        algo.stop()


def test_vtrace_on_policy_matches_gae_lambda1():
    # With target == behavior policy (rho = c = 1) V-trace targets reduce
    # to n-step returns, i.e. GAE with lambda=1.
    from ray_tpu_torch.rl.impala import vtrace

    T, N = 5, 3
    rng = np.random.default_rng(0)
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    values = rng.normal(size=(T, N)).astype(np.float32)
    dones = np.zeros((T, N), np.float32)
    dones[3, 1] = 1.0
    valids = np.ones((T, N), np.float32)
    last_value = rng.normal(size=(N,)).astype(np.float32)
    logp = rng.normal(size=(T, N)).astype(np.float32)
    t = torch.from_numpy
    vs, _pg_adv = vtrace(t(logp), t(logp), t(rewards), t(values), t(dones),
                         t(last_value), t(valids), gamma=0.9)
    gae = compute_gae({"rewards": rewards, "values": values,
                       "dones": dones, "last_value": last_value},
                      gamma=0.9, lam=1.0)
    np.testing.assert_allclose(vs.numpy(), gae["returns"], rtol=1e-4,
                               atol=1e-4)


def test_impala_single_iteration(runtime):
    from ray_tpu_torch.rl import IMPALAConfig

    algo = IMPALAConfig(**CPU).environment("CartPole-v1").env_runners(
        2, num_envs_per_runner=2).training(rollout_length=32).build()
    try:
        metrics = algo.train(min_rollouts=3)
        assert metrics["rollouts_consumed"] >= 3
        assert "total_loss" in metrics
        assert metrics["env_steps_per_sec"] > 0
    finally:
        algo.stop()


@pytest.mark.slow
@pytest.mark.timeout_s(420)
def test_ppo_cnn_learns_minicatch(runtime):
    algo = PPOConfig(**CPU).environment(
        "ray_tpu/MiniCatch-v0", size=16).env_runners(
        2, num_envs_per_runner=8).training(
        rollout_length=64, minibatch_size=512, lr=7e-4,
        frame_stack=2, num_sgd_epochs=6, entropy_coeff=0.01,
        seed=3).build()
    try:
        best = -9.0
        for _ in range(200):
            ret = algo.train().get("episode_return_mean")
            if ret is not None:
                best = max(best, ret)
            if best >= -0.3:
                break
        assert best >= -0.5, f"CNN PPO failed to learn MiniCatch: {best}"
    finally:
        algo.stop()


def test_appo_single_iteration(runtime):
    from ray_tpu_torch.rl import APPOConfig

    algo = APPOConfig(**CPU).environment("CartPole-v1").env_runners(
        2, num_envs_per_runner=2).training(rollout_length=32).build()
    try:
        metrics = algo.train(min_rollouts=3)
        assert metrics["rollouts_consumed"] >= 3
        assert "clip_frac" in metrics and "total_loss" in metrics
        assert metrics["env_steps_per_sec"] > 0
    finally:
        algo.stop()


@pytest.mark.slow
@pytest.mark.timeout_s(420)
def test_appo_learns_cartpole(runtime):
    from ray_tpu_torch.rl import APPOConfig

    algo = APPOConfig(**CPU).environment("CartPole-v1").env_runners(
        2, num_envs_per_runner=4).training(
        rollout_length=64, lr=5e-4, entropy_coeff=0.01, seed=3).build()
    try:
        best = 0.0
        for i in range(80):
            m = algo.train(min_rollouts=4)
            best = max(best, m.get("episode_return_mean", 0.0))
            if best > 120.0:
                break
            if i == 39 and best <= 60.0:
                break
        assert best > 100.0, f"APPO stuck at {best}"
    finally:
        algo.stop()


def test_obs_connectors_pipeline(runtime):
    from ray_tpu_torch.rl.connectors import (ClipObs, NormalizeObs,
                                             ScaleObs, apply_connectors)

    obs = np.array([[0.0, 255.0], [127.5, 0.0]])
    scaled = apply_connectors([ScaleObs(scale=1.0 / 255.0)], obs)
    assert scaled.max() <= 1.0 and scaled.dtype == np.float32
    norm = NormalizeObs(clip=5.0)
    for _ in range(5):
        out = norm(np.random.default_rng(0).normal(3.0, 2.0, (64, 4)))
    assert abs(float(out.mean())) < 0.5

    algo = PPOConfig(**CPU).environment("CartPole-v1").env_runners(
        1, num_envs_per_runner=2).training(
        rollout_length=16, seed=0,
        obs_connectors=[ClipObs(-5.0, 5.0), ScaleObs(scale=0.5)]).build()
    try:
        m = algo.train()
        assert m["env_steps_this_iter"] > 0
        ro = rt.get(algo.runners[0].sample.remote())
        assert np.abs(ro["obs"]).max() <= 2.5 + 1e-6
    finally:
        algo.stop()


# ------------------------------------------------------- test_rl_offpolicy


def test_sum_tree_proportional():
    tree = SumTree(8)
    tree.set([0, 1, 2], [1.0, 3.0, 6.0])
    assert tree.total == pytest.approx(10.0)
    rng = np.random.default_rng(0)
    counts = np.zeros(8)
    draws = 4000
    idx = np.concatenate([tree.sample(8, rng) for _ in range(draws // 8)])
    for i in idx:
        counts[i] += 1
    freq = counts / draws
    assert freq[2] > freq[1] > freq[0] > 0
    assert freq[2] == pytest.approx(0.6, abs=0.05)
    assert counts[3:].sum() == 0


def test_replay_buffer_wraparound_and_sampling():
    buf = ReplayBuffer(capacity=10)
    for start in range(0, 25, 5):
        buf.add({"x": np.arange(start, start + 5, dtype=np.int64)})
    assert len(buf) == 10
    batch, idx, w = buf.sample(32)
    assert batch["x"].min() >= 15
    assert np.all(w == 1.0)


def test_prioritized_replay_prefers_high_td():
    buf = ReplayBuffer(capacity=16, prioritized=True, seed=1)
    buf.add({"x": np.arange(16, dtype=np.int64)})
    buf.update_priorities(np.arange(16), np.full(16, 1e-3))
    buf.update_priorities(np.array([5]), np.array([10.0]))
    batch, idx, w = buf.sample(256)
    assert np.mean(batch["x"] == 5) > 0.5
    assert w.min() > 0 and w.max() == pytest.approx(1.0)
    assert w[batch["x"] == 5].mean() < w[batch["x"] != 5].mean()


def test_rollout_to_transitions_drops_synthetic_rows():
    T, N = 4, 1
    obs = np.arange(T * N).reshape(T, N).astype(np.float32)[..., None]
    ro = {
        "obs": obs,
        "actions": np.zeros((T, N), np.int64),
        "rewards": np.ones((T, N), np.float32),
        "dones": np.array([[0], [1], [0], [0]], np.float32),
        "valids": np.array([[1], [1], [0], [1]], np.float32),
    }
    out = rollout_to_transitions(ro)
    assert len(out["rewards"]) == 2
    np.testing.assert_allclose(out["dones"], [0, 1])
    np.testing.assert_allclose(out["next_obs"][:, 0], [1, 2])


def test_dqn_single_iteration(runtime):
    algo = DQNConfig(**CPU).environment("CartPole-v1").env_runners(
        2, num_envs_per_runner=2).training(
        rollout_length=16, learning_starts=32, batch_size=32,
        train_batches_per_iter=4).build()
    try:
        m1 = algo.train()
        assert m1["env_steps_this_iter"] > 0
        assert m1["buffer_size"] > 0
        for _ in range(3):
            m = algo.train()
        assert m["learner_steps"] > 0 and "loss" in m
        assert m["epsilon"] < algo.config.epsilon_initial
    finally:
        algo.stop()


@pytest.mark.slow
@pytest.mark.timeout_s(420)
def test_dqn_learns_cartpole(runtime):
    """The reference soak, on the distributed plane as there (4 rollout
    actors x 4 envs feeding prioritized replay through the object plane),
    with its acceptance contracts asserted on the learning run."""
    from ray_tpu_torch.rl.distributed import DESCRIPTOR_BYTE_BUDGET

    algo = DQNConfig(**CPU).environment("CartPole-v1").distributed_rollouts(
        4, num_envs_per_actor=4).training(
        rollout_length=64, lr=1e-3, batch_size=128,
        learning_starts=500, train_batches_per_iter=48,
        target_update_interval=100, epsilon_decay_steps=6000,
        prioritized_replay=True, seed=2).build()
    try:
        best, first = 0.0, None
        metrics = {}
        for _ in range(60):
            metrics = algo.train()
            ret = metrics.get("episode_return_mean")
            if ret is not None:
                first = ret if first is None else first
                best = max(best, ret)
            if best >= 120.0:
                break
        assert first is not None
        assert best >= 100.0, f"DQN failed to learn: first={first}, " \
                              f"best={best}"
        assert algo.plane.monotonic_violations == 0
        # Fan-out version clock: initial publish + one per iteration.
        assert metrics["weights_version"] == \
            metrics["training_iteration"] + 1
        rl = metrics["rl"]
        assert rl["env_steps"] > 0 and "queue_depth" in rl
        assert rl["shard_desc_bytes"]["p99"] <= DESCRIPTOR_BYTE_BUDGET
        assert rl["shard_desc_bytes"]["count"] >= rl["shards"]
        assert rl["staleness"]["count"] == rl["shards"]
        assert rl["learner_update_s"]["count"] == metrics["learner_steps"]
    finally:
        algo.stop()


@pytest.mark.slow
@pytest.mark.timeout_s(420)
def test_bc_clones_policy_offline(runtime):
    from ray_tpu_torch.rl import collect_dataset

    teacher = PPOConfig(**CPU).environment("CartPole-v1").env_runners(
        2, num_envs_per_runner=4).training(
        rollout_length=128, minibatch_size=256, seed=11).build()
    try:
        for _ in range(8):
            teacher.train()
        ds = collect_dataset(teacher, num_rollouts=2)
        assert ds.count() > 500
    finally:
        teacher.stop()
    bc = BCConfig(**CPU).environment("CartPole-v1").training(
        epochs=6, batch_size=256, seed=11).build(ds)
    metrics = bc.train()
    assert metrics["rows_trained"] > 0
    assert metrics["action_accuracy"] > 0.55
    assert bc.evaluate(num_episodes=5)["episode_return_mean"] > 40.0


def test_sac_single_iteration(runtime):
    from ray_tpu_torch.rl import SACConfig

    algo = SACConfig(env="Pendulum-v1", seed=3, num_env_runners=1,
                     warmup_steps=64, updates_per_iteration=4,
                     **CPU).build()
    try:
        m1 = algo.train()
        assert m1["env_steps_this_iter"] > 0
        m2 = algo.train()
        assert m2["env_steps_total"] > m1["env_steps_total"]
        assert "critic_loss" in m2
        batch, _, _ = algo.buffer.sample(8)
        assert batch["actions"].dtype == np.float32
        assert batch["actions"].shape[1:] == (1,)
    finally:
        algo.stop()


@pytest.mark.slow
@pytest.mark.timeout_s(400)
def test_sac_learns_pendulum(runtime):
    from ray_tpu_torch.rl import SACConfig

    algo = SACConfig(env="Pendulum-v1", seed=1, num_env_runners=2,
                     updates_per_iteration=48, warmup_steps=800,
                     **CPU).build()
    try:
        best = -float("inf")
        for _ in range(110):
            m = algo.train()
            best = max(best, m.get("episode_return_mean", -float("inf")))
            if best > -600:
                break
        assert best > -600, f"SAC stuck at {best}"
    finally:
        algo.stop()


def test_offline_transitions_roundtrip_parquet(runtime, tmp_path):
    from ray_tpu_torch.rl import SACConfig
    from ray_tpu_torch.rl.offline import (TRANSITION_COLUMNS,
                                          dataset_to_buffer,
                                          load_transitions,
                                          rollouts_to_dataset,
                                          save_transitions)

    algo = SACConfig(env="Pendulum-v1", num_env_runners=1,
                     num_envs_per_runner=2, rollout_length=16, seed=3,
                     **CPU).build()
    try:
        ds = rollouts_to_dataset(algo, num_rollouts=2)
    finally:
        algo.stop()
    n = ds.count()
    assert n > 30
    save_transitions(ds, str(tmp_path / "logs"))
    back = load_transitions(str(tmp_path / "logs"))
    assert back.count() == n
    buf = dataset_to_buffer(back, seed=0)
    assert len(buf) == n
    batch, _idx, _w = buf.sample(16)
    for col in TRANSITION_COLUMNS:
        assert col in batch and len(batch[col]) == 16
    assert batch["obs"].shape[1:] == batch["next_obs"].shape[1:]
    assert batch["obs"].shape[1:] == (3,)


def _scripted_pendulum_dataset(n_episodes: int, noise: float, seed: int):
    """The reference soak's near-expert data (energy swing-up + PD catch
    with Gaussian action noise; actions in [-1, 1])."""
    import gymnasium as gym

    from ray_tpu_torch import data as rdata

    env = gym.make("Pendulum-v1")
    rng = np.random.default_rng(seed)
    cols = {c: [] for c in ("obs", "actions", "rewards", "next_obs",
                            "terminateds")}
    for ep in range(n_episodes):
        obs, _ = env.reset(seed=seed + ep)
        done = False
        while not done:
            cos_th, sin_th, thdot = obs
            th = np.arctan2(sin_th, cos_th)
            energy = 0.5 * thdot ** 2 + 10.0 * (cos_th - 1.0)
            pd = -(10.0 * th + 2.0 * thdot)
            pump = -thdot * energy
            w = (1.0 / (1.0 + np.exp(-10.0 * (cos_th - 0.8)))
                 * 1.0 / (1.0 + np.exp(-4.0 * (4.0 - abs(thdot)))))
            u = w * pd + (1.0 - w) * pump
            u = float(np.clip(u / 2.0 + rng.normal(0.0, noise), -1.0, 1.0))
            nobs, reward, term, trunc, _ = env.step([u * 2.0])
            cols["obs"].append(obs.astype(np.float32))
            cols["actions"].append(np.float32(u))
            cols["rewards"].append(np.float32(reward))
            cols["next_obs"].append(nobs.astype(np.float32))
            cols["terminateds"].append(np.float32(term))
            obs = nobs
            done = term or trunc
    env.close()
    return rdata.from_numpy({
        "obs": np.stack(cols["obs"]),
        "actions": np.asarray(cols["actions"])[:, None],
        "rewards": np.asarray(cols["rewards"]),
        "next_obs": np.stack(cols["next_obs"]),
        "terminateds": np.asarray(cols["terminateds"]),
    })


@pytest.mark.slow
@pytest.mark.timeout_s(500)
def test_cql_learns_pendulum_offline(runtime):
    from ray_tpu_torch.rl import CQLConfig

    ds = _scripted_pendulum_dataset(n_episodes=30, noise=0.15, seed=7)
    assert ds.count() == 30 * 200
    cql = CQLConfig(env="Pendulum-v1", seed=7, **CPU).training(
        updates_per_iteration=400, cql_alpha=10.0, bc_iters=1200).build(ds)
    for _ in range(4):
        m = cql.train()
    assert np.isfinite(m["critic_loss"])
    best = cql.evaluate(num_episodes=5)["episode_return_mean"]
    for _extra in range(3):
        if best > -900.0:
            break
        cql.train()
        best = max(best, cql.evaluate(num_episodes=5)
                   ["episode_return_mean"])
    assert best > -900.0, best


def test_action_connector_units():
    from ray_tpu_torch.rl.connectors import (ClipAction, RescaleAction,
                                             UnsquashAction)

    uns = UnsquashAction(low=[-2.0], high=[2.0])
    out = uns(np.array([[-1.0], [0.0], [1.0], [3.0]]))
    assert np.allclose(out, [[-2.0], [0.0], [2.0], [2.0]])
    clip = ClipAction(low=[-0.5], high=[0.5])
    assert np.allclose(clip(np.array([[-2.0], [0.2]])), [[-0.5], [0.2]])
    res = RescaleAction(scale=2.0, shift=1.0)
    assert np.allclose(res(np.array([[1.0]])), [[3.0]])
    with pytest.raises(ValueError):
        UnsquashAction(low=[-np.inf], high=[np.inf])


def test_learner_connector_normalizes_advantages():
    from ray_tpu_torch.rl.connectors import (NormalizeAdvantages,
                                             apply_learner_connectors)

    batch = {"advantages": np.array([1.0, 2.0, 3.0, 4.0], np.float32),
             "obs": np.zeros((4, 2))}
    out = apply_learner_connectors([NormalizeAdvantages()], batch)
    assert abs(float(out["advantages"].mean())) < 1e-6
    assert abs(float(out["advantages"].std()) - 1.0) < 1e-5
    assert out["obs"] is batch["obs"]
    assert batch["advantages"][0] == 1.0


class _RecordingActionConnector:
    def __init__(self):
        self.calls = 0
        self.last_min = None
        self.last_max = None

    def __call__(self, actions):
        self.calls += 1
        self.last_min = float(np.min(actions))
        self.last_max = float(np.max(actions))
        return actions


@pytest.mark.timeout_s(240)
def test_sac_runs_through_action_connector_chain(runtime):
    from ray_tpu_torch.rl import SACConfig
    from ray_tpu_torch.rl.connectors import ClipAction, UnsquashAction

    algo = SACConfig(env="Pendulum-v1", seed=3, num_env_runners=1,
                     warmup_steps=64, updates_per_iteration=2,
                     **CPU).training(
        action_connectors=[UnsquashAction(low=[-2.0], high=[2.0]),
                           ClipAction(low=[-1.5], high=[1.5])]).build()
    try:
        m = algo.train()
        assert m["env_steps_this_iter"] > 0
        batch, _, _ = algo.buffer.sample(8)
        assert np.abs(batch["actions"]).max() <= 1.0 + 1e-6
    finally:
        algo.stop()


@pytest.mark.timeout_s(240)
def test_cql_evaluate_uses_action_connectors(runtime):
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.rl import CQLConfig
    from ray_tpu_torch.rl.connectors import UnsquashAction

    rec = _RecordingActionConnector()
    n = 64
    ds = rdata.from_numpy({
        "obs": np.random.default_rng(0).normal(size=(n, 3)).astype(
            np.float32),
        "actions": np.zeros((n, 1), np.float32),
        "rewards": np.zeros(n, np.float32),
        "next_obs": np.zeros((n, 3), np.float32),
        "terminateds": np.zeros(n, np.float32),
    }, num_blocks=2)
    cql = CQLConfig(env="Pendulum-v1", seed=0, **CPU).training(
        updates_per_iteration=2,
        action_connectors=[rec, UnsquashAction(low=[-2.0],
                                               high=[2.0])]).build(ds)
    cql.train()
    out = cql.evaluate(num_episodes=1)
    assert rec.calls >= 200
    assert "episode_return_mean" in out
    assert -1.0 - 1e-6 <= rec.last_min and rec.last_max <= 1.0 + 1e-6


# ------------------------------------------------------ test_rl_multiagent


def test_guide_follow_env_contract():
    env = GuideFollowEnv(episode_length=4)
    obs, _ = env.reset()
    assert set(obs) == {"guide", "follower"}
    total = {"guide": 0.0, "follower": 0.0}
    for t in range(4):
        obs, rew, term, trunc, _ = env.step(
            {"guide": t % 2, "follower": t % 2})
        for a in total:
            total[a] += rew[a]
    assert term["__all__"]
    assert total == {"guide": 4.0, "follower": 4.0}


def test_multi_agent_runner_maps_policies(runtime):
    algo = MultiAgentPPOConfig(
        num_env_runners=1, episodes_per_sample=3, seed=0,
        policy_mapping_fn=lambda a: f"{a}_policy", **CPU).build()
    try:
        assert set(algo.policy_specs) == {"guide_policy", "follower_policy"}
        sample = rt.get(algo.runners[0].sample.remote())
        trajs = sample["trajectories"]
        assert set(trajs) == {"guide_policy", "follower_policy"}
        assert len(trajs["guide_policy"]) == 3
        traj = trajs["guide_policy"][0]
        assert traj["obs"].shape == (6, 6)
        assert traj["rewards"].shape == (6,)
    finally:
        algo.stop()


def test_shared_policy_mapping(runtime):
    algo = MultiAgentPPOConfig(
        num_env_runners=1, episodes_per_sample=2, seed=0,
        policy_mapping_fn=lambda a: "shared", **CPU).build()
    try:
        assert set(algo.policy_specs) == {"shared"}
        m = algo.train()
        assert m["env_steps_this_iter"] > 0
    finally:
        algo.stop()


@pytest.mark.timeout_s(400)
@pytest.mark.slow
def test_multi_agent_ppo_learns_guide_follow(runtime):
    algo = MultiAgentPPOConfig(
        seed=0, num_env_runners=2, episodes_per_sample=16,
        policy_mapping_fn=lambda a: f"{a}_policy", **CPU).build()
    try:
        best = {}
        for _ in range(60):
            m = algo.train()
            for a, v in (m.get("agent_return_mean") or {}).items():
                best[a] = max(best.get(a, -np.inf), v)
            if best.get("guide", 0) >= 5.5 and best.get("follower", 0) >= 5.0:
                break
        assert best.get("guide", 0) >= 5.5, best
        assert best.get("follower", 0) >= 5.0, best
    finally:
        algo.stop()


# ------------------------------------------------------ test_rl_checkpoint


@pytest.mark.timeout_s(240)
def test_ppo_kill_and_resume(runtime, tmp_path):
    cfg = PPOConfig(**CPU).environment("CartPole-v1").env_runners(
        1, num_envs_per_runner=2).training(
        rollout_length=16, minibatch_size=32, num_sgd_epochs=1, seed=1)
    algo = cfg.build()
    try:
        for _ in range(2):
            algo.train()
        saved_params = algo.params
        algo.save(str(tmp_path / "ckpt"))
    finally:
        algo.stop()

    algo2 = PPOConfig(**CPU).environment("CartPole-v1").env_runners(
        1, num_envs_per_runner=2).training(
        rollout_length=16, minibatch_size=32, num_sgd_epochs=1,
        seed=99).build()
    try:
        algo2.restore(str(tmp_path / "ckpt"))
        assert algo2._iteration == 2
        assert _tree_equal(algo2.params, saved_params)
        m = algo2.train()
        assert m["training_iteration"] == 3
        assert m["env_steps_total"] > 0
    finally:
        algo2.stop()


@pytest.mark.timeout_s(240)
def test_dqn_kill_and_resume_with_replay_tail(runtime, tmp_path):
    cfg = DQNConfig(**CPU).environment("CartPole-v1").env_runners(
        1, num_envs_per_runner=2).training(
        rollout_length=32, learning_starts=32, batch_size=32,
        train_batches_per_iter=4, seed=1)
    algo = cfg.build()
    try:
        for _ in range(3):
            algo.train()
        saved_steps = algo._total_env_steps
        saved_learner_steps = algo._learner_steps
        saved_buffer_len = len(algo.buffer)
        saved_target = algo.target_params
        assert saved_buffer_len > 0
        algo.save(str(tmp_path / "ckpt"))
    finally:
        algo.stop()

    algo2 = DQNConfig(**CPU).environment("CartPole-v1").env_runners(
        1, num_envs_per_runner=2).training(
        rollout_length=32, learning_starts=32, batch_size=32,
        train_batches_per_iter=4, seed=7).build()
    try:
        algo2.restore(str(tmp_path / "ckpt"))
        assert algo2._iteration == 3
        assert algo2._total_env_steps == saved_steps
        assert algo2._learner_steps == saved_learner_steps
        assert len(algo2.buffer) == saved_buffer_len
        assert _tree_equal(algo2.target_params, saved_target)
        m = algo2.train()
        assert m["training_iteration"] == 4
        assert m["buffer_size"] > saved_buffer_len
    finally:
        algo2.stop()


@pytest.mark.timeout_s(240)
def test_connector_state_survives_checkpoint(runtime, tmp_path):
    from ray_tpu_torch.rl.connectors import NormalizeObs

    cfg = PPOConfig(**CPU).environment("CartPole-v1").env_runners(
        1, num_envs_per_runner=2).training(
        rollout_length=16, minibatch_size=32, num_sgd_epochs=1, seed=2,
        obs_connectors=[NormalizeObs()])
    algo = cfg.build()
    try:
        algo.train()
        conns = rt.get(algo.runners[0].get_connectors.remote())
        count_before = conns[0].count
        assert count_before > 0
        algo.save(str(tmp_path / "ckpt"))
    finally:
        algo.stop()

    algo2 = PPOConfig(**CPU).environment("CartPole-v1").env_runners(
        1, num_envs_per_runner=2).training(
        rollout_length=16, minibatch_size=32, num_sgd_epochs=1, seed=2,
        obs_connectors=[NormalizeObs()]).build()
    try:
        algo2.restore(str(tmp_path / "ckpt"))
        conns2 = rt.get(algo2.runners[0].get_connectors.remote())
        assert conns2[0].count >= count_before
        assert np.all(np.isfinite(conns2[0].mean))
    finally:
        algo2.stop()


@pytest.mark.timeout_s(300)
@pytest.mark.slow
def test_ppo_lr_sweep_under_asha(runtime):
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune import ASHAScheduler, TuneConfig, Tuner

    base = PPOConfig(**CPU).environment("CartPole-v1").env_runners(
        1, num_envs_per_runner=2).training(
        rollout_length=16, minibatch_size=32, num_sgd_epochs=1, seed=3)
    tuner = Tuner(
        as_trainable(base, stop_iters=3),
        param_space={"lr": tune.grid_search([3e-4, 1e-3])},
        tune_config=TuneConfig(
            metric="total_loss", mode="min",
            scheduler=ASHAScheduler(metric="total_loss", mode="min",
                                    max_t=3, grace_period=1),
            max_concurrent_trials=2),
        resources_per_trial={"CPU": 1.0},
    )
    grid = tuner.fit()
    assert len(grid) == 2
    done = [r for r in grid if r.metrics and not r.error]
    assert done, [r.error for r in grid]
    assert all("total_loss" in r.metrics for r in done)


# ------------------------------------------------------- the port's own


def test_restore_puts_the_state_on_the_device_and_refuses_jax(runtime,
                                                              tmp_path):
    """A restore moves every tensor of the state (Adam's moments, the APPO
    target and its counter included) onto the algorithm's device, and the
    learner steps on from them; a JAX package checkpoint is refused."""
    import pickle

    from ray_tpu_torch.rl import APPOConfig

    cfg = APPOConfig(**CPU).environment("CartPole-v1").env_runners(
        1, num_envs_per_runner=2).training(rollout_length=16,
                                           target_update_interval=2)
    algo = cfg.build()
    try:
        algo.train(min_rollouts=3)
        algo.save(str(tmp_path / "ckpt"))
        want = host((algo.params, algo.opt_state))
        updates = algo._updates
    finally:
        algo.stop()
    algo = cfg.build()
    try:
        algo.restore(str(tmp_path / "ckpt"))
        state, target, since = algo.opt_state
        assert _tree_equal((algo.params, algo.opt_state), want)
        assert since == updates % 2 and state.count == updates
        assert all(t.device == algo.device for t in tree_leaves(
            (algo.params, algo.opt_state)) if isinstance(t, torch.Tensor))
        assert algo.train(min_rollouts=1)["training_iteration"] == 2
        path = tmp_path / "ckpt" / "algorithm_state.pkl"
        payload = pickle.loads(path.read_bytes())
        payload.pop("format")
        path.write_bytes(pickle.dumps(payload))
        with pytest.raises(ValueError, match="not written by ray_tpu_torch"):
            algo.restore(str(tmp_path / "ckpt"))
    finally:
        algo.stop()


def test_sac_checkpoint_carries_the_generator(runtime, tmp_path):
    """SAC's draw generator is saved as its state (the JAX package saves
    the PRNG key data): after a restore the next draws repeat."""
    from ray_tpu_torch.rl import SACConfig

    algo = SACConfig(env="Pendulum-v1", seed=3, num_env_runners=1,
                     num_envs_per_runner=2, rollout_length=16,
                     warmup_steps=32, updates_per_iteration=2,
                     **CPU).build()
    try:
        algo.train()
        algo.save(str(tmp_path / "ckpt"))
        after_save = torch.randn(4, generator=algo._gen)
        algo.restore(str(tmp_path / "ckpt"))
        assert torch.equal(torch.randn(4, generator=algo._gen), after_save)
        assert algo.log_alpha.shape == () and algo.log_alpha.dtype == \
            torch.float32
    finally:
        algo.stop()


def _package_exports(path: Path) -> list:
    """Names a package ``__init__`` imports (its exports)."""
    tree = ast.parse(path.read_text())
    return sorted(a.asname or a.name for node in tree.body
                  if isinstance(node, ast.ImportFrom) for a in node.names)


_JAX_RL = Path(__file__).resolve().parents[1] / "ray_tpu" / "rl"


@pytest.mark.parametrize(
    "name", _package_exports(_JAX_RL / "distributed" / "__init__.py"))
def test_distributed_plane_exports_each_reference_name(name):
    """``ray_tpu_torch.rl.distributed`` exports each name the JAX
    package's does, as the same kind of object (class, function or the
    same constant); ``ray_tpu_torch.rl`` re-exports those it does."""
    import ray_tpu.rl as jrl
    import ray_tpu.rl.distributed as jdist

    import ray_tpu_torch.rl as rl
    import ray_tpu_torch.rl.distributed as dist

    got, want = getattr(dist, name), getattr(jdist, name)
    if isinstance(want, type):
        assert isinstance(got, type) and got.__name__ == want.__name__
    elif callable(want):
        assert callable(got) and got.__name__ == want.__name__
    else:
        assert got == want
    if hasattr(jrl, name):
        assert getattr(rl, name) is got


def test_rl_package_exports_every_reference_name():
    import ray_tpu_torch.rl as rl

    want = _package_exports(_JAX_RL / "__init__.py")
    assert [n for n in want if not hasattr(rl, n)] == []


@pytest.mark.parametrize("kind", ["IMPALA", "APPO", "DQN"])
def test_distributed_rollouts_sets_the_reference_fields(kind):
    """``distributed_rollouts`` and the distributed config fields match
    the JAX package's (the port adds ``device``)."""
    import dataclasses

    import ray_tpu.rl as jrl

    import ray_tpu_torch.rl as rl

    jcfg = getattr(jrl, f"{kind}Config")().distributed_rollouts(
        3, num_envs_per_actor=2, mode="inference", shard_queue_size=5)
    cfg = getattr(rl, f"{kind}Config")(**CPU).distributed_rollouts(
        3, num_envs_per_actor=2, mode="inference", shard_queue_size=5)
    fields = {f.name for f in dataclasses.fields(jcfg)}
    assert fields == {f.name for f in dataclasses.fields(cfg)} - {"device"}
    for f in ("distributed", "num_rollout_actors", "num_envs_per_runner",
              "rollout_mode", "shard_queue_size", "learner_mesh"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
