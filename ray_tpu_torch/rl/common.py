"""Shared algorithm plumbing (reference: ``AlgorithmConfig`` base +
``Algorithm`` setup, ``rllib/algorithms/algorithm_config.py``): the fluent
config builders, env-spec probing (with frame-stack shape adjustment and the
``ray_tpu/`` test-env registry), and EnvRunner fleet construction used by
every algorithm — one copy, so PPO and IMPALA can't drift."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import ray_tpu_torch
from ray_tpu_torch.rl.env_runner import EnvRunner


class ConfigBuilderMixin:
    """Fluent setters shared by all algorithm configs."""

    def environment(self, env: str, **env_config):
        self.env = env
        self.env_config = env_config
        return self

    def env_runners(self, num_env_runners: int,
                    num_envs_per_runner: int = 4):
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_runner
        return self

    def training(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def distributed_rollouts(self, num_rollout_actors: int,
                             num_envs_per_actor: int = 4,
                             mode: str = "local",
                             shard_queue_size: int = 8):
        """Opt into the Podracer actor/learner substrate
        (``rl/distributed/``): ``num_rollout_actors`` RolloutActors ship
        trajectory shards through the object plane to one in-process
        learner on the config's ``device``; weights fan out over pubsub.
        ``mode="inference"`` uses the sebulba split (actors query a
        shared batched policy-inference service on the learner's device
        instead of holding local weights)."""
        self.distributed = True
        self.num_rollout_actors = num_rollout_actors
        self.num_envs_per_runner = num_envs_per_actor
        self.rollout_mode = mode
        self.shard_queue_size = shard_queue_size
        return self


def probe_env_spec(env: str, env_config: Dict[str, Any],
                   frame_stack: int = 1,
                   obs_connectors=None) -> Tuple[tuple, int]:
    """Observation shape (after connectors + frame stacking) + action
    count. Connectors transform obs before the policy, so the policy's
    input shape comes from a transformed sample, not the raw space."""
    import gymnasium as gym
    import numpy as np

    if env.startswith("ray_tpu/"):
        from ray_tpu_torch.rl import testing  # noqa: F401 (registers the ids)
    probe = gym.make(env, **env_config)
    obs, _ = probe.reset(seed=0)
    num_actions = int(probe.action_space.n)
    probe.close()
    if obs_connectors:
        import copy

        from ray_tpu_torch.rl.connectors import apply_connectors

        # Probe through a DEEP COPY: stateful connectors (running
        # normalization) must not have their statistics polluted by the
        # probe sample before being shipped to runners.
        obs = apply_connectors(copy.deepcopy(list(obs_connectors)),
                               np.asarray(obs)[None])[0]
    obs_shape = tuple(np.asarray(obs).shape)
    if frame_stack > 1:
        obs_shape = obs_shape[:-1] + (obs_shape[-1] * frame_stack,)
    return tuple(obs_shape), num_actions


def make_env_runners(config) -> List[Any]:
    """Spawn the EnvRunner actor fleet from a config's common fields."""
    runner_cls = ray_tpu_torch.remote(EnvRunner)
    return [
        runner_cls.options(num_cpus=1).remote(
            config.env, config.num_envs_per_runner,
            config.rollout_length, seed=config.seed + i,
            env_config=config.env_config,
            frame_stack=getattr(config, "frame_stack", 1),
            policy_mode=getattr(config, "policy_mode", "categorical"),
            obs_connectors=getattr(config, "obs_connectors", None),
            action_connectors=getattr(config, "action_connectors", None))
        for i in range(config.num_env_runners)
    ]


def rollout_to_transitions(ro, done_key: str = "terminateds",
                           action_dtype=None):
    """(T, N) rollout -> flat off-policy transition batch (obs, actions,
    rewards, next_obs, <done_key>) shared by DQN and SAC.

    next_obs[t] = obs[t+1]; the final row's successor is the runner's
    ``last_obs`` (rollouts that predate that field drop the final row
    instead). Synthetic autoreset rows (valids==0) are not experience.
    The done column is TERMINATED only: a time-limit truncation keeps
    bootstrapping through its true final observation (under NEXT_STEP
    autoreset the done step returns it; the reset obs lands on the
    following, masked row)."""
    import numpy as np

    T = ro["rewards"].shape[0]
    if "last_obs" in ro:
        next_obs = np.concatenate([ro["obs"][1:], ro["last_obs"][None]], 0)
        keep = ro["valids"] > 0.5
        rows = slice(None)
    else:
        next_obs = ro["obs"][1:]
        keep = ro["valids"][:T - 1] > 0.5
        rows = slice(0, T - 1)
    term = ro.get("terminateds", ro["dones"])
    actions = ro["actions"][rows][keep]
    if action_dtype is not None:
        actions = actions.astype(action_dtype)
    return {
        "obs": ro["obs"][rows][keep],
        "actions": actions,
        "rewards": ro["rewards"][rows][keep].astype(np.float32),
        "next_obs": next_obs[keep],
        done_key: term[rows][keep].astype(np.float32),
    }


def stop_runners(runners) -> None:
    for runner in runners:
        try:
            ray_tpu_torch.kill(runner)
        except Exception:  # graftlint: disable=swallowed-exception (best-effort runner teardown; cluster reaps survivors)
            pass
