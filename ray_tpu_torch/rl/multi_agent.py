"""Multi-agent RL: dict-keyed envs, per-policy mapping, independent PPO
(port of ``ray_tpu/rl/multi_agent.py``).

Analogue of the reference's multi-agent stack
(``rllib/env/multi_agent_env.py`` dict-keyed step/reset API,
``rllib/env/multi_agent_env_runner.py`` episode collection, and the
new-API-stack MultiRLModule with ``policy_mapping_fn`` routing agents to
policies). Each policy is an independent PPO learner (independent learning
— the reference's default when no mixing network is configured); the env
runner groups every agent's trajectory under its mapped policy, and the
trainer runs the shared PPO update per policy on the config's ``device``
(the card unless the caller asks for the CPU). The env and its registry
need no gymnasium, so this path runs wherever torch does; runners are CPU
workers inferring from their own copy of the weights.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.core.device import resolve_device
from ray_tpu_torch.rl.checkpointing import Checkpointable
from ray_tpu_torch.rl.models import build_policy
from ray_tpu_torch.rl.ppo import compute_gae, make_ppo_update
from ray_tpu_torch.rl.tree import adam, batch_to, host, own, to_device


class MultiAgentEnv:
    """Dict-keyed multi-agent env (reference: ``MultiAgentEnv``):
    ``reset() -> (obs_dict, info)``;
    ``step(action_dict) -> (obs, rewards, terminateds, truncateds, info)``
    — all keyed by agent id, plus the ``"__all__"`` flag in terminateds/
    truncateds. ``possible_agents`` lists every agent id."""

    possible_agents: List[str] = []
    # Discrete action count shared by all agents (the policy head size);
    # envs MUST set it — there is no safe default.
    num_actions: Optional[int] = None

    def reset(self, *, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError


class GuideFollowEnv(MultiAgentEnv):
    """Two-agent cooperative test env with distinct roles (so separate
    policies are genuinely exercised): both agents see the one-hot step
    index. The *guide* is rewarded for playing ``step % 2``; the *follower*
    is rewarded for matching the guide's action this step (it cannot see
    the action — it must learn the same pattern). Optimal per-agent return
    = episode_length."""

    possible_agents = ["guide", "follower"]
    num_actions = 2

    def __init__(self, episode_length: int = 6):
        self.episode_length = episode_length
        self._t = 0

    def _obs(self):
        one_hot = np.zeros(self.episode_length, np.float32)
        if self._t < self.episode_length:
            one_hot[self._t] = 1.0
        return {"guide": one_hot, "follower": one_hot.copy()}

    def reset(self, *, seed: Optional[int] = None):
        self._t = 0
        return self._obs(), {}

    def step(self, action_dict: Dict[str, Any]):
        want = self._t % 2
        guide_act = int(action_dict["guide"])
        rewards = {
            "guide": 1.0 if guide_act == want else 0.0,
            "follower": 1.0 if int(action_dict["follower"]) == guide_act
            else 0.0,
        }
        self._t += 1
        done = self._t >= self.episode_length
        terminateds = {"guide": done, "follower": done, "__all__": done}
        truncateds = {"guide": False, "follower": False, "__all__": False}
        return self._obs(), rewards, terminateds, truncateds, {}


ENV_REGISTRY: Dict[str, Callable[..., MultiAgentEnv]] = {
    "ray_tpu/GuideFollow-v0": GuideFollowEnv,
}


def _make_env(env: Any, env_config: Dict[str, Any]) -> MultiAgentEnv:
    if isinstance(env, str):
        return ENV_REGISTRY[env](**env_config)
    return env(**env_config)


class MultiAgentEnvRunner:
    """Actor collecting per-policy trajectories from one multi-agent env
    (reference: ``multi_agent_env_runner.py``). ``sample`` steps whole
    episodes (``episodes_per_sample`` of them) and returns, per policy,
    the agent trajectories mapped to it — each a dict of (T, ...) arrays
    ready for per-trajectory GAE on the trainer."""

    def __init__(self, env: Any, env_config: Dict[str, Any],
                 policy_specs: Dict[str, tuple],
                 policy_mapping: Dict[str, str],
                 episodes_per_sample: int = 8, seed: int = 0):
        torch.set_num_threads(1)
        self.env = _make_env(env, env_config)
        self.policy_mapping = dict(policy_mapping)
        self.episodes_per_sample = episodes_per_sample
        self._gen = torch.Generator().manual_seed(seed)
        self._params: Dict[str, Any] = {}
        self._sample_fns = {}
        from ray_tpu_torch.rl.models import make_sample_fn

        for pid, (obs_shape, n_actions) in policy_specs.items():
            _init, forward = build_policy(obs_shape, n_actions)
            self._sample_fns[pid] = make_sample_fn(forward)
        self._completed: List[Dict[str, float]] = []

    def set_weights(self, params_by_policy: Dict[str, Any],
                    version: int = 0) -> None:
        # Own copies: the store hands back read-only views.
        self._params = {pid: own(p) for pid, p in params_by_policy.items()}
        self._version = version

    def sample(self) -> Dict[str, Any]:
        trajs: Dict[str, List[Dict[str, np.ndarray]]] = {}
        for _ in range(self.episodes_per_sample):
            episode = self._run_episode()
            for agent, traj in episode.items():
                pid = self.policy_mapping[agent]
                trajs.setdefault(pid, []).append(traj)
        return {"trajectories": trajs}

    def _run_episode(self) -> Dict[str, Dict[str, np.ndarray]]:
        obs_dict, _ = self.env.reset()
        buf: Dict[str, Dict[str, list]] = {
            a: {"obs": [], "actions": [], "logp": [], "values": [],
                "rewards": []}
            for a in self.env.possible_agents}
        returns = {a: 0.0 for a in self.env.possible_agents}
        # Rewards arriving before an agent's first action of the episode
        # (turn-based: the opener's move can pay/penalize the responder)
        # buffer here and fold into that agent's first transition.
        pending = {a: 0.0 for a in self.env.possible_agents}
        done = False
        while not done:
            actions = {}
            for agent, obs in obs_dict.items():
                pid = self.policy_mapping[agent]
                with torch.no_grad():
                    a, logp, v = self._sample_fns[pid](
                        self._params[pid],
                        torch.from_numpy(np.asarray(obs))[None], self._gen)
                actions[agent] = int(np.asarray(a)[0])
                buf[agent]["obs"].append(np.asarray(obs))
                buf[agent]["actions"].append(actions[agent])
                buf[agent]["logp"].append(float(np.asarray(logp)[0]))
                buf[agent]["values"].append(float(np.asarray(v)[0]))
            obs_dict, rewards, terms, truncs, _ = self.env.step(actions)
            for agent, r in rewards.items():
                returns[agent] += float(r)
                if agent in actions:
                    buf[agent]["rewards"].append(
                        float(r) + pending.pop(agent, 0.0))
                    pending[agent] = 0.0
                elif buf[agent]["rewards"]:
                    # Turn-based envs reward idle agents for earlier moves
                    # (e.g. the opponent's reply): credit the agent's LAST
                    # transition so trajectories stay rectangular.
                    buf[agent]["rewards"][-1] += float(r)
                else:
                    # Reward before the agent's first action: hold it for
                    # the first transition rather than dropping it.
                    pending[agent] = pending.get(agent, 0.0) + float(r)
            done = terms.get("__all__", False) or truncs.get("__all__",
                                                             False)
        self._completed.append(returns)
        return {
            agent: {
                "obs": np.stack(b["obs"]),
                "actions": np.asarray(b["actions"], np.int64),
                "logp": np.asarray(b["logp"], np.float32),
                "values": np.asarray(b["values"], np.float32),
                "rewards": np.asarray(b["rewards"], np.float32),
            }
            for agent, b in buf.items() if b["obs"]
        }

    def episode_stats(self) -> Dict[str, Any]:
        completed, self._completed = self._completed, []
        if not completed:
            return {"episodes": 0}
        agents = completed[0].keys()
        return {
            "episodes": len(completed),
            "agent_return_mean": {
                a: float(np.mean([c[a] for c in completed])) for a in agents},
            "episode_return_mean": float(np.mean(
                [sum(c.values()) for c in completed])),
        }


@dataclass
class MultiAgentPPOConfig:
    env: Any = "ray_tpu/GuideFollow-v0"
    env_config: Dict[str, Any] = field(default_factory=dict)
    policy_mapping_fn: Optional[Callable[[str], str]] = None
    num_env_runners: int = 2
    episodes_per_sample: int = 8
    lr: float = 3e-3
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coeff: float = 0.01
    vf_coeff: float = 0.5
    num_sgd_epochs: int = 4
    hidden: tuple = (64, 64)
    seed: int = 0
    device: str = "cuda"

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO(Checkpointable):
    """Independent PPO over a policy map (reference: the multi-agent
    Algorithm path — MultiRLModule + per-module learner updates)."""

    _CKPT_ATTRS = ("params", "opt_state", "_iteration",
                   "_total_env_steps")

    def __init__(self, config: MultiAgentPPOConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self._iteration = 0
        self._total_env_steps = 0
        mapping_fn = config.policy_mapping_fn or (lambda aid: aid)

        probe = _make_env(config.env, config.env_config)
        obs_dict, _ = probe.reset()
        agents = list(probe.possible_agents)
        self.policy_mapping = {a: mapping_fn(a) for a in agents}
        n_actions = getattr(probe, "num_actions", None)
        if not n_actions:
            raise ValueError(
                "multi-agent envs must declare num_actions (the discrete "
                "action count policies are built with)")
        # Per-policy spec from the first mapped agent's reset observation
        # (turn-based envs may omit idle agents at reset; any agent of the
        # same policy can supply the spec).
        self.policy_specs = {}
        for agent, pid in self.policy_mapping.items():
            if agent in obs_dict:
                self.policy_specs.setdefault(
                    pid,
                    (tuple(np.asarray(obs_dict[agent]).shape), n_actions))
        unmapped = set(self.policy_mapping.values()) - set(self.policy_specs)
        if unmapped:
            raise ValueError(
                f"policies {sorted(unmapped)} have no agent present in the "
                f"reset observation to derive a spec from")

        self.params: Dict[str, Any] = {}
        self.opt_state: Dict[str, Any] = {}
        self._updates: Dict[str, Any] = {}
        self.optimizer = adam(config.lr)
        gen = torch.Generator().manual_seed(config.seed)
        for pid, (obs_shape, n_act) in self.policy_specs.items():
            init_fn, forward = build_policy(obs_shape, n_act, config.hidden)
            self.params[pid] = to_device(init_fn(gen), self.device)
            self.opt_state[pid] = self.optimizer.init(self.params[pid])
            self._updates[pid] = make_ppo_update(
                forward, self.optimizer, config.clip_eps, config.vf_coeff,
                config.entropy_coeff)

        runner_cls = ray_tpu_torch.remote(MultiAgentEnvRunner)
        self.runners = [
            runner_cls.options(num_cpus=0.5).remote(
                config.env, config.env_config, self.policy_specs,
                self.policy_mapping, config.episodes_per_sample,
                seed=config.seed + i)
            for i in range(config.num_env_runners)]
        self._broadcast_weights()

    def _broadcast_weights(self) -> None:
        ref = ray_tpu_torch.put({pid: host(p)
                                 for pid, p in self.params.items()})
        ray_tpu_torch.get([r.set_weights.remote(ref, self._iteration)
                     for r in self.runners])

    def _policy_batch(self, trajs: List[Dict[str, np.ndarray]]
                      ) -> Dict[str, np.ndarray]:
        """Per-trajectory GAE (episodes are complete: terminal bootstrap
        0), then flatten across trajectories."""
        cfg = self.config
        outs = []
        for traj in trajs:
            T = len(traj["rewards"])
            rollout = {
                "rewards": traj["rewards"].reshape(T, 1),
                "values": traj["values"].reshape(T, 1),
                "dones": np.concatenate(
                    [np.zeros((T - 1, 1), np.float32),
                     np.ones((1, 1), np.float32)]),
                "last_value": np.zeros(1, np.float32),
            }
            gae = compute_gae(rollout, cfg.gamma, cfg.gae_lambda)
            outs.append({
                "obs": traj["obs"],
                "actions": traj["actions"],
                "logp": traj["logp"],
                "advantages": gae["advantages"].reshape(-1),
                "returns": gae["returns"].reshape(-1),
            })
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.monotonic()
        samples = ray_tpu_torch.get([r.sample.remote() for r in self.runners])
        sample_time = time.monotonic() - t0

        by_policy: Dict[str, List[Dict[str, np.ndarray]]] = {}
        for s in samples:
            for pid, trajs in s["trajectories"].items():
                by_policy.setdefault(pid, []).extend(trajs)

        t1 = time.monotonic()
        aux_by_policy = {}
        n_steps = 0
        for pid, trajs in by_policy.items():
            batch = self._policy_batch(trajs)
            n_steps += len(batch["actions"])
            batch = batch_to(batch, self.device)
            aux = {}
            for _ in range(cfg.num_sgd_epochs):
                self.params[pid], self.opt_state[pid], aux = \
                    self._updates[pid](self.params[pid],
                                       self.opt_state[pid], batch)
            aux_by_policy[pid] = {k: float(v) for k, v in aux.items()}
        learn_time = time.monotonic() - t1
        self._total_env_steps += n_steps

        self._broadcast_weights()
        stats = ray_tpu_torch.get([r.episode_stats.remote()
                             for r in self.runners])
        agent_returns: Dict[str, List[float]] = {}
        episode_returns = []
        for s in stats:
            if not s.get("episodes"):
                continue
            episode_returns.append(s["episode_return_mean"])
            for a, v in s["agent_return_mean"].items():
                agent_returns.setdefault(a, []).append(v)
        self._iteration += 1
        metrics: Dict[str, Any] = {
            "training_iteration": self._iteration,
            "env_steps_total": self._total_env_steps,
            "env_steps_this_iter": n_steps,
            "env_steps_per_sec": n_steps / max(1e-9,
                                               sample_time + learn_time),
            "loss_by_policy": aux_by_policy,
        }
        if episode_returns:
            metrics["episode_return_mean"] = float(np.mean(episode_returns))
            metrics["agent_return_mean"] = {
                a: float(np.mean(v)) for a, v in agent_returns.items()}
        return metrics

    def stop(self) -> None:
        from ray_tpu_torch.rl.common import stop_runners

        stop_runners(self.runners)
