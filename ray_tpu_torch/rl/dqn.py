"""DQN: off-policy value learning with replay (port of
``ray_tpu/rl/dqn.py``).

Double-DQN targets by default; prioritized replay is proportional with
importance-sampling weights. EnvRunner actors collect epsilon-greedy
transitions (the policy head doubles as the Q head); replay sampling is
numpy host-side, the TD update runs on the learner's ``device``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch.core.device import resolve_device
from ray_tpu_torch.rl.checkpointing import Checkpointable
from ray_tpu_torch.rl.common import (
    ConfigBuilderMixin,
    make_env_runners,
    probe_env_spec,
    stop_runners,
)
from ray_tpu_torch.rl.models import build_policy, take_logp
from ray_tpu_torch.rl.replay import ReplayBuffer
from ray_tpu_torch.rl.tree import adam, batch_to, clone, host, to_device, \
    value_and_grad


@dataclass
class DQNConfig(ConfigBuilderMixin):
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_length: int = 32
    frame_stack: int = 1
    policy_mode: str = "epsilon_greedy"  # consumed by EnvRunner
    lr: float = 1e-3
    gamma: float = 0.99
    buffer_capacity: int = 50_000
    batch_size: int = 128
    learning_starts: int = 1_000
    train_batches_per_iter: int = 32
    target_update_interval: int = 200    # learner steps between hard syncs
    double_q: bool = True
    prioritized_replay: bool = False
    priority_alpha: float = 0.6
    priority_beta: float = 0.4
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_steps: int = 10_000    # env steps to anneal over
    hidden: tuple = (64, 64)
    seed: int = 0
    # Podracer actor/learner substrate (rl/distributed/): same config
    # surface, DQNConfig().distributed_rollouts(4).build(); see
    # ConfigBuilderMixin.distributed_rollouts.
    distributed: bool = False
    num_rollout_actors: int = 4
    rollout_mode: str = "local"     # "inference" = sebulba split
    shard_queue_size: int = 8
    # The JAX package's data-mesh switch; the port's learner drives one
    # card whatever it says (a split across cards is ROADMAP's).
    learner_mesh: bool = True
    min_shards_per_iter: int = 0    # 0 = one per rollout actor
    device: str = "cuda"

    def build(self):
        if self.distributed:
            from ray_tpu_torch.rl.distributed.dqn import DistributedDQN

            return DistributedDQN(self)
        return DQN(self)

    def env_runners(self, num_env_runners: int,
                    num_envs_per_runner: int = 4) -> "DQNConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_runner
        return self

    def training(self, **kwargs) -> "DQNConfig":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self


def rollout_to_transitions(ro: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """(T, N) rollout -> flat DQN transition batch; see the shared helper
    (``common.rollout_to_transitions``) for the boundary semantics."""
    from ray_tpu_torch.rl.common import rollout_to_transitions as shared

    return shared(ro, done_key="dones", action_dtype=np.int32)


def make_dqn_update(forward, optimizer, gamma: float, double_q: bool):
    """The (Double-)DQN TD update: ``update(params, target_params,
    opt_state, batch) -> (params, opt_state, loss, aux)``, the params
    updated in place."""

    def loss_fn(params, target_params, batch):
        q_all, _ = forward(params, batch["obs"])
        q = take_logp(q_all, batch["actions"])
        with torch.no_grad():
            q_next_target, _ = forward(target_params, batch["next_obs"])
            if double_q:
                # Double DQN: online net picks the argmax, target net rates.
                q_next_online, _ = forward(params, batch["next_obs"])
                best = torch.argmax(q_next_online, dim=-1)
                next_q = take_logp(q_next_target, best)
            else:
                next_q = q_next_target.max(dim=-1).values
            target = batch["rewards"] + gamma * (
                1.0 - batch["dones"]) * next_q
        td = q - target
        # Huber loss, importance-weighted for prioritized replay.
        loss = torch.mean(batch["weights"] * F.huber_loss(
            q, target, reduction="none", delta=1.0))
        return loss, {"td_abs": torch.abs(td), "q_mean": torch.mean(q)}

    def update(params, target_params, opt_state, batch):
        (loss, aux), grads = value_and_grad(
            loss_fn, params, target_params, batch, has_aux=True)
        opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss, aux

    return update


class DQN(Checkpointable):
    _CKPT_ATTRS = ("params", "target_params", "opt_state", "_iteration",
                   "_total_env_steps", "_learner_steps")
    _CKPT_BUFFER_ATTR = "buffer"

    def __init__(self, config: DQNConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self._iteration = 0
        self._total_env_steps = 0
        self._learner_steps = 0

        obs_shape, num_actions = probe_env_spec(
            config.env, config.env_config, config.frame_stack,
            getattr(config, "obs_connectors", None))
        init_fn, self._forward = build_policy(obs_shape, num_actions,
                                              config.hidden)
        self.params = to_device(
            init_fn(torch.Generator().manual_seed(config.seed)),
            self.device)
        self.target_params = clone(self.params)
        self.optimizer = adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        self._update = self._make_update()

        self.buffer = ReplayBuffer(
            config.buffer_capacity, prioritized=config.prioritized_replay,
            alpha=config.priority_alpha, beta=config.priority_beta,
            seed=config.seed)
        self.runners = make_env_runners(config)
        self._broadcast_weights()

    # ------------------------------------------------------------- learner

    def _make_update(self):
        cfg = self.config
        return make_dqn_update(self._forward, self.optimizer, cfg.gamma,
                               cfg.double_q)

    # ------------------------------------------------------------- driver

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._total_env_steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_initial + frac * (
            cfg.epsilon_final - cfg.epsilon_initial)

    def _broadcast_weights(self) -> None:
        eps = self._epsilon()
        ref = ray_tpu_torch.put(host(self.params))
        waits = []
        for r in self.runners:
            waits.append(r.set_weights.remote(ref, self._iteration))
            waits.append(r.set_epsilon.remote(eps))
        ray_tpu_torch.get(waits)

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.monotonic()
        rollouts = ray_tpu_torch.get(
            [r.sample.remote() for r in self.runners])
        steps = 0
        for ro in rollouts:
            trans = rollout_to_transitions(ro)
            steps += len(trans["rewards"])
            self.buffer.add(trans)
        self._total_env_steps += steps
        sample_time = time.monotonic() - t0

        t1 = time.monotonic()
        losses, q_means = [], []
        if len(self.buffer) >= max(cfg.learning_starts, cfg.batch_size):
            for _ in range(cfg.train_batches_per_iter):
                batch, idx, weights = self.buffer.sample(cfg.batch_size)
                batch = batch_to({**batch, "weights": weights}, self.device)
                self.params, self.opt_state, loss, aux = self._update(
                    self.params, self.target_params, self.opt_state, batch)
                self.buffer.update_priorities(
                    idx, aux["td_abs"].cpu().numpy())
                losses.append(float(loss))
                q_means.append(float(aux["q_mean"]))
                self._learner_steps += 1
                if self._learner_steps % cfg.target_update_interval == 0:
                    self.target_params = clone(self.params)
        learn_time = time.monotonic() - t1

        self._iteration += 1
        self._broadcast_weights()
        stats = ray_tpu_torch.get(
            [r.episode_stats.remote() for r in self.runners])
        episode_returns = [s["episode_return_mean"] for s in stats
                           if s.get("episodes")]
        metrics = {
            "training_iteration": self._iteration,
            "env_steps_total": self._total_env_steps,
            "env_steps_this_iter": steps,
            "buffer_size": len(self.buffer),
            "learner_steps": self._learner_steps,
            "epsilon": round(self._epsilon(), 4),
            "sample_time_s": round(sample_time, 3),
            "learn_time_s": round(learn_time, 3),
        }
        if losses:
            metrics["loss"] = float(np.mean(losses))
            metrics["q_mean"] = float(np.mean(q_means))
        if episode_returns:
            metrics["episode_return_mean"] = float(np.mean(episode_returns))
        return metrics

    def stop(self) -> None:
        stop_runners(self.runners)
