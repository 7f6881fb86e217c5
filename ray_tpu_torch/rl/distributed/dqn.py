"""Distributed DQN: prioritized replay fed by parallel rollout actors
(port of ``ray_tpu/rl/distributed/dqn.py``).

The off-policy port onto the Podracer substrate: N epsilon-greedy
RolloutActors stream trajectory shards through the object plane into
the learner host's bounded queue; the learner drains them into the
(optionally prioritized) replay buffer and runs TD updates on its
``device``; weights + the annealed epsilon fan out over pubsub. Built
behind the EXISTING config API —
``DQNConfig().distributed_rollouts(4).build()`` — and the learner math
is literally ``dqn.make_dqn_update``, so single-process and distributed
DQN cannot drift.

4+ actors decorrelate the replay stream where 2 synchronous runners
plateau: the run-to-reward soak runs on this plane.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.core.device import resolve_device
from ray_tpu_torch.rl.distributed.learner import (LearnerState,
                                                  RolloutPlane,
                                                  new_plane_key,
                                                  plane_stats)
from ray_tpu_torch.rl.distributed.shard import TrajectoryShard
from ray_tpu_torch.rl.dqn import (DQNConfig, make_dqn_update,
                                  rollout_to_transitions)
from ray_tpu_torch.rl.models import build_policy
from ray_tpu_torch.rl.replay import ReplayBuffer
from ray_tpu_torch.rl.tree import adam, clone, to_device


class DistributedDQN:
    def __init__(self, config: DQNConfig):
        from ray_tpu_torch.rl.common import probe_env_spec

        self.config = config
        # Refuse before any env probe or actor: no card, no learner.
        self.device = resolve_device(config.device)
        self._iteration = 0
        self._total_env_steps = 0
        self._learner_steps = 0
        self.last_leak_report: Dict[str, Any] = {}

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
        self._update = make_dqn_update(
            self._forward, self.optimizer, config.gamma, config.double_q)
        self.buffer = ReplayBuffer(
            config.buffer_capacity, prioritized=config.prioritized_replay,
            alpha=config.priority_alpha, beta=config.priority_beta,
            seed=config.seed)

        self.state = LearnerState(new_plane_key("dqn"), self.device)
        # First version BEFORE the fleet starts: local-mode actors (and
        # the inference service) park in wait_initial until it exists.
        self.state.publish(self.params, {"epsilon": self._epsilon()})
        self.plane = RolloutPlane(
            self.state.plane_key, env=config.env,
            num_actors=config.num_rollout_actors,
            num_envs=config.num_envs_per_runner,
            rollout_length=config.rollout_length, seed=config.seed,
            env_config=config.env_config,
            frame_stack=config.frame_stack,
            policy_mode="epsilon_greedy",
            obs_connectors=getattr(config, "obs_connectors", None),
            action_connectors=getattr(config, "action_connectors", None),
            queue_capacity=config.shard_queue_size,
            mode=config.rollout_mode, obs_shape=obs_shape,
            num_actions=num_actions, hidden=tuple(config.hidden),
            device=self.device)
        self.plane.start()

    # ------------------------------------------------------------- driver

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0,
                   self._total_env_steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_initial + frac * (
            cfg.epsilon_final - cfg.epsilon_initial)

    def _drain(self, min_shards: int, timeout: float = 120.0
               ) -> List[Tuple[Dict[str, np.ndarray], TrajectoryShard]]:
        """Block for ``min_shards`` descriptors, then opportunistically
        take whatever else is queued, up to twice that (keeps the learner
        caught up without a barrier), resolving each shard's arrays
        through the object plane."""
        deadline = time.monotonic() + timeout
        out = []
        while len(out) < min_shards:
            shard = self.plane.queue.get(
                timeout=max(0.0, deadline - time.monotonic()))
            if shard is None:
                raise TimeoutError("no trajectory shards arriving")
            out.append((ray_tpu_torch.get(shard.ref), shard))
        while len(out) < 2 * min_shards:
            shard = self.plane.queue.get(timeout=0.0)
            if shard is None:
                break
            out.append((ray_tpu_torch.get(shard.ref), shard))
        return out

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.monotonic()
        min_shards = cfg.min_shards_per_iter or cfg.num_rollout_actors
        drained = self._drain(min_shards)
        steps = 0
        for ro, shard in drained:
            self.state.record_staleness(shard)
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
                batch = self.state.shard_batch(
                    {**batch, "weights": weights})
                self.params, self.opt_state, loss, aux = \
                    self.state.timed_update(lambda b=batch: self._update(
                        self.params, self.target_params,
                        self.opt_state, b))
                self.buffer.update_priorities(
                    idx, aux["td_abs"].cpu().numpy())
                losses.append(float(loss))
                q_means.append(float(aux["q_mean"]))
                self._learner_steps += 1
                if self._learner_steps % cfg.target_update_interval == 0:
                    self.target_params = clone(self.params)
        learn_time = time.monotonic() - t1

        self._iteration += 1
        self.state.publish(self.params, {"epsilon": self._epsilon()})
        shards = [s for _, s in drained]
        metrics: Dict[str, Any] = {
            "training_iteration": self._iteration,
            "env_steps_total": self._total_env_steps,
            "env_steps_this_iter": steps,
            "buffer_size": len(self.buffer),
            "learner_steps": self._learner_steps,
            "epsilon": round(self._epsilon(), 4),
            "shards_consumed": len(drained),
            "weights_version": self.state.version,
            "sample_time_s": round(sample_time, 3),
            "learn_time_s": round(learn_time, 3),
            "rl": plane_stats(self.state.plane_key, self.plane.queue),
        }
        if losses:
            metrics["loss"] = float(np.mean(losses))
            metrics["q_mean"] = float(np.mean(q_means))
        ep = self.plane.episode_stats_from(shards)
        if ep is not None:
            metrics["episode_return_mean"] = ep
        return metrics

    def stop(self) -> None:
        self.last_leak_report = self.plane.stop()
        self.state.close()
