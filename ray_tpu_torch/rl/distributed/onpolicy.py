"""Distributed IMPALA: V-trace learning over the Podracer substrate (port
of ``ray_tpu/rl/distributed/onpolicy.py``).

The on-policy(ish) port: RolloutActors sample CONTINUOUSLY with
whatever weights they last pulled from the fan-out; the learner drains
the bounded shard queue, corrects each shard's measured staleness with
V-trace (the behavior log-probs in the shard ARE the correction — the
lag distribution in the ``rl`` stats dict tells you how much work
V-trace is doing), updates on its ``device``, and republishes.
Optionally drops shards beyond ``max_shard_staleness`` updates old
instead of correcting them. Built behind the existing ``IMPALAConfig``
API (``IMPALAConfig().distributed_rollouts(4).build()``); the learner
math is literally ``impala.make_impala_update``, which writes the params
in place.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import torch

import ray_tpu_torch
from ray_tpu_torch.core.device import resolve_device
from ray_tpu_torch.rl.distributed.learner import (RL_SHARDS_DROPPED,
                                                  LearnerState,
                                                  RolloutPlane,
                                                  new_plane_key,
                                                  plane_stats)
from ray_tpu_torch.rl.impala import IMPALAConfig, make_impala_update
from ray_tpu_torch.rl.models import build_policy
from ray_tpu_torch.rl.tree import adam, to_device


class DistributedIMPALA:
    def __init__(self, config: IMPALAConfig):
        from ray_tpu_torch.rl.common import probe_env_spec

        self.config = config
        # Refuse before any env probe or actor: no card, no learner.
        self.device = resolve_device(config.device)
        self._iteration = 0
        self._updates = 0
        self._total_env_steps = 0
        self.last_leak_report: Dict[str, Any] = {}

        obs_shape, num_actions = probe_env_spec(
            config.env, config.env_config, config.frame_stack,
            getattr(config, "obs_connectors", None))
        init_fn, self._forward = build_policy(obs_shape, num_actions,
                                              config.hidden)
        self.params = to_device(
            init_fn(torch.Generator().manual_seed(config.seed)),
            self.device)
        self.optimizer = adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        self._update = make_impala_update(self._forward, self.optimizer,
                                          config)

        self.state = LearnerState(new_plane_key("impala-dist"),
                                  self.device)
        # Version clock = updates + 1, so a shard's staleness reads in
        # learner-update units (the V-trace contract).
        self.state.publish(self.params, version=1)
        self.plane = RolloutPlane(
            self.state.plane_key, env=config.env,
            num_actors=config.num_rollout_actors,
            num_envs=config.num_envs_per_runner,
            rollout_length=config.rollout_length, seed=config.seed,
            env_config=config.env_config,
            frame_stack=config.frame_stack,
            policy_mode="categorical",
            obs_connectors=getattr(config, "obs_connectors", None),
            action_connectors=getattr(config, "action_connectors", None),
            queue_capacity=config.shard_queue_size,
            mode=config.rollout_mode, obs_shape=obs_shape,
            num_actions=num_actions, hidden=tuple(config.hidden),
            device=self.device)
        self.plane.start()

    def train(self, min_rollouts: int = 4) -> Dict[str, Any]:
        """Consume >= min_rollouts shards as they arrive (no barrier),
        update per shard, publish every broadcast_interval updates."""
        cfg = self.config
        t0 = time.monotonic()
        consumed = 0
        dropped = 0
        aux: Dict[str, Any] = {}
        lag_sum = 0
        steps = 0
        shards = []
        deadline = t0 + 120.0
        while consumed < min_rollouts:
            shard = self.plane.queue.get(
                timeout=max(0.0, deadline - time.monotonic()))
            if shard is None:
                raise TimeoutError("no trajectory shards arriving")
            rollout = ray_tpu_torch.get(shard.ref)
            self.state.record_staleness(shard)
            lag = max(0, self._updates - shard.weights_version + 1)
            if cfg.max_shard_staleness and lag > cfg.max_shard_staleness:
                dropped += 1
                RL_SHARDS_DROPPED.inc(1, {
                    "plane": self.state.plane_key, "reason": "stale"})
                continue
            shards.append(shard)
            batch = self.state.shard_batch({
                k: rollout[k]
                for k in ("obs", "actions", "logp", "rewards", "dones",
                          "valids", "last_value")})
            self.params, self.opt_state, aux = self.state.timed_update(
                lambda b=batch: self._update(self.params, self.opt_state,
                                             b))
            self._updates += 1
            lag_sum += lag
            consumed += 1
            valid_steps = int(rollout["valids"].sum())
            self._total_env_steps += valid_steps
            steps += valid_steps
            if self._updates % cfg.broadcast_interval == 0:
                self.state.publish(self.params, version=self._updates + 1)
        elapsed = time.monotonic() - t0

        self._iteration += 1
        metrics: Dict[str, Any] = {
            "training_iteration": self._iteration,
            "env_steps_total": self._total_env_steps,
            "env_steps_per_sec": steps / max(1e-9, elapsed),
            "rollouts_consumed": consumed,
            "shards_dropped_stale": dropped,
            "mean_policy_lag": lag_sum / max(1, consumed),
            "weights_version": self.state.version,
            "rl": plane_stats(self.state.plane_key, self.plane.queue),
            **{k: float(v) for k, v in aux.items()},
        }
        ep = self.plane.episode_stats_from(shards)
        if ep is not None:
            metrics["episode_return_mean"] = ep
        return metrics

    def stop(self) -> None:
        self.last_leak_report = self.plane.stop()
        self.state.close()
