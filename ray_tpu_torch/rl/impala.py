"""IMPALA: asynchronous actor-learner RL with V-trace correction (port of
``ray_tpu/rl/impala.py``).

EnvRunner actors sample CONTINUOUSLY with whatever weights they last
received (no per-iteration barrier); the learner consumes rollouts as they
arrive, corrects for the policy lag with V-trace importance weighting,
updates on its ``device``, and publishes fresh weights through the
versioned pubsub fan-out (``rl/distributed/fanout.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np
import torch

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
from ray_tpu_torch.rl.tree import adam, batch_to, host, to_device, \
    value_and_grad


@torch.no_grad()
def vtrace(behavior_logp, target_logp, rewards, values, dones, last_value,
           valids, gamma: float, rho_clip: float = 1.0,
           c_clip: float = 1.0):
    """V-trace targets and policy-gradient advantages (Espeholt et al.
    2018, eqs. 1-2) over (T, N) rollouts of tensors; no gradient flows
    through them (the JAX update stops it on both outputs).

    Synthetic autoreset rows (``valids`` == 0) break the recursion exactly
    like episode boundaries."""
    rho = torch.exp(target_logp - behavior_logp)
    rho_c = torch.clamp(rho, max=rho_clip)
    c = torch.clamp(rho, max=c_clip)
    T = rewards.shape[0]
    next_values = torch.cat([values[1:], last_value[None]], dim=0)

    nonterminal = (1.0 - dones) * valids
    deltas = rho_c * (rewards + gamma * next_values * (1.0 - dones)
                      - values) * valids
    acc = torch.zeros_like(last_value)
    vs_minus_v = [None] * T
    for t in reversed(range(T)):     # jax.lax.scan over the reversed rows
        acc = deltas[t] + gamma * c[t] * nonterminal[t] * acc
        vs_minus_v[t] = acc
    vs = values + torch.stack(vs_minus_v)
    next_vs = torch.cat([vs[1:], last_value[None]], dim=0)
    pg_adv = rho_c * (rewards + gamma * next_vs * (1.0 - dones) - values)
    return vs, pg_adv * valids


def make_impala_update(forward, optimizer, cfg):
    """The V-trace actor-critic update: ``update(params, opt_state, batch)
    -> (params, opt_state, aux)``, the params updated in place."""

    def loss_fn(params, batch):
        T, N = batch["rewards"].shape
        obs = batch["obs"].reshape((T * N,) + batch["obs"].shape[2:])
        logits, values_flat = forward(params, obs)
        logits = logits.reshape(T, N, -1)
        values = values_flat.reshape(T, N)
        logp_all = torch.log_softmax(logits, -1)
        target_logp = take_logp(logp_all, batch["actions"])
        vs, pg_adv = vtrace(
            batch["logp"], target_logp, batch["rewards"],
            values, batch["dones"], batch["last_value"],
            batch["valids"], cfg.gamma, cfg.rho_clip, cfg.c_clip)
        valid_count = torch.clamp(batch["valids"].sum(), min=1.0)
        pi_loss = -torch.sum(target_logp * pg_adv) / valid_count
        vf_loss = torch.sum(
            batch["valids"] * (values - vs) ** 2) / valid_count
        entropy = -torch.sum(
            batch["valids"][..., None]
            * torch.softmax(logits, -1) * logp_all) / valid_count
        total = (pi_loss + cfg.vf_coeff * vf_loss
                 - cfg.entropy_coeff * entropy)
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    def update(params, opt_state, batch):
        (loss, aux), grads = value_and_grad(loss_fn, params, batch,
                                            has_aux=True)
        opt_state = optimizer.update(grads, opt_state, params)
        aux["total_loss"] = loss
        return params, opt_state, aux

    return update


@dataclass
class IMPALAConfig(ConfigBuilderMixin):
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_length: int = 64
    frame_stack: int = 1
    lr: float = 5e-4
    gamma: float = 0.99
    entropy_coeff: float = 0.01
    vf_coeff: float = 0.5
    rho_clip: float = 1.0
    c_clip: float = 1.0
    hidden: tuple = (64, 64)
    seed: int = 0
    broadcast_interval: int = 1  # learner updates between weight pushes
    # Podracer actor/learner substrate (rl/distributed/): see
    # ConfigBuilderMixin.distributed_rollouts.
    distributed: bool = False
    num_rollout_actors: int = 4
    rollout_mode: str = "local"     # "inference" = sebulba split
    shard_queue_size: int = 8
    # The JAX package's data-mesh switch; the port's learner drives one
    # card whatever it says (a split across cards is ROADMAP's).
    learner_mesh: bool = False
    max_shard_staleness: int = 0    # 0 = keep everything; else drop
    device: str = "cuda"

    def build(self):
        if self.distributed and type(self) is IMPALAConfig:
            from ray_tpu_torch.rl.distributed.onpolicy import \
                DistributedIMPALA

            return DistributedIMPALA(self)
        return IMPALA(self)


class IMPALA(Checkpointable):
    _CKPT_ATTRS = ("params", "opt_state", "_iteration", "_updates",
                   "_total_env_steps", "_steps_iter")

    def __init__(self, config: IMPALAConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self._iteration = 0
        self._updates = 0
        self._total_env_steps = 0
        self._steps_iter = 0

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
        self._update = self._make_update()

        self.runners = make_env_runners(config)
        # Weight sync rides the versioned pubsub fan-out: the learner
        # publishes once per broadcast, runners pull on their next
        # sample.
        from ray_tpu_torch.rl.distributed.fanout import WeightFanout
        from ray_tpu_torch.rl.distributed.learner import new_plane_key

        self._fanout = WeightFanout(new_plane_key("impala"))
        ray_tpu_torch.get([r.enable_weight_sync.remote(self._fanout.key)
                           for r in self.runners])
        self._push_weights()
        # Continuous sampling: one outstanding rollout per runner, refilled
        # as the learner consumes (the async pipeline; no iteration barrier).
        self._inflight: Dict[Any, int] = {
            runner.sample.remote(): i
            for i, runner in enumerate(self.runners)}

    def _make_update(self):
        return make_impala_update(self._forward, self.optimizer,
                                  self.config)

    def _push_weights(self) -> None:
        """Publish ONCE to the versioned pubsub fan-out; every runner
        pulls the object-plane ref at its next sample() freshness poll.
        The version clock is the learner's update count + 1, so a runner's
        measured lag at consume time is ``self._updates - (version - 1)``
        in update units."""
        self._fanout.publish(host(self.params), version=self._updates + 1)

    def train(self, min_rollouts: int = 4) -> Dict[str, Any]:
        """Consume >= min_rollouts as they arrive (no barrier), update per
        rollout, push weights every broadcast_interval updates."""
        cfg = self.config
        t0 = time.monotonic()
        consumed = 0
        aux = {}
        lag_sum = 0
        while consumed < min_rollouts:
            ready, _ = ray_tpu_torch.wait(list(self._inflight),
                                          num_returns=1, timeout=120.0)
            if not ready:
                raise TimeoutError("no rollouts arriving")
            for ref in ready:
                idx = self._inflight.pop(ref)
                rollout = ray_tpu_torch.get(ref)
                self._inflight[self.runners[idx].sample.remote()] = idx
                batch = batch_to(
                    {k: rollout[k] for k in (
                        "obs", "actions", "logp", "rewards", "dones",
                        "valids", "last_value")}, self.device)
                self.params, self.opt_state, aux = self._update(
                    self.params, self.opt_state, batch)
                self._updates += 1
                # Fan-out versions are stamped updates+1 at publish, so
                # the runner's lag in update units at consume is:
                lag_sum += max(
                    0, self._updates - rollout["weights_version"])
                consumed += 1
                valid_steps = int(rollout["valids"].sum())
                self._total_env_steps += valid_steps
                self._steps_iter += valid_steps
                if self._updates % cfg.broadcast_interval == 0:
                    self._push_weights()
        elapsed = time.monotonic() - t0

        stats = ray_tpu_torch.get(
            [r.episode_stats.remote() for r in self.runners])
        episode_returns = [s["episode_return_mean"] for s in stats
                           if s.get("episodes")]
        self._iteration += 1
        steps = self._steps_iter
        self._steps_iter = 0
        metrics = {
            "training_iteration": self._iteration,
            "env_steps_total": self._total_env_steps,
            "env_steps_per_sec": steps / max(1e-9, elapsed),
            "rollouts_consumed": consumed,
            "mean_policy_lag": lag_sum / max(1, consumed),
            **{k: float(v) for k, v in aux.items()},
        }
        if episode_returns:
            metrics["episode_return_mean"] = float(np.mean(episode_returns))
        return metrics

    def stop(self) -> None:
        stop_runners(self.runners)
        self._fanout.close()
