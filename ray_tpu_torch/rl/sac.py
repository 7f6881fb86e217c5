"""SAC: off-policy continuous control (soft actor-critic); port of
``ray_tpu/rl/sac.py``.

Squashed-Gaussian actor, twin Q critics with target networks (clipped
double-Q), and automatic entropy-temperature tuning against the -|A|
target. EnvRunner actors (CPU workers) collect short rollouts with the
current actor; transitions land in a uniform replay buffer; the learner
runs its updates on the config's ``device`` and polyak-averages the
targets. Each update's Gaussian noise is drawn on the host from the
algorithm's ``torch.Generator`` (seeded ``seed + 1``) and enters the losses
as tensors.
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
from ray_tpu_torch.rl.common import ConfigBuilderMixin, make_env_runners, \
    stop_runners
from ray_tpu_torch.rl.models import (
    build_squashed_gaussian_actor,
    build_twin_q,
    squashed_sample,
)
from ray_tpu_torch.rl.replay import ReplayBuffer
from ray_tpu_torch.rl.tree import adam, batch_to, clone, host, \
    to_device, tree_leaves, value_and_grad


@dataclass
class SACConfig(ConfigBuilderMixin):
    env: str = "Pendulum-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_env_runners: int = 1
    num_envs_per_runner: int = 4
    rollout_length: int = 32
    policy_mode: str = "continuous"  # consumed by make_env_runners
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005               # polyak target rate
    batch_size: int = 256
    buffer_capacity: int = 200_000
    updates_per_iteration: int = 64
    warmup_steps: int = 1_000        # random-ish exploration before learning
    hidden: tuple = (256, 256)
    seed: int = 0
    device: str = "cuda"

    def build(self) -> "SAC":
        return SAC(self)


def alpha_step(alpha_opt, alpha_os, log_alpha, logp, target_entropy):
    """Temperature: push policy entropy toward the target. The JAX update
    hands ``-(exp(log_alpha) * mean(logp + target_entropy))`` to Adam AS
    the gradient (not the gradient of ``-log_alpha * ...``)."""
    with torch.no_grad():
        grad = -(torch.exp(log_alpha)
                 * (logp.detach() + target_entropy).mean())
    return alpha_opt.update(grad, alpha_os, log_alpha)


@torch.no_grad()
def polyak(target, online, tau: float) -> None:
    """target <- (1 - tau) * target + tau * online, in place."""
    for t, c in zip(tree_leaves(target), tree_leaves(online)):
        t.mul_(1.0 - tau).add_(c, alpha=tau)


def sac_draws(generator: torch.Generator, batch_size: int, action_dim: int,
              device) -> Dict[str, torch.Tensor]:
    """One update's standard normal noise: the critic target's next
    action and the actor's action (the JAX update's ``k1`` and ``k2``)."""
    shape = (batch_size, action_dim)
    return {k: torch.randn(shape, generator=generator).to(device)
            for k in ("critic", "actor")}


def make_sac_update(actor_fwd, critic_fwd, actor_opt, critic_opt,
                    alpha_opt, gamma: float, tau: float,
                    target_entropy: float):
    """``update(actor, critic, target_critic, log_alpha, opt_states, batch,
    draws) -> (actor, critic, target_critic, log_alpha, opt_states, aux)``
    with ``draws`` from :func:`sac_draws`; every tree is updated in place.
    The critic step differentiates the critic alone; the actor step runs
    against the critic it has just updated."""

    def critic_loss_fn(critic, actor, target_critic, log_alpha, batch,
                       noise):
        with torch.no_grad():
            mean, log_std = actor_fwd(actor, batch["next_obs"])
            next_a, next_logp = squashed_sample(mean, log_std, noise)
            tq1, tq2 = critic_fwd(target_critic, batch["next_obs"], next_a)
            alpha = torch.exp(log_alpha)
            target_v = torch.minimum(tq1, tq2) - alpha * next_logp
            target_q = (batch["rewards"] + gamma
                        * (1.0 - batch["terminateds"]) * target_v)
        q1, q2 = critic_fwd(critic, batch["obs"], batch["actions"])
        return ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()

    def actor_loss_fn(actor, critic, log_alpha, batch, noise):
        mean, log_std = actor_fwd(actor, batch["obs"])
        a, logp = squashed_sample(mean, log_std, noise)
        q1, q2 = critic_fwd(critic, batch["obs"], a)
        alpha = torch.exp(log_alpha)
        return (alpha * logp - torch.minimum(q1, q2)).mean(), logp

    def update(actor, critic, target_critic, log_alpha, opt_states,
               batch, draws):
        actor_os, critic_os, alpha_os = opt_states
        c_loss, c_grads = value_and_grad(
            critic_loss_fn, critic, actor, target_critic, log_alpha,
            batch, draws["critic"])
        critic_os = critic_opt.update(c_grads, critic_os, critic)

        (a_loss, logp), a_grads = value_and_grad(
            actor_loss_fn, actor, critic, log_alpha, batch, draws["actor"],
            has_aux=True)
        actor_os = actor_opt.update(a_grads, actor_os, actor)

        alpha_os = alpha_step(alpha_opt, alpha_os, log_alpha, logp,
                              target_entropy)
        polyak(target_critic, critic, tau)
        aux = {"critic_loss": c_loss, "actor_loss": a_loss,
               "alpha": torch.exp(log_alpha), "entropy": -logp.mean()}
        return (actor, critic, target_critic, log_alpha,
                (actor_os, critic_os, alpha_os), aux)

    return update


class SAC(Checkpointable):
    _CKPT_ATTRS = ("actor", "critic", "target_critic", "log_alpha",
                   "actor_opt_state", "critic_opt_state",
                   "alpha_opt_state", "_iteration", "_total_env_steps")
    _CKPT_KEY_ATTRS = ("_gen",)
    _CKPT_BUFFER_ATTR = "buffer"

    def __init__(self, config: SACConfig):
        import gymnasium as gym

        self.config = config
        self.device = resolve_device(config.device)
        self._iteration = 0
        self._total_env_steps = 0

        probe = gym.make(config.env, **config.env_config)
        obs_dim = int(np.prod(probe.observation_space.shape))
        action_dim = int(np.prod(probe.action_space.shape))
        probe.close()
        self._action_dim = action_dim

        gen = torch.Generator().manual_seed(config.seed)
        actor_init, self._actor_fwd = build_squashed_gaussian_actor(
            obs_dim, action_dim, config.hidden)
        critic_init, self._critic_fwd = build_twin_q(
            obs_dim, action_dim, config.hidden)
        self.actor = to_device(actor_init(gen), self.device)
        self.critic = to_device(critic_init(gen), self.device)
        self.target_critic = clone(self.critic)
        # Auto-tuned temperature, optimized in log space (always > 0).
        self.log_alpha = torch.zeros((), device=self.device)
        self._target_entropy = -float(action_dim)

        self._actor_opt = adam(config.actor_lr)
        self._critic_opt = adam(config.critic_lr)
        self._alpha_opt = adam(config.alpha_lr)
        self.actor_opt_state = self._actor_opt.init(self.actor)
        self.critic_opt_state = self._critic_opt.init(self.critic)
        self.alpha_opt_state = self._alpha_opt.init(self.log_alpha)
        self._update = self._make_update()
        self._gen = torch.Generator().manual_seed(config.seed + 1)

        self.buffer = ReplayBuffer(config.buffer_capacity, seed=config.seed)
        self.runners = make_env_runners(config)
        self._broadcast_weights()

    # ------------------------------------------------------------- learner

    def _make_update(self):
        cfg = self.config
        return make_sac_update(self._actor_fwd, self._critic_fwd,
                               self._actor_opt, self._critic_opt,
                               self._alpha_opt, cfg.gamma, cfg.tau,
                               self._target_entropy)

    # --------------------------------------------------------------- train

    def _broadcast_weights(self) -> None:
        ref = ray_tpu_torch.put(host(self.actor))
        ray_tpu_torch.get([r.set_weights.remote(ref, self._iteration)
                           for r in self.runners])

    def _rollout_to_transitions(self, ro: Dict[str, np.ndarray]
                                ) -> Dict[str, np.ndarray]:
        """See ``common.rollout_to_transitions`` for boundary semantics."""
        from ray_tpu_torch.rl.common import rollout_to_transitions

        return rollout_to_transitions(ro, done_key="terminateds")

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.monotonic()
        rollouts = ray_tpu_torch.get(
            [r.sample.remote() for r in self.runners])
        sample_time = time.monotonic() - t0
        n_new = 0
        for ro in rollouts:
            batch = self._rollout_to_transitions(ro)
            n_new += len(batch["rewards"])
            if len(batch["rewards"]):
                self.buffer.add(batch)
        self._total_env_steps += n_new

        t1 = time.monotonic()
        aux = {}
        if self._total_env_steps >= cfg.warmup_steps:
            for _ in range(cfg.updates_per_iteration):
                batch, _idx, _w = self.buffer.sample(cfg.batch_size)
                draws = sac_draws(self._gen, cfg.batch_size,
                                  self._action_dim, self.device)
                (self.actor, self.critic, self.target_critic,
                 self.log_alpha,
                 (self.actor_opt_state, self.critic_opt_state,
                  self.alpha_opt_state), aux) = self._update(
                    self.actor, self.critic, self.target_critic,
                    self.log_alpha,
                    (self.actor_opt_state, self.critic_opt_state,
                     self.alpha_opt_state), batch_to(batch, self.device),
                    draws)
        aux = {k: float(v) for k, v in aux.items()}
        learn_time = time.monotonic() - t1

        self._broadcast_weights()
        stats = ray_tpu_torch.get([r.episode_stats.remote()
                                   for r in self.runners])
        episode_returns = [s["episode_return_mean"] for s in stats
                           if s.get("episodes")]
        self._iteration += 1
        metrics = {
            "training_iteration": self._iteration,
            "env_steps_total": self._total_env_steps,
            "env_steps_this_iter": n_new,
            "env_steps_per_sec": n_new / max(1e-9,
                                             sample_time + learn_time),
            "sample_time_s": round(sample_time, 3),
            "learn_time_s": round(learn_time, 3),
            "buffer_size": len(self.buffer),
            **aux,
        }
        if episode_returns:
            metrics["episode_return_mean"] = float(np.mean(episode_returns))
        return metrics

    def stop(self) -> None:
        stop_runners(self.runners)
