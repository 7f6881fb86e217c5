"""CQL: conservative Q-learning for offline continuous control (port of
``ray_tpu/rl/cql.py``).

SAC plus a conservative critic regularizer, trained from offline data with
no environment interaction. The critic loss adds

    alpha_cql * ( logsumexp_a Q(s, a) - Q(s, a_data) )

with the logsumexp estimated over uniform-random actions plus current- and
next-policy actions (the CQL(H) estimator). Data comes from the offline
pipeline (``rl/offline.py``): a transitions Dataset staged into a
ReplayBuffer. Each update's draws (Gaussian noise for four action samples,
the uniform actions) come from the algorithm's ``torch.Generator`` on the
host and enter the losses as tensors. ``evaluate`` rolls the mean action
in a real env.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.core.device import resolve_device
from ray_tpu_torch.rl.checkpointing import Checkpointable
from ray_tpu_torch.rl.common import ConfigBuilderMixin
from ray_tpu_torch.rl.connectors import apply_connectors
from ray_tpu_torch.rl.models import (
    build_squashed_gaussian_actor,
    build_twin_q,
    squashed_sample,
)
from ray_tpu_torch.rl.sac import alpha_step, polyak
from ray_tpu_torch.rl.tree import adam, batch_to, clone, to_device, \
    value_and_grad


@dataclass
class CQLConfig(ConfigBuilderMixin):
    env: str = "Pendulum-v1"             # for specs + evaluation only
    env_config: Dict[str, Any] = field(default_factory=dict)
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    batch_size: int = 256
    updates_per_iteration: int = 200
    cql_alpha: float = 1.0               # conservative penalty weight
    cql_n_actions: int = 4               # sampled actions per source
    bc_iters: int = 1000                 # actor warm-starts as pure BC
    initial_alpha: float = 0.2           # entropy temperature at start
    fixed_alpha: bool = False            # offline: auto-tuning can run away
    hidden: tuple = (256, 256)
    seed: int = 0
    device: str = "cuda"

    def build(self, dataset=None) -> "CQL":
        return CQL(self, dataset)

    def training(self, **kwargs) -> "CQLConfig":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self


def cql_draws(generator: torch.Generator, batch_size: int, action_dim: int,
              n_actions: int, device) -> Dict[str, torch.Tensor]:
    """One update's draws, in the JAX update's key order: the TD target's
    next-action noise, the uniform actions in [-1, 1), the current- and
    next-policy action noise (``n_actions`` per row, rows repeated in
    place), and the actor's noise."""
    b, a, n = batch_size, action_dim, n_actions
    draws = {"next": torch.randn((b, a), generator=generator),
             "rand": torch.rand((b, n, a), generator=generator) * 2.0 - 1.0,
             "pi": torch.randn((b * n, a), generator=generator),
             "npi": torch.randn((b * n, a), generator=generator),
             "actor": torch.randn((b, a), generator=generator)}
    return {k: v.to(device) for k, v in draws.items()}


def make_cql_update(actor_fwd, critic_fwd, actor_opt, critic_opt,
                    alpha_opt, cfg, target_entropy: float):
    """``update(actor, critic, target_critic, log_alpha, opt_states, batch,
    draws, bc) -> (actor, critic, target_critic, log_alpha, opt_states,
    aux)`` with ``draws`` from :func:`cql_draws`; ``bc`` picks the
    behaviour-cloning actor loss (the warm start). Every tree is updated
    in place."""
    n_act = cfg.cql_n_actions

    def q_on_actions(critic, obs, actions):
        """Q1/Q2 for (B, K, A) action sets -> (B, K) each."""
        B, K = actions.shape[0], actions.shape[1]
        obs_rep = torch.repeat_interleave(obs, K, dim=0)
        flat = actions.reshape(B * K, -1)
        q1, q2 = critic_fwd(critic, obs_rep, flat)
        return q1.reshape(B, K), q2.reshape(B, K)

    def critic_loss_fn(critic, actor, target_critic, log_alpha, batch,
                       draws):
        B = batch["obs"].shape[0]
        with torch.no_grad():
            # Standard SAC TD target.
            mean, log_std = actor_fwd(actor, batch["next_obs"])
            next_a, next_logp = squashed_sample(mean, log_std, draws["next"])
            tq1, tq2 = critic_fwd(target_critic, batch["next_obs"], next_a)
            alpha = torch.exp(log_alpha)
            target_v = torch.minimum(tq1, tq2) - alpha * next_logp
            target_q = (batch["rewards"] + cfg.gamma
                        * (1.0 - batch["terminateds"]) * target_v)
            # Policy actions for the conservative term (constants here).
            pi_mean, pi_ls = actor_fwd(actor, batch["obs"])
            pi_a, _ = squashed_sample(
                torch.repeat_interleave(pi_mean, n_act, 0),
                torch.repeat_interleave(pi_ls, n_act, 0), draws["pi"])
            npi_mean, npi_ls = actor_fwd(actor, batch["next_obs"])
            npi_a, _ = squashed_sample(
                torch.repeat_interleave(npi_mean, n_act, 0),
                torch.repeat_interleave(npi_ls, n_act, 0), draws["npi"])
            cat = torch.cat([draws["rand"], pi_a.reshape(B, n_act, -1),
                             npi_a.reshape(B, n_act, -1)], dim=1)
        q1, q2 = critic_fwd(critic, batch["obs"], batch["actions"])
        td = ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()
        # Conservative term: logsumexp over random + policy actions
        # (CQL(H)), pushing down OOD Q while holding up data Q.
        cq1, cq2 = q_on_actions(critic, batch["obs"], cat)
        gap = (torch.logsumexp(cq1, dim=1) - q1
               + torch.logsumexp(cq2, dim=1) - q2)
        return td + cfg.cql_alpha * gap.mean(), (td, gap.mean())

    def actor_loss_fn(actor, critic, log_alpha, batch, noise, bc):
        mean, log_std = actor_fwd(actor, batch["obs"])
        a, logp = squashed_sample(mean, log_std, noise)
        alpha = torch.exp(log_alpha)
        if not bc:
            q1, q2 = critic_fwd(critic, batch["obs"], a)
            return (alpha * logp - torch.minimum(q1, q2)).mean(), logp
        # BC warm-start: maximize the squashed-Gaussian log-density of the
        # DATA action — the change-of-variables pair of squashed_sample.
        data_a = torch.clamp(batch["actions"], -0.999, 0.999)
        pre = torch.atanh(data_a)
        std = torch.exp(log_std)
        base = (-0.5 * ((pre - mean) / std) ** 2 - log_std
                - 0.5 * math.log(2.0 * math.pi)).sum(-1)
        squash = torch.log(1.0 - data_a ** 2 + 1e-6).sum(-1)
        return (alpha * logp - (base - squash)).mean(), logp

    def update(actor, critic, target_critic, log_alpha, opt_states,
               batch, draws, bc):
        actor_os, critic_os, alpha_os = opt_states
        (c_loss, (td, gap)), c_grads = value_and_grad(
            critic_loss_fn, critic, actor, target_critic, log_alpha,
            batch, draws, has_aux=True)
        critic_os = critic_opt.update(c_grads, critic_os, critic)

        (a_loss, logp), a_grads = value_and_grad(
            actor_loss_fn, actor, critic, log_alpha, batch, draws["actor"],
            bool(bc), has_aux=True)
        actor_os = actor_opt.update(a_grads, actor_os, actor)

        if not cfg.fixed_alpha:
            alpha_os = alpha_step(alpha_opt, alpha_os, log_alpha, logp,
                                  target_entropy)
        polyak(target_critic, critic, cfg.tau)
        aux = {"critic_loss": c_loss, "td_loss": td,
               "cql_gap": gap, "actor_loss": a_loss,
               "alpha": torch.exp(log_alpha)}
        return (actor, critic, target_critic, log_alpha,
                (actor_os, critic_os, alpha_os), aux)

    return update


class CQL(Checkpointable):
    """Offline learner over a transitions Dataset (no EnvRunners)."""

    _CKPT_ATTRS = ("actor", "critic", "target_critic", "log_alpha",
                   "actor_opt_state", "critic_opt_state",
                   "alpha_opt_state", "_iteration", "_updates_done")
    _CKPT_KEY_ATTRS = ("_gen",)

    def __init__(self, config: CQLConfig, dataset=None):
        import gymnasium as gym

        self.config = config
        self.device = resolve_device(config.device)
        self._iteration = 0
        self._updates_done = 0
        self.buffer = None
        if dataset is not None:
            self.set_dataset(dataset)

        probe = gym.make(config.env, **config.env_config)
        obs_dim = int(np.prod(probe.observation_space.shape))
        self._action_dim = int(np.prod(probe.action_space.shape))
        self._action_shape = probe.action_space.shape
        # Stored actions live in [-1, 1] (EnvRunner convention); the
        # module-to-env connector chain maps them to the env's action
        # space only at evaluation time (default: unsquash to bounds).
        self._action_connectors = list(
            getattr(config, "action_connectors", None) or [])
        if not self._action_connectors:
            from ray_tpu_torch.rl.connectors import UnsquashAction

            self._action_connectors = [UnsquashAction(
                np.asarray(probe.action_space.low).reshape(-1),
                np.asarray(probe.action_space.high).reshape(-1))]
        probe.close()

        gen = torch.Generator().manual_seed(config.seed)
        actor_init, self._actor_fwd = build_squashed_gaussian_actor(
            obs_dim, self._action_dim, config.hidden)
        critic_init, self._critic_fwd = build_twin_q(
            obs_dim, self._action_dim, config.hidden)
        self.actor = to_device(actor_init(gen), self.device)
        self.critic = to_device(critic_init(gen), self.device)
        self.target_critic = clone(self.critic)
        self.log_alpha = torch.full((), math.log(config.initial_alpha),
                                    device=self.device)
        self._target_entropy = -float(self._action_dim)

        self._actor_opt = adam(config.actor_lr)
        self._critic_opt = adam(config.critic_lr)
        self._alpha_opt = adam(config.alpha_lr)
        self.actor_opt_state = self._actor_opt.init(self.actor)
        self.critic_opt_state = self._critic_opt.init(self.critic)
        self.alpha_opt_state = self._alpha_opt.init(self.log_alpha)
        self._update = self._make_update()
        self._gen = torch.Generator().manual_seed(config.seed + 1)

    def set_dataset(self, dataset) -> None:
        from ray_tpu_torch.rl.offline import dataset_to_buffer

        self.buffer = dataset_to_buffer(dataset, seed=self.config.seed)

    # ------------------------------------------------------------- learner

    def _make_update(self):
        return make_cql_update(self._actor_fwd, self._critic_fwd,
                               self._actor_opt, self._critic_opt,
                               self._alpha_opt, self.config,
                               self._target_entropy)

    # --------------------------------------------------------------- train

    def train(self, dataset=None) -> Dict[str, Any]:
        if dataset is not None:
            self.set_dataset(dataset)
        if self.buffer is None:
            raise ValueError("CQL needs a transitions dataset "
                             "(CQLConfig.build(dataset))")
        cfg = self.config
        t0 = time.monotonic()
        aux = {}
        for _ in range(cfg.updates_per_iteration):
            batch, _idx, _w = self.buffer.sample(cfg.batch_size)
            draws = cql_draws(self._gen, cfg.batch_size, self._action_dim,
                              cfg.cql_n_actions, self.device)
            bc = self._updates_done < cfg.bc_iters
            (self.actor, self.critic, self.target_critic, self.log_alpha,
             (self.actor_opt_state, self.critic_opt_state,
              self.alpha_opt_state), aux) = self._update(
                self.actor, self.critic, self.target_critic,
                self.log_alpha,
                (self.actor_opt_state, self.critic_opt_state,
                 self.alpha_opt_state), batch_to(batch, self.device),
                draws, bc)
            self._updates_done += 1
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "updates": cfg.updates_per_iteration,
            "learn_time_s": round(time.monotonic() - t0, 3),
            "buffer_size": len(self.buffer),
            **{k: float(v) for k, v in aux.items()},
        }

    def evaluate(self, num_episodes: int = 8,
                 seed: Optional[int] = None) -> Dict[str, Any]:
        """Mean-action rollouts in the real env (no exploration noise)."""
        import gymnasium as gym

        env = gym.make(self.config.env, **self.config.env_config)
        base_seed = self.config.seed if seed is None else seed
        returns = []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=base_seed + ep)
            done, total = False, 0.0
            while not done:
                with torch.no_grad():
                    mean, _ = self._actor_fwd(
                        self.actor, torch.as_tensor(
                            np.asarray(obs, np.float32))[None].to(
                                self.device))
                    squashed = torch.tanh(mean).cpu().numpy()  # (1, d)
                # Module-to-env mapping goes through the connector chain
                # (default: unsquash to the env's bounds), same as runners.
                action = np.asarray(apply_connectors(
                    self._action_connectors, squashed))[0].reshape(
                    self._action_shape)
                obs, reward, term, trunc, _ = env.step(action)
                total += float(reward)
                done = term or trunc
            returns.append(total)
        env.close()
        return {"episode_return_mean": float(np.mean(returns)),
                "episodes": num_episodes}
