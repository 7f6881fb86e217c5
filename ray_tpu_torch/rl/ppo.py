"""PPO (port of ``ray_tpu/rl/ppo.py``).

N EnvRunner actors sample in parallel -> GAE advantages -> minibatched
clipped-surrogate updates on the learner -> weights broadcast back through
the object store. The learner's params and Adam state live on the
config's ``device`` (the card unless the caller asks for the CPU); each
iteration's batch goes to the device once and minibatches are gathered
there.
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


@dataclass
class PPOConfig(ConfigBuilderMixin):
    env: str = "CartPole-v1"
    env_config: Dict[str, Any] = field(default_factory=dict)
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_length: int = 128
    frame_stack: int = 1
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coeff: float = 0.01
    vf_coeff: float = 0.5
    num_sgd_epochs: int = 4
    minibatch_size: int = 256
    hidden: tuple = (64, 64)
    seed: int = 0
    device: str = "cuda"

    def build(self) -> "PPO":
        return PPO(self)

    def env_runners(self, num_env_runners: int,
                    num_envs_per_runner: int = 4) -> "PPOConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_runner
        return self

    def training(self, **kwargs) -> "PPOConfig":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self


def compute_gae(rollout: Dict[str, np.ndarray], gamma: float,
                lam: float) -> Dict[str, np.ndarray]:
    """Generalized advantage estimation over a (T, N) rollout.

    ``valids`` (optional) marks synthetic autoreset transitions (gymnasium
    >= 1.0 NEXT_STEP mode): they contribute nothing and break the GAE chain
    so values never leak across episode boundaries."""
    rewards, values, dones = (rollout["rewards"], rollout["values"],
                              rollout["dones"])
    valids = rollout.get("valids")
    T, N = rewards.shape
    adv = np.zeros((T, N), np.float32)
    last_adv = np.zeros(N, np.float32)
    next_value = rollout["last_value"]
    for t in reversed(range(T)):
        if valids is not None:
            invalid = valids[t] < 0.5
        else:
            invalid = np.zeros(N, bool)
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_adv = delta + gamma * lam * nonterminal * last_adv
        # Synthetic step: no advantage, and the chain restarts above it.
        last_adv = np.where(invalid, 0.0, last_adv)
        adv[t] = last_adv
        next_value = np.where(invalid, next_value, values[t])
    returns = adv + values
    return {"advantages": adv, "returns": returns}


def make_ppo_update(forward, optimizer, clip_eps: float, vf_coeff: float,
                    entropy_coeff: float):
    """The clipped-surrogate PPO update (shared by single- and multi-agent
    trainers): ``update(params, opt_state, batch) -> (params, opt_state,
    aux)``, the params updated in place."""

    def loss_fn(params, batch):
        logits, values = forward(params, batch["obs"])
        logp_all = torch.log_softmax(logits, -1)
        logp = take_logp(logp_all, batch["actions"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["advantages"]
        # jnp.std: the population deviation.
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        surr = torch.minimum(
            ratio * adv, ratio.clamp(1 - clip_eps, 1 + clip_eps) * adv)
        pi_loss = -surr.mean()
        vf_loss = torch.mean((values - batch["returns"]) ** 2)
        entropy = -torch.mean(
            torch.sum(torch.softmax(logits, -1) * logp_all, dim=-1))
        total = pi_loss + vf_coeff * vf_loss - entropy_coeff * entropy
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    def update(params, opt_state, batch):
        (loss, aux), grads = value_and_grad(loss_fn, params, batch,
                                            has_aux=True)
        opt_state = optimizer.update(grads, opt_state, params)
        aux["total_loss"] = loss
        return params, opt_state, aux

    return update


class PPO(Checkpointable):
    _CKPT_ATTRS = ("params", "opt_state", "_iteration", "_total_env_steps")

    def __init__(self, config: PPOConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self._iteration = 0
        self._total_env_steps = 0

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
        self._broadcast_weights()

    # ------------------------------------------------------------- losses

    def _make_update(self):
        cfg = self.config
        return make_ppo_update(self._forward, self.optimizer, cfg.clip_eps,
                               cfg.vf_coeff, cfg.entropy_coeff)

    # ------------------------------------------------------------- train

    def _broadcast_weights(self) -> None:
        ref = ray_tpu_torch.put(host(self.params))  # one copy in the store
        ray_tpu_torch.get([r.set_weights.remote(ref, self._iteration)
                           for r in self.runners])

    def train(self) -> Dict[str, Any]:
        """One training iteration (sample, GAE, minibatched updates)."""
        cfg = self.config
        t0 = time.monotonic()
        rollout_refs = [r.sample.remote() for r in self.runners]
        rollouts = ray_tpu_torch.get(rollout_refs)
        sample_time = time.monotonic() - t0

        # Flatten (T, N) across runners into one batch.
        batches = []
        for ro in rollouts:
            gae = compute_gae(ro, cfg.gamma, cfg.gae_lambda)
            T, N = ro["rewards"].shape
            flat = {
                "obs": ro["obs"].reshape((T * N,) + ro["obs"].shape[2:]),
                "actions": ro["actions"].reshape(-1),
                "logp": ro["logp"].reshape(-1),
                "advantages": gae["advantages"].reshape(-1),
                "returns": gae["returns"].reshape(-1),
                "valids": ro["valids"].reshape(-1),
            }
            batches.append(flat)
        batch = {k: np.concatenate([b[k] for b in batches]) for k in
                 batches[0]}
        # Synthetic autoreset rows are not experience.
        keep = batch.pop("valids") > 0.5
        batch = {k: v[keep] for k, v in batch.items()}
        # Learner-side connector pipeline: whole-batch transforms.
        from ray_tpu_torch.rl.connectors import apply_learner_connectors

        batch = apply_learner_connectors(
            getattr(cfg, "learner_connectors", None), batch)
        n = len(batch["actions"])
        self._total_env_steps += n

        t1 = time.monotonic()
        on_device = batch_to(batch, self.device)
        rng = np.random.default_rng(cfg.seed + self._iteration)
        aux = {}
        mb = min(cfg.minibatch_size, n)
        for _ in range(cfg.num_sgd_epochs):
            perm = torch.from_numpy(rng.permutation(n)).to(self.device)
            for start in range(0, n - mb + 1, mb):
                idx = perm[start:start + mb]
                minibatch = {k: v[idx] for k, v in on_device.items()}
                self.params, self.opt_state, aux = self._update(
                    self.params, self.opt_state, minibatch)
        aux = {k: float(v) for k, v in aux.items()}
        learn_time = time.monotonic() - t1

        self._broadcast_weights()
        stats = [s for s in ray_tpu_torch.get(
            [r.episode_stats.remote() for r in self.runners])]
        episode_returns = [s["episode_return_mean"] for s in stats
                           if s.get("episodes")]
        self._iteration += 1
        metrics = {
            "training_iteration": self._iteration,
            "env_steps_total": self._total_env_steps,
            "env_steps_this_iter": n,
            "env_steps_per_sec": n / max(1e-9, sample_time + learn_time),
            "sample_time_s": round(sample_time, 3),
            "learn_time_s": round(learn_time, 3),
            **aux,
        }
        if episode_returns:
            metrics["episode_return_mean"] = float(np.mean(episode_returns))
        return metrics

    def stop(self) -> None:
        stop_runners(self.runners)
