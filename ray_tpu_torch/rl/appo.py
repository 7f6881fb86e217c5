"""APPO: asynchronous PPO (IMPALA pipeline + clipped surrogate); port of
``ray_tpu/rl/appo.py``.

PPO losses computed asynchronously over IMPALA's actor-learner pipeline
with V-trace off-policy correction and a periodically-synced TARGET network
stabilizing the value baseline:

* policy: PPO clipped surrogate on V-trace advantages.
* value: regression to V-trace targets computed with the TARGET network's
  values; the target hard-syncs every ``target_update_interval`` learner
  updates.

The target params and the updates-since-sync counter ride inside the
optimizer-state bundle, so checkpoints carry both.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ray_tpu_torch.rl.impala import IMPALA, IMPALAConfig, vtrace
from ray_tpu_torch.rl.models import take_logp
from ray_tpu_torch.rl.tree import clone, value_and_grad


@dataclass
class APPOConfig(IMPALAConfig):
    clip_eps: float = 0.2
    target_update_interval: int = 16   # learner updates between syncs

    def build(self) -> "APPO":
        return APPO(self)


def make_appo_update(forward, optimizer, cfg):
    """``update(params, bundle, batch) -> (params, bundle, aux)`` with
    ``bundle = (opt_state, target_params, updates_since_sync)``; the
    params are updated in place, the target is replaced by a copy of them
    at a sync."""

    def loss_fn(params, target_params, batch):
        T, N = batch["rewards"].shape
        obs = batch["obs"].reshape((T * N,) + batch["obs"].shape[2:])
        logits, values_flat = forward(params, obs)
        logits = logits.reshape(T, N, -1)
        values = values_flat.reshape(T, N)
        with torch.no_grad():
            _t_logits, t_values_flat = forward(target_params, obs)
        t_values = t_values_flat.reshape(T, N)
        logp_all = torch.log_softmax(logits, -1)
        target_logp = take_logp(logp_all, batch["actions"])
        # V-trace baseline/advantages from the TARGET network.
        vs, pg_adv = vtrace(
            batch["logp"], target_logp, batch["rewards"],
            t_values, batch["dones"], batch["last_value"],
            batch["valids"], cfg.gamma, cfg.rho_clip, cfg.c_clip)
        valid = batch["valids"]
        valid_count = torch.clamp(valid.sum(), min=1.0)
        # PPO clipped surrogate with the off-policy ratio.
        ratio = torch.exp(target_logp - batch["logp"])
        clipped = ratio.clamp(1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps)
        pi_loss = -torch.sum(
            valid * torch.minimum(ratio * pg_adv, clipped * pg_adv)
        ) / valid_count
        vf_loss = torch.sum(valid * (values - vs) ** 2) / valid_count
        entropy = -torch.sum(
            valid[..., None] * torch.softmax(logits, -1) * logp_all
        ) / valid_count
        total = (pi_loss + cfg.vf_coeff * vf_loss
                 - cfg.entropy_coeff * entropy)
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy,
                       "clip_frac": torch.sum(
                           valid * (torch.abs(ratio - 1.0)
                                    > cfg.clip_eps)) / valid_count}

    def update(params, bundle, batch):
        opt_state, target_params, since_sync = bundle
        (loss, aux), grads = value_and_grad(
            loss_fn, params, target_params, batch, has_aux=True)
        opt_state = optimizer.update(grads, opt_state, params)
        since_sync = since_sync + 1
        if since_sync >= cfg.target_update_interval:
            target_params = clone(params)
            since_sync = 0
        aux["total_loss"] = loss
        return params, (opt_state, target_params, since_sync), aux

    return update


class APPO(IMPALA):
    def __init__(self, config: APPOConfig):
        super().__init__(config)
        # Bundle = (Adam state, target params, updates-since-sync).
        self.opt_state = (self.opt_state, clone(self.params), 0)

    def _make_update(self):
        return make_appo_update(self._forward, self.optimizer, self.config)
