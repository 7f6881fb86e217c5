"""Offline RL: behavior cloning from logged experience (port of
``ray_tpu/rl/bc.py``).

Experience lives in a :class:`ray_tpu_torch.data.Dataset` (however
produced — ``collect_dataset`` records it from a trained policy's runners,
or read_parquet loads logged data); the learner does cross-entropy on
(obs, action) with the same policy network the online algorithms use, on
the config's ``device``, so a cloned policy can be handed straight back to
EnvRunners for evaluation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.core.device import resolve_device
from ray_tpu_torch.rl.checkpointing import Checkpointable
from ray_tpu_torch.rl.common import ConfigBuilderMixin, probe_env_spec
from ray_tpu_torch.rl.models import build_policy, take_logp
from ray_tpu_torch.rl.tree import adam, batch_to, to_device, value_and_grad


def collect_dataset(algo, num_rollouts: int = 4):
    """Record rollouts from a (trained) algorithm's runners into a Dataset
    of (obs, action) rows — the shape offline pipelines consume."""
    import ray_tpu_torch
    from ray_tpu_torch import data as rdata

    obs_all, act_all = [], []
    for _ in range(num_rollouts):
        for ro in ray_tpu_torch.get(
                [r.sample.remote() for r in algo.runners]):
            keep = ro["valids"].reshape(-1) > 0.5
            obs = ro["obs"].reshape((-1,) + ro["obs"].shape[2:])[keep]
            act = ro["actions"].reshape(-1)[keep]
            obs_all.append(obs)
            act_all.append(act)
    return rdata.from_numpy({
        "obs": np.concatenate(obs_all),
        "actions": np.concatenate(act_all).astype(np.int64),
    })


@dataclass
class BCConfig(ConfigBuilderMixin):
    env: str = "CartPole-v1"            # for obs/action spec + evaluation
    env_config: Dict[str, Any] = field(default_factory=dict)
    frame_stack: int = 1
    lr: float = 1e-3
    epochs: int = 4
    batch_size: int = 256
    hidden: tuple = (64, 64)
    seed: int = 0
    device: str = "cuda"

    def build(self, dataset=None) -> "BC":
        return BC(self, dataset)

    def training(self, **kwargs) -> "BCConfig":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self


def make_bc_update(forward, optimizer):
    """``update(params, opt_state, batch) -> (params, opt_state, loss,
    acc)``: one cross-entropy step on (obs, actions), the params updated
    in place."""

    def loss_fn(params, batch):
        logits, _ = forward(params, batch["obs"])
        logp = torch.log_softmax(logits, -1)
        nll = -take_logp(logp, batch["actions"])
        acc = torch.mean((torch.argmax(logits, -1)
                          == batch["actions"]).to(torch.float32))
        return torch.mean(nll), acc

    def update(params, opt_state, batch):
        (loss, acc), grads = value_and_grad(loss_fn, params, batch,
                                            has_aux=True)
        opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss, acc

    return update


class BC(Checkpointable):
    """Behavior cloning learner over a Dataset of {"obs", "actions"}."""

    _CKPT_ATTRS = ("params", "opt_state", "_iteration")

    def __init__(self, config: BCConfig, dataset=None):
        self.config = config
        self.device = resolve_device(config.device)
        self.dataset = dataset
        self._iteration = 0

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

    def _make_update(self):
        return make_bc_update(self._forward, self.optimizer)

    def train(self, dataset=None) -> Dict[str, Any]:
        """One pass of ``epochs`` over the dataset via streamed batches."""
        ds = dataset or self.dataset
        if ds is None:
            raise ValueError("BC needs a dataset (BCConfig.build(dataset))")
        losses, accs, rows = [], [], 0
        for _ in range(self.config.epochs):
            for batch in ds.iter_batches(batch_size=self.config.batch_size):
                if len(batch["actions"]) < 2:
                    continue
                self.params, self.opt_state, loss, acc = self._update(
                    self.params, self.opt_state,
                    batch_to(batch, self.device))
                losses.append(float(loss))
                accs.append(float(acc))
                rows += len(batch["actions"])
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "rows_trained": rows,
            "loss": float(np.mean(losses)) if losses else None,
            "action_accuracy": float(np.mean(accs)) if accs else None,
        }

    def evaluate(self, num_episodes: int = 8,
                 seed: Optional[int] = None) -> Dict[str, Any]:
        """Greedy-policy evaluation in a real environment."""
        import gymnasium as gym

        if self.config.env.startswith("ray_tpu/"):
            from ray_tpu_torch.rl import testing  # noqa: F401

        env = gym.make(self.config.env, **self.config.env_config)
        base_seed = self.config.seed if seed is None else seed
        fs = self.config.frame_stack

        def stacked(obs, stack):
            if fs <= 1:
                return obs, None
            if stack is None:  # episode start: [frame]*k history
                stack = np.tile(obs, (1, 1, fs))
            else:
                c = obs.shape[-1]
                stack = np.roll(stack, -c, axis=-1)
                stack[..., -c:] = obs
            return stack, stack

        returns = []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=base_seed + ep)
            view, stack = stacked(obs, None)
            done, total = False, 0.0
            while not done:
                with torch.no_grad():
                    logits, _v = self._forward(self.params, torch.as_tensor(
                        np.array(view))[None].to(self.device))
                action = int(torch.argmax(logits[0]))
                obs, reward, term, trunc, _ = env.step(action)
                view, stack = stacked(obs, stack)
                total += float(reward)
                done = term or trunc
            returns.append(total)
        env.close()
        return {"episode_return_mean": float(np.mean(returns)),
                "episodes": num_episodes}
