"""RolloutActor: the Podracer actor half of the actor/learner split (port
of ``ray_tpu/rl/distributed/rollout.py``).

An :class:`~ray_tpu_torch.rl.env_runner.EnvRunner` (a CPU worker) that
(1) pulls weights from the versioned pubsub fan-out instead of accepting
per-runner pushes, (2) ships every rollout through the OBJECT PLANE
(``ray_tpu_torch.put`` in this process; the learner RPC carries only a
small descriptor — see ``shard.py``), and (3) in ``inference`` mode runs
the sebulba split: no local weights at all, every policy forward goes to
a batched :class:`~ray_tpu_torch.rl.distributed.inference.PolicyInference`
actor shared by the fleet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rl.env_runner import EnvRunner


class RolloutActor(EnvRunner):
    def __init__(self, env_name: str, actor_index: int, plane_key: str,
                 num_envs: int = 4, rollout_length: int = 32,
                 seed: int = 0, env_config: Optional[Dict] = None,
                 frame_stack: int = 1,
                 policy_mode: str = "categorical",
                 obs_connectors: Optional[list] = None,
                 action_connectors: Optional[list] = None,
                 inference: Any = None):
        super().__init__(env_name, num_envs=num_envs,
                         rollout_length=rollout_length, seed=seed,
                         env_config=env_config, frame_stack=frame_stack,
                         policy_mode=policy_mode,
                         obs_connectors=obs_connectors,
                         action_connectors=action_connectors)
        self._index = int(actor_index)
        self._seq = 0
        self._inference = inference
        if inference is None:
            # Local-weights mode: subscribe to the learner's fan-out.
            self.enable_weight_sync(plane_key)

    # ------------------------------------------------- inference mode

    def _policy_step(self, obs, generator):
        if self._inference is None:
            return super()._policy_step(obs, generator)
        import torch

        # The whole (N, ...) vector-env batch is one inference request;
        # the service coalesces requests from the fleet into one
        # forward. Randomness is delegated: the service owns the draw
        # stream (a per-request fold of this seed keeps actors
        # decorrelated without shipping generators over RPC).
        seed = int(torch.randint(0, 2 ** 31 - 1, (),
                                 generator=generator))
        action, logp, value, version = ray_tpu_torch.get(
            self._inference.infer.remote((np.asarray(obs), seed)))
        # The service's version clock is monotonic, so recording the
        # last reply's version keeps this actor's shard versions
        # monotonic too.
        self._weights_version = int(version)
        return np.asarray(action), np.asarray(logp), np.asarray(value)

    # ------------------------------------------------------ collection

    def collect(self) -> Dict[str, Any]:
        """One fixed-shape rollout -> object plane; returns ONLY the
        shard descriptor (ref + metadata). The arrays never transit
        this RPC's reply payload — pinned by the descriptor-size test
        and the ``DESCRIPTOR_BYTE_BUDGET`` contract."""
        ro = self.sample()
        env_steps = int(ro["valids"].sum())
        ref = ray_tpu_torch.put(ro)
        self._seq += 1
        return {
            "ref": ref,
            "weights_version": int(ro["weights_version"]),
            "env_steps": env_steps,
            "actor_index": self._index,
            "seq": self._seq,
            "episodes": self.episode_stats(),
        }
