"""Batched policy inference: the sebulba actor/inference split (port of
``ray_tpu/rl/distributed/inference.py``).

In Podracer's sebulba configuration the environments and the policy
forward live in DIFFERENT processes: env-stepping actors send
observation batches to an inference service that coalesces requests
from the whole fleet into one forward pass on the accelerator. Here
the service is one actor (created with ``max_concurrency > 1`` so
requests from many rollout actors are in flight together) using the
serve plane's batching idiom (``serve/batching.py`` ``@batch`` — the
same accumulate-until-size-or-deadline queue the decode replicas use
for admission), with row-count padding to a few static shapes, so a
forward's draws do not depend on how many rows it coalesced.

The forward runs on the service's ``device``: the learner's card, whose
``GPU`` lease the rollout plane gives the service. Draws come from a
``torch.Generator`` on that device, seeded per forward from the forward
count and every request's seed (the JAX service folds the same numbers
into its key).

Weights arrive over the SAME versioned pubsub fan-out the rollout
actors use in local mode; replies carry the ``weights_version`` of the
params that computed them, so shard staleness accounting works
identically in both modes.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.core.device import resolve_device
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.util.metrics import Counter, Histogram

RL_INFER_REQS = Counter(
    "rl_inference_requests",
    "policy inference requests received (one per rollout-actor step)",
    ("plane",))
RL_INFER_BATCH = Histogram(
    "rl_inference_batch_size",
    "requests coalesced per policy forward",
    boundaries=(1, 2, 4, 8, 16, 32),
    tag_keys=("plane",))

# Coalesced row counts pad up to one of these, so the forward sees a
# handful of static shapes (serve's pad_to_buckets idiom).
_ROW_BUCKETS = (8, 16, 32, 64, 128, 256)


def _forward_seed(forward_calls: int, seeds: Sequence[int]) -> int:
    """The generator seed of one forward: the forward count with each
    request's seed folded in, in request order (a 64-bit LCG step per
    fold)."""
    s = int(forward_calls)
    for seed in seeds:
        s = (s * 6364136223846793005 + int(seed)
             + 1442695040888963407) % (1 << 63)
    return s


class PolicyInference:
    """One shared policy-forward service per rollout fleet."""

    def __init__(self, obs_shape: Tuple[int, ...], num_actions: int,
                 plane_key: str, policy_mode: str = "categorical",
                 hidden: Tuple[int, ...] = (64, 64),
                 device: Any = "cuda"):
        from ray_tpu_torch.rl.distributed.fanout import WeightReceiver
        from ray_tpu_torch.rl.models import (build_policy,
                                             make_egreedy_sample_fn,
                                             make_sample_fn)

        self.device = resolve_device(device)
        self._plane_key = plane_key
        self._policy_mode = policy_mode
        _init, forward = build_policy(tuple(obs_shape), int(num_actions),
                                      tuple(hidden))
        if policy_mode == "epsilon_greedy":
            self._sample_fn = make_egreedy_sample_fn(forward)
        else:
            self._sample_fn = make_sample_fn(forward)
        # (version, params on the device, epsilon): swapped whole, so a
        # forward reads one consistent triple.
        self._serving: Tuple[int, Any, float] = (0, None, 1.0)
        self._receiver = WeightReceiver(plane_key)
        # Guards the serving stats and the swap ONLY (batches flush from
        # whichever caller or timer thread filled them — max_concurrency
        # > 1 on this actor). The weight pull deliberately runs outside
        # any lock: it is an RPC + object-plane pull, and concurrent
        # pulls converge on the same newest version.
        self._lock = threading.Lock()
        # Serializes only the FIRST pull: batches that flush together
        # before any params exist must not each wait on the hub, since a
        # receiver hands a version to one caller only (the others would
        # wait for the next publish).
        self._initial = threading.Lock()
        self._forward_calls = 0
        self._requests = 0
        self._max_batch = 0

    def _sync_weights(self) -> None:
        if self._serving[1] is None:
            with self._initial:
                if self._serving[1] is None:
                    # Waiting on the hub under _initial is the point: a
                    # receiver hands a version to one caller only.
                    # graftlint: disable=lock-held-blocking
                    self._apply(self._receiver.wait_initial())
            return
        got = self._receiver.poll(0.0)
        if got is not None:
            self._apply(got)

    def _apply(self, got) -> None:
        from ray_tpu_torch.rl.tree import own, to_device

        version, params, extras = got
        params = to_device(own(params), self.device)
        with self._lock:
            version_now, _params, epsilon = self._serving
            if version > version_now:
                self._serving = (int(version), params,
                                 float(extras.get("epsilon", epsilon)))

    @property
    def weights_version(self) -> int:
        return self._receiver.weights_version

    @batch(max_batch_size=8, batch_wait_timeout_s=0.02)
    def infer(self, requests: List[Tuple[np.ndarray, int]]):
        """Batched entry point: each request is (obs_batch, seed); the
        decorator hands this method the coalesced list. One forward
        serves them all; replies are split back per request as
        (action, logp, value, weights_version)."""
        self._sync_weights()
        version, params, epsilon = self._serving
        sizes = [len(r[0]) for r in requests]
        obs = np.concatenate([np.asarray(r[0]) for r in requests], axis=0)
        rows = len(obs)
        target = next((b for b in _ROW_BUCKETS if b >= rows), rows)
        if target > rows:
            obs = np.concatenate(
                [obs, np.repeat(obs[-1:], target - rows, axis=0)], axis=0)
        # The service owns the draw stream: folding each request's seed
        # in keeps actors decorrelated without shipping generators.
        gen = torch.Generator(device=self.device).manual_seed(
            _forward_seed(self._forward_calls, [s for _o, s in requests]))
        x = torch.from_numpy(np.ascontiguousarray(obs)).to(self.device)
        with torch.no_grad():
            if self._policy_mode == "epsilon_greedy":
                out = self._sample_fn(params, x, gen, epsilon)
            else:
                out = self._sample_fn(params, x, gen)
        action, logp, value = (t[:rows].cpu().numpy() for t in out)
        with self._lock:
            self._forward_calls += 1
            self._requests += len(requests)
            self._max_batch = max(self._max_batch, len(requests))
        RL_INFER_REQS.inc(len(requests), {"plane": self._plane_key})
        RL_INFER_BATCH.observe(len(requests), {"plane": self._plane_key})
        out = []
        start = 0
        for n in sizes:
            out.append((action[start:start + n], logp[start:start + n],
                        value[start:start + n], version))
            start += n
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "forward_calls": self._forward_calls,
                "requests": self._requests,
                "max_batch": self._max_batch,
                "weights_version": self._serving[0],
            }
