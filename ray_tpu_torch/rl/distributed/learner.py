"""Learner host: bounded shard intake + updates on the learner's device +
weight fan-out (port of ``ray_tpu/rl/distributed/learner.py``).

The Podracer learner half. One driver-process "learner host" drives:

* a :class:`RolloutPlane` — the rollout-actor fleet with one in-flight
  ``collect()`` per actor and an intake thread that moves shard
  DESCRIPTORS (never trajectory bytes) into a bounded
  :class:`~ray_tpu_torch.rl.distributed.shard.ShardQueue`; a full queue
  stops the refill, so learner lag backpressures the fleet instead of
  accumulating memory. In ``inference`` mode the plane also runs the
  batched :class:`~ray_tpu_torch.rl.distributed.inference.PolicyInference`
  service on the learner's device (with the node's ``GPU`` lease when
  that is a card);
* a :class:`LearnerState` — the learner's device and the versioned weight
  fan-out. The JAX package splits each batch over a ``data`` mesh when it
  sees more than one device; the port's learner drives one card, so
  ``shard_batch`` moves each leaf to it (a split across cards waits for a
  box with more cards);
* the versioned weight fan-out (``fanout.py``) plus the plane's
  metrics — all through ``util/metrics`` (no ad-hoc client-side lists),
  surfaced as the ``rl`` training-stats dict.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.core.device import resolve_device
from ray_tpu_torch.rl.distributed.fanout import WeightFanout
from ray_tpu_torch.rl.distributed.inference import PolicyInference
from ray_tpu_torch.rl.distributed.rollout import RolloutActor
from ray_tpu_torch.rl.distributed.shard import (ShardQueue,
                                                ShardQueueClosed,
                                                TrajectoryShard)
from ray_tpu_torch.rl.tree import batch_to, host
from ray_tpu_torch.util import metrics as um
from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

logger = logging.getLogger(__name__)

RL_ENV_STEPS = Counter(
    "rl_env_steps_total", "valid env steps consumed by the learner",
    ("plane",))
RL_SHARDS = Counter(
    "rl_shards_total", "trajectory shards consumed by the learner",
    ("plane",))
RL_SHARDS_DROPPED = Counter(
    "rl_shards_dropped_total",
    "shards discarded (over max staleness, or undrained at shutdown)",
    ("plane", "reason"))
RL_QUEUE_DEPTH = Gauge(
    "rl_shard_queue_depth", "descriptors parked in the learner queue",
    ("plane",))
RL_STALENESS = Histogram(
    "rl_weights_staleness",
    "learner updates the policy was behind when its shard was consumed",
    boundaries=(0, 1, 2, 4, 8, 16, 32, 64),
    tag_keys=("plane",))
RL_UPDATE_S = Histogram(
    "rl_learner_update_s", "wall time of one learner update's issue",
    tag_keys=("plane",))
RL_DESC_BYTES = Histogram(
    "rl_shard_desc_bytes",
    "serialized shard-descriptor size seen by the intake loop",
    boundaries=(256, 512, 1024, 2048, 4096, 8192, 16384),
    tag_keys=("plane",))

_plane_counter = itertools.count()


def new_plane_key(prefix: str) -> str:
    """Unique fan-out key per algorithm instance (pid-scoped so two
    drivers on one box never cross-subscribe)."""
    return f"{prefix}-{os.getpid()}-{next(_plane_counter)}"


def plane_stats(plane_key: str, queue: Optional[ShardQueue] = None
                ) -> Dict[str, Any]:
    """The ``rl`` training-stats dict: read back from the metrics
    registry (one source of truth with the Prometheus/status surfaces),
    filtered to this plane's tag."""
    snap = {"local": um._Registry.get().snapshot()}
    tag_key = (("plane", plane_key),)
    out: Dict[str, Any] = {}
    for field, name in (("staleness", "rl_weights_staleness"),
                        ("learner_update_s", "rl_learner_update_s"),
                        ("shard_desc_bytes", "rl_shard_desc_bytes"),
                        ("inference_batch", "rl_inference_batch_size")):
        entry = um.merge_histograms(snap, name).get(tag_key)
        if entry:
            out[field] = um.histogram_summary(entry)
    for field, name in (("env_steps", "rl_env_steps_total"),
                        ("shards", "rl_shards_total")):
        totals = um.counter_totals(snap, name)
        if tag_key in totals:
            out[field] = totals[tag_key]
    if queue is not None:
        out["queue_depth"] = queue.qsize()
    return out


def _await_free_gpu(plane_key: str, device, grace_s: float = 10.0) -> None:
    """Refuse the build unless a ``GPU`` lease is free within
    ``grace_s`` (a lease given back by a stopped plane returns within a
    heartbeat or two): the service never falls back to the CPU."""
    deadline = time.monotonic() + grace_s
    while ray_tpu_torch.available_resources().get("GPU", 0) < 1:
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"rollout plane {plane_key}: the policy inference service "
                f"runs on {device} and needs a free GPU lease; none came "
                f"free within {grace_s:.0f}s")
        time.sleep(0.2)


class RolloutPlane:
    """The rollout-actor fleet + intake thread + bounded shard queue.

    ``device`` is the learner's: in ``inference`` mode the policy service
    runs there, holding the node's ``GPU`` lease when it is a card (a
    node with no free ``GPU`` refuses the build). Rollout actors are CPU
    workers."""

    def __init__(self, plane_key: str, env: str, num_actors: int,
                 num_envs: int, rollout_length: int, seed: int,
                 env_config: Optional[Dict] = None,
                 frame_stack: int = 1,
                 policy_mode: str = "categorical",
                 obs_connectors: Optional[list] = None,
                 action_connectors: Optional[list] = None,
                 queue_capacity: int = 8,
                 mode: str = "local",
                 obs_shape: Optional[Tuple[int, ...]] = None,
                 num_actions: int = 0,
                 hidden: Tuple[int, ...] = (64, 64),
                 device: Any = "cuda"):
        if num_actors < 1:
            raise ValueError("need at least one rollout actor")
        self.plane_key = plane_key
        self.queue = ShardQueue(queue_capacity)
        self.mode = mode
        self.inference = None
        if mode == "inference":
            num_gpus = 1 if torch.device(device).type == "cuda" else 0
            if num_gpus:
                _await_free_gpu(plane_key, device)
            infer_cls = ray_tpu_torch.remote(PolicyInference)
            # max_concurrency: every rollout actor may have a request
            # in flight; +1 headroom for the stats() probe.
            self.inference = infer_cls.options(
                num_cpus=0, num_gpus=num_gpus,
                max_concurrency=num_actors + 1).remote(
                tuple(obs_shape), int(num_actions), plane_key,
                policy_mode, tuple(hidden), str(device))
        actor_cls = ray_tpu_torch.remote(RolloutActor)
        self.actors = [
            actor_cls.options(num_cpus=1).remote(
                env, i, plane_key, num_envs=num_envs,
                rollout_length=rollout_length, seed=seed + i,
                env_config=env_config or {}, frame_stack=frame_stack,
                policy_mode=policy_mode, obs_connectors=obs_connectors,
                action_connectors=action_connectors,
                inference=self.inference)
            for i in range(num_actors)
        ]
        self._inflight: Dict[Any, int] = {}
        self._last_version = [-1] * num_actors
        self._monotonic_violations = 0
        self._stop = threading.Event()
        self._intake: Optional[threading.Thread] = None

    def start(self) -> None:
        """Submit one collect per actor and start the intake thread.
        Call AFTER the learner published its first weights version —
        local-mode actors park in ``wait_initial`` otherwise."""
        for i, actor in enumerate(self.actors):
            self._inflight[actor.collect.remote()] = i
        self._intake = threading.Thread(
            target=self._intake_loop, name=f"rl-intake-{self.plane_key}",
            daemon=True)
        self._intake.start()

    def _intake_loop(self) -> None:
        from ray_tpu_torch.core.serialization import serialized_size

        while not self._stop.is_set():
            if not self._inflight:
                # Every actor's refill was skipped mid-stop; nothing
                # left to wait on.
                self._stop.wait(0.2)
                continue
            ready, _ = ray_tpu_torch.wait(list(self._inflight),
                                          num_returns=1, timeout=0.5)
            if not ready:
                continue
            for ref in ready:
                idx = self._inflight.pop(ref)
                try:
                    desc = ray_tpu_torch.get(ref)
                except Exception:
                    if self._stop.is_set():
                        return
                    logger.warning("rollout actor %d collect failed",
                                   idx, exc_info=True)
                    continue
                desc_bytes = serialized_size(desc)
                version = int(desc["weights_version"])
                if version < self._last_version[idx]:
                    # Never expected: the fan-out receiver is monotonic.
                    self._monotonic_violations += 1
                self._last_version[idx] = version
                shard = TrajectoryShard(
                    ref=desc["ref"], weights_version=version,
                    env_steps=int(desc["env_steps"]),
                    actor_index=idx, seq=int(desc["seq"]),
                    desc_bytes=desc_bytes,
                    episodes=dict(desc.get("episodes") or {}))
                RL_DESC_BYTES.observe(desc_bytes,
                                      {"plane": self.plane_key})
                # Bounded put IS the backpressure edge: while the
                # learner lags, this thread parks here and actor idx
                # stays idle (no refill below).
                try:
                    while not self.queue.put(shard, timeout=0.5):
                        if self._stop.is_set():
                            return
                except ShardQueueClosed:
                    return
                RL_QUEUE_DEPTH.set(self.queue.qsize(),
                                   {"plane": self.plane_key})
                if not self._stop.is_set():
                    self._inflight[
                        self.actors[idx].collect.remote()] = idx

    @property
    def monotonic_violations(self) -> int:
        return self._monotonic_violations

    def episode_stats_from(self, shards: List[TrajectoryShard]
                           ) -> Optional[float]:
        """Weighted mean episode return across the consumed shards'
        piggybacked episode stats (no extra per-runner RPC)."""
        returns, weights = [], []
        for s in shards:
            ep = s.episodes
            if ep.get("episodes"):
                returns.append(ep["episode_return_mean"])
                weights.append(ep["episodes"])
        if not returns:
            return None
        return float(np.average(returns, weights=weights))

    def stop(self) -> Dict[str, int]:
        """Tear down: stop intake, drain the queue (dropping refs),
        kill the fleet and the inference service (which gives its
        ``GPU`` lease back). Returns the leak-accounting report the
        shutdown test pins (every queued slot and in-flight collect
        accounted)."""
        self._stop.set()
        leftover = self.queue.close()
        if self._intake is not None:
            self._intake.join(timeout=10.0)
        abandoned = len(self._inflight)
        self._inflight.clear()
        if leftover:
            RL_SHARDS_DROPPED.inc(len(leftover), {
                "plane": self.plane_key, "reason": "shutdown"})
        for actor in self.actors:
            try:
                ray_tpu_torch.kill(actor)
            except Exception:  # graftlint: disable=swallowed-exception (best-effort teardown; cluster reaps survivors)
                pass
        if self.inference is not None:
            try:
                ray_tpu_torch.kill(self.inference)
            except Exception:  # graftlint: disable=swallowed-exception (best-effort teardown; cluster reaps survivors)
                pass
        RL_QUEUE_DEPTH.set(0, {"plane": self.plane_key})
        return {"undrained_shards": len(leftover),
                "abandoned_collects": abandoned,
                "queue_depth": self.queue.qsize(),
                "intake_alive": bool(self._intake
                                     and self._intake.is_alive())}


class LearnerState:
    """The learner's device and its versioned weight fan-out."""

    def __init__(self, plane_key: str, device: Any = "cuda"):
        self.plane_key = plane_key
        self.device = resolve_device(device)
        self.fanout = WeightFanout(plane_key)

    @property
    def version(self) -> int:
        return self.fanout.version

    def shard_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Each leaf on the learner's device (float64 as float32, as the
        JAX package lands it with x64 off)."""
        return batch_to(batch, self.device)

    def record_staleness(self, shard: TrajectoryShard) -> int:
        lag = max(0, self.version - shard.weights_version)
        RL_STALENESS.observe(lag, {"plane": self.plane_key})
        RL_SHARDS.inc(1, {"plane": self.plane_key})
        RL_ENV_STEPS.inc(shard.env_steps, {"plane": self.plane_key})
        return lag

    def timed_update(self, fn: Callable[[], Any]) -> Any:
        """Run one update and observe its host wall time. On a card that
        is the host's issue of the update's kernels (no sync is added):
        time the device's work with CUDA events around the call."""
        t0 = time.monotonic()
        out = fn()
        RL_UPDATE_S.observe(time.monotonic() - t0,
                            {"plane": self.plane_key})
        return out

    def publish(self, params: Any,
                extras: Optional[Dict[str, Any]] = None,
                version: Optional[int] = None) -> int:
        """Publish a host copy of ``params`` (``rl.tree.host``)."""
        return self.fanout.publish(host(params), extras, version)

    def close(self) -> None:
        self.fanout.close()
