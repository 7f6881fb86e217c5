"""Versioned parameter fan-out over the cluster pubsub.

The Podracer weight-distribution edge: the learner publishes ONE
object-plane ref per weights version to the core pubsub hub
(``core/pubsub.py`` — latest-value-per-key, monotonic versions), and
every rollout/inference actor long-polls the hub and pulls the ref on
notify. Publishing is O(1) in actor count (the old path RPC'd every
runner per sync); the params bytes move at most once per actor per
version, through the object plane, and an actor that falls behind sees
only the NEWEST version — exactly the sebulba contract, where actors
sample with whatever weights they last pulled and the learner's
off-policy correction (V-trace) absorbs the measured lag.

Version discipline: the value embeds the learner's own
``weights_version`` (update count), which subscribers enforce as
strictly monotonic; the hub's per-key version clock paces the long-poll
wakeups. Both only move forward.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.core.rpc_stubs import ControllerStub

logger = logging.getLogger(__name__)

WEIGHTS_CHANNEL = "rl_weights"


def _controller_client():
    from ray_tpu_torch.core.runtime import get_core_worker

    return get_core_worker().controller


class WeightFanout:
    """Learner-side publisher. Owns the object-plane ref of the LATEST
    version (pinned so subscribers can always resolve it); older
    versions unpin on publish and free once the last actor drops them.
    ``close()`` drops the hub key — the controller releases its handle
    on the ref, which is the zero-leaked-ObjectRefs shutdown edge."""

    def __init__(self, key: str, channel: str = WEIGHTS_CHANNEL):
        self._key = key
        self._channel = channel
        self._version = 0
        self._hub_version = 0
        self._latest_ref = None
        self._closed = False

    @property
    def key(self) -> str:
        return self._key

    @property
    def version(self) -> int:
        return self._version

    @property
    def latest_ref(self):
        return self._latest_ref

    def publish(self, host_params: Any,
                extras: Optional[Dict[str, Any]] = None,
                version: Optional[int] = None) -> int:
        """Put ``host_params`` (a numpy pytree) into the object plane and
        publish {version, ref, extras} to the hub. Returns the new
        weights_version (strictly monotonic). An explicit ``version``
        lets a learner stamp its own clock (e.g. update count) instead
        of the publish count — it must still move strictly forward."""
        if self._closed:
            raise RuntimeError("publish after close")
        if version is not None and version <= self._version:
            raise ValueError(
                f"weights_version must be strictly monotonic: "
                f"{version} <= {self._version}")
        import time as _time

        from ray_tpu_torch.util import tracing

        t0 = _time.time()
        ref = ray_tpu_torch.put(host_params)
        self._version = self._version + 1 if version is None else version
        value = {"version": self._version, "ref": ref,
                 "extras": dict(extras or {})}
        # min_version keeps the hub's wakeup clock monotonic across a
        # controller restart (same idiom as serve's snapshot publish).
        self._hub_version = ControllerStub(_controller_client()).psub_publish(
            self._channel, self._key, value, self._hub_version + 1)
        # Object-plane hop in the trace (no-op without an active span):
        # `ray_tpu_torch timeline` shows the weight put + hub publish as one
        # psub:publish slice under the learner's sync span.
        tracing.record_span("psub:publish", t0, _time.time(),
                            channel=self._channel, version=self._version)
        self._latest_ref = ref
        return self._version

    def close(self) -> None:
        """Drop the hub key and the pinned ref. Idempotent."""
        if self._closed:
            return
        self._closed = True
        try:
            ControllerStub(_controller_client()).psub_drop(
                self._channel, self._key)
        except Exception:  # graftlint: disable=swallowed-exception (driver may be mid-shutdown; the hub's in-memory state dies with the controller anyway)
            pass
        self._latest_ref = None


class WeightReceiver:
    """Actor-side subscriber: poll the hub for a NEWER version than the
    last applied one and resolve the ref through the object plane.

    ``weights_version`` is strictly monotonic at every receiver — a
    republish, hub restart, or duplicate notify can never move an
    actor's weights backwards (pinned by tests)."""

    def __init__(self, key: str, channel: str = WEIGHTS_CHANNEL):
        self._key = key
        self._channel = channel
        self._weights_version = 0   # last APPLIED learner version
        self._hub_version = 0       # hub poll cursor

    @property
    def weights_version(self) -> int:
        return self._weights_version

    def poll(self, timeout: float = 0.0
             ) -> Optional[Tuple[int, Any, Dict[str, Any]]]:
        """One hub poll. ``timeout=0`` is a cheap freshness check (the
        per-rollout cadence); a positive timeout parks on the hub's
        long-poll (startup, when no weights exist yet). Returns
        (version, host_params, extras) when a strictly newer version
        arrived, else None."""
        result = ControllerStub(_controller_client()).psub_poll(
            self._channel, self._key, self._hub_version, timeout,
            timeout=timeout + 15.0)
        if result is None:
            return None
        hub_version, value = result
        self._hub_version = max(self._hub_version, hub_version)
        version = int(value["version"])
        if version <= self._weights_version:
            return None  # duplicate/stale publish: never move backwards
        params = ray_tpu_torch.get(value["ref"])
        self._weights_version = version
        return version, params, dict(value.get("extras") or {})

    def wait_initial(self, timeout: float = 60.0
                     ) -> Tuple[int, Any, Dict[str, Any]]:
        """Block until the first version is published (actor startup)."""
        import time

        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"no weights published on {self._channel}/{self._key} "
                    f"within {timeout}s")
            got = self.poll(timeout=min(remaining, 10.0))
            if got is not None:
                return got
