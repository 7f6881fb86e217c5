"""Versioned long-poll pub/sub hub.

TPU-era analogue of the reference's two notification layers: the generalized
pubsub used for GCS notifications (``src/ray/pubsub/publisher.h`` — one
long-poll connection per subscriber, batched messages) and Serve's
``LongPollHost`` (``serve/_private/long_poll.py:173`` — versioned snapshots,
subscribers re-poll with the last version they saw). The hub keeps only the
LATEST value per (channel, key) with a monotonically increasing version —
subscribers that fall behind see the newest state, not an event log, which is
the right semantics for control-plane state (actor records, serve configs,
job states) and keeps memory bounded.

Embedded in the controller (server side) and wrapped by :class:`Subscriber`
(client side). Wakeups are condition-variable broadcast; a poll with an
up-to-date version parks until publish or timeout.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# The controller's notices of dead worker processes: one key whose value
# is the newest ``[stamp, (host, port, pid)]`` pairs, oldest first. Every
# owner drops the handle counts those processes held (core/runtime.py
# ``_drop_dead_holders``).
DEAD_HOLDERS_CHANNEL = "dead_holders"
DEAD_HOLDERS_KEY = "recent"


class Pubsub:
    def __init__(self):
        self._cond = threading.Condition()
        # (channel, key) -> (version, value). Versions are per-(channel,key).
        self._state: Dict[Tuple[str, str], Tuple[int, Any]] = {}
        # (channel, key) -> monotonic publish time of the CURRENT version
        # (publish -> deliver latency; guarded by _cond).
        self._pub_ts: Dict[Tuple[str, str], float] = {}
        # (channel, key) -> highest publisher epoch seen (guarded by
        # _cond). Keys published WITH an epoch are fenced: a later
        # publish carrying a lower epoch is rejected — the zombie-old-
        # controller write the serve plane's restart protocol must
        # exclude (reference: GCS leader fencing via Redis epochs).
        self._pub_epochs: Dict[Tuple[str, str], int] = {}

    @staticmethod
    def _instrumented() -> bool:
        from ray_tpu_torch.core.config import config

        return config.core_metrics_enabled

    def _observe_delivery(self, channel: str, cur: Tuple[int, Any],
                          last_version: int, pub_ts: Optional[float],
                          parked_since: float) -> None:
        """Record subscriber lag (versions skipped by this poll) and, for
        a poller that was PARKED when the publish landed, the publish ->
        delivery latency. Runs on RPC pool threads, never the reactor."""
        from ray_tpu_torch.core import coremetrics as cm

        tags = {"channel": channel}
        cm.PSUB_SUB_LAG.observe(float(cur[0] - last_version), tags)
        if pub_ts is not None and pub_ts >= parked_since:
            cm.PSUB_DELIVER_S.observe(time.monotonic() - pub_ts, tags)

    def publish(self, channel: str, key: str, value: Any,
                min_version: int = 0,
                epoch: Optional[int] = None) -> Optional[int]:
        """``min_version`` lets a publisher keep its subscribers' version
        clocks monotonic across a HUB restart (head FT): a fresh hub would
        restart at 1, below what long-pollers already saw, stranding them —
        the publisher passes the floor it knows it reached before.

        ``epoch`` opts the key into publisher FENCING: the hub remembers
        the highest epoch that published it, and a publish carrying a
        LOWER epoch returns None without writing — a deposed serve
        controller (its replacement bumped the epoch) cannot clobber the
        live snapshot, however late its write arrives. Epoch-less
        publishes on the same key stay unfenced (back-compat)."""
        instrumented = self._instrumented()
        with self._cond:
            if epoch is not None:
                cur_epoch = self._pub_epochs.get((channel, key), 0)
                if epoch < cur_epoch:
                    return None  # fenced: a newer publisher owns the key
                self._pub_epochs[(channel, key)] = epoch
            version = max(self._state.get((channel, key), (0, None))[0] + 1,
                          min_version)
            self._state[(channel, key)] = (version, value)
            if instrumented:
                self._pub_ts[(channel, key)] = time.monotonic()
            self._cond.notify_all()
        if instrumented:
            from ray_tpu_torch.core import coremetrics as cm

            cm.PSUB_PUBLISHES.inc(1.0, {"channel": channel})
        return version

    def drop(self, channel: str, key: str) -> None:
        with self._cond:
            self._state.pop((channel, key), None)
            self._pub_ts.pop((channel, key), None)
            self._pub_epochs.pop((channel, key), None)

    def poll(self, channel: str, key: str, last_version: int = 0,
             timeout: float = 30.0) -> Optional[Tuple[int, Any]]:
        """Long-poll: block until (channel, key) has a version newer than
        ``last_version``; returns (version, value) or None on timeout."""
        t_parked = time.monotonic()
        deadline = t_parked + timeout
        instrumented = self._instrumented()
        with self._cond:
            while True:
                cur = self._state.get((channel, key))
                if cur is not None and cur[0] > last_version:
                    pub_ts = self._pub_ts.get((channel, key))
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(min(remaining, 1.0))
        if instrumented:
            self._observe_delivery(channel, cur, last_version, pub_ts,
                                   t_parked)
        return cur

    def poll_many(self, watches: Dict[str, Tuple[str, str, int]],
                  timeout: float = 30.0):
        """Multi-key long-poll (Serve's LongPollHost shape): ``watches`` maps
        a caller-chosen tag -> (channel, key, last_version). Returns
        {tag: (version, value)} for every watch that has news, or None on
        timeout. One condition wait covers all watches."""
        t_parked = time.monotonic()
        deadline = t_parked + timeout
        instrumented = self._instrumented()
        with self._cond:
            while True:
                updates = {}
                meta = []
                for tag, (channel, key, last) in watches.items():
                    cur = self._state.get((channel, key))
                    if cur is not None and cur[0] > last:
                        updates[tag] = cur
                        meta.append((channel, cur, last,
                                     self._pub_ts.get((channel, key))))
                if updates:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(min(remaining, 1.0))
        if instrumented:
            for channel, cur, last, pub_ts in meta:
                self._observe_delivery(channel, cur, last, pub_ts, t_parked)
        return updates

    def snapshot(self, channel: str) -> Dict[str, Tuple[int, Any]]:
        with self._cond:
            return {k: v for (ch, k), v in self._state.items()
                    if ch == channel}

    def keys(self, channel: str) -> Dict[str, int]:
        """Key -> current version for a channel, without the values (cheap
        discovery for subscribers that fetch lazily, e.g. log streaming)."""
        with self._cond:
            return {k: v[0] for (ch, k), v in self._state.items()
                    if ch == channel}


class Subscriber:
    """Client-side helper: blocking waits and background watch threads over a
    remote hub exposed via ``psub_poll`` / ``psub_poll_many`` RPCs."""

    def __init__(self, client):
        self._client = client  # RpcClient to the hub's host process

    def wait_for(self, channel: str, key: str, predicate,
                 timeout: Optional[float] = None,
                 last_version: int = 0):
        """Block until ``predicate(value)`` is true for a published value;
        returns (version, value). Raises TimeoutError."""
        deadline = None if timeout is None else time.monotonic() + timeout
        version = last_version
        while True:
            step = 30.0
            if deadline is not None:
                step = min(step, deadline - time.monotonic())
                if step <= 0:
                    raise TimeoutError(
                        f"pubsub wait on {channel}/{key} timed out")
            result = self._client.call("psub_poll", channel, key, version,
                                       step, timeout=step + 15.0)
            if result is None:
                continue
            version, value = result
            if predicate(value):
                return version, value

    def watch(self, channel: str, key: str, callback,
              stop_event: threading.Event,
              last_version: int = 0) -> threading.Thread:
        """Spawn a daemon thread invoking ``callback(version, value)`` on
        every update until ``stop_event`` is set."""

        def _dropped():
            from ray_tpu_torch.core.config import config

            if config.core_metrics_enabled:
                from ray_tpu_torch.core.coremetrics import PSUB_DROPPED_NOTIFIES

                PSUB_DROPPED_NOTIFIES.inc(1.0, {"channel": channel})

        def _loop():
            version = last_version
            while not stop_event.is_set():
                try:
                    result = self._client.call("psub_poll", channel, key,
                                               version, 10.0, timeout=25.0)
                except Exception:
                    _dropped()
                    if stop_event.wait(1.0):
                        return
                    continue
                if result is None:
                    continue
                version, value = result
                try:
                    callback(version, value)
                except Exception:
                    # The watch loop must outlive one bad callback, but
                    # a subscriber silently not applying updates is a
                    # routing/membership bug in the making.
                    from ray_tpu_torch.util.ratelimit import log_every

                    _dropped()
                    log_every(f"pubsub.watch.{channel}", 10.0, logger,
                              "watch callback for %r failed", channel,
                              exc_info=True)

        thread = threading.Thread(target=_loop, daemon=True,
                                  name=f"psub-watch-{channel}-{key}")
        thread.start()
        return thread
