"""Per-node metrics agent: the push half of the cluster metrics pipeline
for processes that have no core worker.

Worker and driver processes already ship their registry to the
controller through the ``util.metrics`` flusher (it needs a connected
runtime for its source identity and controller link). A NODE supervisor
process that never calls ``init()`` — ``ray_tpu start`` worker boxes —
has a registry full of exactly the series this PR exists for (its
RpcServer's write-path counters, its heartbeat RTTs) and no one to push
them. The agent is that pusher: bounded cumulative snapshots over the
node's existing controller link, on the heartbeat cadence.

One process, one pusher: the registry's ``claim_pusher`` arbitration
makes the core-worker flusher always win (richest identity), and an
agent that loses ownership retracts its series with one final EMPTY
push — two pushers shipping the same registry under different source
keys would double every counter in the cluster view.

The agent's controller link is a ``ReconnectingClient``: a controller
restart costs retries, never the thread (mirrors the PR 9 flusher
robustness contract, pinned by tests/test_core_observability.py).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from ray_tpu_torch.core.config import config
from ray_tpu_torch.util.metrics import _Registry
from ray_tpu_torch.util.ratelimit import log_every

logger = logging.getLogger(__name__)


class MetricsAgent:
    def __init__(self, controller_client, node_id_bytes: bytes,
                 period_s: Optional[float] = None):
        self._controller = controller_client
        self._source = {"node_id": node_id_bytes, "worker_id": b"",
                        "role": "node", "pid": os.getpid()}
        self._period = period_s
        self._owner = f"agent-{id(self)}"
        self._pushed_any = False
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="metrics-agent", daemon=True)
        self._thread.start()

    def _push(self, snapshot) -> bool:
        try:
            self._controller.notify("push_metrics", self._source, snapshot)
            return True
        except Exception:
            # Droppable (snapshots are cumulative; the next push
            # supersedes), but a push failing every beat means the head
            # is unreachable — leave a trail.
            log_every("metrics_agent.push", 60.0, logger,
                      "metrics agent push to controller failed",
                      exc_info=True)
            return False

    def push_once(self) -> bool:
        """One synchronous push (tests / shutdown flush). Respects the
        single-pusher arbitration."""
        from ray_tpu_torch.core import runtime

        if runtime._core_worker is not None:
            return False
        if not _Registry.get().claim_pusher(self._owner):
            return False
        ok = self._push(_Registry.get().snapshot())
        self._pushed_any = self._pushed_any or ok
        return ok

    def _loop(self) -> None:
        while not self._stopped.wait(
                self._period if self._period is not None
                else config.heartbeat_period_s):
            from ray_tpu_torch.core import runtime

            owns = (runtime._core_worker is None
                    and _Registry.get().claim_pusher(self._owner))
            if owns:
                ok = self._push(_Registry.get().snapshot())
                self._pushed_any = self._pushed_any or ok
            elif self._pushed_any:
                # Lost ownership to the core-worker flusher (an init()
                # landed in this process): retract our series so the
                # same registry isn't counted under two source keys.
                self._pushed_any = not self._push([])

    def stop(self) -> None:
        self._stopped.set()
        _Registry.get().release_pusher(self._owner)
