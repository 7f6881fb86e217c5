"""Controller-side pipeline registry: the ``pipe_*`` RPC surface.

The pipeline-parallel training plane (``ray_tpu_torch/train/pipeline_plane``)
is a driver-side scheduler over a gang of stage actors; what must
OUTLIVE any single driver step — and be fenced against a deposed
incarnation after a whole-gang restart — is tiny: which pipelines
exist, their geometry, and the **last completed optimizer step** under
the **current epoch**. This registry is that record, built on the same
three idioms as the host-group registry (``core/multihost.py``):

* re-registering an existing pipeline id bumps a **monotonic epoch**
  (the whole-gang-restart path: the re-formed gang re-registers and
  every write from the old incarnation turns stale);
* ``step_complete`` is **fenced** — a stale-epoch writer gets
  ``{"ok": False, "reason": "stale_epoch"}`` back and must self-fence
  instead of moving the step clock backwards for the live gang;
* ``state`` is the operator/test view (``ray_tpu doctor``'s
  pipeline-stall evidence names pipelines through it).

Progress only ever moves FORWARD under one epoch: ``last_step`` is a
max, so a duplicate or re-ordered completion report is idempotent.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional


class _PipeRecord:
    __slots__ = ("pipeline_id", "num_stages", "group_id", "owner",
                 "epoch", "last_step", "registered_at", "last_report")

    def __init__(self, pipeline_id: str, num_stages: int, group_id: str,
                 owner: str):
        self.pipeline_id = pipeline_id
        self.num_stages = int(num_stages)
        self.group_id = group_id
        self.owner = owner
        self.epoch = 1
        self.last_step = -1
        self.registered_at = time.monotonic()
        self.last_report = None


class PipelineRegistry:
    """Pipeline records keyed by pipeline id. All handlers run on the
    controller's RPC pool threads; everything is O(1) under one lock
    (no parked waiters — the plane's scheduling loop lives driver-side,
    only durable-ish progress facts land here)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pipes: Dict[str, _PipeRecord] = {}

    # ------------------------------------------------------- handlers

    def register(self, pipeline_id: str, num_stages: int,
                 group_id: str = "", owner: str = "") -> Dict[str, Any]:
        """Create a pipeline record, or RE-register an existing id —
        the whole-gang-restart path: the epoch bumps (fencing every
        in-flight step report of the previous incarnation) while
        ``last_step`` is KEPT, because it is exactly the resume point
        the re-formed gang asks for."""
        with self._lock:
            rec = self._pipes.get(pipeline_id)
            if rec is None:
                rec = _PipeRecord(pipeline_id, num_stages, group_id,
                                  owner)
                self._pipes[pipeline_id] = rec
            else:
                rec.epoch += 1
                rec.num_stages = int(num_stages)
                rec.group_id = group_id
            return {"epoch": rec.epoch, "last_step": rec.last_step}

    def drop(self, pipeline_id: str) -> bool:
        """Unregister (idempotent)."""
        with self._lock:
            return self._pipes.pop(pipeline_id, None) is not None

    def step_complete(self, pipeline_id: str, step: int,
                      epoch: int) -> Dict[str, Any]:
        """Record one completed optimizer step, fenced by epoch: a
        writer from a deposed gang incarnation is rejected (it must
        self-fence), and within the live epoch progress is a max —
        duplicate reports are idempotent."""
        with self._lock:
            rec = self._pipes.get(pipeline_id)
            if rec is None:
                return {"ok": False, "reason": "unknown_pipeline"}
            if epoch < rec.epoch:
                return {"ok": False, "reason": "stale_epoch",
                        "epoch": rec.epoch}
            rec.last_step = max(rec.last_step, int(step))
            rec.last_report = time.monotonic()
            return {"ok": True, "last_step": rec.last_step,
                    "epoch": rec.epoch}

    def state(self, pipeline_id: Optional[str] = None) -> Any:
        """Operator/test view of registered pipelines."""
        now = time.monotonic()

        def summary(rec: _PipeRecord) -> Dict[str, Any]:
            return {
                "pipeline_id": rec.pipeline_id,
                "num_stages": rec.num_stages,
                "group_id": rec.group_id,
                "owner": rec.owner,
                "epoch": rec.epoch,
                "last_step": rec.last_step,
                "age_s": round(now - rec.registered_at, 3),
                "report_age_s": (None if rec.last_report is None
                                 else round(now - rec.last_report, 3)),
            }

        with self._lock:
            if pipeline_id is not None:
                rec = self._pipes.get(pipeline_id)
                return summary(rec) if rec is not None else None
            return {p: summary(rec) for p, rec in self._pipes.items()}
