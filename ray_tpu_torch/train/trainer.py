"""TorchTrainer: distributed training orchestration (port of
``ray_tpu/train/trainer.py``'s ``JaxTrainer``).

Analogue of the reference's ``TorchTrainer`` / ``DataParallelTrainer`` +
``BackendExecutor`` + ``TrainingIterator``
(``train/data_parallel_trainer.py:25``,
``_internal/backend_executor.py:67,129,441``, ``train/trainer.py:31``):
each worker runs one torch process on one card, in one NCCL process group
across the gang when ``ScalingConfig.torch_config`` asks for it
(``ray_tpu_torch.parallel`` builds meshes over it); the trainer's job is
gang placement, session plumbing, result streaming, and restart-based
fault tolerance (``FailureConfig.max_failures``; recovery resumes from the
latest reported checkpoint — reference: ``backend_executor.py:727``).
``datasets=`` splits each ``ray_tpu_torch.data.Dataset`` into one
streaming shard per worker on every attempt and every trial; no usage
report is written.

Unlike the reference, ``fit()`` does not route through the HPO engine for
single runs (no hidden single-trial Tuner); ``ray_tpu_torch.tune``
composes *over* trainers instead.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.worker_group import (GangReservationError,
                                              WorkerGroup, launch_gang)


@dataclass
class Result:
    metrics: Optional[Dict[str, Any]] = None
    checkpoint: Optional[Checkpoint] = None
    error: Optional[str] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)


class TrainingFailedError(ray_tpu_torch.RayTpuError):
    pass


class TorchTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        result_callback: Optional[Callable[[Dict], None]] = None,
    ):
        self._train_fn = train_loop_per_worker
        self._config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        # name -> ray_tpu_torch.data.Dataset; each attempt re-splits into
        # one streaming shard per worker, consumed via
        # ``train.get_dataset_shard(name)`` (reference:
        # DataParallelTrainer datasets + data_config.py ingest).
        self._datasets = datasets
        self._callback = result_callback
        self._name = self.run_config.name or f"train_{uuid.uuid4().hex[:8]}"

    def dataset_shards_per_rank(self) -> Optional[List[Dict[str, Any]]]:
        """Fresh streaming splits, one dict of shards per worker rank
        (fresh per attempt/trial: a DataIterator is single-consumption)."""
        if not self._datasets:
            return None
        n = self.scaling_config.num_workers
        split = {name: ds.streaming_split(n)
                 for name, ds in self._datasets.items()}
        return [{name: its[rank] for name, its in split.items()}
                for rank in range(n)]

    def fit(self) -> Result:
        from ray_tpu_torch import usage as _usage

        _usage.record_feature("train.TorchTrainer")
        max_failures = self.run_config.failure_config.max_failures
        attempts = 0
        latest_checkpoint: Optional[str] = None
        history: List[Dict[str, Any]] = []
        while True:
            try:
                result = self._run_attempt(latest_checkpoint, history)
                return result
            except _AttemptFailed as e:
                # Prefer the durable record: a worker may have persisted a
                # newer checkpoint than the driver's last poll observed.
                latest_checkpoint = (self._scan_storage_for_latest()
                                     or e.latest_checkpoint
                                     or latest_checkpoint)
                attempts += 1
                if max_failures != -1 and attempts > max_failures:
                    return Result(
                        metrics=history[-1]["metrics"] if history else None,
                        checkpoint=(Checkpoint(latest_checkpoint)
                                    if latest_checkpoint else None),
                        error=e.reason,
                        metrics_history=history,
                    )

    def _scan_storage_for_latest(self) -> Optional[str]:
        """Newest checkpoint dir under <storage>/<name> (persisted by worker
        ``report`` calls; survives worker and driver crashes)."""
        import os

        if self.run_config.storage_path is None:
            return None
        root = os.path.join(self.run_config.storage_path, self._name)
        if not os.path.isdir(root):
            return None
        ckpts = sorted(d for d in os.listdir(root)
                       if d.startswith("checkpoint_"))
        return os.path.join(root, ckpts[-1]) if ckpts else None

    def _run_attempt(self, latest_checkpoint: Optional[str],
                     history: List[Dict[str, Any]]) -> Result:
        from ray_tpu_torch.core import serialization

        sc = self.scaling_config
        # Deterministic driver-side failures (unpicklable train fn,
        # unreservable gang) raise HERE, outside the retry budget — only
        # distributed failures below convert to attempt failures.
        fn_blob = serialization.dumps_function(self._train_fn)
        try:
            # The shared gang-request path (worker_group.launch_gang —
            # tune trials use the same one): placement gang + worker
            # start + the optional process-group bootstrap through
            # core/multihost.py. All-or-nothing: a failure inside hands
            # back a fully torn-down gang.
            group = launch_gang(sc, self.run_config.storage_path,
                                self._name, latest_checkpoint,
                                dataset_shards_per_rank=(
                                    self.dataset_shards_per_rank()))
        except GangReservationError:
            raise  # the cluster cannot fit the gang: not retriable here
        except Exception as e:
            # A worker can die between starting its train thread and
            # the start() reply flushing (e.g. the loop crashes
            # immediately): that's an attempt failure, not a driver
            # error — the retry budget owns it.
            raise _AttemptFailed(
                f"worker group setup failed: {e}", latest_checkpoint)
        try:
            try:
                group.run(self._train_fn, self._config, fn_blob=fn_blob)
            except _AttemptFailed:
                raise
            except Exception as e:
                raise _AttemptFailed(
                    f"worker group setup failed: {e}", latest_checkpoint)
            return self._poll_until_done(group, history, latest_checkpoint)
        finally:
            group.shutdown()

    def _poll_until_done(self, group: WorkerGroup, history,
                         latest_checkpoint) -> Result:
        """Push-driven result streaming: each worker's ``wait_status`` is a
        long-poll (blocks inside the actor until news), so the driver sits in
        ``wait`` on outstanding replies instead of a fixed-period poll
        loop."""
        error: Optional[str] = None
        pending: Dict[Any, int] = {
            worker.wait_status.remote(30.0): i
            for i, worker in enumerate(group.workers)}
        while pending:
            ready, _ = ray_tpu_torch.wait(list(pending), num_returns=1,
                                    timeout=120.0)
            if not ready:
                raise _AttemptFailed("workers unresponsive for 120s",
                                     latest_checkpoint)
            for ref in ready:
                i = pending.pop(ref)
                try:
                    status = ray_tpu_torch.get(ref)
                except Exception as e:
                    raise _AttemptFailed(
                        f"worker {i} unreachable: {e}", latest_checkpoint)
                for r in status["results"]:
                    if "error" in r:
                        error = r["error"]
                        continue
                    if r.get("checkpoint"):
                        latest_checkpoint = r["checkpoint"]
                    if r["rank"] == 0:
                        history.append(r)
                        if self._callback is not None:
                            self._callback(r)
                if status["finished"]:
                    if status["error"] and error is None:
                        error = status["error"]
                    if status["latest_checkpoint"]:
                        latest_checkpoint = status["latest_checkpoint"]
                else:
                    pending[group.workers[i].wait_status.remote(30.0)] = i
        if error is not None:
            raise _AttemptFailed(f"train loop raised: {error}",
                                 latest_checkpoint)
        return Result(
            metrics=history[-1]["metrics"] if history else None,
            checkpoint=(Checkpoint(latest_checkpoint)
                        if latest_checkpoint else None),
            metrics_history=history,
        )


class _AttemptFailed(Exception):
    def __init__(self, reason: str, latest_checkpoint: Optional[str]):
        self.reason = reason
        self.latest_checkpoint = latest_checkpoint
        super().__init__(reason)
