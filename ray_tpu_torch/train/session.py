"""Per-worker training session: the worker-side half of the Train protocol
(port of ``ray_tpu/train/session.py``).

Analogue of the reference's ``_TrainSession``
(``train/_internal/session.py:110``; ``report`` :402/:666): the user's
``train_loop_per_worker`` runs in a thread inside a TrainWorker actor; this
module gives it ``report(metrics, checkpoint=...)`` — which enqueues results
for the driver and persists checkpoints to run storage — plus world/rank
introspection for process-group and mesh construction. ``local_rank`` is
the worker's index among its gang's workers on its node (the card it
trains on); the JAX package sets 0 (one process per TPU-VM host).
"""

from __future__ import annotations

import os
import queue
import shutil
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_session = threading.local()


@dataclass
class WorldInfo:
    world_rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    coordinator: Optional[str] = None


class TrainSession:
    def __init__(self, world: WorldInfo, storage_path: Optional[str],
                 experiment_name: str,
                 latest_checkpoint: Optional[str] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None):
        self.world = world
        self.storage_path = storage_path
        self.experiment_name = experiment_name
        self.results: "queue.Queue" = queue.Queue()
        self.latest_checkpoint = latest_checkpoint
        self.iteration = 0
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None
        # This worker's per-rank DataIterators (reference:
        # session.get_dataset_shard / streaming_split ingest).
        self.dataset_shards: Dict[str, Any] = dataset_shards or {}

    # -------------------------------------------------------------- api

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        self.iteration += 1
        persisted: Optional[str] = None
        if checkpoint is not None:
            persisted = self._persist(checkpoint)
            self.latest_checkpoint = persisted
        self.results.put({
            "metrics": dict(metrics),
            "checkpoint": persisted,
            "iteration": self.iteration,
            "rank": self.world.world_rank,
        })

    def get_checkpoint(self) -> Optional[Checkpoint]:
        """Latest checkpoint for resume-after-restart (reference:
        ``session.get_checkpoint``)."""
        if self.latest_checkpoint is None:
            return None
        return Checkpoint(self.latest_checkpoint)

    def _persist(self, checkpoint: Checkpoint) -> str:
        """Move the checkpoint into run storage (rank-0 path layout
        ``<storage>/<experiment>/checkpoint_<iter>``; reference:
        ``train/_internal/storage.py`` StorageContext)."""
        if self.storage_path is None:
            return checkpoint.path
        dest = os.path.join(self.storage_path, self.experiment_name,
                            f"checkpoint_{self.iteration:06d}")
        if os.path.abspath(checkpoint.path) != os.path.abspath(dest):
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            if os.path.exists(dest):
                shutil.rmtree(dest)
            shutil.copytree(checkpoint.path, dest)
        return dest


def init_session(session: TrainSession) -> None:
    _session.value = session


def get_session() -> TrainSession:
    s = getattr(_session, "value", None)
    if s is None:
        raise RuntimeError(
            "No train session active: this API must be called from inside "
            "a train_loop_per_worker launched by TorchTrainer.")
    return s


# Module-level convenience API (mirrors ``ray.train`` functions).

def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return get_session().get_checkpoint()


def get_dataset_shard(name: str = "train"):
    """This worker's DataIterator for ``TorchTrainer(datasets={name: ds})``
    (reference: ``ray.train.get_dataset_shard`` — each worker pulls its
    own streaming split; pair with ``iter_device_batches()`` for
    prefetched batches on this worker's card, or ``mesh=`` for
    mesh-sharded ones)."""
    shards = get_session().dataset_shards
    if name not in shards:
        raise KeyError(
            f"no dataset shard {name!r}; pass datasets={{{name!r}: ds}} "
            f"to TorchTrainer (have: {sorted(shards)})")
    return shards[name]


def get_world_rank() -> int:
    return get_session().world.world_rank


def get_world_size() -> int:
    return get_session().world.world_size


def get_local_rank() -> int:
    return get_session().world.local_rank
