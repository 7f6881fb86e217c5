"""Gang-scheduled group of training worker actors (port of
``ray_tpu/train/worker_group.py``).

Analogue of the reference's ``WorkerGroup``
(``train/_internal/worker_group.py:102,193``) + the worker-side execution
half of ``BackendExecutor``: N actors placed on the bundles of one placement
group (gang semantics — all-or-nothing), each running the user's train loop
in a thread with a ``TrainSession`` attached, streaming results back to the
driver by polling.

One worker drives one card (or ``gpus_per_worker`` of them): its
``local_rank`` is its index among the gang's workers on its node, read from
the placement group's bundles. Its card comes from its ``GPU`` lease: the
node starts the worker with ``CUDA_VISIBLE_DEVICES`` narrowed to the cards
the lease holds (``core/node.py``), so the worker drives ``cuda:0``, the
first of them. The current CUDA device is per thread, so the runner thread
that calls the user's loop sets it again.
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.placement import (
    PlacementGroup,
    PlacementGroupSchedulingStrategy,
    placement_group,
    remove_placement_group,
)


class GangReservationError(ray_tpu_torch.RayTpuError):
    """The cluster cannot currently reserve the gang's placement group.
    Retriable: callers (Tune) requeue the trial until resources free."""


class TrainWorker:
    """Actor hosting one training process (one torch process per card)."""

    def __init__(self, world: Dict[str, Any], storage_path: Optional[str],
                 experiment_name: str, latest_checkpoint: Optional[str],
                 card: Optional[int] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None):
        from ray_tpu_torch.train.session import (TrainSession, WorldInfo,
                                                 init_session)

        self._session = TrainSession(
            WorldInfo(**world), storage_path, experiment_name,
            latest_checkpoint, dataset_shards=dataset_shards)
        init_session(self._session)
        # The card this worker drives (None: a worker without a GPU lease).
        self._card = card
        self._thread: Optional[threading.Thread] = None

    def start(self, fn_blob: bytes, config: Optional[Dict]) -> bool:
        from ray_tpu_torch.train.session import init_session

        fn = serialization.loads_function(fn_blob)
        session = self._session
        card = self._card

        def runner():
            init_session(session)  # session is thread-local; bind in-thread
            try:
                import torch

                if card is not None and torch.cuda.is_available():
                    # The current device is per thread: the loop's
                    # thread sets the card its lease names.
                    torch.cuda.set_device(card)
                if config is None:
                    fn()
                else:
                    fn(config)
            except BaseException as e:  # noqa: BLE001
                session.error = e
                session.results.put({
                    "error": traceback.format_exc(), "rank":
                    session.world.world_rank})
            finally:
                session.finished.set()

        self._thread = threading.Thread(target=runner, name="train-loop",
                                        daemon=True)
        self._thread.start()
        return True

    def next_results(self) -> List[Dict[str, Any]]:
        """Drain queued results (non-blocking)."""
        out = []
        while True:
            try:
                out.append(self._session.results.get_nowait())
            except Exception:
                break
        return out

    def status(self) -> Dict[str, Any]:
        return {
            "finished": self._session.finished.is_set(),
            "error": repr(self._session.error) if self._session.error else None,
            "latest_checkpoint": self._session.latest_checkpoint,
        }

    def wait_status(self, timeout: float = 30.0) -> Dict[str, Any]:
        """Long-poll: block until at least one result is queued (or the loop
        finishes / timeout), then return drained results + status in one
        reply. The driver waits on this instead of polling at a fixed
        period."""
        import queue as _q
        import time as _t

        deadline = _t.monotonic() + timeout
        out = self.next_results()
        while not out and not self._session.finished.is_set():
            remaining = deadline - _t.monotonic()
            if remaining <= 0:
                break
            try:
                out.append(self._session.results.get(
                    timeout=min(remaining, 1.0)))
            except _q.Empty:
                continue
        # Order matters: read finished BEFORE the final drain. If the loop
        # sets finished after our last get() timed out, results queued in
        # that window must still ship in this reply — the driver stops
        # calling once it sees finished=True.
        status = self.status()
        out.extend(self.next_results())
        return {"results": out, **status}

    def ping(self) -> str:
        return "pong"

    # ------------------------------------------------ torch.distributed

    def reserve_coordinator(self, port: int = 0) -> str:
        """Rank 0: pick the rendezvous address for the group."""
        from ray_tpu_torch.train.torch_backend import pick_coordinator_address

        return pick_coordinator_address(port)

    def join_gang_runtime(self, group_id: str, epoch: int, member: str,
                          coordinator: str, num_processes: int,
                          process_id: int, local_rank: int,
                          device_type: Optional[str]) -> int:
        """Join this worker into the gang's process group THROUGH the
        multihost subsystem (core/multihost.py): a barrier'd
        bootstrap-fingerprint check first — a worker whose coordinator,
        world size or device type disagrees with the gang raises the typed
        mismatch instead of hanging in the rendezvous — then the join on
        its card."""
        from ray_tpu_torch.core import multihost

        n = multihost.join_torch_gang(group_id, member, epoch, coordinator,
                                      num_processes, process_id,
                                      local_rank, device_type)
        self._session.world.coordinator = coordinator
        return n

    def shutdown_torch(self, timeout: float = 10.0) -> bool:
        """Destroy this worker's process group. Every rank must call it
        at once (a rank killed with a live NCCL communicator can hang or
        abort the others); it is timeout-guarded so a wedged group cannot
        hang the actor (the group falls back to kill)."""
        from ray_tpu_torch.train.torch_backend import shutdown_process

        done = threading.Event()

        def run():
            shutdown_process()
            done.set()

        t = threading.Thread(target=run, name="torch-shutdown", daemon=True)
        t.start()
        t.join(timeout)
        return done.is_set()


def local_ranks(pg: PlacementGroup, n: int) -> List[int]:
    """Each bundle's index among the group's bundles on its node."""
    seen: Dict[Any, int] = {}
    out = []
    for i in range(n):
        node = pg.bundle_node(i)[0]
        out.append(seen.get(node, 0))
        seen[node] = out[-1] + 1
    return out


class WorkerGroup:
    def __init__(self, num_workers: int, resources_per_worker: Dict[str, float],
                 placement_strategy: str = "PACK", torch_config=None):
        self.num_workers = num_workers
        self.resources = dict(resources_per_worker)
        self.torch_config = torch_config
        self.pg: PlacementGroup = placement_group(
            [dict(self.resources) for _ in range(num_workers)],
            strategy=placement_strategy)
        if not self.pg.ready(timeout=60.0):
            remove_placement_group(self.pg)
            raise GangReservationError(
                f"could not gang-reserve {num_workers} x {self.resources} "
                f"(placement strategy {placement_strategy})")
        self.workers: List[Any] = []
        self.local_ranks: List[int] = []
        self._torch_bootstrapped = False
        self._gang_id: Optional[str] = None

    def start(self, storage_path: Optional[str], experiment_name: str,
              latest_checkpoint: Optional[str],
              dataset_shards_per_rank: Optional[List[Dict[str, Any]]] = None
              ) -> None:
        actor_cls = ray_tpu_torch.remote(TrainWorker)
        self.local_ranks = local_ranks(self.pg, self.num_workers)
        gpus = self.resources.get("GPU", 0)
        for rank in range(self.num_workers):
            world = {"world_rank": rank, "world_size": self.num_workers,
                     "local_rank": self.local_ranks[rank]}
            shards = (dataset_shards_per_rank[rank]
                      if dataset_shards_per_rank else None)
            self.workers.append(actor_cls.options(
                num_cpus=0,
                resources=self.resources,
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    self.pg, rank),
            ).remote(world, storage_path, experiment_name,
                     latest_checkpoint, 0 if gpus else None,
                     shards))
        if self.torch_config is not None and self.torch_config.distributed:
            self._bootstrap_torch()

    def _bootstrap_torch(self) -> None:
        """Form ONE process group across the gang THROUGH the multihost
        subsystem (core/multihost.py): the gang registers a group with the
        controller, every worker enters the bootstrap-fingerprint barrier
        (a misaligned world size or device type is a typed refusal instead
        of a hung rendezvous), rank 0 hosts the tcp rendezvous, and every
        worker joins on its card (reference analogue: BackendExecutor +
        _setup_torch_process_group, train/torch/config.py:65-170)."""
        from ray_tpu_torch.core import multihost

        self._gang_id, epoch = multihost.register_gang(
            len(self.workers), owner="train-worker-group")
        # Set BEFORE joining: if the join succeeds on some ranks and the
        # gather fails (timeout, inconsistent sizes), those ranks hold
        # live process groups and still need cooperative teardown.
        self._torch_bootstrapped = True
        multihost.form_torch_runtime(self.workers, self.torch_config,
                                     group_id=self._gang_id, epoch=epoch)

    def _leave_torch_distributed(self) -> None:
        """Cooperative teardown: killing the gang with live NCCL
        communicators can hang or abort the survivors. Every rank destroys
        its process group concurrently under one shared deadline
        (multihost.leave_torch_runtime), and the group record drops; a
        wedged or already-dead worker falls through to the kill path."""
        if not self._torch_bootstrapped or not self.workers:
            return
        from ray_tpu_torch.core import multihost

        multihost.leave_torch_runtime(self.workers, group_id=self._gang_id,
                                      timeout=20.0)

    def run(self, train_fn: Callable, config: Optional[Dict],
            fn_blob: Optional[bytes] = None) -> None:
        if fn_blob is None:
            fn_blob = serialization.dumps_function(train_fn)
        ray_tpu_torch.get([w.start.remote(fn_blob, config)
                           for w in self.workers])

    def shutdown(self) -> None:
        self._leave_torch_distributed()
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # graftlint: disable=swallowed-exception (best-effort worker teardown)
                pass
        try:
            remove_placement_group(self.pg)
        except Exception:  # graftlint: disable=swallowed-exception (best-effort worker teardown)
            pass


def launch_gang(scaling_config, storage_path: Optional[str],
                experiment_name: str, latest_checkpoint: Optional[str],
                dataset_shards_per_rank: Optional[List[Dict[str, Any]]]
                = None) -> WorkerGroup:
    """The ONE gang-request path for trainer attempts AND tune trials:
    reserve the placement gang, start the workers, and (when the
    scaling config asks for it) form the process group through
    core/multihost.py. All-or-nothing: any failure after the
    reservation tears the gang down before re-raising, so callers never
    hold a half-started group. ``GangReservationError`` propagates
    untouched (it is the retriable "cluster full" signal Tune requeues
    on)."""
    group = WorkerGroup(scaling_config.num_workers,
                        scaling_config.worker_resources(),
                        scaling_config.placement_strategy,
                        torch_config=scaling_config.torch_config)
    try:
        group.start(storage_path, experiment_name, latest_checkpoint,
                    dataset_shards_per_rank=dataset_shards_per_rank)
    except BaseException:
        group.shutdown()
        raise
    return group
