"""Tuner: the HPO trial loop (port of ``ray_tpu/tune/tuner.py``).

Analogue of the reference's ``Tuner.fit`` -> ``TuneController`` event loop
(``tune/tuner.py:44,344``, ``tune/execution/tune_controller.py:68,666``):
trials run as actors (via the same TrainWorker session machinery Train
uses — the reference likewise unifies trial and train execution), the
controller polls results, feeds them to the scheduler (FIFO/ASHA/PBT), and
stops / exploits trials per its decisions. PBT exploitation restarts the
trial actor from the donor trial's latest checkpoint with perturbed
hyperparameters (reference: ``pbt.py`` checkpoint clone + perturb).

Train-over-Tune layering (reference: ``train/base_trainer.py:819`` wraps a
trainer as a Tune ``Trainable``; ``tune/execution/placement_groups.py``
gang-places trial resources): ``Tuner(TorchTrainer(...))`` runs each trial
as a full gang-scheduled ``WorkerGroup`` — per-trial placement group, N
workers, optional ``torch.distributed`` process group — with the trial's
sampled config merged over ``train_loop_config``. ASHA stop and PBT
checkpoint-clone/perturb act on the whole gang. Function trials can also
request a per-trial PG by passing a bundle LIST as ``resources_per_trial``
(bundle 0 hosts the trial; the rest reserve side resources).
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import ray_tpu_torch
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.placement import (
    PlacementGroupSchedulingStrategy,
    placement_group,
    remove_placement_group,
)
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.trainer import TorchTrainer
from ray_tpu_torch.train.worker_group import (
    GangReservationError,
    TrainWorker,
    WorkerGroup,
    launch_gang,
)
from ray_tpu_torch.tune.schedulers import CONTINUE, EXPLOIT, STOP, FIFOScheduler
from ray_tpu_torch.tune.search import generate_variants


@dataclass
class TuneConfig:
    metric: str = "loss"
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Any = None
    search_alg: Any = None  # e.g. tune.TPESearcher; None = grid/random
    seed: int = 0


@dataclass
class TrialResult:
    trial_id: str
    config: Dict[str, Any]
    metrics: Optional[Dict[str, Any]] = None
    checkpoint: Optional[Checkpoint] = None
    error: Optional[str] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)


class ResultGrid:
    def __init__(self, results: List[TrialResult], metric: str, mode: str):
        self.results = results
        self._metric, self._mode = metric, mode

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        scored = [r for r in self.results
                  if r.metrics and metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        return (max if mode == "max" else min)(
            scored, key=lambda r: r.metrics[metric])

    def __len__(self):
        return len(self.results)

    def __iter__(self):
        return iter(self.results)


class _Trial:
    def __init__(self, trial_id: str, config: Dict[str, Any]):
        self.id = trial_id
        self.config = dict(config)
        # Execution state (never snapshotted): either one TrainWorker
        # actor (function trial) or a WorkerGroup gang (trainer trial).
        self.actor = None
        self.group: Optional[WorkerGroup] = None
        self.pg = None               # function-trial per-trial PG
        self.workers: List[Any] = []  # long-poll targets; [0] is rank 0
        # Bumped on every (re)launch and stop: outstanding long-poll
        # replies from a previous incarnation are dropped by epoch check.
        self.epoch = 0
        self.state = "PENDING"
        self.iteration = 0
        self.latest_checkpoint: Optional[str] = None
        self.result = TrialResult(trial_id, dict(config))

    def __hash__(self):
        return hash(self.id)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "config": self.config,
            "state": self.state,
            "iteration": self.iteration,
            "latest_checkpoint": self.latest_checkpoint,
            "error": self.result.error,
            "metrics": self.result.metrics,
            "metrics_history": self.result.metrics_history[-50:],
        }

    @classmethod
    def from_snapshot(cls, data: Dict[str, Any]) -> "_Trial":
        trial = cls(data["id"], data["config"])
        trial.state = data["state"]
        trial.iteration = data.get("iteration", 0)
        trial.latest_checkpoint = data.get("latest_checkpoint")
        trial.result.error = data.get("error")
        trial.result.metrics = data.get("metrics")
        trial.result.metrics_history = list(data.get("metrics_history", []))
        if trial.latest_checkpoint:
            trial.result.checkpoint = Checkpoint(trial.latest_checkpoint)
        return trial


class Tuner:
    def __init__(
        self,
        trainable: Union[Callable[[Dict[str, Any]], None], TorchTrainer],
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        resources_per_trial: Optional[
            Union[Dict[str, float], List[Dict[str, float]]]] = None,
        storage_path: Optional[str] = None,
        name: Optional[str] = None,
    ):
        self._trainable = trainable
        self._trainer = trainable if isinstance(trainable, TorchTrainer) \
            else None
        self._param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self._resources = resources_per_trial or {"CPU": 1.0}
        if storage_path is None and self._trainer is not None:
            storage_path = self._trainer.run_config.storage_path
        self._storage = storage_path
        self._name = name or f"tune_{uuid.uuid4().hex[:8]}"
        self._restored_trials: Optional[List[_Trial]] = None

    # --------------------------------------------------- restore/snapshot

    @classmethod
    def restore(cls, path: str, trainable: Union[Callable, TorchTrainer],
                resume_errored: bool = False,
                tune_config: Optional["TuneConfig"] = None) -> "Tuner":
        """Rebuild a Tuner from an experiment-state snapshot so a crashed or
        killed driver can resume its sweep (reference: ``Tuner.restore``,
        ``tune/tuner.py:171`` + ``execution/experiment_state.py``). Finished
        trials keep their results; in-flight trials restart from their
        latest checkpoint; errored trials restart only with
        ``resume_errored``. Schedulers are code, not snapshot state — pass
        ``tune_config`` (with the scheduler) to keep ASHA/PBT decisions
        after restore; otherwise the sweep resumes under FIFO."""
        import json
        import os

        with open(os.path.join(path, "experiment_state.json")) as f:
            state = json.load(f)
        resources = state["resources"]
        tuner = cls(
            trainable,
            param_space={},
            tune_config=tune_config or TuneConfig(**state["tune_config"]),
            resources_per_trial=resources,
            storage_path=state["storage"],
            name=state["name"],
        )
        trials = [_Trial.from_snapshot(t) for t in state["trials"]]
        for trial in trials:
            if trial.state in ("RUNNING", "PENDING"):
                trial.state = "PENDING"
            elif trial.state == "ERROR" and resume_errored:
                trial.state = "PENDING"
                trial.result.error = None
        tuner._restored_trials = trials
        return tuner

    def _experiment_dir(self) -> Optional[str]:
        import os

        if self._storage is None:
            return None
        path = os.path.join(self._storage, self._name)
        os.makedirs(path, exist_ok=True)
        return path

    def _save_state(self, trials: List[_Trial]) -> None:
        import json
        import os

        path = self._experiment_dir()
        if path is None:
            return
        tc = self.tune_config
        state = {
            "name": self._name,
            "storage": self._storage,
            "resources": self._resources,
            "tune_config": {"metric": tc.metric, "mode": tc.mode,
                            "num_samples": tc.num_samples,
                            "max_concurrent_trials": tc.max_concurrent_trials,
                            "seed": tc.seed},
            "trials": [t.snapshot() for t in trials],
        }
        tmp = os.path.join(path, "experiment_state.json.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, os.path.join(path, "experiment_state.json"))

    # ------------------------------------------------------------- fit

    def fit(self) -> ResultGrid:
        from ray_tpu_torch import usage as _usage

        _usage.record_feature("tune.Tuner")
        tc = self.tune_config
        scheduler = tc.scheduler or FIFOScheduler()
        searcher = tc.search_alg
        if self._restored_trials is not None:
            trials = self._restored_trials
            searcher = None  # restored sweeps replay their saved configs
        elif searcher is not None:
            # Model-based search: configs are SUGGESTED one at a time as
            # slots free up, informed by completed trials (reference:
            # Optuna/HyperOpt searcher seam, tune/search/searcher.py).
            searcher.set_search_properties(tc.metric, tc.mode,
                                           self._param_space)
            trials = []
        else:
            variants = generate_variants(self._param_space, tc.num_samples,
                                         tc.seed)
            trials = [_Trial(f"{self._name}_{i:05d}", cfg)
                      for i, cfg in enumerate(variants)]
        train_fn = (self._trainer._train_fn if self._trainer is not None
                    else self._trainable)
        fn_blob = serialization.dumps_function(train_fn)
        if tc.max_concurrent_trials:
            max_conc = tc.max_concurrent_trials
        elif searcher is not None:
            # Unbounded concurrency would suggest the whole sweep before
            # any result lands, degenerating model-based search to random.
            max_conc = 4
        else:
            max_conc = max(len(trials), tc.num_samples, 1)

        pending = [t for t in trials if t.state == "PENDING"]
        running: List[_Trial] = []
        # Long-poll replies in flight: ref -> (trial, worker, epoch). A
        # stale epoch (trial exploited/stopped/restarted) is ignored.
        waiting: Dict[Any, tuple] = {}

        def arm(trial: _Trial, workers: Optional[List[Any]] = None) -> None:
            for w in (workers if workers is not None else trial.workers):
                waiting[w.wait_status.remote(10.0)] = (trial, w, trial.epoch)

        def more_to_suggest() -> bool:
            return searcher is not None and len(trials) < tc.num_samples

        # Set after a failed gang reservation; cleared when a running
        # trial finishes (frees its PG) or by the bounded idle retry below
        # — so an unplaceable trial doesn't churn 60s pg.ready() attempts
        # against the controller on every loop pass.
        reserve_blocked = False
        idle_reserve_retries = 0

        def finish(trial: _Trial) -> None:
            nonlocal reserve_blocked
            reserve_blocked = False
            if trial in running:
                running.remove(trial)
            if searcher is not None:
                searcher.on_trial_complete(trial.id, trial.result.metrics)
            self._save_state(trials)

        self._save_state(trials)
        while pending or running or more_to_suggest():
            while (len(running) < max_conc and not reserve_blocked
                   and (pending or more_to_suggest())):
                if pending:
                    trial = pending.pop(0)
                else:
                    tid = f"{self._name}_{len(trials):05d}"
                    trial = _Trial(tid, searcher.suggest(tid))
                    trials.append(trial)
                try:
                    self._launch(trial, fn_blob)
                except GangReservationError:
                    # Cluster can't fit another gang right now: requeue
                    # and wait for a running trial to free its PG.
                    pending.append(trial)
                    reserve_blocked = True
                    break
                except Exception as e:
                    self._stop_trial(trial)  # free a reserved PG, if any
                    trial.state = "ERROR"
                    trial.result.error = f"trial launch failed: {e}"
                    continue
                idle_reserve_retries = 0
                running.append(trial)
                arm(trial)
            if not waiting:
                if running:
                    time.sleep(0.05)
                    continue
                if pending:
                    # Nothing running to free resources. The shortage can
                    # still be transient (autoscaler bringing up a node,
                    # external actors finishing) — retry with backoff a
                    # few times before declaring the sweep unplaceable.
                    idle_reserve_retries += 1
                    if idle_reserve_retries >= 4:
                        for trial in pending:
                            trial.state = "ERROR"
                            trial.result.error = (
                                "cannot gang-reserve trial resources and "
                                "no running trial will free any")
                        pending.clear()
                        continue
                    time.sleep(5.0 * idle_reserve_retries)
                    reserve_blocked = False
                continue
            ready, _ = ray_tpu_torch.wait(list(waiting), num_returns=1,
                                    timeout=60.0)
            for ref in ready:
                trial, worker, epoch = waiting.pop(ref)
                if trial.epoch != epoch or trial.state != "RUNNING":
                    continue  # exploited/restarted/stopped since this poll
                verdict = self._consume(trial, ref, worker, scheduler,
                                        fn_blob)
                if verdict == "continue":
                    arm(trial, [worker])
                elif verdict == "exploited":
                    arm(trial)  # fresh gang, re-arm every new worker
                elif verdict == "worker_finished":
                    pass  # non-rank-0 done; rank 0 decides the trial
                else:  # terminal
                    finish(trial)
        self._save_state(trials)
        return ResultGrid([t.result for t in trials], tc.metric, tc.mode)

    # --------------------------------------------------------- internals

    def _launch(self, trial: _Trial, fn_blob: bytes,
                checkpoint: Optional[str] = None) -> None:
        trial.epoch += 1
        start_ckpt = checkpoint or trial.latest_checkpoint
        experiment = f"{self._name}/{trial.id}"
        if self._trainer is not None:
            # Gang trial: the trial REQUESTS a gang through the shared
            # launch path (worker_group.launch_gang — the same code
            # trainer attempts use): per-trial PG, N workers, and the
            # optional process-group bootstrap routed through
            # core/multihost.py (group registration + bootstrap-hash
            # barrier) instead of hand-rolled rendezvous wiring here.
            # The trial's sampled config merges over train_loop_config
            # (reference: base_trainer.py:608 config-merge into the
            # trainable).
            group = launch_gang(
                self._trainer.scaling_config, self._storage, experiment,
                start_ckpt,
                dataset_shards_per_rank=(
                    self._trainer.dataset_shards_per_rank()))
            try:
                merged = {**(self._trainer._config or {}), **trial.config}
                group.run(None, merged, fn_blob=fn_blob)
            except Exception:
                group.shutdown()
                raise
            trial.group = group
            trial.workers = list(group.workers)
            trial.actor = group.workers[0]
        else:
            actor_cls = ray_tpu_torch.remote(TrainWorker)
            world = {"world_rank": 0, "world_size": 1, "local_rank": 0}
            opts: Dict[str, Any] = {"num_cpus": 0}
            if isinstance(self._resources, (list, tuple)):
                # Per-trial placement group from a bundle list: bundle 0
                # hosts the trial actor, the rest reserve side resources
                # (reference: tune/execution/placement_groups.py
                # PlacementGroupFactory).
                pg = placement_group([dict(b) for b in self._resources],
                                     strategy="PACK")
                if not pg.ready(timeout=60.0):
                    remove_placement_group(pg)
                    raise GangReservationError(
                        f"could not reserve trial bundles "
                        f"{self._resources}")
                trial.pg = pg
                opts["resources"] = dict(self._resources[0])
                opts["scheduling_strategy"] = \
                    PlacementGroupSchedulingStrategy(pg, 0)
            else:
                opts["resources"] = dict(self._resources)
            try:
                trial.actor = actor_cls.options(**opts).remote(
                    world, self._storage, experiment, start_ckpt)
                trial.actor.start.remote(fn_blob, trial.config)
            except Exception:
                if trial.pg is not None:  # don't leak the reserved PG
                    remove_placement_group(trial.pg)
                    trial.pg = None
                raise
            trial.workers = [trial.actor]
        trial.state = "RUNNING"

    def _consume(self, trial: _Trial, status_ref, worker, scheduler,
                 fn_blob: bytes) -> str:
        """Digest one worker's wait_status long-poll reply. Returns
        "continue" (re-arm this worker), "exploited" (gang replaced),
        "worker_finished" (non-rank-0 done), or "terminal"."""
        try:
            status = ray_tpu_torch.get(status_ref, timeout=60)
        except Exception as e:
            trial.result.error = f"trial worker failed: {e}"
            self._stop_trial(trial)
            trial.state = "ERROR"
            return "terminal"
        for r in status["results"]:
            if "error" in r:
                trial.state = "ERROR"
                trial.result.error = r["error"]
                continue
            if r.get("checkpoint"):
                trial.latest_checkpoint = r["checkpoint"]
            if r.get("rank", 0) != 0:
                continue  # metrics/scheduling follow rank 0 only
            trial.iteration += 1
            metrics = dict(r["metrics"])
            metrics.setdefault("training_iteration", trial.iteration)
            trial.result.metrics = metrics
            trial.result.metrics_history.append(metrics)
            trial.result.checkpoint = (
                Checkpoint(trial.latest_checkpoint)
                if trial.latest_checkpoint else None)
            decision = scheduler.on_result(trial, metrics)
            if decision == STOP:
                self._stop_trial(trial)
                trial.state = "TERMINATED"
                return "terminal"
            if decision == EXPLOIT:
                donor = scheduler.exploit_target(trial)
                if donor is not None and donor.latest_checkpoint:
                    if self._exploit(trial, donor, scheduler, fn_blob):
                        return "exploited"
                    return "terminal"
        if trial.state == "ERROR" or status["error"]:
            if status["error"] and trial.result.error is None:
                trial.result.error = status["error"]
            self._stop_trial(trial)
            trial.state = "ERROR"
            return "terminal"
        if status["finished"]:
            if not trial.workers or worker is trial.workers[0]:
                self._stop_trial(trial)
                trial.state = "TERMINATED"
                return "terminal"
            return "worker_finished"
        return "continue"

    def _exploit(self, trial: _Trial, donor: _Trial, scheduler,
                 fn_blob: bytes) -> bool:
        """PBT exploit: restart this trial (actor or whole gang) from the
        donor's checkpoint with perturbed config."""
        self._stop_trial(trial)
        trial.config = scheduler.perturb_config(donor.config)
        trial.result.config = dict(trial.config)
        trial.latest_checkpoint = donor.latest_checkpoint
        try:
            self._launch(trial, fn_blob,
                         checkpoint=donor.latest_checkpoint)
        except Exception as e:
            trial.state = "ERROR"
            trial.result.error = f"exploit relaunch failed: {e}"
            return False
        return True

    def _stop_trial(self, trial: _Trial) -> None:
        trial.epoch += 1  # drop every outstanding long-poll for this trial
        if trial.group is not None:
            try:
                trial.group.shutdown()
            except Exception:  # graftlint: disable=swallowed-exception (best-effort trial teardown; cluster reaps the actor)
                pass
            trial.group = None
        elif trial.actor is not None:
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:  # graftlint: disable=swallowed-exception (best-effort trial teardown; cluster reaps the actor)
                pass
        if trial.pg is not None:
            try:
                remove_placement_group(trial.pg)
            except Exception:  # graftlint: disable=swallowed-exception (best-effort trial teardown; cluster reaps the actor)
                pass
            trial.pg = None
        trial.actor = None
        trial.workers = []
