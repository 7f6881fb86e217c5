"""The port's Tuner when the cluster cannot hold a second gang: on a node
of one ``GPU``, two trials of a one-worker ``use_gpu`` trainer. The first
trial's gang takes the ``GPU``; the second's reservation is refused
(``GangReservationError``), the trial is requeued, and it launches once
the first has finished and freed its placement group
(``tune/tuner.py``'s ``reserve_blocked`` path). The worker group waits
60 s for a reservation; the test caps that wait at a few seconds, which
takes the same path."""

import torch_train_program as prog


def test_gang_trial_refused_then_requeued(tmp_path, monkeypatch):
    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.core import placement
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.worker_group import GangReservationError
    from ray_tpu_torch.tune import tuner as tuner_mod

    ready = placement.PlacementGroup.ready
    monkeypatch.setattr(placement.PlacementGroup, "ready",
                        lambda self, timeout=30.0: ready(
                            self, timeout=min(timeout, 3.0)))
    launches = []
    launch = tuner_mod.Tuner._launch

    def spy(self, trial, *args, **kwargs):
        try:
            launch(self, trial, *args, **kwargs)
        except GangReservationError:
            launches.append((trial.config["lr"], "refused"))
            raise
        launches.append((trial.config["lr"], "launched"))

    monkeypatch.setattr(tuner_mod.Tuner, "_launch", spy)
    rt.init(num_cpus=2, resources={"GPU": 1})
    try:
        gang = TorchTrainer(
            prog.reports_loop, train_loop_config={"pkg": "ray_tpu_torch"},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(storage_path=str(tmp_path)))
        grid = tune.Tuner(
            gang, param_space={"lr": tune.grid_search([1.0, 2.0])},
            tune_config=tune.TuneConfig(metric="loss", mode="min")).fit()
        results = sorted(grid, key=lambda r: r.config["lr"])
        assert launches == [(1.0, "launched"), (2.0, "refused"),
                            (2.0, "launched")]
        assert [r.error for r in results] == [None, None]
        assert [[m["step"] for m in r.metrics_history]
                for r in results] == [[0, 1, 2], [0, 1, 2]]
        assert prog._poll(lambda: rt.available_resources().get("GPU"),
                          1.0) == 1.0
    finally:
        rt.shutdown()
