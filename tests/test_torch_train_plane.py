"""The port's train plane (``TorchTrainer``, worker groups, sessions,
checkpoints through storage, restarts) held against the JAX package's
``JaxTrainer`` on the CPU.

One user program (``torch_train_program.train_program``: single-worker
reports, the world info of 3 workers, a checkpoint round trip, recovery
from a worker process killed after its step-1 checkpoint, an exhausted
failure budget, the session API outside a loop) runs on ``ray_tpu`` and
then on ``ray_tpu_torch``, each in a cluster of its own (init, run,
shutdown; never both up). Results and error class names must be equal."""

import pytest

import torch_train_program as prog

RUNS = ("ray_tpu", "ray_tpu_torch")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import importlib

    tmp = str(tmp_path_factory.mktemp("train_plane"))
    out = {}
    for pkg in RUNS:
        rt = importlib.import_module(pkg)
        rt.init(num_cpus=4)
        try:
            out[pkg] = prog.train_program(pkg, tmp)
        finally:
            rt.shutdown()
    return out


@pytest.mark.parametrize("key", ["reports", "world", "checkpoint",
                                 "recover", "exhausted", "no_session",
                                 "no_session_rank", "cpus_back"])
def test_program_matches_jax_trainer(results, key):
    assert results["ray_tpu_torch"][key] == results["ray_tpu"][key]


def test_single_worker_reports(results):
    got = results["ray_tpu_torch"]["reports"]
    assert got["error"] is None and len(got["history"]) == 3
    assert got["metrics"]["loss"] == pytest.approx(1.0 / 3)


def test_world_info_of_three_workers(results):
    got = results["ray_tpu_torch"]["world"]
    assert got["metrics"] == {"rank": 0, "world": 3}  # rank 0's metrics


def test_checkpoint_round_trip(results):
    got = results["ray_tpu_torch"]["checkpoint"]
    assert got["checkpoint"] == "checkpoint_000002"
    assert got["state"] == {"step": 1}


def test_failure_recovery_resumes_from_checkpoint(results):
    got = results["ray_tpu_torch"]["recover"]
    assert got["error"] is None, got["error"]
    assert got["metrics"] == {"step": 3, "resumed_from": 2}
    assert got["checkpoint"] == "checkpoint_000002"


def test_failure_budget_exhausted(results):
    got = results["ray_tpu_torch"]["exhausted"]
    assert got == {"failed": True, "says": True, "metrics": None}


def test_session_api_outside_a_loop(results):
    assert results["ray_tpu_torch"]["no_session"] == "RuntimeError"
    assert results["ray_tpu_torch"]["no_session_rank"] == "RuntimeError"


def test_not_ported_surfaces_name_their_item():
    """``datasets=`` and ``get_dataset_shard`` are ported (outside a loop
    the shard call raises as the JAX package's does); the pipeline plane's
    names resolve to ``train.pipeline_plane``'s classes; ``use_tpu`` has
    no chip to lease, as ``num_tpus`` has none."""
    from ray_tpu import train as jtrain
    from ray_tpu_torch import train
    from ray_tpu_torch.train import session

    trainer = train.TorchTrainer(prog.failing_loop,
                                 datasets={"train": object()})
    assert trainer.scaling_config.num_workers == 1
    with pytest.raises(RuntimeError, match="No train session active"):
        train.get_dataset_shard("train")
    with pytest.raises(RuntimeError, match="No train session active"):
        jtrain.get_dataset_shard("train")
    session.init_session(session.TrainSession(session.WorldInfo(), None,
                                              "shardless"))
    try:
        with pytest.raises(KeyError, match=r"no dataset shard 'eval'; pass "
                           r"datasets=\{'eval': ds\} to TorchTrainer "
                           r"\(have: \[\]\)"):
            train.get_dataset_shard("eval")
    finally:
        session._session.value = None
    from ray_tpu_torch.train import pipeline_plane

    for name in ("PipelinePlane", "StageActor", "PipelineError"):
        assert getattr(train, name) is getattr(pipeline_plane, name)
    assert train.pipeline_plane is pipeline_plane
    with pytest.raises(ValueError, match="use_gpu"):
        train.ScalingConfig(use_tpu=True)
    assert train.ScalingConfig(use_gpu=True).worker_resources() == {
        "CPU": 1.0, "GPU": 1.0}
    assert train.ScalingConfig(use_gpu=True, gpus_per_worker=2,
                               resources_per_worker={"CPU": 4}
                               ).worker_resources() == {"CPU": 4, "GPU": 2.0}
    assert train.ScalingConfig().worker_resources() == {"CPU": 1.0}


def test_config_defaults_match_jax():
    """``FailureConfig``, ``CheckpointConfig`` and ``RunConfig`` are the
    JAX package's; ``ScalingConfig`` differs only in its card fields."""
    from dataclasses import asdict, fields

    from ray_tpu.train import config as jc
    from ray_tpu_torch.train import config as tc

    for name in ("FailureConfig", "CheckpointConfig", "RunConfig"):
        assert asdict(getattr(tc, name)()) == asdict(getattr(jc, name)())
    jax_fields = {f.name for f in fields(jc.ScalingConfig)}
    torch_fields = {f.name for f in fields(tc.ScalingConfig)}
    assert jax_fields - torch_fields == {"tpu_chips_per_worker",
                                         "jax_config"}
    assert torch_fields - jax_fields == {"use_gpu", "gpus_per_worker",
                                         "torch_config"}
