"""ray_tpu_torch.train: distributed training orchestration (port of
``ray_tpu.train``; reference: Ray Train).

``TorchTrainer`` takes ``JaxTrainer``'s place. The pipeline plane
(``PipelinePlane``, ``StageActor``, ``PipelineError``) loads lazily, at
the first use of one of its names.
"""

from ray_tpu_torch.train.checkpoint import (  # noqa: F401
    Checkpoint,
    restore_pytree,
    save_pytree,
    temp_checkpoint_dir,
)
from ray_tpu_torch.train.config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.session import (  # noqa: F401
    get_checkpoint,
    get_dataset_shard,
    get_session,
    get_world_rank,
    get_world_size,
    report,
)
from ray_tpu_torch.train.trainer import Result, TorchTrainer  # noqa: F401


def __getattr__(name):
    # PipelinePlane pulls in the multihost/actor stack; keep the common
    # `from ray_tpu_torch import train` import light by resolving the
    # pipeline plane lazily. importlib, NOT a from-import: `from
    # ray_tpu_torch.train import pipeline_plane` consults THIS
    # __getattr__ before importing the submodule (infinite recursion).
    if name in ("PipelinePlane", "StageActor", "PipelineError",
                "pipeline_plane"):
        import importlib

        mod = importlib.import_module("ray_tpu_torch.train.pipeline_plane")
        if name == "pipeline_plane":
            return mod
        return getattr(mod, name)
    raise AttributeError(name)
