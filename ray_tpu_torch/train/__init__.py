"""ray_tpu_torch.train: distributed training orchestration (port of
``ray_tpu.train``; reference: Ray Train).

``TorchTrainer`` takes ``JaxTrainer``'s place; the pipeline plane
(``PipelinePlane``, ``StageActor``, ``PipelineError``) is not ported yet
(ROADMAP.md queue 1, item 4) and its names raise.
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
    if name in ("PipelinePlane", "StageActor", "PipelineError",
                "pipeline_plane"):
        from ray_tpu_torch.core.errors import not_ported

        raise not_ported(f"train.{name}", "item 4, the pipeline plane")
    raise AttributeError(name)
