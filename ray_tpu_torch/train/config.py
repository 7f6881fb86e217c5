"""Train configuration dataclasses (port of ``ray_tpu/train/config.py``).

Analogue of the reference's typed config surface
(``python/ray/air/config.py``: ``ScalingConfig`` :95, ``RunConfig``,
``FailureConfig`` :395, ``CheckpointConfig``). Where the JAX package
leases TPU chips (``use_tpu`` / ``tpu_chips_per_worker``), a worker here
leases cards as the runtime's ``GPU`` resource (``use_gpu`` /
``gpus_per_worker``); a GPU-leased worker is a fresh interpreter
(``core/node.py``). ``torch_config``
(``train.torch_backend.TorchConfig``) asks for one ``torch.distributed``
process group across the gang, as ``jax_config`` asks for one
``jax.distributed`` runtime.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class ScalingConfig:
    num_workers: int = 1
    resources_per_worker: Dict[str, float] = field(
        default_factory=lambda: {"CPU": 1.0})
    use_gpu: bool = False
    gpus_per_worker: float = 1.0
    placement_strategy: str = "PACK"
    # One torch.distributed process group across the worker gang; see
    # ray_tpu_torch.train.torch_backend.TorchConfig.
    torch_config: Optional[Any] = None
    use_tpu: bool = False

    def __post_init__(self):
        if self.use_tpu:
            raise ValueError("use_tpu has no chip to lease on "
                             "ray_tpu_torch; pass use_gpu")

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker)
        if self.use_gpu and self.gpus_per_worker:
            res["GPU"] = float(self.gpus_per_worker)
        return res


@dataclass
class FailureConfig:
    """Restart-based recovery: on any worker failure the whole group is torn
    down and relaunched from the latest reported checkpoint (reference:
    ``backend_executor.py:727`` retry loop; elasticity is intentionally out of
    scope at this snapshot, matching the reference)."""

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
