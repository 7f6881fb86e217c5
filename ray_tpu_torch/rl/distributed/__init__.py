"""The distributed RL substrate (port of ``ray_tpu/rl/distributed``).

Carried: the versioned pubsub weight fan-out (``fanout.py``) and
``new_plane_key``, which single-process IMPALA and APPO and the EnvRunner's
``enable_weight_sync`` use. The rollout actors, shard queue, policy
inference service and the distributed learners are ROADMAP.md queue 1's
next RL slice; their names raise."""

from ray_tpu_torch.rl.distributed.fanout import (  # noqa: F401
    WEIGHTS_CHANNEL,
    WeightFanout,
    WeightReceiver,
)
from ray_tpu_torch.rl.distributed.learner import new_plane_key  # noqa: F401

NOT_PORTED = ("DistributedDQN", "PolicyInference", "LearnerState",
              "RolloutPlane", "plane_stats", "DistributedIMPALA",
              "RolloutActor", "DESCRIPTOR_BYTE_BUDGET", "ShardQueue",
              "ShardQueueClosed", "TrajectoryShard")


def __getattr__(name):
    if name in NOT_PORTED:
        from ray_tpu_torch.core.errors import not_ported

        raise not_ported(f"rl.distributed.{name}",
                         "item 5, the distributed plane")
    raise AttributeError(name)
