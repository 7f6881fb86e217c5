"""Podracer-style distributed RL substrate (port of
``ray_tpu/rl/distributed``; PAPERS.md: "Podracer architectures for
scalable Reinforcement Learning", RLAX).

Actor/learner split over the runtime's existing planes: trajectory
shards transit the OBJECT plane (descriptors only on the RPC plane),
weights fan out versioned over core PUBSUB, policy inference optionally
runs as a batched SERVE-style service on the learner's card (sebulba
split, holding the node's ``GPU`` lease), and the learner is one
in-process host on its ``device``. Rollout actors are CPU workers.
"""

from ray_tpu_torch.rl.distributed.dqn import DistributedDQN  # noqa: F401
from ray_tpu_torch.rl.distributed.fanout import (  # noqa: F401
    WEIGHTS_CHANNEL,
    WeightFanout,
    WeightReceiver,
)
from ray_tpu_torch.rl.distributed.inference import (  # noqa: F401
    PolicyInference,
)
from ray_tpu_torch.rl.distributed.learner import (  # noqa: F401
    LearnerState,
    RolloutPlane,
    new_plane_key,
    plane_stats,
)
from ray_tpu_torch.rl.distributed.onpolicy import (  # noqa: F401
    DistributedIMPALA,
)
from ray_tpu_torch.rl.distributed.rollout import RolloutActor  # noqa: F401
from ray_tpu_torch.rl.distributed.shard import (  # noqa: F401
    DESCRIPTOR_BYTE_BUDGET,
    ShardQueue,
    ShardQueueClosed,
    TrajectoryShard,
)
