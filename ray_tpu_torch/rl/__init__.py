"""ray_tpu_torch.rl: reinforcement learning at scale (port of
``ray_tpu.rl``; reference: RLlib).

The algorithms and offline RL, with the learner on the card: PPO,
IMPALA, APPO, DQN, SAC, CQL, BC and multi-agent PPO, and the distributed
plane (``DistributedDQN``, ``DistributedIMPALA``, ``PolicyInference``,
``RolloutActor``, ``ShardQueue``, ``TrajectoryShard``). Importing the
package imports no gymnasium; building an env-driven algorithm does.
"""

from ray_tpu_torch.rl.bc import BC, BCConfig, collect_dataset  # noqa: F401
from ray_tpu_torch.rl.checkpointing import (  # noqa: F401
    Checkpointable,
    as_trainable,
)
from ray_tpu_torch.rl.appo import APPO, APPOConfig  # noqa: F401
from ray_tpu_torch.rl.cql import CQL, CQLConfig  # noqa: F401
from ray_tpu_torch.rl.offline import (  # noqa: F401
    dataset_to_buffer,
    load_transitions,
    rollouts_to_dataset,
    save_transitions,
)
from ray_tpu_torch.rl.distributed import (  # noqa: F401
    DistributedDQN,
    DistributedIMPALA,
    PolicyInference,
    RolloutActor,
    ShardQueue,
    TrajectoryShard,
)
from ray_tpu_torch.rl.dqn import DQN, DQNConfig  # noqa: F401
from ray_tpu_torch.rl.env_runner import EnvRunner  # noqa: F401
from ray_tpu_torch.rl.replay import ReplayBuffer, SumTree  # noqa: F401
from ray_tpu_torch.rl.impala import IMPALA, IMPALAConfig, vtrace  # noqa: F401
from ray_tpu_torch.rl.models import (  # noqa: F401
    build_policy,
    init_mlp_policy,
    mlp_forward,
)
from ray_tpu_torch.rl.multi_agent import (  # noqa: F401
    MultiAgentEnv,
    MultiAgentEnvRunner,
    MultiAgentPPO,
    MultiAgentPPOConfig,
)
from ray_tpu_torch.rl.ppo import PPO, PPOConfig, compute_gae  # noqa: F401
from ray_tpu_torch.rl.sac import SAC, SACConfig  # noqa: F401
