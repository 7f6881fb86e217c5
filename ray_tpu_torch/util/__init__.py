"""ray_tpu_torch.util: ActorPool, Queue, host-side collectives."""

from ray_tpu_torch.util.actor_pool import ActorPool  # noqa: F401
from ray_tpu_torch.util.queue import Empty, Full, Queue  # noqa: F401
