"""Low-level ``torch.distributed`` bootstrap: the per-PROCESS half of
process-group formation (the counterpart of ``ray_tpu/train/jax_backend.py``).

The reference's own torch process-group setup
(``train/torch/config.py:65-170``: ``_setup_torch_process_group``) driven
by the gang: rank 0's host serves the tcp rendezvous, every worker calls
``init_process_group`` through ``parallel/mesh.py::init_distributed``, and
the result is one default process group a ``MeshSpec`` builds its mesh
over. One process drives one card: NCCL on the card the worker's
``local_rank`` names, gloo only when the caller asks for
``device_type="cpu"`` (the CPU test rig: N worker processes on one
machine). Without a card and without that argument the join raises.

GANG orchestration lives one layer up in ``ray_tpu_torch.core.multihost``
(group registration, the barrier'd bootstrap-fingerprint check, epoch
fencing); this module only knows how to join ONE process to an
already-agreed-on rendezvous.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from typing import Optional


@dataclass
class TorchConfig:
    """Backend config selecting how train workers form the process group.

    ``distributed=False`` (default): no process group — correct for one
    worker on one card. ``distributed=True``: the worker group forms one
    ``torch.distributed`` group across all workers. ``device_type="cpu"``
    asks for gloo (the JAX package's ``platform="cpu"``); ``None`` means
    the card and NCCL. There is no ``local_device_count``: one device per
    process.
    """

    distributed: bool = False
    device_type: Optional[str] = None
    # Rendezvous port; 0 = pick a free one on rank 0's host.
    coordinator_port: int = 0


def pick_coordinator_address(port: int = 0) -> str:
    """Rank-0 side: an address other workers can reach this host on."""
    host = _routable_host()
    if port == 0:
        with socket.socket() as s:
            s.bind(("", 0))
            port = s.getsockname()[1]
    return f"{host}:{port}"


def _routable_host() -> str:
    """This worker's address as seen by peers: the core runtime's RPC bind
    address when inside a worker, else loopback."""
    from ray_tpu_torch.core.runtime import get_core_worker, is_initialized

    return get_core_worker().addr[0] if is_initialized() else "127.0.0.1"


def init_process(coordinator_address: str, num_processes: int,
                 process_id: int, local_rank: int = 0,
                 device_type: Optional[str] = None) -> int:
    """Join this process to the gang's process group (rank
    ``process_id``, on ``cuda:local_rank`` unless ``device_type="cpu"``).
    Returns the world size. Idempotent per process."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import init_distributed

    if not dist.is_initialized():
        init_distributed(process_id, num_processes,
                         init_method=f"tcp://{coordinator_address}",
                         device_type=device_type, local_rank=local_rank)
    return dist.get_world_size()


def shutdown_process() -> None:
    """Destroy the default process group (between attempts in one
    process)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
