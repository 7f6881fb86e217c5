"""Device meshes (port of ``ray_tpu/parallel/mesh.py``).

Parallelism is declared, as in the JAX package: a ``DeviceMesh`` with the
named axes ``AXES``, over which ``parallel.sharding``'s rule tables place
tensors (DTensor placements).

| axis       | strategy                  | collective                        |
|------------|---------------------------|-----------------------------------|
| ``data``   | data parallel             | all-reduce of the gradients       |
| ``fsdp``   | sharded data parallel     | all-gather params, reduce-scatter |
| ``tensor`` | tensor (Megatron) parallel| all-reduce of activations         |
| ``seq``    | sequence parallel         | send/recv ring (ring attention)   |
| ``expert`` | expert parallel (MoE)     | token exchange                    |

A mesh spans the ranks of the default process group: one rank per card
over NCCL, or, when the caller passes ``device_type="cpu"``, one process
per mesh position over gloo (the tests' stand-in for the JAX package's
virtual 8-device CPU mesh). Without a card and without that argument
``build`` raises, as ``core.device.resolve_device`` does. Size-1 axes are
kept in the mesh, so every mesh has the five names.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from datetime import timedelta
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ray_tpu_torch.core.device import resolve_device

AXES = ("data", "fsdp", "tensor", "seq", "expert")


def _device_type(device_type: Optional[str]) -> str:
    """``None`` means ``cuda`` (raising without a card); ``cpu`` is the
    only route to gloo."""
    return resolve_device(device_type).type


def backend_for(device_type: Optional[str]) -> str:
    return "gloo" if _device_type(device_type) == "cpu" else "nccl"


def init_distributed(rank: int = 0, world_size: int = 1,
                     init_method: Optional[str] = None,
                     device_type: Optional[str] = None,
                     timeout_s: float = 120.0) -> None:
    """Initialize the default process group for the mesh: NCCL on the
    card (rank ``r`` on ``cuda:r % device_count``), gloo only when the
    caller passes ``device_type="cpu"``. ``init_method`` is a rendezvous
    URL (``file://...`` or ``tcp://localhost:<port>``); a world of one
    rendezvouses in process and needs none."""
    dtype = _device_type(device_type)
    if dtype == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kwargs = dict(backend=backend_for(device_type), rank=rank,
                  world_size=world_size, timeout=timedelta(seconds=timeout_s))
    if init_method is None:
        if world_size != 1:
            raise ValueError("a world of more than one rank needs an "
                             "init_method to rendezvous through")
        kwargs["store"] = dist.HashStore()
    else:
        kwargs["init_method"] = init_method
    if dtype == "cuda":
        kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(**kwargs)


def _world(n_devices: int, device_type: str) -> None:
    """Make sure a default group exists: a world of one is set up in
    process; a larger world is the caller's to initialize."""
    if dist.is_initialized():
        return
    if n_devices != 1:
        raise RuntimeError(
            f"a mesh of {n_devices} ranks needs the default process group: "
            f"call parallel.mesh.init_distributed in every rank first")
    init_distributed(0, 1, None, device_type)


def _device_mesh(device_type: str, sizes: Tuple[int, ...],
                 names: Tuple[str, ...], ranks: Optional[Sequence[int]]):
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if ranks is None:
        return init_device_mesh(device_type, sizes, mesh_dim_names=names)
    mesh = torch.as_tensor(list(ranks), dtype=torch.int).reshape(sizes)
    return DeviceMesh(device_type, mesh, mesh_dim_names=names)


def _ranks(devices: Optional[Sequence[int]]) -> Optional[Sequence[int]]:
    return None if devices is None else [int(d) for d in devices]


@dataclass(frozen=True)
class MeshSpec:
    """A named parallelism layout. Sizes must multiply to the rank count
    (a -1 entry is inferred, like a reshape). ``dcn_data > 1`` declares
    that many data-parallel replicas across slower links; the factor
    folds into the ``data`` axis as its slowest-varying part, so the
    rule tables are unchanged."""

    data: int = 1
    fsdp: int = -1
    tensor: int = 1
    seq: int = 1
    expert: int = 1
    dcn_data: int = 1

    def sizes(self, n_devices: int) -> Tuple[int, ...]:
        """Final per-axis sizes (dcn folded into data)."""
        if n_devices % self.dcn_data:
            raise ValueError(
                f"{n_devices} devices not divisible across "
                f"{self.dcn_data} slices")
        per_slice = self._ici_sizes(n_devices // self.dcn_data)
        return (per_slice[0] * self.dcn_data,) + per_slice[1:]

    def _ici_sizes(self, n_devices: int) -> Tuple[int, ...]:
        sizes = [self.data, self.fsdp, self.tensor, self.seq, self.expert]
        if sizes.count(-1) > 1:
            raise ValueError("at most one mesh axis may be -1")
        known = math.prod(s for s in sizes if s != -1)
        if -1 in sizes:
            if n_devices % known != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by {known}")
            sizes[sizes.index(-1)] = n_devices // known
        if math.prod(sizes) != n_devices:
            raise ValueError(
                f"mesh {dict(zip(AXES, sizes))} needs {math.prod(sizes)} "
                f"devices, have {n_devices}")
        return tuple(sizes)

    def build(self, devices: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None):
        """The ``DeviceMesh`` over ``devices`` (global ranks; default: every
        rank of the default group), named ``AXES``, size-1 axes kept.
        Ranks fill the mesh in row-major order, so with ``dcn_data`` the
        slice index is the slowest-varying factor of ``data``."""
        dtype = _device_type(device_type)
        ranks = _ranks(devices)
        n = len(ranks) if ranks is not None else (
            dist.get_world_size() if dist.is_initialized() else 1)
        sizes = self.sizes(n)
        _world(n, dtype)
        return _device_mesh(dtype, sizes, AXES, ranks)


def single_device_mesh(device_type: Optional[str] = None):
    """A mesh of one rank (every axis of size 1)."""
    return MeshSpec(data=1, fsdp=1).build([0], device_type)


# Serving meshes name their two axes apart from AXES, so train and serve
# rule tables cannot cross.
DECODE_AXES = ("batch", "model")


def decode_mesh(shape: Tuple[int, int],
                devices: Optional[Sequence[int]] = None,
                device_type: Optional[str] = None):
    """Named 2-D serving mesh ``(batch, model)`` over the first
    ``batch * model`` ranks (or the explicit ``devices``)."""
    b, m = int(shape[0]), int(shape[1])
    if b < 1 or m < 1:
        raise ValueError(f"mesh shape must be positive, got {shape}")
    dtype = _device_type(device_type)
    ranks = _ranks(devices)
    if ranks is None:
        ranks = list(range(b * m))
    if len(ranks) != b * m:
        raise ValueError(
            f"decode mesh {b}x{m} needs {b * m} devices, have {len(ranks)}")
    _world(b * m, dtype)
    return _device_mesh(dtype, (b, m), DECODE_AXES, ranks)


def axis_sizes(mesh: Union[Mapping[str, int], object]) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of a mapping, which
    is returned as a dict): the JAX ``mesh.shape``."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def preset_for(n_devices: int, model_params: int = 0) -> MeshSpec:
    """Heuristic preset: small models pure fsdp; big models tensor-shard
    within a host and fsdp across."""
    if model_params >= 30_000_000_000 and n_devices >= 8:
        return MeshSpec(tensor=8, fsdp=-1)
    if model_params >= 6_000_000_000 and n_devices >= 4:
        return MeshSpec(tensor=4, fsdp=-1)
    return MeshSpec(fsdp=-1)
