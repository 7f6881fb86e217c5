"""Placement groups: gang reservation of resource bundles across nodes.

Analogue of the reference's ``python/ray/util/placement_group.py`` API over
the GCS-side 2PC scheduler (``gcs_placement_group_scheduler.h``). Strategies
PACK / SPREAD / STRICT_PACK / STRICT_SPREAD match ``common.proto:937-944``.
A placement group is the gang-scheduling primitive: a slice of hosts is
reserved as one STRICT_SPREAD group with a bundle per host (the JAX
package's ``ray_tpu/tpu.py::slice_placement_group`` does it for a TPU pod
slice; the port reserves a node's cards through ``reserve_subslice`` and
``HostGroup``), generalizing the reference's ``TPU-{pod_type}-head``
resource hack (``_private/accelerators/tpu.py:381``) into a
scheduler-native mechanism.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.errors import RayTpuError
from ray_tpu_torch.core.ids import PlacementGroupID
from ray_tpu_torch.core.rpc_stubs import ControllerStub
from ray_tpu_torch.core.runtime import get_core_worker

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID,
                 bundles: List[Dict[str, float]], strategy: str):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy

    def ready(self, timeout: float = 30.0) -> bool:
        """Block until all bundles are reserved (reference: ``pg.ready()``)."""
        core = get_core_worker()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            stub = ControllerStub(core.controller)
            info = stub.get_placement_group(self.id.binary())
            if info is not None and info["state"] == "CREATED":
                return True
            # Retry the 2PC reservation (capacity may have freed up).
            info = stub.create_placement_group(
                self.id.binary(), self.bundles, self.strategy)
            if info.get("state") == "CREATED":
                return True
            time.sleep(0.2)
        return False

    def bundle_node(self, index: int):
        """Return (node_id_bytes, node_addr) hosting bundle ``index``."""
        core = get_core_worker()
        info = ControllerStub(core.controller).get_placement_group(
            self.id.binary())
        if info is None or index not in info["placement"]:
            raise RayTpuError(f"bundle {index} of pg {self.id.hex()} not placed")
        return info["placement"][index]

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles, self.strategy))


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK") -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    core = get_core_worker()
    pg_id = PlacementGroupID.from_random()
    ControllerStub(core.controller).create_placement_group(
        pg_id.binary(), [dict(b) for b in bundles], strategy)
    return PlacementGroup(pg_id, [dict(b) for b in bundles], strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    core = get_core_worker()
    ControllerStub(core.controller).remove_placement_group(
        pg.id.binary())


# ------------------------------------------------ sub-slice reservations
#
# The mesh-parallel serving primitive (ROADMAP #1): a GSPMD replica does
# not want "n chips somewhere" — it wants an ICI-CONTIGUOUS rectangle of
# ONE slice's chip grid. The controller's TopologyView owns the grids
# (nodes advertise their slice at registration, core/topology.py); this
# is the client half.


class SubSliceReservation:
    """A held sub-slice: release it when the replica spanning it dies."""

    def __init__(self, assignment: Dict[str, Any]):
        self.assignment = dict(assignment)

    @property
    def reservation_id(self) -> str:
        return self.assignment["reservation_id"]

    @property
    def slice_id(self) -> str:
        return self.assignment["slice_id"]

    @property
    def chips(self) -> int:
        return int(self.assignment["chips"])

    @property
    def nodes(self) -> List[str]:
        return list(self.assignment.get("nodes", []))

    def release(self) -> bool:
        core = get_core_worker()
        return ControllerStub(core.controller).release_subslice(
            self.reservation_id)

    def __repr__(self):
        return (f"SubSliceReservation({self.reservation_id!r}, "
                f"slice={self.slice_id!r}, shape="
                f"{tuple(self.assignment['shape'])})")


def reserve_subslice(chips: int = 0,
                     shape: Optional[Any] = None,
                     owner: str = "") -> Optional[SubSliceReservation]:
    """Reserve a contiguous sub-slice (``shape`` = chip-grid rectangle,
    e.g. a replica's ``(batch, model)`` mesh footprint; bare ``chips``
    folds to the most-square block). Returns None when no single
    advertised slice can host it contiguously — the caller queues or
    rejects, it never gets a fragment straddling slices."""
    core = get_core_worker()
    sub = ControllerStub(core.controller).reserve_subslice(
        owner or f"driver-{os.getpid()}",
        int(chips), list(shape) if shape is not None else None)
    return SubSliceReservation(sub) if sub is not None else None


def cluster_topology() -> Dict[str, Any]:
    """Every advertised slice's grid, free chips, fragmentation, and
    live sub-slice reservations (controller ``topology_state`` RPC)."""
    core = get_core_worker()
    return ControllerStub(core.controller).topology_state()


class PlacementGroupSchedulingStrategy:
    """Pin a task/actor to a bundle of a placement group (reference:
    ``util/scheduling_strategies.py``)."""

    def __init__(self, placement_group: PlacementGroup,
                 placement_group_bundle_index: int = 0):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft
