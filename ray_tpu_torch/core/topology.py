"""Accelerator topology as scheduler state: chips, hosts, slices and
their adjacency (copy of ``ray_tpu/core/topology.py``).

On the JAX package a slice is a TPU pod slice and its grid the ICI torus.
Here a node with cards advertises one slice per host (its NVLink domain),
sized by its ``GPU`` resource; the allocator, the cluster-wide
``TopologyView`` and the reservation model are the JAX package's,
unchanged. The dev box can still opt into a virtual slice with
``RAY_TPU_VIRTUAL_SLICE``. ``parse_topology`` and ``most_square`` also read
a ``decode_mesh_shape``.

* :class:`SliceInfo` — what a node advertises: its slice id, the chip
  grid, and chips per host.
* :class:`SliceGrid` — allocator for one slice: aligned, contiguous
  rectangular sub-slices, per-chip occupancy and fragmentation.
* :class:`TopologyView` — the controller's cluster-wide view: best-fit
  sub-slice reservation that never spans two slices, release, and an
  operator-readable state summary.

Pure host arithmetic: nothing here touches a card.
"""

from __future__ import annotations

import itertools
import os
import socket
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

_reservation_ids = itertools.count(1)


@dataclass(frozen=True)
class SliceInfo:
    """One pod slice as a node advertises it."""

    slice_id: str
    topology: Tuple[int, int]   # chip grid (x, y): the ICI footprint
    chips_per_host: int = 4

    @property
    def chips(self) -> int:
        return self.topology[0] * self.topology[1]

    @property
    def hosts(self) -> int:
        return max(1, self.chips // self.chips_per_host)

    def to_dict(self) -> Dict[str, Any]:
        return {"slice_id": self.slice_id,
                "topology": list(self.topology),
                "chips_per_host": self.chips_per_host}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SliceInfo":
        return SliceInfo(d["slice_id"], tuple(d["topology"]),
                         int(d.get("chips_per_host", 4)))


def parse_topology(spec: str) -> Tuple[int, int]:
    """``"2x4"`` -> (2, 4); a bare chip count folds to its most-square
    grid (``"8"`` -> (2, 4))."""
    spec = spec.strip().lower()
    if "x" in spec:
        a, b = spec.split("x", 1)
        return (int(a), int(b))
    return most_square(int(spec))


def most_square(chips: int) -> Tuple[int, int]:
    """The most-square (a, b) with a*b == chips and a <= b: the shape a
    chip-count reservation asks for when the caller has no mesh in mind
    (minimizes ICI hop diameter for a given footprint)."""
    if chips < 1:
        raise ValueError(f"chips must be positive, got {chips}")
    a = int(chips ** 0.5)
    while a > 1 and chips % a:
        a -= 1
    return (a, chips // a)


def detect_slice(resources: Optional[Dict[str, float]] = None,
                 node_hint: str = "") -> Optional[SliceInfo]:
    """What slice (if any) this node should advertise.

    A node with cards: the ``GPU`` resource gives the chip count; the
    slice is the node's own NVLink domain (one per host), so its id names
    the host and the node. Dev box: ``RAY_TPU_VIRTUAL_SLICE`` (e.g. ``"2x4"`` or ``"8"``) opts a
    CPU node into advertising a virtual slice over the forced host
    devices — serving tests and the single-process GSPMD path use this.
    An optional ``/N`` suffix (``"4x4/4"``) sets chips-per-host below
    the full slice, making the single dev-box node advertise a virtual
    MULTI-host slice (4x4 grid, 4 chips per host = 4 hosts) — the gang
    substrate (core/multihost.py) spawns one member per virtual host
    against it, the multi-raylet-in-one-machine trick at host
    granularity. Returns None when the node has no accelerator story
    (pure CPU nodes stay out of the topology view entirely)."""
    virt = os.environ.get("RAY_TPU_VIRTUAL_SLICE")
    if virt:
        spec, _, cph = virt.partition("/")
        topo = parse_topology(spec)
        return SliceInfo(f"virtual-{node_hint or os.getpid()}", topo,
                         chips_per_host=(int(cph) if cph
                                         else topo[0] * topo[1]))
    chips = int((resources or {}).get("GPU", 0))
    if chips <= 0:
        return None
    slice_id = f"gpu-{chips}-{socket.gethostname()}-{node_hint or os.getpid()}"
    return SliceInfo(slice_id, most_square(chips), chips_per_host=chips)


@dataclass(frozen=True)
class SubSlice:
    """A reserved contiguous rectangle of one slice's chip grid."""

    reservation_id: str
    slice_id: str
    origin: Tuple[int, int]
    shape: Tuple[int, int]

    @property
    def chips(self) -> int:
        return self.shape[0] * self.shape[1]

    def chip_ids(self) -> List[Tuple[int, int]]:
        ox, oy = self.origin
        return [(ox + i, oy + j) for i in range(self.shape[0])
                for j in range(self.shape[1])]

    def to_dict(self) -> Dict[str, Any]:
        return {"reservation_id": self.reservation_id,
                "slice_id": self.slice_id,
                "origin": list(self.origin), "shape": list(self.shape),
                "chips": self.chips}


class SliceGrid:
    """Sub-slice allocator for ONE slice. Not thread-safe: the owning
    TopologyView serializes access."""

    def __init__(self, info: SliceInfo):
        self.info = info
        self._used: Dict[Tuple[int, int], str] = {}  # chip -> reservation
        self._reservations: Dict[str, SubSlice] = {}

    @property
    def free_chips(self) -> int:
        return self.info.chips - len(self._used)

    def _fits(self, shape: Tuple[int, int]) -> bool:
        gx, gy = self.info.topology
        return shape[0] <= gx and shape[1] <= gy

    def _orientations(self, shape: Tuple[int, int]
                      ) -> List[Tuple[int, int]]:
        out = [shape]
        if shape[::-1] != shape:
            out.append(shape[::-1])
        return [s for s in out if self._fits(s)]

    def reserve(self, shape: Tuple[int, int],
                owner: str = "") -> Optional[SubSlice]:
        """Reserve an aligned contiguous ``shape`` rectangle; None when
        no aligned free block exists (the caller may try another slice,
        queue, or reject — NEVER assemble a fragment). Origins are
        multiples of the block shape (buddy alignment): frees coalesce
        by construction, so two released 2x2 neighbors are always
        re-reservable as either 2x2 — no compaction pass exists or is
        needed."""
        for sh in self._orientations(shape):
            gx, gy = self.info.topology
            for ox in range(0, gx - sh[0] + 1, sh[0]):
                for oy in range(0, gy - sh[1] + 1, sh[1]):
                    block = [(ox + i, oy + j) for i in range(sh[0])
                             for j in range(sh[1])]
                    if any(c in self._used for c in block):
                        continue
                    rid = f"sub-{next(_reservation_ids)}"
                    sub = SubSlice(rid, self.info.slice_id, (ox, oy), sh)
                    for c in block:
                        self._used[c] = rid
                    self._reservations[rid] = sub
                    return sub
        return None

    def release(self, reservation_id: str) -> bool:
        sub = self._reservations.pop(reservation_id, None)
        if sub is None:
            return False
        for c in sub.chip_ids():
            self._used.pop(c, None)
        return True

    def largest_free_block(self) -> int:
        """Chips in the largest aligned rectangle still reservable: the
        honest capacity signal (free_chips alone overstates a
        checkerboarded slice)."""
        best = 0
        gx, gy = self.info.topology
        for sx in _divisors(gx):
            for sy in _divisors(gy):
                if sx * sy <= best:
                    continue
                probe = [(i, j) for i in range(sx) for j in range(sy)]
                for ox in range(0, gx - sx + 1, sx):
                    for oy in range(0, gy - sy + 1, sy):
                        if all((ox + i, oy + j) not in self._used
                               for i, j in probe):
                            best = max(best, sx * sy)
                            break
                    else:
                        continue
                    break
        return best

    def fragmentation(self) -> float:
        """1 - largest_free_block / free_chips: 0 = all free capacity is
        one contiguous block, 1 = free chips exist but none are
        reservable together."""
        free = self.free_chips
        if free == 0:
            return 0.0
        return round(1.0 - self.largest_free_block() / free, 4)

    def summary(self) -> Dict[str, Any]:
        return {
            "slice_id": self.info.slice_id,
            "topology": list(self.info.topology),
            "chips": self.info.chips,
            "chips_per_host": self.info.chips_per_host,
            "hosts": self.info.hosts,
            "chips_free": self.free_chips,
            "largest_free_block": self.largest_free_block(),
            "fragmentation": self.fragmentation(),
            "reservations": {rid: sub.to_dict()
                             for rid, sub in self._reservations.items()},
        }


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


class TopologyView:
    """Cluster-wide slice registry + sub-slice scheduler (controller
    side). All methods are thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._grids: Dict[str, SliceGrid] = {}
        # slice id -> node ids (hex) advertising it (multi-host slices
        # have one node per TPU-VM host, all advertising the same slice).
        self._nodes: Dict[str, List[str]] = {}
        self._owners: Dict[str, str] = {}  # reservation id -> owner tag
        # Demoted hosts (autopilot taint-host action, or an operator):
        # node hex -> monotonic expiry deadline. A tainted host is a
        # placement PREFERENCE, not a hard exclusion — when every
        # feasible slice is tainted the reservation still succeeds
        # (capacity beats hygiene); taints only reorder choices.
        self._taints: Dict[str, float] = {}

    def register(self, node_hex: str, info: SliceInfo) -> None:
        with self._lock:
            grid = self._grids.get(info.slice_id)
            if grid is None:
                self._grids[info.slice_id] = SliceGrid(info)
            nodes = self._nodes.setdefault(info.slice_id, [])
            if node_hex not in nodes:
                nodes.append(node_hex)

    def node_dead(self, node_hex: str) -> None:
        """Forget a dead node; a slice with no live host left drops with
        its reservations (the owners' replicas died with the hosts)."""
        with self._lock:
            for slice_id in list(self._nodes):
                nodes = self._nodes[slice_id]
                if node_hex in nodes:
                    nodes.remove(node_hex)
                if not nodes:
                    grid = self._grids.pop(slice_id, None)
                    self._nodes.pop(slice_id, None)
                    if grid is not None:
                        for rid in list(grid._reservations):
                            self._owners.pop(rid, None)

    # ------------------------------------------------------------ taints

    def _live_taints(self) -> Dict[str, float]:
        """Prune expired taints; returns node hex -> expiry deadline.
        Caller holds ``_lock``."""
        now = time.monotonic()
        for node in [n for n, exp in self._taints.items() if exp <= now]:
            del self._taints[node]
        return self._taints

    def taint(self, node_hex: str, ttl_s: float) -> None:
        """Demote ``node_hex`` from new placement for ``ttl_s`` seconds.
        Re-tainting extends the deadline (never shortens it)."""
        deadline = time.monotonic() + max(0.0, float(ttl_s))
        with self._lock:
            self._taints[node_hex] = max(
                self._taints.get(node_hex, 0.0), deadline)

    def untaint(self, node_hex: str) -> bool:
        """Lift a taint early (probe-based re-admission, operator
        override). Returns whether a live taint existed."""
        with self._lock:
            self._live_taints()
            return self._taints.pop(node_hex, None) is not None

    def tainted(self) -> Dict[str, float]:
        """Live taints as node hex -> remaining seconds."""
        with self._lock:
            now = time.monotonic()
            return {n: round(exp - now, 3)
                    for n, exp in self._live_taints().items()}

    def reserve(self, owner: str, chips: int = 0,
                shape: Optional[Tuple[int, int]] = None
                ) -> Optional[Dict[str, Any]]:
        """Best-fit sub-slice reservation: the feasible slice with the
        fewest free chips wins (bin-packing keeps big contiguous blocks
        available for big replicas). A request larger than ANY single
        slice — or satisfiable only by combining fragments of several
        slices — returns None: ICI contiguity is a hard constraint, not
        a preference. Tainted hosts demote, they don't exclude: slices
        containing a tainted node sort after clean ones, and the
        returned node list is ordered untainted-first so rank->host
        assignment lands on healthy hosts when any exist."""
        if shape is None:
            shape = most_square(chips)
        shape = (int(shape[0]), int(shape[1]))
        with self._lock:
            taints = self._live_taints()
            order = sorted(self._grids.values(),
                           key=lambda g: (any(n in taints for n in
                                              self._nodes[g.info.slice_id]),
                                          g.free_chips,
                                          g.info.slice_id))
            for grid in order:
                sub = grid.reserve(shape, owner)
                if sub is not None:
                    self._owners[sub.reservation_id] = owner
                    out = sub.to_dict()
                    nodes = list(self._nodes[sub.slice_id])
                    out["nodes"] = ([n for n in nodes if n not in taints]
                                    + [n for n in nodes if n in taints])
                    return out
            return None

    def release(self, reservation_id: str) -> bool:
        with self._lock:
            self._owners.pop(reservation_id, None)
            return any(g.release(reservation_id)
                       for g in self._grids.values())

    def release_owner(self, owner: str) -> int:
        """Release every reservation ``owner`` holds (replica death
        cleanup); returns the count released."""
        with self._lock:
            rids = [rid for rid, o in self._owners.items() if o == owner]
            n = 0
            for rid in rids:
                self._owners.pop(rid, None)
                if any(g.release(rid) for g in self._grids.values()):
                    n += 1
            return n

    def state(self) -> Dict[str, Any]:
        with self._lock:
            now = time.monotonic()
            return {
                "slices": {sid: g.summary()
                           for sid, g in self._grids.items()},
                "nodes": {sid: list(nodes)
                          for sid, nodes in self._nodes.items()},
                "owners": dict(self._owners),
                "taints": {n: round(exp - now, 3)
                           for n, exp in self._live_taints().items()},
            }
