"""Resource-set arithmetic shared by controller and node.

Analogue of the reference's resource model (``src/ray/common/scheduling/
resource_instance_set.h`` + ``fixed_point.h``): the reference uses fixed-point
integers to avoid float drift; here a single epsilon-tolerant helper set keeps
controller and node feasibility decisions consistent (one definition, not
four).
"""

from __future__ import annotations

from typing import Dict, Optional

EPS = 1e-9

# Accelerator-count keys in the resource vector. ``CHIPS`` is the
# node-level accelerator count (TPU chips, or virtual devices on the dev
# box); ``slice:<id>`` keys bind that count to a named pod slice so a
# mesh-parallel replica's reservation is accounted against the RIGHT
# slice, not a pooled cluster total. Both are plain scalar resources —
# fits/take/credit below need no special cases (the whole point of
# keeping the vector a flat dict).
CHIPS = "chips"
SLICE_PREFIX = "slice:"


def chip_count(res: Dict[str, float]) -> float:
    """Accelerator chips in a resource vector (0.0 when none)."""
    return res.get(CHIPS, 0.0)


def slice_key(slice_id: str) -> str:
    return SLICE_PREFIX + slice_id


def slice_of(res: Dict[str, float]) -> Optional[str]:
    """The slice id a resource vector is bound to (first ``slice:`` key),
    or None for slice-agnostic vectors."""
    for k in res:
        if k.startswith(SLICE_PREFIX):
            return k[len(SLICE_PREFIX):]
    return None


def chip_resources(chips: float,
                   slice_id: Optional[str] = None) -> Dict[str, float]:
    """Resource vector for ``chips`` accelerators, optionally bound to a
    slice (what a sub-slice replica requests and a node advertises)."""
    out = {CHIPS: float(chips)}
    if slice_id:
        out[slice_key(slice_id)] = float(chips)
    return out


def fits(avail: Dict[str, float], req: Dict[str, float]) -> bool:
    """True if ``req`` fits in ``avail`` (missing keys = 0)."""
    return all(avail.get(k, 0.0) + EPS >= v for k, v in req.items())


def take(avail: Dict[str, float], req: Dict[str, float]) -> bool:
    """Atomically deduct ``req`` from ``avail`` if it fits. Caller holds the
    lock protecting ``avail``."""
    if not fits(avail, req):
        return False
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) - v
    return True


def deduct(avail: Dict[str, float], req: Dict[str, float]) -> None:
    """Deduct without a feasibility check (optimistic accounting)."""
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) - v


def credit(avail: Dict[str, float], req: Dict[str, float]) -> None:
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) + v
