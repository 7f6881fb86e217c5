"""Mesh-shape parsing (the port's copy of ``parse_topology`` and
``most_square`` from ``ray_tpu/core/topology.py``, under the same names):
how a ``decode_mesh_shape`` string becomes a ``(batch, model)`` shape."""

from __future__ import annotations

from typing import Tuple


def parse_topology(spec: str) -> Tuple[int, int]:
    """``"2x4"`` -> (2, 4); a bare chip count folds to its most-square
    grid (``"8"`` -> (2, 4))."""
    spec = spec.strip().lower()
    if "x" in spec:
        a, b = spec.split("x", 1)
        return (int(a), int(b))
    return most_square(int(spec))


def most_square(chips: int) -> Tuple[int, int]:
    """The most-square (a, b) with a * b == chips and a <= b."""
    if chips < 1:
        raise ValueError(f"chips must be positive, got {chips}")
    a = int(chips ** 0.5)
    while a > 1 and chips % a:
        a -= 1
    return (a, chips // a)
