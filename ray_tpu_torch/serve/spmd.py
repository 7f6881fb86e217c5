"""The SPMD lockstep of a serving replica that spans a decode mesh.

The JAX package drives a mesh replica from one process: one controller
decides intake, cancels and deadlines and launches each program over
every device. Here each card has its own process, all running the same
engine, so every host decision that picks the next collective must be
the same on every rank, or the ranks issue different collectives and
hang. Token decisions already are: logits come back whole and bit-equal
on every rank, and samplers draw from identically seeded streams. Intake
and the clock are not, so rank 0 alone takes requests and reads the
clock, and at the start of every step (and of every idle wait) it
broadcasts one control message that every rank applies at the same point
of its loop.

The message travels over a gloo group of the mesh's ranks, created once,
so host objects never go through NCCL. It carries a counter of messages;
a rank that sees another counter than its own raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch.distributed as dist


class Lockstep:
    """Rank 0's per-step control broadcast to the other ranks of
    ``ranks`` (the mesh's global ranks, rank 0 first)."""

    def __init__(self, ranks: Sequence[int]):
        self.ranks = [int(r) for r in ranks]
        self.rank = dist.get_rank()
        self.lead = self.rank == self.ranks[0]
        self.group = (dist.group.WORLD if dist.get_backend() == "gloo"
                      and dist.get_world_size() == len(self.ranks)
                      else dist.new_group(self.ranks, backend="gloo"))
        self.sent = 0  # messages exchanged so far

    def exchange(self, message: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
        """Rank 0 passes its ``message``, every rank gets it back (the
        other ranks pass nothing)."""
        box = [dict(message, seq=self.sent) if self.lead else None]
        dist.broadcast_object_list(box, src=self.ranks[0], group=self.group)
        got = box[0]
        if got["seq"] != self.sent:
            raise RuntimeError(
                f"rank {self.rank} of the mesh replica is out of lockstep: "
                f"control message {got['seq']} from rank {self.ranks[0]}, "
                f"{self.sent} expected")
        self.sent += 1
        return got
