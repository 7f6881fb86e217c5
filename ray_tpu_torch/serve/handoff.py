"""KV-page handoff ledger: the prefill->decode lease of disaggregated
serving (copy of ``ray_tpu/serve/handoff.py``).

Disaggregated serving splits a request across two deployments: a PREFILL
deployment absorbs the prompt into its paged pool, then publishes the
filled KV pages as object-plane refs plus a few hundred bytes of
descriptor; a DECODE deployment adopts the pages into its own pool and
streams from the first decode step. Between publish and adopt the pages
live as host-side objects owned by the prefill side (in the port, on the
runtime's shared-memory object store through ``core/api.py``); this
ledger is the accounting for that window.

Lease discipline: ``publish_handoff`` registers a descriptor whose refs
the process keeps alive; ``discharge_handoff`` (adopt-ack or abort, either
way) must run on every exception path. The escape hatch for a caller that
died mid-splice is ``sweep()``, driven by the deployment's
``replica_metrics``: it expires entries past ``serve_handoff_ttl_s`` and
hands their refs back to the caller to free. Expiry after a successful
adopt is harmless: the decode side already fetched the bytes.
"""

from __future__ import annotations

import pickle
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.config import config as rt_config

# Budget on the serialized DESCRIPTOR (refs + block geometry + first
# token, never the page payload, which rides the object plane): the
# router splice forwards it inline with the request, so it must stay
# RPC-header-sized.
HANDOFF_DESC_BYTE_BUDGET = 8192


def descriptor_nbytes(desc: Dict[str, Any]) -> int:
    """Serialized size of a handoff descriptor (the object plane's refs
    pickle to their ids, tens of bytes each, never the payload)."""
    return len(pickle.dumps(desc, protocol=5))


class HandoffLedger:
    """Per-replica registry of published-but-undischarged handoffs.

    Thread-safe: publish runs on request threads, sweep on the
    ``replica_metrics`` pull path. Entries are keyed by the descriptor's
    ``handoff_id``; values keep the publish timestamp so discharge can
    report the publish->adopt latency."""

    def __init__(self, ttl_s: Optional[float] = None):
        self._ttl_s = (rt_config.serve_handoff_ttl_s
                       if ttl_s is None else float(ttl_s))
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict[str, Any]] = {}

    # ------------------------------------------------------------ lease

    def publish_handoff(self, desc: Dict[str, Any]) -> Dict[str, Any]:
        """Register a published handoff; the caller owns discharging it
        (adopt-ack or abort) on every path. Returns ``desc``."""
        with self._lock:
            self._entries[desc["handoff_id"]] = {
                "desc": desc, "t_publish": time.monotonic()}
        return desc

    def discharge_handoff(self, handoff_id: str
                          ) -> Optional[Dict[str, Any]]:
        """Pop a published entry (adopt-ack, abort, or expiry all land
        here). Returns ``{"desc", "age_s"}`` or None when the entry was
        already discharged: discharge is idempotent by design, since the
        caller's abort path and the TTL sweep may race, and both sides
        freeing is a double-free only the ledger can referee."""
        with self._lock:
            entry = self._entries.pop(handoff_id, None)
        if entry is None:
            return None
        return {"desc": entry["desc"],
                "age_s": time.monotonic() - entry["t_publish"]}

    # ------------------------------------------------------------ sweep

    def sweep(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Pop entries older than the TTL and return them (desc +
        age_s); the caller frees their refs and counts them expired.
        Rides ``replica_metrics``, so whoever polls the deployment's
        metrics doubles as the returns-the-pages backstop."""
        now = time.monotonic() if now is None else now
        expired: List[Dict[str, Any]] = []
        with self._lock:
            for hid in [h for h, e in self._entries.items()
                        if now - e["t_publish"] > self._ttl_s]:
                entry = self._entries.pop(hid)
                expired.append({"desc": entry["desc"],
                                "age_s": now - entry["t_publish"]})
        return expired

    # ------------------------------------------------------------ stats

    def live(self) -> int:
        with self._lock:
            return len(self._entries)

    def live_bytes(self) -> int:
        """Payload bytes pinned by undischarged handoffs (the number
        that says whether the prefill fleet is leaking)."""
        with self._lock:
            return sum(int(e["desc"].get("nbytes", 0))
                       for e in self._entries.values())
