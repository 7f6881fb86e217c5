"""GPU detection, peak rates and host-group placement (the port's
counterpart of ``ray_tpu/tpu.py``, with the same function names).

Analogue of the reference's ``python/ray/_private/accelerators/
nvidia_gpu.py``: cards are counted with ``nvidia-smi`` (``core/api.py``
``detect_gpus``), never through a CUDA call in this process, and the gang
primitive is a placement group over per-host bundles, as in the JAX
module.

``peak_flops_per_chip`` reads a table of dense bf16 tensor-core peaks
from NVIDIA's data sheets (no sparsity): H100 SXM 989 TFLOP/s, H100 PCIe
756, H100 NVL 835, A100 312. A kind string that names none of them gets
the H100 SXM's 989 TFLOP/s, the card the port is built for, as the JAX
function gives an unknown TPU kind the v5e's peak.

A slice is named ``"<kind>-<cards>"`` (for example ``"h100-16"``), the
form of a TPU pod type; a host holds 8 cards unless told otherwise.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

# Cards per host of common NVIDIA servers (HGX / DGX boards hold 8).
_CHIPS_PER_HOST_DEFAULT = 8

_PEAK_BF16_FLOPS = {
    # per-card dense bf16 tensor-core FLOP/s (NVIDIA data sheets)
    "h100 pcie": 756e12,
    "h100 nvl": 835e12,
    "h100": 989e12,     # SXM: "NVIDIA H100 80GB HBM3"
    "a100": 312e12,
}
_DEFAULT_KIND = "h100"


def detect_chip_count(timeout_s: float = 20.0) -> Tuple[int, Optional[str]]:
    """Return (local card count, first card's name) without creating a
    CUDA context: ``detect_gpus`` runs ``nvidia-smi -L`` in a subprocess
    under a timeout and honours ``CUDA_VISIBLE_DEVICES``. Returns
    (0, None) when no card or no driver is present."""
    from ray_tpu_torch.core.api import detect_gpus

    return detect_gpus(timeout_s)


def device_kind() -> Optional[str]:
    """The first visible card's name. Reads it through torch only when
    this process already holds a CUDA context, so the call never creates
    one; otherwise asks ``nvidia-smi``. None without a card."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        try:
            return torch.cuda.get_device_name(torch.cuda.current_device())
        except RuntimeError:
            return None
    return detect_chip_count()[1]


def peak_flops_per_chip(kind: Optional[str] = None) -> float:
    """Peak dense bf16 FLOP/s per card, keyed off the device kind string
    (the longest table key the kind contains wins)."""
    kind = (kind or device_kind() or "").lower()
    for gen, flops in sorted(_PEAK_BF16_FLOPS.items(),
                             key=lambda kv: -len(kv[0])):
        if gen in kind:
            return flops
    return _PEAK_BF16_FLOPS[_DEFAULT_KIND]


def pod_slice_hosts(pod_type: str) -> int:
    """Number of hosts in a slice, e.g. h100-16 -> 2 hosts (8 cards a
    host assumed, as the JAX function assumes 4 chips a TPU-VM host)."""
    chips = int(pod_type.rsplit("-", 1)[1])
    return max(1, chips // _CHIPS_PER_HOST_DEFAULT)


def slice_placement_group(pod_type: str,
                          chips_per_host: int = _CHIPS_PER_HOST_DEFAULT,
                          extra_cpu: float = 1.0):
    """Reserve a whole slice of cards as one gang: a STRICT_SPREAD
    placement group with one ``{"GPU": n, "CPU": extra_cpu}`` bundle per
    host, so a trainer pins one worker per host and
    ``torch.distributed`` forms its group across exactly those hosts."""
    from ray_tpu_torch.core.placement import placement_group

    n_hosts = pod_slice_hosts(pod_type)
    chips = int(pod_type.rsplit("-", 1)[1])
    per_host_chips = min(chips, chips_per_host)
    bundles: List[Dict[str, float]] = [
        {"GPU": float(per_host_chips), "CPU": extra_cpu}
        for _ in range(n_hosts)
    ]
    return placement_group(bundles, strategy="STRICT_SPREAD")
