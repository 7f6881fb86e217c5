"""Data ingest (port of the parts of ``ray_tpu/data`` a train loop needs).

``device_prefetch`` streams host batches onto the card while the previous
step computes. The Dataset API (``ray_tpu/data/dataset.py``,
``read_api.py``) imports the runtime, so it waits for the runtime's slice
(ROADMAP.md queue 1, item 4).
"""

from ray_tpu_torch.data.ingest import DevicePrefetch, device_prefetch

__all__ = ["DevicePrefetch", "device_prefetch"]
