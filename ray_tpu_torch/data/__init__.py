"""ray_tpu_torch.data: streaming distributed datasets on the runtime (port
of ``ray_tpu/data``; reference: Ray Data), and device ingest.

``Dataset`` / ``DataIterator`` / ``GroupedData`` and the readers are the
JAX package's, on numpy blocks in the shared-memory store.
``device_prefetch`` streams host batches onto the card while the previous
step computes; ``iter_device_batches`` feeds it. The ingest module (and
with it torch) loads at its first use, so a data task's worker imports
numpy and the runtime only.
"""

from ray_tpu_torch.data.dataset import (  # noqa: F401
    DataIterator,
    Dataset,
    GroupedData,
)
from ray_tpu_torch.data.read_api import (  # noqa: F401
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,
    read_binary_files,
    read_csv,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
    read_tfrecords,
)

_INGEST = ("DevicePrefetch", "device_prefetch")


def __getattr__(name):
    if name in _INGEST:
        from ray_tpu_torch.data import ingest

        return getattr(ingest, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
