"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Without a
card and without an explicit device they raise: a serving or benchmark path
that quietly fell back to the CPU would report CPU numbers as the card's.
"""

from __future__ import annotations

from typing import Union

import torch

from ray_tpu_torch.core.errors import not_ported  # noqa: F401  (re-export)

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev
