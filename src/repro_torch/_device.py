"""Device selection shared by the port's entry points.

Entry points that create tensors run on ``cuda`` unless the caller asks
for the CPU. Without CUDA they raise: there is no silent CPU fallback.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises when a CUDA device is asked for
    (explicitly or by default) and ``torch.cuda.is_available()`` is
    False."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def dtype_of(name: str) -> torch.dtype:
    """Config dtype string -> torch dtype ("bfloat16" | "float32")."""
    if name == "bfloat16":
        return torch.bfloat16
    if name == "float32":
        return torch.float32
    raise ValueError(f"unknown dtype {name!r} (bfloat16 | float32)")
