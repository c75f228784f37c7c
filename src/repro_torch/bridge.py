"""Load the JAX package's parameters into the port.

``params_from_numpy`` takes the JAX params as nested dicts of numpy
arrays (the ``repro.models.transformer.init_params`` pytree, converted
leaf by leaf with ``np.asarray(leaf, np.float32)``: numpy has no bf16)
and returns the port's params on ``device`` in the config's dtype,
except the leaves that the reference keeps in float32 under any config
dtype, which stay float32: the mamba leaves of ``ssm.F32_LEAVES`` and
the MoE router (``moe.F32_LEAVES``), the lists that ``init_params``
reads too. The f32 round trip of bf16 values is exact.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch._device import DeviceLike, dtype_of, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe, ssm

# subtree -> its leaves that stay float32
F32_LEAVES = {"mamba": ssm.F32_LEAVES, "moe": moe.F32_LEAVES}


def params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig,
                      device: DeviceLike = None) -> Dict[str, Any]:
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)

    def convert(node, path):
        if isinstance(node, dict):
            return {k: convert(v, path + (k,)) for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype != np.float32:
            raise TypeError(f"expected float32 leaves, got {arr.dtype}")
        f32 = any(sub in path and path[-1] in leaves
                  for sub, leaves in F32_LEAVES.items())
        return torch.tensor(arr, dtype=torch.float32 if f32 else dtype, device=dev)

    return convert(tree, ())
