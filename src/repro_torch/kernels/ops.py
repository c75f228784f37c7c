"""Deprecated wrappers over the ternary CiM kernels (port of
``repro/kernels/ops.py``).

Historically layer code called :func:`cim_matmul` directly; dispatch now
lives in the declarative execution API (``repro_torch.api`` /
``repro_torch.core.execution``): a ``CiMExecSpec`` names the
formulation, backend and packing, and a registry maps it to a kernel.
The wrappers below are kept for source compatibility: each one builds
the equivalent spec and forwards to ``execute(spec, x, w)``, which owns
batch-dim flattening, the K pad to whole blocks, the dtype policy and
the straight-through backward (the CiM array's gradient is that of an
exact matmul: the ADC clamp is piecewise linear with slope 1 almost
everywhere). The backends are the port's: ``auto``, ``cuda`` (the
hand-written kernels; their plain versions for CPU tensors) and
``torch``.
"""
from __future__ import annotations

from typing import Literal

import torch

from repro_torch.kernels.packed_mac import packed_cim_matmul  # noqa: F401 (re-export)
from repro_torch.kernels.ternary_mac import (  # noqa: F401 (re-export)
    DEFAULT_ADC_MAX,
    DEFAULT_BLOCK,
    ternary_cim_matmul,
    ternary_exact_matmul,
)

Backend = Literal["auto", "cuda", "torch"]


def cim_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    block: int = DEFAULT_BLOCK,
    adc_max: int = DEFAULT_ADC_MAX,
    backend: Backend = "auto",
) -> torch.Tensor:
    """Deprecated alias: forwards to ``repro_torch.api.execute`` with the
    "blocked" formulation.

    x: (..., K) ternary values; w: (K, N) ternary values.
    Forward: per-``block`` ADC-clamped MAC. Backward: exact-matmul
    gradients (straight-through past the clamp).
    """
    # import inside the function: repro_torch.core.execution imports the
    # kernels of this package, so a module-level import would cycle
    from repro_torch.core import execution as xapi

    spec = xapi.CiMExecSpec(
        formulation="blocked", backend=backend, block=block, adc_max=adc_max
    )
    return xapi.execute(spec, x, w)


def exact_ternary_matmul(x: torch.Tensor, w: torch.Tensor,
                         backend: Backend = "auto") -> torch.Tensor:
    """Deprecated alias: forwards to ``repro_torch.api.execute`` with the
    "exact" formulation (the near-memory baseline, kernel-backed on the
    card)."""
    from repro_torch.core import execution as xapi

    return xapi.execute(xapi.CiMExecSpec(formulation="exact", backend=backend), x, w)
