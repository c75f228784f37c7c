"""SiTe CiM functional model (port of ``repro/core/site_cim.py``): the
paper's constants, the array configuration and the cell's scalar-product
truth table, in PyTorch.

The architectural semantics (Sections III and IV of the paper): weights
and inputs are encoded differentially (M1/M2 bit-cells, RWL1/RWL2
wordlines); N_A = 16 rows are asserted per cycle; RBL1 counts the (+1)
products ``a`` and RBL2 the (-1) products ``b``; a 3-bit flash ADC plus
one sense amp reads each of them as 0..8; the block partial
clip8(a) - clip8(b) accumulates in the PCU across the K/16 blocks of a
column. Flavors I and II compute the same MAC (they differ in circuits and
cost, ``repro_torch.hw``).

The matmul entry points here are **deprecated aliases**, as in the
reference: each builds a ``CiMExecSpec`` from its ``SiTeCiMConfig`` and
forwards to ``repro_torch.core.execution.execute``. The reference pins
them to its plain backend (``"jnp"``), so these pin them to the port's
plain backend, ``"torch"``; the device follows the inputs, and the
sensing-error channel draws from a ``torch.Generator`` (the reference's
``key``). New call sites should use ``repro_torch.api`` directly.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

# Paper constants (Sections III.2, IV.3)
N_ROWS = 256            # rows per array
N_COLS = 256            # columns per array
N_ACTIVE = 16           # rows asserted per cycle (N_A)
ADC_BITS = 3
ADC_MAX = 8             # 3-bit ADC + extra sense amp for the value 8
SENSE_ERROR_PROB = 3.1e-3  # total probability of a sensing error [21]


@dataclasses.dataclass(frozen=True)
class SiTeCiMConfig:
    """Architectural knobs of a SiTe CiM array (paper defaults)."""
    flavor: str = "I"            # "I" (per-cell coupling) or "II" (sub-column)
    block: int = N_ACTIVE        # rows asserted per cycle
    adc_max: int = ADC_MAX       # clamp bound for a and b
    error_prob: float = 0.0      # sensing-error probability (0 = ideal)
    n_rows: int = N_ROWS
    n_cols: int = N_COLS

    def __post_init__(self):
        if self.flavor not in ("I", "II"):
            raise ValueError(f"unknown SiTe CiM flavor {self.flavor!r}")
        if self.n_rows % self.block != 0:
            raise ValueError("n_rows must be divisible by the block size")


PAPER_CIM_I = SiTeCiMConfig(flavor="I")
PAPER_CIM_II = SiTeCiMConfig(flavor="II")


def scalar_product(i: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Ternary scalar product through the cell model, as ``torch.int32``.

    The cell produces discharge events on (RBL1, RBL2); they are modelled
    and decoded rather than shortcut to ``i * w``, so the truth table is
    checked the way the paper's Fig. 3 states it.
    """
    m1, m2 = w > 0, w < 0
    rwl1, rwl2 = i > 0, i < 0
    # RBL1 discharges when the AX1 path (RWL1 & M1) or the cross-coupled
    # AX4 path (RWL2 & M2) conducts; symmetrically RBL2 (Fig. 2 / 3(c))
    rbl1 = (rwl1 & m1) | (rwl2 & m2)   # "+1" event
    rbl2 = (rwl1 & m2) | (rwl2 & m1)   # "-1" event
    return rbl1.to(torch.int32) - rbl2.to(torch.int32)


# ---------------------------------------------------------------------------
# Deprecated aliases over the execution registry
# ---------------------------------------------------------------------------


def _warn_ignored_precision(precision) -> None:
    if precision is not None:
        warnings.warn(
            "the `precision` argument of the deprecated site_cim aliases is "
            "ignored: the execution shim (repro_torch.core.execution) owns "
            "the dtype/precision policy",
            DeprecationWarning,
            stacklevel=3,
        )


def _spec_from_config(config: SiTeCiMConfig, formulation: str):
    from repro_torch.core import execution as xapi

    return xapi.CiMExecSpec(
        formulation=formulation,
        backend="torch",
        flavor=config.flavor,
        block=config.block,
        adc_max=config.adc_max,
        error_prob=config.error_prob,
    )


def site_cim_matmul(
    x_t: torch.Tensor,
    w_t: torch.Tensor,
    config: SiTeCiMConfig = PAPER_CIM_I,
    generator: Optional[torch.Generator] = None,
    precision=None,
) -> torch.Tensor:
    """Deprecated alias: ``execute`` with the "blocked" formulation (per
    16-row a/b event counts and the ADC clamp).

    x_t: (..., K) ternary inputs (any numeric dtype); w_t: (K, N) ternary
    weights; ``config.adc_max`` clamps the per-block counts; ``generator``
    feeds the sensing-error channel (required if ``config.error_prob >
    0``). Returns (..., N) ``sum_blk clip8(a_blk) - clip8(b_blk)`` in the
    dtype of ``x_t``, with the straight-through gradient of ``execute``.
    """
    _warn_ignored_precision(precision)
    from repro_torch.core import execution as xapi

    return xapi.execute(_spec_from_config(config, "blocked"), x_t, w_t,
                        generator=generator)


def nm_ternary_matmul(x_t: torch.Tensor, w_t: torch.Tensor,
                      precision=None) -> torch.Tensor:
    """Deprecated alias: ``execute`` with the "exact" formulation (the
    near-memory baseline: row-by-row digital MAC, no ADC clamp; the
    NM/CiM difference is cost, ``repro_torch.hw``)."""
    _warn_ignored_precision(precision)
    from repro_torch.core import execution as xapi

    spec = xapi.CiMExecSpec(formulation="exact", backend="torch")
    return xapi.execute(spec, x_t, w_t)


def site_cim_matmul_corrected(
    x_t: torch.Tensor,
    w_t: torch.Tensor,
    config: SiTeCiMConfig = PAPER_CIM_I,
    precision=None,
) -> torch.Tensor:
    """Deprecated alias: ``execute`` with the "corrected" (clip as
    correction) formulation, exact_dot + sum_blk (relu(b_blk - 8) -
    relu(a_blk - 8)): equal to :func:`site_cim_matmul` with error_prob=0,
    the bulk contraction one full-depth product."""
    _warn_ignored_precision(precision)
    from repro_torch.core import execution as xapi

    return xapi.execute(_spec_from_config(config, "corrected"), x_t, w_t)


def site_cim_matmul_bitplane(
    x_t: torch.Tensor, w_t: torch.Tensor, config: SiTeCiMConfig = PAPER_CIM_I
) -> torch.Tensor:
    """Deprecated alias: ``execute`` with the "bitplane" (event-counting)
    formulation::

        a = #(RWL1 & M1) + #(RWL2 & M2)   (RBL1 discharge events)
        b = #(RWL1 & M2) + #(RWL2 & M1)   (RBL2 discharge events)
    """
    from repro_torch.core import execution as xapi

    return xapi.execute(_spec_from_config(config, "bitplane"), x_t, w_t)
