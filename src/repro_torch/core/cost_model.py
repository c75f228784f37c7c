"""DEPRECATED compatibility shim — the array-level cost model now lives
in the declarative hardware API, ``repro_torch.hw`` (DESIGN.md §7).

Every legacy name forwards to its ``repro_torch.hw`` equivalent and emits a
``DeprecationWarning`` on first touch:

  * ``TECHNOLOGIES`` / ``DESIGNS``          -> ``hw.PAPER_TECHNOLOGIES`` /
    ``hw.PAPER_DESIGNS`` (the *registered* sets are ``hw.technologies()``
    / ``hw.designs()`` — new technologies land there, never here),
  * ``ArrayMetrics`` / ``ARRAY_METRICS``    -> ``hw.DesignMetrics`` /
    ``hw.design_metrics(tech, design)``,
  * ``TechBase`` / ``TECH_BASE``            -> ``hw.TechnologySpec`` /
    ``hw.get_technology(name)``,
  * ``array_cost(tech, design)``            -> ``hw.array_cost(ArraySpec)``,
  * ``paper_validation_table`` / ``flavor_comparison`` — unchanged
    output, now derived through the registries.

Geometry constants (N_ROWS, N_COLS, N_ACTIVE, CYCLES_PER_MAC_*) forward
to the ``ArraySpec`` defaults.
"""
from __future__ import annotations

import warnings
from typing import Dict

from repro_torch.hw import array as _arr
from repro_torch.hw import registry as _reg

# re-exported types (no warning: harmless to name in annotations)
ArrayMetrics = _reg.DesignMetrics
TechBase = _reg.TechnologySpec
ArrayCost = _arr.ArrayCost


def _warn(name: str, repl: str) -> None:
    warnings.warn(
        f"repro_torch.core.cost_model.{name} is deprecated; use {repl}",
        DeprecationWarning,
        stacklevel=3,
    )


def array_cost(tech: str, design: str) -> ArrayCost:
    """Forward to ``hw.array_cost`` on a default-geometry ArraySpec."""
    return _arr.array_cost(_arr.ArraySpec(technology=tech, design=design))


def paper_validation_table() -> Dict[str, Dict[str, Dict[str, float]]]:
    return _arr.paper_validation_table()


def flavor_comparison() -> Dict[str, Dict[str, float]]:
    return _arr.flavor_comparison()


def _legacy_array_metrics() -> Dict[str, Dict[str, ArrayMetrics]]:
    return {
        tech: {d: _reg.design_metrics(tech, d) for d in _reg.PAPER_DESIGNS}
        for tech in _reg.PAPER_TECHNOLOGIES
    }


_FORWARDS = {
    "TECHNOLOGIES": (lambda: _reg.PAPER_TECHNOLOGIES,
                     "repro_torch.hw.technologies() (registered set) or "
                     "hw.PAPER_TECHNOLOGIES (paper set)"),
    "DESIGNS": (lambda: _reg.PAPER_DESIGNS, "repro_torch.hw.designs()"),
    "N_ROWS": (lambda: _arr.DEFAULT_ROWS, "ArraySpec.rows"),
    "N_COLS": (lambda: _arr.DEFAULT_COLS, "ArraySpec.cols"),
    "N_ACTIVE": (lambda: _arr.DEFAULT_N_ACTIVE, "ArraySpec.n_active"),
    "CYCLES_PER_MAC_CIM": (
        lambda: _arr.DEFAULT_ROWS // _arr.DEFAULT_N_ACTIVE,
        "ArraySpec.cycles_per_pass"),
    "CYCLES_PER_MAC_NM": (lambda: _arr.DEFAULT_ROWS,
                          "ArraySpec.cycles_per_pass"),
    "ARRAY_METRICS": (_legacy_array_metrics,
                      "repro_torch.hw.design_metrics(tech, design)"),
    "TECH_BASE": (
        lambda: {t: _reg.get_technology(t) for t in _reg.PAPER_TECHNOLOGIES},
        "repro_torch.hw.get_technology(name)"),
}


def __getattr__(name: str):
    if name in _FORWARDS:
        thunk, repl = _FORWARDS[name]
        _warn(name, repl)
        return thunk()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_FORWARDS))
