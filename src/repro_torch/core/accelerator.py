"""DEPRECATED compatibility shim — the TiM-DNN-style system model now
lives in ``repro_torch.hw.macro`` (+ the paper's DNN suite in
``repro_torch.hw.dnn_suite``), generalized over ``ArraySpec``/``MacroSpec``
(DESIGN.md §7).

Functions forward directly (same signatures, same outputs); legacy
module constants forward with a ``DeprecationWarning`` — new code
should size macros through ``hw.MacroSpec`` fields instead.
"""
from __future__ import annotations

import warnings

from repro_torch.hw import array as _array
from repro_torch.hw import dnn_suite as _suite
from repro_torch.hw import macro as _macro

# types + paper pins, re-exported unchanged
GemmLayer = _macro.GemmLayer
SystemResult = _macro.SystemResult
conv = _macro.conv
PAPER_SYSTEM_SPEEDUP = _macro.PAPER_SYSTEM_SPEEDUP
PAPER_SYSTEM_ENERGY = _macro.PAPER_SYSTEM_ENERGY

# the paper's Section VI workloads
alexnet = _suite.alexnet
resnet34 = _suite.resnet34
inception = _suite.inception
lstm = _suite.lstm
gru = _suite.gru
get_benchmarks = _suite.get_benchmarks

# the system model itself
run_system = _macro.run_system
speedup_and_energy = _macro.speedup_and_energy
average_speedup = _macro.average_speedup
average_energy_reduction = _macro.average_energy_reduction


_DEFAULT = _macro.PAPER_MACRO
_FORWARDS = {
    "N_ARRAYS": (lambda: _DEFAULT.n_arrays, "MacroSpec.n_arrays"),
    "N_PCUS": (lambda: _array.DEFAULT_PCUS, "ArraySpec.pcus"),
    "POST_NS_PER_OUT": (lambda: _DEFAULT.post_ns_per_out,
                        "MacroSpec.post_ns_per_out"),
    "POST_PJ_PER_OUT": (lambda: _DEFAULT.post_pj_per_out,
                        "MacroSpec.post_pj_per_out"),
    "WRITE_AMORTIZATION": (lambda: _DEFAULT.write_amortization,
                           "MacroSpec.write_amortization"),
    "ISO_AREA_NM_ARRAYS": (lambda: _macro.PAPER_ISO_AREA_NM_ARRAYS,
                           "repro_torch.hw.iso_area_nm_arrays(array, macro)"),
    "BENCHMARKS": (lambda: _suite.BENCHMARKS,
                   "repro_torch.hw.dnn_suite.get_benchmarks()"),
}


def __getattr__(name: str):
    if name in _FORWARDS:
        thunk, repl = _FORWARDS[name]
        warnings.warn(
            f"repro_torch.core.accelerator.{name} is deprecated; use {repl}",
            DeprecationWarning,
            stacklevel=2,
        )
        return thunk()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_FORWARDS))
