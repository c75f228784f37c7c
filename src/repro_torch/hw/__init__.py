"""``repro_torch.hw`` — the declarative hardware API (DESIGN.md §7), the
port's own copy of ``repro/hw``: pure Python, the same arithmetic, and
registries of its own (a technology registered in one package does not
appear in the other). ``tests/test_torch_hw.py`` holds every table and
projection equal to the reference's.

Mirror of the execution API: where ``repro_torch.core.execution`` makes the
ternary-MAC *semantics* data (``CiMExecSpec`` + backend registry), this
package makes the *hardware* data —

  * :class:`ArraySpec` — one memory array (technology, design,
    geometry), validated against the technology / design registries,
  * :func:`register_technology` / :func:`register_design` — new memory
    cells (RRAM ternary synapses, ...) land as one registration of cost
    parameters; every consumer (``api.spec_cost_summary``, the system
    projection, ``profile.replay``) picks them up with zero edits,
  * :class:`MacroSpec` + the TiM-DNN-style system model (``hw.macro``),
  * :func:`project` — the repo's own registry architectures
    (transformer / SSM / hybrid / MoE / encdec / VLM) run through the
    accelerator model (``hw.workload``),
  * the paper's Figs 9/11 claims derived — not stored — and pinned as a
    validation table (``hw.array.paper_validation_table``),
  * ``project(..., calibration=table)``: the same workload costed by a
    :class:`repro_torch.profile.CalibrationTable` fitted to the port's
    kernels on the card, beside the analytic CiM numbers.

``core/cost_model.py`` and ``core/accelerator.py`` are deprecated
compatibility shims over this package.
"""
from repro_torch.hw.array import (  # noqa: F401
    ArrayCost,
    ArraySpec,
    array_cost,
    design_claims,
    flavor_comparison,
    paper_validation_table,
    parse_array_spec,
)
from repro_torch.hw.macro import (  # noqa: F401
    GemmLayer,
    MacroSpec,
    PAPER_MACRO,
    PAPER_SYSTEM_ENERGY,
    PAPER_SYSTEM_SPEEDUP,
    SystemResult,
    average_energy_reduction,
    average_speedup,
    iso_area_nm_arrays,
    layer_cost,
    run_layers,
    run_system,
    speedup_and_energy,
)
from repro_torch.hw.registry import (  # noqa: F401
    PAPER_DESIGNS,
    PAPER_TECHNOLOGIES,
    DesignMetrics,
    DesignSpec,
    TechnologySpec,
    cim_designs_of,
    design_for_flavor,
    design_metrics,
    designs,
    get_design,
    get_technology,
    register_design,
    register_technology,
    technologies,
    unregister_technology,
)
from repro_torch.hw.workload import (  # noqa: F401
    WeightGemm,
    arch_gemms,
    project,
    workload_layers,
)
