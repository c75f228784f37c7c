"""Technology / design registries — the hardware half of the declarative
API (mirror of the kernel registry in ``repro_torch.core.execution``).

The paper's array analysis (Section V) is parameterized by exactly two
things:

  * a **memory technology** — absolute NM-baseline timing/energy plus the
    normalized Fig 9/11 ratios of each CiM design against that baseline
    (8T-SRAM, 3T-eDRAM, 3T-FEMFET in the paper; RRAM ternary synapses or
    any future cell land here as one ``register_technology`` call), and
  * an **array design** — how the array computes (near-memory row-by-row
    readout vs in-memory multi-row assertion) and which execution-spec
    flavor it serves (NM, SiTe CiM I, SiTe CiM II).

Everything downstream (``hw.array`` cost derivation, the ``hw.macro``
system model, ``hw.workload`` projections, bench_array/bench_system,
``api.spec_cost_summary``) iterates these registries, so a new
technology registered with cost parameters only — zero edits to any
module — immediately shows up end to end.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DesignMetrics:
    """Normalized-to-NM metrics of one CiM design on one technology.

    These ratios are the technology's *cost parameters* (for the paper's
    three technologies they come straight from Figs 9/11 and Section V
    text); the derived claims that the paper reports are computed from
    them in ``hw.array`` and pinned as a validation table — the split
    between calibration inputs and validated outputs.
    """
    cim_latency_vs_nm: float      # full MAC pass latency ratio
    cim_energy_vs_nm: float       # full MAC pass energy ratio
    read_latency_vs_nm: float
    read_energy_vs_nm: float
    write_latency_vs_nm: float
    write_energy_vs_nm: float
    cell_area_vs_nm: float        # ternary cell area ratio
    macro_area_vs_nm: float       # incl. peripherals (ADCs vs NM MAC unit)


@dataclasses.dataclass(frozen=True)
class TechnologySpec:
    """One memory technology: absolute NM-baseline scale + per-design ratios.

    t_read_ns / e_read_pj: one row read (a full row of bit-cell pairs
      sensed in parallel) and its energy.
    t_write_ns / e_write_pj: one row write.
    t_nm_mac_ns / e_nm_mac_pj: digital near-memory MAC of one row against
      the input element (pipelined with the next read in the NM design).
    leakage_mw: array standby power (0 for NVM — paper Section II.C).
    designs: design name -> DesignMetrics (the NM baseline itself is
      implicitly all-1.0 and need not be listed).
    """
    name: str
    t_read_ns: float
    e_read_pj: float
    t_write_ns: float
    e_write_pj: float
    t_nm_mac_ns: float
    e_nm_mac_pj: float
    leakage_mw: float
    designs: Mapping[str, DesignMetrics] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class DesignSpec:
    """One array design: how the array computes a MAC pass.

    cim:    True if multiple rows are asserted per cycle (computing in
            memory); False for the row-by-row near-memory readout.
    flavor: the ``CiMExecSpec.flavor`` this design serves ("I"/"II"),
            None for the NM baseline (``api.spec_design`` routes through
            this mapping).
    """
    name: str
    cim: bool
    flavor: Optional[str] = None
    description: str = ""


_NM_METRICS = DesignMetrics(1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)

_TECHNOLOGIES: Dict[str, TechnologySpec] = {}
_DESIGNS: Dict[str, DesignSpec] = {}


def register_technology(spec: TechnologySpec) -> TechnologySpec:
    """Register a memory technology. Every design named in
    ``spec.designs`` must already be registered (typos die early)."""
    if not spec.name:
        raise ValueError("technology needs a name")
    for d in spec.designs:
        if d not in _DESIGNS:
            raise ValueError(
                f"technology {spec.name!r} references unregistered design "
                f"{d!r} (known: {sorted(_DESIGNS)}); register_design first"
            )
    _TECHNOLOGIES[spec.name] = spec
    return spec


def register_design(spec: DesignSpec) -> DesignSpec:
    """Register a CiM/NM design point by name (returns ``spec`` so it
    can be used inline); technologies reference designs by these
    names."""
    if not spec.name:
        raise ValueError("design needs a name")
    _DESIGNS[spec.name] = spec
    return spec


def unregister_technology(name: str) -> None:
    """Remove a registered technology (test/tooling hygiene)."""
    _TECHNOLOGIES.pop(name, None)


def get_technology(name: str) -> TechnologySpec:
    """The registered :class:`TechnologySpec` for ``name``; raises
    KeyError listing the registered technologies."""
    try:
        return _TECHNOLOGIES[name]
    except KeyError:
        raise KeyError(
            f"unknown technology {name!r} (registered: {technologies()}); "
            f"add one with repro_torch.hw.register_technology"
        ) from None


def get_design(name: str) -> DesignSpec:
    """The registered :class:`DesignSpec` for ``name``; raises KeyError
    listing the registered designs."""
    try:
        return _DESIGNS[name]
    except KeyError:
        raise KeyError(
            f"unknown design {name!r} (registered: {designs()}); "
            f"add one with repro_torch.hw.register_design"
        ) from None


def technologies() -> Tuple[str, ...]:
    """Registered technology names, registration order."""
    return tuple(_TECHNOLOGIES)


def designs() -> Tuple[str, ...]:
    """Registered design names, registration order."""
    return tuple(_DESIGNS)


def design_metrics(tech: str, design: str) -> DesignMetrics:
    """Normalized ratios of ``design`` on ``tech`` (NM = all 1.0)."""
    t = get_technology(tech)
    d = get_design(design)
    if not d.cim:
        return _NM_METRICS
    try:
        return t.designs[design]
    except KeyError:
        raise KeyError(
            f"technology {tech!r} has no cost parameters for design "
            f"{design!r} (it provides: {sorted(t.designs)})"
        ) from None


def cim_designs_of(tech: str) -> Tuple[str, ...]:
    """The CiM designs a technology provides cost parameters for."""
    return tuple(d for d in get_technology(tech).designs if get_design(d).cim)


def design_for_flavor(flavor: str) -> str:
    """Map an execution-spec flavor onto its array design."""
    for d in _DESIGNS.values():
        if d.cim and d.flavor == flavor:
            return d.name
    raise KeyError(
        f"no registered CiM design serves flavor {flavor!r} "
        f"(designs: {designs()})"
    )


# ---------------------------------------------------------------------------
# Built-ins: the paper's designs and technologies (Figs 9/11, Section V)
# ---------------------------------------------------------------------------

register_design(DesignSpec(
    "NM", cim=False, flavor=None,
    description="near-memory baseline: row-by-row readout + digital MAC",
))
register_design(DesignSpec(
    "CiM-I", cim=True, flavor="I",
    description="SiTe CiM I: 16 rows asserted per cycle, cross-coupled cell",
))
register_design(DesignSpec(
    "CiM-II", cim=True, flavor="II",
    description="SiTe CiM II: one row per each of the 16 blocks per cycle",
))

# Fig. 9 (SiTe CiM I): "~88% lower latency" for all three technologies;
# energy savings 74 / 78 / 78%; read energy +22/24/17%, read latency
# +7/7/19%; write latency +4/4/10%, write energy comparable; cell area
# +18/34/34%; macro area 1.3x-1.53x (SRAM at the low end — its baseline
# cell is largest, so the relative ADC overhead is smallest; the paper
# gives the range, the per-tech split is our documented assumption).
# Fig. 11 (SiTe CiM II): MAC delay improvements 80 / 78 / 84%; energy
# 61 / 63 / 62%; read speed 2.4X / 2.6X / 1.8X lower; read energy
# +74/44/79%; write latency +8/10/3%; cell area +6%; macro 1.21x-1.33x.
# Absolute NM scale: 45nm PTM class numbers; SRAM fastest read, FEMFET
# slow high-voltage write (-5V reset / +4.8V set), eDRAM in between.
register_technology(TechnologySpec(
    name="8T-SRAM",
    t_read_ns=1.0, e_read_pj=12.0, t_write_ns=1.0, e_write_pj=14.0,
    t_nm_mac_ns=1.2, e_nm_mac_pj=22.0, leakage_mw=1.5,
    designs={
        "CiM-I": DesignMetrics(0.12, 0.26, 1.07, 1.22, 1.04, 1.00, 1.18, 1.30),
        "CiM-II": DesignMetrics(0.20, 0.39, 2.40, 1.74, 1.08, 1.00, 1.06, 1.21),
    },
))
register_technology(TechnologySpec(
    name="3T-eDRAM",
    t_read_ns=1.3, e_read_pj=10.0, t_write_ns=1.1, e_write_pj=11.0,
    t_nm_mac_ns=1.2, e_nm_mac_pj=22.0, leakage_mw=0.8,
    designs={
        "CiM-I": DesignMetrics(0.12, 0.22, 1.07, 1.24, 1.04, 1.00, 1.34, 1.53),
        "CiM-II": DesignMetrics(0.22, 0.37, 2.60, 1.44, 1.10, 1.00, 1.06, 1.33),
    },
))
register_technology(TechnologySpec(
    name="3T-FEMFET",
    t_read_ns=1.5, e_read_pj=10.0, t_write_ns=8.0, e_write_pj=30.0,
    t_nm_mac_ns=1.2, e_nm_mac_pj=22.0, leakage_mw=0.0,
    designs={
        "CiM-I": DesignMetrics(0.12, 0.22, 1.19, 1.17, 1.10, 1.00, 1.34, 1.53),
        "CiM-II": DesignMetrics(0.16, 0.38, 1.80, 1.79, 1.03, 1.00, 1.06, 1.33),
    },
))

# The paper's technology set — validation tables iterate these (a newly
# registered technology appears in cost/bench rows but is never silently
# compared against the paper's Figs).
PAPER_TECHNOLOGIES = ("8T-SRAM", "3T-eDRAM", "3T-FEMFET")
PAPER_DESIGNS = ("NM", "CiM-I", "CiM-II")
