"""``ArraySpec`` + array-level cost derivation (paper Section V).

An ``ArraySpec`` is the hardware mirror of ``CiMExecSpec``: a frozen,
declarative description of one memory array — which technology and
design it is built from plus its geometry — that every cost consumer
(``api.spec_cost_summary``, dry-run/roofline cells, the macro system
model, bench_array) binds to instead of module constants.

Cost derivation is generic over the registries: absolute per-operation
costs come from the technology's NM-baseline scale times the design's
normalized ratios. The paper's Fig 9/11 numbers are *not* the data
structure — they are derived by :func:`design_claims` and pinned as a
validation table (:func:`paper_validation_table`, held equal to the
JAX package's in ``tests/test_torch_hw.py``).

Conventions (unchanged from the paper):
  * a "MAC pass" is one full pass over all ``rows`` of a column set:
    NM = ``rows`` sequential row reads + digital MAC; CiM designs
    assert ``n_active`` rows per cycle (the latency/energy advantage is
    measured in the technology's normalized ratios, which were
    characterized at the paper's 256x256 / N_A=16 geometry).
  * ``adc_bits``-bit flash ADC plus one extra sense amp reads block
    partials 0..2**adc_bits exactly (the clamp bound ``adc_max``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict

from repro_torch.hw import registry as reg

# Paper geometry defaults: 512x256 binary arrays = 256x256 ternary words.
DEFAULT_ROWS = 256
DEFAULT_COLS = 256
DEFAULT_N_ACTIVE = 16
DEFAULT_ADC_BITS = 3
DEFAULT_PCUS = 32


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Declarative description of one CiM/NM memory array.

    technology: a registered technology name (``hw.technologies()``).
    design:     a registered design name (``hw.designs()``).
    rows/cols:  ternary words (two binary cells per word).
    n_active:   rows asserted per cycle in CiM designs (paper N_A = 16).
    adc_bits:   flash-ADC precision; clamp bound = 2**adc_bits (+ the
                extra sense amp, i.e. 8 for 3 bits).
    clock_ghz:  digital periphery clock (PCU drain / post-processing);
                the analog array timing comes from the technology.
    pcus:       partial-sum compute units draining the columns.
    """
    technology: str = "8T-SRAM"
    design: str = "NM"
    rows: int = DEFAULT_ROWS
    cols: int = DEFAULT_COLS
    n_active: int = DEFAULT_N_ACTIVE
    adc_bits: int = DEFAULT_ADC_BITS
    clock_ghz: float = 1.0
    pcus: int = DEFAULT_PCUS

    def __post_init__(self):
        reg.get_technology(self.technology)   # friendly KeyError on typos
        reg.get_design(self.design)
        if self.rows <= 0 or self.cols <= 0:
            raise ValueError(f"bad geometry {self.rows}x{self.cols}")
        if self.n_active <= 0 or self.rows % self.n_active:
            raise ValueError(
                f"n_active must divide rows: {self.n_active} vs {self.rows}"
            )
        if self.adc_bits <= 0:
            raise ValueError(f"adc_bits must be positive, got {self.adc_bits}")
        if self.clock_ghz <= 0:
            raise ValueError(f"clock_ghz must be positive, got {self.clock_ghz}")
        if self.pcus <= 0 or self.cols % self.pcus:
            raise ValueError(f"pcus must divide cols: {self.pcus} vs {self.cols}")

    @property
    def adc_max(self) -> int:
        return 2 ** self.adc_bits

    @property
    def cycles_per_pass(self) -> int:
        """Array cycles for one full MAC pass over all rows."""
        if reg.get_design(self.design).cim:
            return self.rows // self.n_active
        return self.rows

    @property
    def name(self) -> str:
        """Canonical string form, re-parseable by :func:`parse_array_spec`."""
        return (f"{self.technology}/{self.design}/{self.rows}x{self.cols}"
                f"/a{self.n_active}")

    def with_design(self, design: str) -> "ArraySpec":
        return dataclasses.replace(self, design=design)


_GEOM_RE = re.compile(r"^(\d+)x(\d+)$")
_NACTIVE_RE = re.compile(r"^a(\d+)$")
_PCUS_RE = re.compile(r"^p(\d+)$")
_GRAMMAR = "TECH[/DESIGN][/RxC][/aN][/pP]"


def parse_array_spec(text: str) -> ArraySpec:
    """Parse ``TECH[/DESIGN][/RxC][/aN][/pP]`` into an ArraySpec.

    Examples: ``8T-SRAM`` (NM), ``3T-FEMFET/CiM-I``,
    ``8T-SRAM/CiM-II/256x256/a16``, ``8T-SRAM/CiM-I/96x96/a16/p32``.
    Unknown names and malformed tokens raise with the registered sets /
    grammar listed (the launch CLIs surface this directly); ArraySpec's
    own geometry validation errors are re-raised with the spec text
    attached.
    """
    parts = [p for p in str(text).split("/") if p]
    if not parts:
        raise ValueError(f"empty array spec (grammar: {_GRAMMAR})")
    kw: Dict[str, object] = {"technology": parts[0]}
    for p in parts[1:]:
        if m := _GEOM_RE.match(p):
            kw["rows"], kw["cols"] = int(m.group(1)), int(m.group(2))
        elif m := _NACTIVE_RE.match(p):
            kw["n_active"] = int(m.group(1))
        elif m := _PCUS_RE.match(p):
            kw["pcus"] = int(m.group(1))
        elif p in reg.designs():
            kw["design"] = p
        else:
            raise ValueError(
                f"unknown token {p!r} in array spec {text!r}: not a "
                f"geometry token and not a registered design "
                f"{list(reg.designs())} (grammar: {_GRAMMAR})"
            )
    if kw["technology"] not in reg.technologies():
        raise ValueError(
            f"unknown technology {kw['technology']!r} in array spec "
            f"{text!r}; registered: {list(reg.technologies())}"
        )
    try:
        return ArraySpec(**kw)  # type: ignore[arg-type]
    except ValueError as e:
        raise ValueError(f"invalid array spec {text!r}: {e}") from None


@dataclasses.dataclass(frozen=True)
class ArrayCost:
    """Absolute per-operation array costs, derived from the registries."""
    tech: str
    design: str
    mac_pass_ns: float     # one full rows x cols ternary MAC pass
    mac_pass_pj: float
    row_read_ns: float
    row_read_pj: float
    row_write_ns: float
    row_write_pj: float
    cell_area: float       # relative units (NM ternary cell of tech = 1.0)
    macro_area: float
    macs_per_pass: int = DEFAULT_ROWS * DEFAULT_COLS


def array_cost(array: ArraySpec) -> ArrayCost:
    """Derive absolute costs for one array: NM baseline scale x the
    design's normalized ratios (all 1.0 for NM itself)."""
    base = reg.get_technology(array.technology)
    m = reg.design_metrics(array.technology, array.design)
    # NM MAC pass: `rows` row reads + digital MACs (read/compute
    # pipelined, so latency is dominated by reads; energy adds both).
    nm_mac_ns = array.rows * max(base.t_read_ns, base.t_nm_mac_ns)
    nm_mac_pj = array.rows * (base.e_read_pj + base.e_nm_mac_pj)
    return ArrayCost(
        tech=array.technology,
        design=array.design,
        mac_pass_ns=nm_mac_ns * m.cim_latency_vs_nm,
        mac_pass_pj=nm_mac_pj * m.cim_energy_vs_nm,
        row_read_ns=base.t_read_ns * m.read_latency_vs_nm,
        row_read_pj=base.e_read_pj * m.read_energy_vs_nm,
        row_write_ns=base.t_write_ns * m.write_latency_vs_nm,
        row_write_pj=base.e_write_pj * m.write_energy_vs_nm,
        cell_area=m.cell_area_vs_nm,
        macro_area=m.macro_area_vs_nm,
        macs_per_pass=array.rows * array.cols,
    )


def design_claims(array: ArraySpec) -> Dict[str, float]:
    """The paper-style derived claims of one CiM array vs its own
    same-technology NM baseline (the quantities Figs 9/11 report)."""
    nm = array_cost(array.with_design("NM"))
    c = array_cost(array)
    return {
        "cim_latency_reduction_pct": 100.0 * (1 - c.mac_pass_ns / nm.mac_pass_ns),
        "cim_energy_reduction_pct": 100.0 * (1 - c.mac_pass_pj / nm.mac_pass_pj),
        "read_energy_overhead_pct": 100.0 * (c.row_read_pj / nm.row_read_pj - 1),
        "read_latency_overhead_pct": 100.0 * (c.row_read_ns / nm.row_read_ns - 1),
        "write_latency_overhead_pct": 100.0 * (c.row_write_ns / nm.row_write_ns - 1),
        "cell_area_overhead_pct": 100.0 * (c.cell_area - 1),
        "macro_area_ratio": c.macro_area,
    }


def paper_validation_table() -> Dict[str, Dict[str, Dict[str, float]]]:
    """The claims of Figs 9/11 as derived from this model, restricted to
    the paper's six (technology, design) pairs — what tests and
    EXPERIMENTS.md compare against the paper's text. Registered
    non-paper technologies intentionally never appear here; they show up
    in ``bench_array.rows()`` instead."""
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for tech in reg.PAPER_TECHNOLOGIES:
        out[tech] = {}
        for design in ("CiM-I", "CiM-II"):
            out[tech][design] = design_claims(
                ArraySpec(technology=tech, design=design))
    return out


def flavor_comparison() -> Dict[str, Dict[str, float]]:
    """Section V.3: CiM II vs CiM I energy/latency/area ratios."""
    out = {}
    for tech in reg.PAPER_TECHNOLOGIES:
        c1 = array_cost(ArraySpec(technology=tech, design="CiM-I"))
        c2 = array_cost(ArraySpec(technology=tech, design="CiM-II"))
        out[tech] = {
            "energy_II_over_I": c2.mac_pass_pj / c1.mac_pass_pj,
            "latency_II_over_I": c2.mac_pass_ns / c1.mac_pass_ns,
            "cell_area_II_over_I": c2.cell_area / c1.cell_area,
        }
    return out
