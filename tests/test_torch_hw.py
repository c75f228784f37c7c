"""The port's hardware model against the JAX package's: the technology /
design registries, ``ArraySpec`` and its grammar, the array costs and the
paper's Figs 9/11 claims, the TiM-DNN system model over the paper's DNN
suite (Figs 12/13), the projection of every registry arch, the shape
cells, execution's cost bridge, the deprecated ``cost_model`` /
``accelerator`` shims, and ``site_cim``'s truth table and aliases.

Both sides are the same Python arithmetic on the same numbers, so every
comparison is ``==``."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.hw as J
from repro import api as japi
from repro.core import accelerator as jacc
from repro.core import cost_model as jcm
from repro.core import execution as JX
from repro.core import site_cim as jsc
from repro.models import registry as jreg
from repro_torch import api
from repro_torch import hw
from repro_torch.core import accelerator as acc
from repro_torch.core import cost_model as cm
from repro_torch.core import execution as X
from repro_torch.core import site_cim as sc
from repro_torch.models import registry as reg

PAPER_DESIGNS = ("NM", "CiM-I", "CiM-II")
_d = dataclasses.asdict


def _plain(v):
    """``v`` with every dataclass turned into a dict, recursively: the two
    packages' classes differ, their fields must not."""
    if dataclasses.is_dataclass(v):
        return _d(v)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


# ---------------------------------------------------------------------------
# Registries, ArraySpec, array costs
# ---------------------------------------------------------------------------


def test_registries_match_reference():
    assert hw.technologies() == J.technologies()
    assert hw.designs() == J.designs()
    assert hw.PAPER_TECHNOLOGIES == J.PAPER_TECHNOLOGIES
    assert hw.PAPER_DESIGNS == J.PAPER_DESIGNS
    for tech in J.technologies():
        assert _d(hw.get_technology(tech)) == _d(J.get_technology(tech))
        assert hw.cim_designs_of(tech) == J.cim_designs_of(tech)
        for design in J.designs():
            assert (_d(hw.design_metrics(tech, design))
                    == _d(J.design_metrics(tech, design)))
    for design in J.designs():
        assert _d(hw.get_design(design)) == _d(J.get_design(design))
    for flavor in ("I", "II"):
        assert hw.design_for_flavor(flavor) == J.design_for_flavor(flavor)


def test_registries_are_the_ports_own():
    spec = hw.TechnologySpec(
        name="RRAM-test", t_read_ns=2.0, e_read_pj=8.0, t_write_ns=20.0,
        e_write_pj=40.0, t_nm_mac_ns=1.2, e_nm_mac_pj=22.0, leakage_mw=0.0,
        designs={"CiM-I": hw.DesignMetrics(0.1, 0.2, 1.1, 1.2, 1.0, 1.0, 1.2, 1.4)})
    hw.register_technology(spec)
    try:
        assert "RRAM-test" in hw.technologies()
        assert "RRAM-test" not in J.technologies()
        cost = hw.array_cost(hw.ArraySpec(technology="RRAM-test", design="CiM-I"))
        assert cost.mac_pass_ns == 256 * 2.0 * 0.1
        # a registered technology is never compared against the paper's Figs
        assert "RRAM-test" not in hw.paper_validation_table()
    finally:
        hw.unregister_technology("RRAM-test")
    assert "RRAM-test" not in hw.technologies()
    with pytest.raises(ValueError, match="unregistered design"):
        hw.register_technology(hw.TechnologySpec(
            "bad", 1, 1, 1, 1, 1, 1, 0, designs={"CiM-9": spec.designs["CiM-I"]}))


@pytest.mark.parametrize("text", [
    "8T-SRAM", "3T-FEMFET/CiM-I", "8T-SRAM/CiM-II/256x256/a16",
    "8T-SRAM/CiM-I/96x96/a16/p32", "3T-eDRAM/NM/512x128/a32/p64"])
def test_parse_array_spec_matches_reference(text):
    mine, theirs = hw.parse_array_spec(text), J.parse_array_spec(text)
    assert _d(mine) == _d(theirs)
    assert mine.name == theirs.name
    assert mine.cycles_per_pass == theirs.cycles_per_pass
    assert mine.adc_max == theirs.adc_max
    # the name leaves pcus out, in both packages
    assert _d(hw.parse_array_spec(mine.name)) == _d(J.parse_array_spec(theirs.name))


@pytest.mark.parametrize("text", ["", "7T-SRAM", "8T-SRAM/CiM-III",
                                  "8T-SRAM/CiM-I/256x256/a15", "8T-SRAM/q3"])
def test_parse_array_spec_rejects_as_reference(text):
    with pytest.raises(ValueError):
        J.parse_array_spec(text)
    with pytest.raises(ValueError):
        hw.parse_array_spec(text)


def test_array_costs_and_paper_tables_match_reference():
    assert hw.paper_validation_table() == J.paper_validation_table()
    assert hw.flavor_comparison() == J.flavor_comparison()
    for tech in J.technologies():
        for design in J.designs():
            mine = hw.array_cost(hw.ArraySpec(technology=tech, design=design))
            theirs = J.array_cost(J.ArraySpec(technology=tech, design=design))
            assert _d(mine) == _d(theirs)
            if J.get_design(design).cim:
                assert (hw.design_claims(hw.ArraySpec(technology=tech, design=design))
                        == J.design_claims(J.ArraySpec(technology=tech, design=design)))


# ---------------------------------------------------------------------------
# The system model (Figs 12/13)
# ---------------------------------------------------------------------------


def test_dnn_suite_matches_reference():
    from repro.hw import dnn_suite as jsuite
    from repro_torch.hw import dnn_suite as suite

    mine, theirs = suite.get_benchmarks(), jsuite.get_benchmarks()
    assert list(mine) == list(theirs)
    for name in theirs:
        assert [_d(l) for l in mine[name]] == [_d(l) for l in theirs[name]]


@pytest.mark.parametrize("tech", J.PAPER_TECHNOLOGIES)
def test_system_model_matches_reference(tech):
    from repro.hw import dnn_suite as jsuite

    for bench in jsuite.get_benchmarks():
        for design in PAPER_DESIGNS:
            for n_arrays in (None, 41):
                assert (_d(hw.run_system(bench, tech, design, n_arrays))
                        == _d(J.run_system(bench, tech, design, n_arrays)))
    for design in ("CiM-I", "CiM-II"):
        array = hw.ArraySpec(technology=tech, design=design)
        assert hw.iso_area_nm_arrays(array) == J.iso_area_nm_arrays(
            J.ArraySpec(technology=tech, design=design))
        for baseline in ("iso-capacity", "iso-area"):
            assert (hw.speedup_and_energy(tech, design, baseline)
                    == J.speedup_and_energy(tech, design, baseline))
            assert (hw.average_speedup(tech, design, baseline)
                    == J.average_speedup(tech, design, baseline))
            assert (hw.average_energy_reduction(tech, design, baseline)
                    == J.average_energy_reduction(tech, design, baseline))
    with pytest.raises(ValueError, match="NM"):
        hw.speedup_and_energy(tech, "NM")


def test_system_pins_match_reference():
    assert hw.PAPER_SYSTEM_SPEEDUP == J.PAPER_SYSTEM_SPEEDUP
    assert hw.PAPER_SYSTEM_ENERGY == J.PAPER_SYSTEM_ENERGY
    assert _d(hw.PAPER_MACRO) == _d(J.PAPER_MACRO)
    small = hw.MacroSpec(n_arrays=8)
    array = hw.ArraySpec(technology="3T-eDRAM", design="CiM-II")
    assert hw.iso_area_nm_arrays(array, small) == J.iso_area_nm_arrays(
        J.ArraySpec(technology="3T-eDRAM", design="CiM-II"), J.MacroSpec(n_arrays=8))


# ---------------------------------------------------------------------------
# Shape cells and the projection of every registry arch
# ---------------------------------------------------------------------------


def test_shape_cells_match_reference():
    assert reg.ARCH_IDS == jreg.ARCH_IDS
    assert {k: _d(v) for k, v in reg.SHAPES.items()} == \
        {k: _d(v) for k, v in jreg.SHAPES.items()}
    for smoke in (False, True):
        mine = [(a, _d(s), r) for a, s, r in reg.all_cells(smoke=smoke)]
        theirs = [(a, _d(s), r) for a, s, r in jreg.all_cells(smoke=smoke)]
        assert mine == theirs
    for arch in reg.ARCH_IDS:
        assert reg.get_config(arch).subquadratic == jreg.get_config(arch).subquadratic


CELLS = [(arch, name) for arch in jreg.ARCH_IDS for name, shape in jreg.SHAPES.items()
         if jreg.cell_supported(jreg.get_config(arch), shape) is None]


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_project_matches_reference(arch, shape):
    for tech in J.PAPER_TECHNOLOGIES:
        for design in PAPER_DESIGNS:
            mine = hw.project(arch, shape, hw.ArraySpec(technology=tech, design=design))
            theirs = J.project(arch, shape, J.ArraySpec(technology=tech, design=design))
            assert mine == theirs, (tech, design)
    cfg, cell = reg.get_config(arch), reg.SHAPES[shape]
    assert ([(_d(l), c) for l, c in hw.workload_layers(cfg, cell)]
            == [(_d(l), c) for l, c in J.workload_layers(
                jreg.get_config(arch), jreg.SHAPES[shape])])


def test_project_takes_configs_and_cells_and_rejects_unknown_shapes():
    cfg = reg.get_config("zamba2-2.7b", smoke=True)
    cell = reg.ShapeCell("tiny", "prefill", 64, 2)
    mine = hw.project(cfg, cell, hw.ArraySpec(design="CiM-I"))
    theirs = J.project(jreg.get_config("zamba2-2.7b", smoke=True),
                       jreg.ShapeCell("tiny", "prefill", 64, 2),
                       J.ArraySpec(design="CiM-I"))
    assert mine == theirs
    with pytest.raises(KeyError, match="unknown shape"):
        hw.project("smollm-135m", "decode_1k", hw.ArraySpec())


# ---------------------------------------------------------------------------
# Execution's cost bridge, and api's exports
# ---------------------------------------------------------------------------


SPEC_CASES = [(f, fl) for f in JX.FORMULATIONS for fl in ("I", "II")]


@pytest.mark.parametrize("formulation,flavor", SPEC_CASES)
def test_spec_cost_summary_matches_reference(formulation, flavor):
    mine = X.CiMExecSpec(formulation=formulation, backend="torch", flavor=flavor)
    theirs = JX.CiMExecSpec(formulation=formulation, backend="jnp", flavor=flavor)
    assert X.spec_design(mine) == JX.spec_design(theirs)
    assert X.spec_cost_summary(mine) == JX.spec_cost_summary(theirs)
    for tech in J.PAPER_TECHNOLOGIES:
        assert (X.spec_cost_summary(mine, tech=tech)
                == JX.spec_cost_summary(theirs, tech=tech))
        arr = hw.ArraySpec(technology=tech, design="NM", rows=128, cols=128)
        jarr = J.ArraySpec(technology=tech, design="NM", rows=128, cols=128)
        assert (X.spec_cost_summary(mine, array=arr)
                == JX.spec_cost_summary(theirs, array=jarr))
        assert (_d(X.spec_array_cost(mine, array=arr))
                == _d(JX.spec_array_cost(theirs, array=jarr)))
    with pytest.raises(ValueError, match="either tech= or array="):
        X.spec_cost_summary(mine, tech="8T-SRAM", array=hw.ArraySpec())


def test_fused_costs_as_cim_though_it_does_not_clamp():
    spec = X.CiMExecSpec(formulation="fused", backend="torch")
    assert not spec.clamps
    assert X.spec_design(spec) == "CiM-I"


def test_api_exports_the_references_hardware_names():
    names = ("ArrayCost", "ArraySpec", "DesignMetrics", "DesignSpec", "MacroSpec",
             "TechnologySpec", "array_cost", "design_claims", "designs",
             "parse_array_spec", "project", "register_design",
             "register_technology", "technologies", "spec_array_cost",
             "spec_cost_summary", "spec_design", "autotune", "clear_tile_cache")
    for name in names:
        assert hasattr(japi, name) and hasattr(api, name), name
    assert hasattr(api, "set_shape_class_override")


# ---------------------------------------------------------------------------
# The deprecated shims
# ---------------------------------------------------------------------------


def _forwards(mod):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        values = {name: getattr(mod, name) for name in mod._FORWARDS}
    return values, caught


@pytest.mark.parametrize("pair", [(cm, jcm), (acc, jacc)], ids=["cost_model", "accelerator"])
def test_shims_forward_as_reference(pair):
    mine, theirs = pair
    assert set(mine._FORWARDS) == set(theirs._FORWARDS)
    got, caught = _forwards(mine)
    want, _ = _forwards(theirs)
    assert len(caught) == len(got)
    assert all(issubclass(w.category, DeprecationWarning) for w in caught)
    assert all(str(w.message).startswith(f"repro_torch.core.{mine.__name__.rsplit('.', 1)[1]}.")
               for w in caught)
    assert _plain(got) == _plain(want)
    with pytest.raises(AttributeError):
        mine.NOT_A_NAME  # noqa: B018


def test_shim_functions_match_reference():
    for tech in J.PAPER_TECHNOLOGIES:
        for design in PAPER_DESIGNS:
            assert _d(cm.array_cost(tech, design)) == _d(jcm.array_cost(tech, design))
    assert cm.paper_validation_table() == jcm.paper_validation_table()
    assert cm.flavor_comparison() == jcm.flavor_comparison()
    assert _d(acc.run_system("LSTM", "8T-SRAM", "CiM-I")) == \
        _d(jacc.run_system("LSTM", "8T-SRAM", "CiM-I"))
    assert acc.average_speedup("3T-FEMFET", "CiM-II", "iso-area") == \
        jacc.average_speedup("3T-FEMFET", "CiM-II", "iso-area")


# ---------------------------------------------------------------------------
# site_cim: the cell's truth table and the deprecated aliases
# ---------------------------------------------------------------------------


def test_paper_constants_match_reference():
    for name in ("N_ROWS", "N_COLS", "N_ACTIVE", "ADC_BITS", "ADC_MAX",
                 "SENSE_ERROR_PROB"):
        assert getattr(sc, name) == getattr(jsc, name)
    assert _d(sc.PAPER_CIM_I) == _d(jsc.PAPER_CIM_I)
    assert _d(sc.PAPER_CIM_II) == _d(jsc.PAPER_CIM_II)
    with pytest.raises(ValueError, match="flavor"):
        sc.SiTeCiMConfig(flavor="III")
    with pytest.raises(ValueError, match="divisible"):
        sc.SiTeCiMConfig(block=24)


def test_scalar_product_truth_table_matches_reference():
    vals = [-1, 0, 1]
    i = np.array([a for a in vals for _ in vals], np.int8)
    w = np.array([b for _ in vals for b in vals], np.int8)
    mine = sc.scalar_product(torch.from_numpy(i), torch.from_numpy(w))
    theirs = np.asarray(jsc.scalar_product(jnp.asarray(i), jnp.asarray(w)))
    assert mine.dtype == torch.int32
    assert np.array_equal(mine.numpy(), theirs)
    assert np.array_equal(mine.numpy(), i.astype(np.int32) * w)


ALIASES = ("site_cim_matmul", "nm_ternary_matmul", "site_cim_matmul_corrected",
           "site_cim_matmul_bitplane")


@pytest.mark.parametrize("alias", ALIASES)
def test_site_cim_aliases_match_reference(alias):
    rng = np.random.default_rng(11)
    # dense +1 runs saturate the clamp in some blocks
    x = rng.choice([-1.0, 0.0, 1.0], size=(3, 5, 80), p=[0.2, 0.1, 0.7]).astype(np.float32)
    w = rng.choice([-1.0, 0.0, 1.0], size=(80, 24), p=[0.2, 0.1, 0.7]).astype(np.float32)
    configs = [sc.PAPER_CIM_I, sc.PAPER_CIM_II, sc.SiTeCiMConfig(adc_max=3)]
    jconfigs = [jsc.PAPER_CIM_I, jsc.PAPER_CIM_II, jsc.SiTeCiMConfig(adc_max=3)]
    for cfg, jcfg in zip(configs, jconfigs):
        args = () if alias == "nm_ternary_matmul" else (cfg,)
        jargs = () if alias == "nm_ternary_matmul" else (jcfg,)
        mine = getattr(sc, alias)(torch.from_numpy(x), torch.from_numpy(w), *args)
        theirs = np.asarray(getattr(jsc, alias)(jnp.asarray(x), jnp.asarray(w), *jargs))
        assert mine.dtype == torch.float32 and tuple(mine.shape) == (3, 5, 24)
        assert np.array_equal(mine.numpy(), theirs)


def test_site_cim_alias_is_the_torch_spec_and_warns_on_precision():
    x = torch.ones((2, 32))
    w = torch.ones((32, 3))
    with pytest.warns(DeprecationWarning, match="precision"):
        out = sc.site_cim_matmul(x, w, precision="highest")
    assert torch.equal(out, X.execute(X.CiMExecSpec("blocked", "torch"), x, w))
    assert torch.equal(out, torch.full((2, 3), 16.0))     # 2 blocks x clip8(16)
    noisy = sc.SiTeCiMConfig(error_prob=0.5)
    with pytest.raises(ValueError, match="torch.Generator"):
        sc.site_cim_matmul(x, w, noisy)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert torch.equal(sc.site_cim_matmul(x, w, noisy, generator=g1),
                       sc.site_cim_matmul(x, w, noisy, generator=g2))


def test_core_reexports_the_references_names():
    import repro.core as jcore
    import repro_torch.core as core

    for name in ("CiMExecSpec", "execute", "register_backend", "registered_specs",
                 "ADC_MAX", "N_ACTIVE", "PAPER_CIM_I", "PAPER_CIM_II",
                 "SENSE_ERROR_PROB", "SiTeCiMConfig", "nm_ternary_matmul",
                 "scalar_product", "site_cim_matmul", "site_cim_matmul_bitplane",
                 "site_cim_matmul_corrected", "from_bitplanes", "pack_ternary",
                 "ste_ternarize", "ste_unit_ternarize", "ternarize", "to_bitplanes",
                 "unpack_ternary"):
        assert hasattr(jcore, name)
        assert getattr(core, name) is not None, name
    assert core.scalar_product is sc.scalar_product
