"""core (PyTorch port of ``repro/core``): the signed-ternary CiM MAC.

Public surface, as the reference's:
  * the declarative execution API (``repro_torch.core.execution`` /
    ``repro_torch.api``);
  * ternary quantization and encodings (``repro_torch.core.ternary``);
  * the SiTe CiM array's functional model (``repro_torch.core.site_cim``:
    aliases forwarding into the execution registry);
  * the declarative hardware model lives in ``repro_torch.hw``;
    ``core.cost_model`` and ``core.accelerator`` are deprecated shims
    over it.

The names resolve on first access (PEP 562), not at import:
``kernels/`` imports ``core.ternary``, and ``core.execution`` imports
``kernels/``, so an eager re-export here would make that a cycle.
"""
import importlib

_EXPORTS = {
    "execution": ("CiMExecSpec", "execute", "register_backend",
                  "registered_specs"),
    "site_cim": ("ADC_MAX", "N_ACTIVE", "PAPER_CIM_I", "PAPER_CIM_II",
                 "SENSE_ERROR_PROB", "SiTeCiMConfig", "nm_ternary_matmul",
                 "scalar_product", "site_cim_matmul",
                 "site_cim_matmul_bitplane", "site_cim_matmul_corrected"),
    "ternary": ("block_overflow_rate", "from_bitplanes", "pack_ternary",
                "ste_ternarize", "ste_unit_ternarize", "ternarize",
                "ternarize_fixed", "ternary_sparsity", "to_bitplanes",
                "unpack_ternary", "validate_bitplanes"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name: str):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


def __dir__():
    return sorted(list(globals()) + __all__)
