"""``repro_torch.api`` — the port's public API: declarative execution of
the signed-ternary MAC (what it computes, and how), declarative hardware
(what it would cost on the paper's arrays), the stored-plane format, and
the serving engine.

    from repro_torch import api

    spec = api.CiMExecSpec(formulation="blocked", backend="auto")
    out = api.execute(spec, x_t, w_t)

    arr = api.ArraySpec(technology="3T-FEMFET", design="CiM-I")
    api.spec_cost_summary(spec, array=arr)          # cost on that array
    api.project("yi-34b", "decode_32k", arr)        # system projection

Tensor-parallel execution over a ``launch.mesh.TPMesh`` (one process
per rank): ``execute_tp`` (row-parallel) and ``execute_packed_tp``
(column-parallel over stored planes). New kernels land via
``register_backend``; new memory technologies and
array designs via ``register_technology`` / ``register_design``. The
wrappers of the five hand-written kernels are re-exported here, as the
JAX package's ``kernels`` re-exports its Pallas kernels; ``autotune``
sweeps their launch grids.
"""
from repro_torch.core.execution import (  # noqa: F401
    BACKENDS,
    DECODE_M_MAX,
    FLAVORS,
    FORMULATIONS,
    PACKINGS,
    SHAPE_CLASSES,
    BackendEntry,
    CiMExecSpec,
    autotune,
    canonical_plane_layout,
    clear_tile_cache,
    execute,
    execute_packed,
    execute_packed_tp,
    execute_tp,
    get_backend,
    kernel_plan,
    register_backend,
    registered_specs,
    set_shape_class_override,
    shape_class,
    spec_array_cost,
    spec_cost_summary,
    spec_design,
    tile_candidates,
    tiles_for,
)
from repro_torch.core.ternary import PackedPlanes  # noqa: F401
from repro_torch.hw import (  # noqa: F401
    ArrayCost,
    ArraySpec,
    DesignMetrics,
    DesignSpec,
    MacroSpec,
    TechnologySpec,
    array_cost,
    design_claims,
    designs,
    parse_array_spec,
    project,
    register_design,
    register_technology,
    technologies,
)
from repro_torch.kernels.packed_mac import (  # noqa: F401
    packed_cim_matmul,
    packed_cim_matmul_decode,
    packed_cim_matmul_decode_stream,
)
from repro_torch.kernels.ternary_mac import (  # noqa: F401
    ternary_cim_matmul,
    ternary_exact_matmul,
)
from repro_torch.quant.prepare import prepare_for_spec  # noqa: F401
from repro_torch.serve.engine import ContinuousBatcher, Request, generate  # noqa: F401
