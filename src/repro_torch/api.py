"""``repro_torch.api`` — the port's public API: declarative execution of
the signed-ternary MAC (what it computes, and how), the stored-plane
format, and the serving engine.

    from repro_torch import api

    spec = api.CiMExecSpec(formulation="blocked", backend="auto")
    out = api.execute(spec, x_t, w_t)

New kernels land via ``register_backend``. The wrappers of the five
hand-written kernels are re-exported here, as the JAX package's
``kernels`` re-exports its Pallas kernels. The hardware cost models of
``repro.api`` (``repro.hw``) are not ported yet.
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
    canonical_plane_layout,
    execute,
    execute_packed,
    get_backend,
    register_backend,
    registered_specs,
    shape_class,
    tiles_for,
)
from repro_torch.core.ternary import PackedPlanes  # noqa: F401
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
