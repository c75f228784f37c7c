"""``repro_torch.profile``: measured-time observability for the hardware
model, profile → calibrate → replay (port of ``repro/profile``,
DESIGN.md §11).

  * :mod:`repro_torch.profile.trace`: opt-in per-step traces of the
    serving engine and the execution layer
    (``ContinuousBatcher(profile=...)``, ``launch/serve --profile``,
    :func:`set_profiler`); JSON-lines events in the reference's format;
  * :mod:`repro_torch.profile.calibrate`: least-squares fit of the cost
    parameters (per-MAC latency scale, weight-traffic rate, per-call and
    per-step fixed overhead) to measured kernel and step times, a
    versioned :class:`CalibrationTable` (the reference's JSON) that
    ``hw.project(calibration=...)`` and
    ``execution.autotune(calibration=...)`` consume;
  * :mod:`repro_torch.profile.replay`: dependency-graph replay of a
    serving workload under predicted segment times: serve tok/s and
    p50/p99 step latency for (arch × ArraySpec × occupancy) points,
    held to a predicted-vs-measured bound.
"""
from repro_torch.profile.calibrate import (  # noqa: F401
    CALIBRATION_VERSION,
    CalibrationTable,
    EngineFit,
    KernelFit,
    calibrate,
    fit_engines,
    fit_kernel,
    fit_kernels,
)
from repro_torch.profile.replay import (  # noqa: F401
    Node,
    ReplayRequest,
    compare_to_measured,
    make_array_kernel_model,
    make_kernel_model,
    poisson_requests,
    predict_decode_step_us,
    replay_traffic_bench,
    requests_from_trace,
    requests_like_bench,
    simulate,
    table_from_traffic_row,
)
from repro_torch.profile.trace import (  # noqa: F401
    REQUIRED_FIELDS,
    TRACE_SCHEMA_VERSION,
    Profiler,
    TraceEvent,
    backend_block,
    current_profiler,
    event_from_json,
    read_trace,
    set_profiler,
    validate_event,
    wrap_step,
)
