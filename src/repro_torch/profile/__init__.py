"""``repro_torch.profile``: opt-in per-step traces of the serving engine
and the execution layer (port of the trace leg of ``repro/profile``).

  * :mod:`repro_torch.profile.trace`: ``ContinuousBatcher(profile=...)``,
    ``launch/serve --profile`` and :func:`set_profiler`; JSON-lines
    events in the reference's format.

Not ported yet: ``calibrate`` and ``replay`` (they need ``hw/``).
"""
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
