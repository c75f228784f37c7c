"""Per-step trace capture (port of ``repro/profile/trace.py``).

The serving engine and the execution layer have opt-in timing hooks that
record one :class:`TraceEvent` per step: the batcher's decode step, its
prefill of a fill batch and its offline weight preparation
(``ContinuousBatcher(profile=...)``, ``launch/serve --profile``), and
every eager ``execute``/``execute_packed`` call outside a batcher step
while a profiler is installed (:func:`set_profiler`). Events go to an
in-memory list and, for a profiler with a path, to a JSON-lines file that
:func:`read_trace` reads back. The file format is the reference's, byte
for byte: a trace that either package writes, the other reads.

Timing the device means waiting for it. With no profiler,
:func:`wrap_step` returns the step function itself, so the disabled
engine runs what an uninstrumented one runs; the profiler's own
``torch.cuda.synchronize`` happens after the step returned, never inside
a captured graph, and never counts in the engine's ``host_syncs``.

Event schema (JSON lines; ``v`` is :data:`TRACE_SCHEMA_VERSION`)::

    {"v": 1, "entry_point": "serve.decode_step", "exec_spec": "mode:off",
     "shape_class": "decode", "mesh": null, "wall_us": 812.4,
     "dispatch_us": 101.2, "meta": {"arch": "smollm-135m", "step": 3,
     "occupancy": 2, ...}}

``wall_us`` is the host call to the device's completion (dispatch
included); ``dispatch_us`` the host time to enqueue the work.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import torch

#: bump when the event schema changes; readers reject unknown versions
TRACE_SCHEMA_VERSION = 1

#: the fields every event must carry
REQUIRED_FIELDS = ("entry_point", "exec_spec", "shape_class", "mesh", "wall_us")


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One timed step or kernel call.

    entry_point: dotted hook name: ``serve.decode_step``,
      ``serve.prefill``, ``serve.prepare``, ``execution.execute``,
      ``execution.execute_packed``, ``frontdoor.request``.
    exec_spec:   the CiM execution spec's name (``"blocked/cuda/none"``)
      or a quant-mode tag (``"mode:off"``) when the engine serves without
      an explicit spec.
    shape_class: ``"decode"`` / ``"prefill"``, or a hook's own tag
      (``"prepare"``, ``"request"``).
    mesh:        ``{axis: size}`` for TP serving, ``None`` unsharded.
    wall_us:     host call to device completion (dispatch and the
      profiler's own sync included).
    dispatch_us: host time to enqueue (the call returned, the device may
      still run).
    meta:        the hook's payload (m/k/n/macs/weight_bytes for kernel
      events; arch/step/occupancy for engine events).
    """

    entry_point: str
    exec_spec: str
    shape_class: str
    mesh: Optional[Mapping[str, int]]
    wall_us: float
    dispatch_us: float = 0.0
    meta: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "v": TRACE_SCHEMA_VERSION,
            "entry_point": self.entry_point,
            "exec_spec": self.exec_spec,
            "shape_class": self.shape_class,
            "mesh": dict(self.mesh) if self.mesh is not None else None,
            "wall_us": self.wall_us,
            "dispatch_us": self.dispatch_us,
            "meta": dict(self.meta),
        }


def validate_event(d: Mapping[str, Any]) -> None:
    """Raise ``ValueError`` unless ``d`` is a well-formed serialized
    event of the current schema version."""
    if not isinstance(d, Mapping):
        raise ValueError(f"trace event must be an object, got {type(d).__name__}")
    v = d.get("v")
    if v != TRACE_SCHEMA_VERSION:
        raise ValueError(
            f"trace schema version {v!r} != {TRACE_SCHEMA_VERSION} "
            f"(re-capture the trace with this tree)")
    for field in REQUIRED_FIELDS:
        if field not in d:
            raise ValueError(f"trace event missing required field {field!r}: {d}")
    for field in ("entry_point", "exec_spec", "shape_class"):
        if not d[field] or not isinstance(d[field], str):
            raise ValueError(f"trace event field {field!r} must be a "
                             f"non-empty string, got {d[field]!r}")
    if d["mesh"] is not None and not isinstance(d["mesh"], Mapping):
        raise ValueError(f"trace event mesh must be null or an object: {d['mesh']!r}")
    wall = d["wall_us"]
    if not isinstance(wall, (int, float)) or wall < 0:
        raise ValueError(f"trace event wall_us must be >= 0, got {wall!r}")


def event_from_json(d: Mapping[str, Any]) -> TraceEvent:
    validate_event(d)
    return TraceEvent(
        entry_point=d["entry_point"],
        exec_spec=d["exec_spec"],
        shape_class=d["shape_class"],
        mesh=dict(d["mesh"]) if d["mesh"] is not None else None,
        wall_us=float(d["wall_us"]),
        dispatch_us=float(d.get("dispatch_us", 0.0)),
        meta=dict(d.get("meta", {})),
    )


class Profiler:
    """Collects :class:`TraceEvent`\\ s; with a ``path``, also appends
    them to that JSON-lines file, flushed per event so a crashed run
    keeps its trace. Replicas of the front door step in threads and share
    one profiler, so :meth:`record` takes a lock. Use as a context
    manager, or call :meth:`close` when done with a path-backed one."""

    def __init__(self, path: Optional[Union[str, Path]] = None):
        self.path = Path(path) if path is not None else None
        self.events: List[TraceEvent] = []
        self._fh = None
        self._lock = threading.Lock()

    def record(self, event: Optional[TraceEvent] = None, **kw) -> TraceEvent:
        """Append one event (a :class:`TraceEvent`, or its constructor's
        keyword arguments)."""
        if event is None:
            event = TraceEvent(**kw)
        elif kw:
            raise ValueError("pass an event or kwargs, not both")
        with self._lock:
            self.events.append(event)
            if self.path is not None:
                if self._fh is None:
                    self._fh = open(self.path, "a")
                self._fh.write(json.dumps(event.to_json(), sort_keys=True) + "\n")
                self._fh.flush()
        return event

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "Profiler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_trace(path: Union[str, Path]) -> List[TraceEvent]:
    """Load and validate a JSON-lines trace file."""
    events: List[TraceEvent] = []
    for i, line in enumerate(Path(path).read_text().splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        try:
            d = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}:{i}: not JSON: {e}") from None
        events.append(event_from_json(d))
    return events


# ---------------------------------------------------------------------------
# The process-wide profiler (eager execution-layer calls)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Profiler] = None


def set_profiler(p: Optional[Profiler]) -> Optional[Profiler]:
    """Install ``p`` as the process-wide profiler (``None`` uninstalls)
    and wire the execution layer's sink to it: every eager
    ``execute``/``execute_packed`` call is timed while it is installed,
    except inside a batcher or serve step and while the current stream
    captures a graph (the reference times no call under a jit trace).
    Returns the previous profiler, so a caller can restore it."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = p
    from repro_torch.core import execution

    execution.set_profile_sink(p.record if p is not None else None)
    return prev


def current_profiler() -> Optional[Profiler]:
    """The installed process-wide profiler, or None."""
    return _ACTIVE


def backend_block() -> Dict[str, Any]:
    """Where numbers came from: the ``"backend"`` block a benchmark
    artifact embeds. ``interpret`` is true off the card, where every
    kernel wrapper runs its plain PyTorch version: such timings prove
    plumbing and bit-exactness, never a kernel's speed."""
    if torch.cuda.is_available():
        return {
            "platform": "cuda",
            "device_kind": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "interpret": False,
        }
    return {"platform": "cpu", "device_kind": "cpu", "device_count": 1,
            "interpret": True}


def _cuda_devices(tree) -> List[torch.device]:
    """The CUDA devices of the tensors in a nest of tuples, lists and
    dicts (a step's output)."""
    found: Dict[torch.device, None] = {}

    def walk(node):
        if torch.is_tensor(node):
            if node.device.type == "cuda":
                found[node.device] = None
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)

    walk(tree)
    return list(found)


# ---------------------------------------------------------------------------
# Step instrumentation (the serving engine's hook)
# ---------------------------------------------------------------------------


def wrap_step(
    fn: Callable,
    profiler: Optional[Profiler],
    entry_point: str,
    *,
    exec_spec: str = "mode:off",
    shape_class: str = "decode",
    mesh: Optional[Mapping[str, int]] = None,
    meta_fn: Optional[Callable[..., Mapping[str, Any]]] = None,
) -> Callable:
    """Wrap a step function with wall-time capture.

    With ``profiler=None`` this returns ``fn`` itself (the same object),
    so the disabled path runs exactly what an uninstrumented engine runs.
    With a profiler, the wrapper times the call, waits for the devices of
    its outputs (``torch.cuda.synchronize``, after the call returned: a
    step that captures a graph has ended its capture by then), and
    records one event; ``meta_fn(*args)`` gives the hook's payload at
    record time.
    """
    if profiler is None:
        return fn

    def timed(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        t1 = time.perf_counter()
        for dev in _cuda_devices(out):
            # analysis: host-sync ok -- the profiler waits after the step returned, never inside it
            torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        profiler.record(TraceEvent(
            entry_point=entry_point,
            exec_spec=exec_spec,
            shape_class=shape_class,
            mesh=mesh,
            wall_us=(t2 - t0) * 1e6,
            dispatch_us=(t1 - t0) * 1e6,
            meta=dict(meta_fn(*args)) if meta_fn is not None else {},
        ))
        return out

    return timed


# ---------------------------------------------------------------------------
# Tracing contract (repro_torch.analysis): with no profiler, wrap_step
# returns the step itself, so the disabled instrumentation adds no op
# and no host sync to the step.
# ---------------------------------------------------------------------------

from repro_torch.analysis.contracts import (  # noqa: E402
    TraceContract,
    register_trace_contract,
)


def _instrumented_step_point():
    """The production fused decode step, run raw (``wrapped=0``) and
    through the disabled profile wrapper (``wrapped=1``): the auditor
    requires one op count across both."""

    def build(wrapped: int = 0):
        from repro_torch.serve.engine import fused_step_point

        step, args = fused_step_point("off")(n_slots=3)
        if wrapped:
            step = wrap_step(step, None, "serve.decode_step")
        return step, args

    return build


register_trace_contract(
    "profile.step_instrumentation.disabled",
    _instrumented_step_point(),
    TraceContract(max_host_syncs=0, max_host_to_device=0),
    axes={"wrapped": (0, 1)},
)
