"""Declarative tracing contracts: the vocabulary and the registry (port of
``repro/analysis/contracts.py``).

A :class:`TraceContract` names the invariants that one entry point of the
port must hold when it runs: how many host syncs and host-to-device
copies the ops it dispatches may contain, which dtypes must never be
padded, which ops are forbidden (optionally only inside or outside a
hand-written kernel's plain version), what dtype the plain version of a
kernel must accumulate in, and which configuration axes the op count
must be *invariant* to (the "one batched program" serving discipline: a
step's size independent of ``n_slots``, of the TP degree and of the
profiler's wrapper).

Where the reference walks a jaxpr, the port walks the aten ops that one
call dispatches (``repro_torch.analysis.op_audit``), and a launch of a
hand-written kernel counts as one pseudo-op ``kernel:<C entry>``. Two
rules of the reference are about the TPU kernel body (the accumulation
dtype of its dots and its DMA structure); on the card they become facts
of the SASS that ``nvcc`` emits for every instance of the kernel
(:class:`SassPin`), which the contract records and ``chip_smoke.py``
applies to the SASS it reads. Where no SASS is read (the CPU, the CLI)
they are recorded as skips, never dropped.

Contracts are declared **at the definition site**: ``serve/engine.py``,
``core/execution.py``, ``kernels/packed_mac.py``,
``serve/frontdoor/worker.py`` and ``profile/trace.py`` each call
:func:`register_trace_contract` next to the code whose discipline the
contract pins. One registry then drives the op auditor, the tests and
the ``python -m repro_torch.analysis`` CLI and its baseline.

This module imports nothing heavy (no torch): the definition sites import
it at import time, and builders defer every heavy import until the
auditor runs them. :func:`kernel_scope` marks where a kernel wrapper runs
its plain version, so that a rule's ``within`` can name it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import threading
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

#: the scope a kernel wrapper's plain version runs in is ``kernel:<C
#: entry>``; ``within="kernel"`` matches any of them
KERNEL_SCOPE = "kernel"


@dataclasses.dataclass(frozen=True)
class OpRule:
    """Forbid (occurrences of) one op, optionally predicated.

    rule:   stable rule id for reports and baselines (kebab-case).
    op:     op to match: an aten overload (``"aten.constant_pad_nd.default"``),
            its packet name (``"constant_pad_nd"``) or a kernel pseudo-op
            (``"kernel:packed_decode_mac"``); ``None`` matches every op
            (predicate-only rules).
    within: ``None`` = anywhere; ``"kernel"`` = inside any kernel's plain
            version; ``"kernel:<C entry>"`` = inside that kernel's;
            ``"top"`` = outside every kernel scope.
    when:   optional ``record -> bool`` refinement (an
            ``op_audit.OpRecord``: ``op``, ``inputs``, ``outputs``,
            ``scope``); the rule fires only where it returns True. Keep
            predicates pure functions of the record's dtypes, shapes and
            devices so findings are deterministic across runs.
    reason: one line shown in the finding message.
    """

    rule: str
    op: Optional[str] = None
    within: Optional[str] = None
    when: Optional[Callable[[Any], bool]] = None
    reason: str = ""


#: the ops that change an operand's dtype
CONVERT_OPS = ("_to_copy", "to", "copy_", "_to_dtype")


def _is_kind(name: str, kinds) -> bool:
    for kind in kinds:
        # kind "int" covers every signed/unsigned width: both are integer
        # event carriers
        if kind == "int" and name.startswith(("int", "uint")):
            return True
        if name == kind:
            return True
    return False


def forbid_convert(
    *,
    from_kinds: Tuple[str, ...] = ("int",),
    to: Tuple[str, ...] = ("float32", "float64"),
    within: Optional[str] = KERNEL_SCOPE,
    rule: str = "no-f32-event-promotion",
    reason: str = "integer ADC event counts must stay integer",
) -> OpRule:
    """An :class:`OpRule` forbidding a conversion from an integer (or
    listed-kind) dtype to the listed float dtypes: the regression class
    where int8/int32 ADC event counts get silently promoted to f32. A
    conversion is an explicit one (``.to``, ``.float()``, a ``copy_``
    into a float tensor) or an op whose tensor inputs are all of the
    listed kinds and whose output is such a float (``counts * 0.5``, a
    true division). Default scope: inside the kernels' plain versions,
    where the decode path's int32 accumulation contract lives."""

    def _when(rec) -> bool:
        if not rec.outputs or not rec.inputs:
            return False
        if rec.name == "copy_":
            # copy_(dst, src): the source is the second input
            src, dst = rec.inputs[1:2], rec.inputs[:1]
        elif rec.name in CONVERT_OPS:
            src, dst = rec.inputs[:1], rec.outputs[:1]
        else:
            src, dst = rec.inputs, rec.outputs
            if not all(_is_kind(t.dtype, from_kinds) for t in src):
                return False
        return (any(_is_kind(t.dtype, from_kinds) for t in src)
                and any(t.dtype in to for t in dst))

    return OpRule(rule=rule, op=None, within=within, when=_when, reason=reason)


@dataclasses.dataclass(frozen=True)
class SassPin:
    """A fact of the SASS of every compiled instance of one kernel.

    rule:    the reference rule it stands for (``"accum-dtype"`` or
             ``"prim-count"``).
    entry:   the kernel's C entry (``"packed_stream_mac"``).
    require: at least one of these opcodes appears in every instance.
    forbid:  none of these opcodes appears in any instance.
    reason:  one line shown in the finding message.
    """

    rule: str
    entry: str
    require: Tuple[str, ...] = ()
    forbid: Tuple[str, ...] = ()
    reason: str = ""

    def describe(self) -> str:
        parts = []
        if self.require:
            parts.append("one of " + "|".join(self.require))
        if self.forbid:
            parts.append("no " + "|".join(self.forbid))
        return f"{self.rule} on {self.entry}: " + ", ".join(parts)


def sass_int_accum(entry: str) -> SassPin:
    """The card's form of ``accum_dtype="int32"``: every instance of
    ``entry`` multiplies on int8 tensor cores (IMMA, which accumulates in
    S32) and holds no float tensor-core MMA (HMMA)."""
    return SassPin("accum-dtype", entry, require=("IMMA",), forbid=("HMMA",),
                   reason="int8 tensor-core MMAs accumulate in S32")


def sass_async_copies(entry: str) -> Tuple[SassPin, SassPin]:
    """The card's form of the stream kernel's DMA pin (2 ``dma_start``,
    1 ``dma_wait``): every instance of ``entry`` copies global->shared
    asynchronously (LDGSTS) and waits on those copies (LDGDEPBAR or
    DEPBAR)."""
    return (SassPin("prim-count", entry, require=("LDGSTS",),
                    reason="the ring's asynchronous global->shared copies"),
            SassPin("prim-count", entry, require=("LDGDEPBAR", "DEPBAR"),
                    reason="the wait on the ring's copies"))


@dataclasses.dataclass(frozen=True)
class TraceContract:
    """The declarative rule set checked against the ops of one call.

    max_host_syncs: cap on host syncs anywhere in the call:
      ``aten._local_scalar_dense`` (``.item()``, ``int(t)``,
      ``bool(t)``), a device->host copy, and the ops whose output shape
      depends on the data (``nonzero``, ``masked_select``, ``unique``, a
      boolean index). The fused decode step pins 0: its single host
      fetch happens *outside* the step.
    max_host_to_device: cap on host->device copies: ``lift_fresh``
      (``torch.tensor(...)`` of host data) and a host->device copy. A
      captured CUDA graph cannot hold one.
    no_pad_on_dtypes: dtype names whose operands must never be padded
      (``("uint8",)``: the stored 2-bit planes enter the kernels in their
      canonical layout, zero per-step relayout); a ``cat`` that grows a
      tensor of such a dtype counts as a pad.
    forbid_ops: tuple of :class:`OpRule`.
    forbid_dtype_shapes: ``((dtype_name, shape), ...)``: no op may
      *produce* a tensor of that dtype and shape.
    accum_dtype: every ``mm``/``bmm``/``sum``/``einsum`` inside a
      kernel's plain version yields exactly this dtype (on the card:
      :attr:`sass_pins`).
    max_ops: optional hard cap on the op count (kernel launches included).
    sass_pins: tuple of :class:`SassPin`: what every compiled instance of
      a kernel on this path must hold in its SASS.

    Op-count *invariance* axes live on the :class:`TracePoint` (they
    parameterize the builder, not the rule set).
    """

    max_host_syncs: Optional[int] = None
    max_host_to_device: Optional[int] = None
    no_pad_on_dtypes: Tuple[str, ...] = ()
    forbid_ops: Tuple[OpRule, ...] = ()
    forbid_dtype_shapes: Tuple[Tuple[str, Tuple[int, ...]], ...] = ()
    accum_dtype: Optional[str] = None
    max_ops: Optional[int] = None
    sass_pins: Tuple[SassPin, ...] = ()


class SkipTrace(Exception):
    """Raised by a builder when one axis combination cannot run here
    (a ``cuda`` backend without a card, a rank group that cannot spawn).
    Recorded as a skip in the run metadata: never a finding, never
    silently dropped."""


@dataclasses.dataclass(frozen=True)
class TracePoint:
    """A registered audit target: ``build(**axes)`` returns ``(fn,
    args)``, run once under the op auditor; ``axes`` maps axis name to the
    values swept for op-count invariance (the auditor runs the full cross
    product and requires one single count). A combination with ``tp`` > 1
    runs in rank 0 of a spawned gloo group of that size, which the
    builder reaches through :func:`rank_mesh`."""

    name: str
    build: Callable[..., Tuple[Callable, tuple]]
    contract: TraceContract
    axes: Mapping[str, Tuple[Any, ...]] = dataclasses.field(default_factory=dict)


_TRACE_REGISTRY: Dict[str, TracePoint] = {}

#: modules whose import populates the registry: the definition sites.
#: The CLI and the reproducibility test import these; adding a new
#: contract-bearing module means adding it here.
DEFAULT_CONTRACT_MODULES = (
    "repro_torch.core.execution",
    "repro_torch.kernels.packed_mac",
    "repro_torch.serve.engine",
    "repro_torch.serve.frontdoor.worker",
    "repro_torch.profile.trace",
)


def register_trace_contract(
    name: str,
    build: Callable[..., Tuple[Callable, tuple]],
    contract: TraceContract,
    *,
    axes: Optional[Mapping[str, Tuple[Any, ...]]] = None,
) -> TracePoint:
    """Register ``name`` as an auditable trace point. Idempotent per
    name (module reloads overwrite); names are dotted, rooted at the
    defining package (``"serve.fused_decode_step"``)."""
    point = TracePoint(name=name, build=build, contract=contract,
                       axes=dict(axes or {}))
    _TRACE_REGISTRY[name] = point
    return point


def get_trace_contract(name: str) -> TracePoint:
    load_default_contracts()
    try:
        return _TRACE_REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_TRACE_REGISTRY))
        raise KeyError(f"no trace contract {name!r} (known: {known})") from None


def registered_trace_contracts() -> Tuple[TracePoint, ...]:
    """Every registered point, sorted by name (deterministic reports)."""
    load_default_contracts()
    return tuple(_TRACE_REGISTRY[k] for k in sorted(_TRACE_REGISTRY))


def load_default_contracts() -> None:
    """Import the definition-site modules so their registrations run."""
    for mod in DEFAULT_CONTRACT_MODULES:
        importlib.import_module(mod)


# ---------------------------------------------------------------------------
# Scopes and the rank a builder runs in
# ---------------------------------------------------------------------------

_LOCAL = threading.local()


def current_scope() -> Tuple[str, ...]:
    """The stack of scopes this thread runs in (empty at the top)."""
    return getattr(_LOCAL, "scope", ())


@contextlib.contextmanager
def kernel_scope(entry: str) -> Iterator[None]:
    """Mark the ops run inside as kernel ``entry``'s plain version (scope
    ``kernel:<entry>``). The wrappers enter it where a CPU tensor takes
    the plain version (through :func:`plain_call`); a launch on the card
    is one pseudo-op instead."""
    prev = current_scope()
    _LOCAL.scope = prev + (f"{KERNEL_SCOPE}:{entry}",)
    try:
        yield
    finally:
        _LOCAL.scope = prev


#: the recorders of kernel calls (``op_audit``'s recorder with
#: ``work=True`` adds one while it runs): ``sink(entry, call, out, launched)``
_CALL_SINKS: list = []


def report_call(entry: str, call: Tuple[int, ...], out, launched: bool) -> None:
    """Report one call of kernel ``entry`` to every installed sink:
    ``call`` is its logical work (M, K, N, products, bytes;
    ``kernels.mac_call``), ``out`` its result, ``launched`` whether it was
    a launch on the card (counted in the wrapper's ``launches`` just
    before) or the plain version (:func:`plain_call`)."""
    for sink in tuple(_CALL_SINKS):
        sink(entry, call, out, launched)


def plain_call(entry: str, call: Tuple[int, ...], fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)``, kernel ``entry``'s plain version, in
    its :func:`kernel_scope`, and report the call (:func:`report_call`)
    with ``call``, the work its launch on the card would do. Returns
    ``fn``'s result."""
    with kernel_scope(entry):
        out = fn(*args, **kwargs)
    report_call(entry, call, out, launched=False)
    return out


_RANK_MESH: Optional[Any] = None


def set_rank_mesh(mesh: Optional[Any]) -> None:
    """Install the mesh of the spawned rank the auditor runs builders in
    (``None`` outside a rank)."""
    global _RANK_MESH
    _RANK_MESH = mesh


def rank_mesh(tp: int):
    """The ``tp``-rank mesh a builder's TP combination runs under: the
    spawned rank's own (``op_audit`` spawns one group per degree);
    :class:`SkipTrace` where this process is no rank of such a group."""
    mesh = _RANK_MESH
    if mesh is None or mesh.size != tp:
        raise SkipTrace(f"tp={tp} runs in a spawned rank group")
    return mesh
