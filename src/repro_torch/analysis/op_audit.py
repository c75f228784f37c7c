"""The op auditor (port of ``repro/analysis/jaxpr_audit.py``): run a
function once, record every aten op it dispatches, and check the
declarative :class:`~repro_torch.analysis.contracts.TraceContract` rules
against that program, plus op-count invariance across the registered
configuration axes (one run per axis value, one single count required).

Where the reference traces a jaxpr, the port runs the call under a
``TorchDispatchMode`` that records each aten op's overload, the dtypes,
shapes and devices of its tensor inputs and outputs, and the scope it
ran in (``contracts.kernel_scope``: inside a kernel wrapper's plain
version). A launch of a hand-written kernel is no aten op: the auditor
reads the wrappers' launch counters (``serve.graph.launch_counted``)
before every op and at the end, and records each launch as a pseudo-op
``kernel:<C entry>``, so a kernel call counts in the program size and a
rule can name it.

The op analysis (``launch/op_analysis.py``) reads the same recorder with
``work=True``: every kernel call, a launch or its plain version, then
adds its pseudo-op with the call's logical work (``info``: M, K, N,
products, bytes; reported by the wrapper, ``contracts.report_call``), a
launch no wrapper reported (a CUDA graph's replay) adds one without work,
which the op analysis refuses, and every collective adds a
``collective:<op>`` pseudo-op with (result bytes, group size)
(``dist.collectives``); the recorder also follows the storages the ops
make (each counted once, however many views share it) and keeps the
peak of their live bytes.

Findings are plain data (rule id, severity, stable message), so the
CLI's report is byte-reproducible: messages embed only op names, dtypes,
shapes and counts, never object ids or tensor addresses.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.contracts import (
    KERNEL_SCOPE,
    OpRule,
    SkipTrace,
    TraceContract,
    TracePoint,
    current_scope,
    get_trace_contract,
    set_rank_mesh,
)

#: ops whose output shape depends on the data: the host waits for it
DATA_DEPENDENT_OPS = frozenset({
    "nonzero", "masked_select", "unique", "_unique", "_unique2", "unique_dim",
    "unique_consecutive", "repeat_interleave",
})
#: the contractions and reductions whose result dtype ``accum_dtype`` pins
ACCUM_OPS = frozenset({"mm", "bmm", "sum", "einsum", "addmm", "baddbmm",
                       "matmul", "mv", "dot"})
PAD_OPS = frozenset({"constant_pad_nd", "pad"})
#: the axis that changes how a rank's program is partitioned: the op count
#: must be one within each of its values, and not grow with the degree
TP_AXIS = "tp"
#: how long a spawned rank group may take for its traces
RANK_TIMEOUT_S = 600.0
#: the pseudo-op prefix of a collective (``collective:all-reduce``)
COLLECTIVE = "collective"


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation. ``where`` is a contract name (op engine) or a
    repo-relative ``path:line`` (lint engine)."""

    severity: str
    engine: str
    rule: str
    where: str
    message: str

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    """What the auditor keeps of a tensor: its dtype name (``"int8"``),
    shape and device type (``"cpu"``, ``"cuda"``)."""

    dtype: str
    shape: Tuple[int, ...]
    device: str

    def __str__(self) -> str:
        return f"{self.dtype}{list(self.shape)}"


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched op: ``op`` is the aten overload
    (``"aten.mm.default"``) or ``"kernel:<C entry>"`` for a kernel launch;
    ``scope`` the stack of kernel scopes it ran in."""

    op: str
    inputs: Tuple[TensorMeta, ...] = ()
    outputs: Tuple[TensorMeta, ...] = ()
    scope: Tuple[str, ...] = ()
    #: a kernel call's logical work (M, K, N, products, bytes) or a
    #: collective's (result bytes, group size); recorded with work=True
    info: Tuple[int, ...] = ()

    @property
    def name(self) -> str:
        """The op's packet name (``"mm"``), or the pseudo-op itself."""
        if self.op.startswith(KERNEL_SCOPE + ":"):
            return self.op
        parts = self.op.split(".")
        return parts[1] if len(parts) > 2 else parts[-1]

    @property
    def is_kernel(self) -> bool:
        return self.op.startswith(KERNEL_SCOPE + ":")

    @property
    def is_collective(self) -> bool:
        return self.op.startswith(COLLECTIVE + ":")


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _tensors(obj, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors of an op's arguments or results, in order (tensors,
    and tensors in lists, tuples and dict values, one level deep as aten
    ops take them)."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            if isinstance(item, torch.Tensor):
                out.append(item)
            elif isinstance(item, (list, tuple, dict)):
                _tensors(item, out)
    elif isinstance(obj, dict):
        _tensors(list(obj.values()), out)
    return out


def _metas(obj) -> Tuple[TensorMeta, ...]:
    return tuple(TensorMeta(_dtype_name(t.dtype), tuple(t.shape), t.device.type)
                 for t in _tensors(obj, []))


class _Recorder(TorchDispatchMode):
    """Records every op dispatched inside, and the kernel launches between
    them (read from the wrappers' launch counters). ``work``: also the
    work of every kernel call and collective, and the peak of the live
    bytes of the storages the ops make (see the module docstring)."""

    def __init__(self, work: bool = False):
        super().__init__()
        from repro_torch.serve.graph import launch_counted

        self.records: List[OpRecord] = []
        self._wrappers = [(fn, fn.entry) for fn in launch_counted()]
        self._seen = [fn.launches for fn, _ in self._wrappers]
        self.work = work
        # storage key -> (weak reference, bytes) of the storages made inside
        self._live: Dict[int, Tuple[Any, int]] = {}
        self._held = 0
        self.peak_bytes = 0

    def __enter__(self):
        if self.work:
            from repro_torch.analysis import contracts
            from repro_torch.dist import collectives

            contracts._CALL_SINKS.append(self._on_call)
            collectives._SINKS.append(self._on_collective)
        return super().__enter__()

    def __exit__(self, *exc):
        if self.work:
            from repro_torch.analysis import contracts
            from repro_torch.dist import collectives

            contracts._CALL_SINKS.remove(self._on_call)
            collectives._SINKS.remove(self._on_collective)
        return super().__exit__(*exc)

    def _on_call(self, entry: str, call: Tuple[int, ...], out, launched: bool) -> None:
        if launched:
            # this launch is counted already: claim it here, with its work,
            # after the launches no wrapper reported
            i = [e for _, e in self._wrappers].index(entry)
            self._seen[i] += 1
            self.poll_launches()
        self.records.append(OpRecord(f"{KERNEL_SCOPE}:{entry}", (), _metas(out),
                                     current_scope(), tuple(call)))
        self._track(_tensors(out, []), ())

    def _on_collective(self, op: str, nbytes: int, n: int) -> None:
        self.records.append(OpRecord(f"{COLLECTIVE}:{op}", scope=current_scope(),
                                     info=(int(nbytes), int(n))))

    def _track(self, outs: List[torch.Tensor], ins: List[torch.Tensor]) -> None:
        """Count the storages of ``outs`` that no input shares and that are
        not counted yet; the peak is exact (expired storages are swept
        before a new peak is taken)."""
        from torch.multiprocessing.reductions import StorageWeakRef

        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen:
                continue
            seen.add(key)
            held = self._live.get(key)
            if held is not None and not held[0].expired():
                continue
            nbytes = st.nbytes()
            if self._held + nbytes > self.peak_bytes:
                self._sweep()
            self._live[key] = (StorageWeakRef(st), nbytes)
            self._held += nbytes
            self.peak_bytes = max(self.peak_bytes, self._held)

    def _sweep(self) -> None:
        for key in [k for k, (ref, _) in self._live.items() if ref.expired()]:
            self._held -= self._live.pop(key)[1]

    def live_bytes(self) -> int:
        """The bytes of the storages made inside that are still alive."""
        self._sweep()
        return self._held

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # nothing here compiles: wrapping the hook in dynamo's disable
        # would import dynamo (seconds) at the first op recorded
        return False

    def poll_launches(self) -> None:
        for i, (fn, entry) in enumerate(self._wrappers):
            moved = fn.launches - self._seen[i]
            if moved:
                self._seen[i] = fn.launches
                # launches no wrapper reported (a graph's replay): no work
                self.records.extend([OpRecord(f"{KERNEL_SCOPE}:{entry}",
                                              scope=current_scope())] * moved)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.poll_launches()
        out = func(*args, **kwargs)
        scope = current_scope()
        self.records.append(OpRecord(str(func), _metas((args, kwargs)), _metas(out),
                                     scope))
        if self.work and not _in_kernel(scope):
            self._track(_tensors(out, []), _tensors((args, kwargs), []))
        return out


def trace_ops(fn, args: Sequence[Any]) -> Tuple[OpRecord, ...]:
    """Run ``fn(*args)`` once and return the ops it dispatched, in order,
    with a ``kernel:<C entry>`` pseudo-op for every kernel launch."""
    rec = _Recorder()
    with rec:
        fn(*args)
    rec.poll_launches()
    return tuple(rec.records)


@dataclasses.dataclass
class Recording:
    """One call recorded with its work (``_Recorder(work=True)``): the trace, the peak of the live bytes of the storages
    made inside it, the bytes of those still alive at its end (its
    results) and what it returned."""

    trace: Tuple[OpRecord, ...]
    peak_bytes: int
    end_bytes: int
    out: Any


def record_call(fn, *args) -> Recording:
    """Run ``fn(*args)`` once under the recorder with kernel calls,
    collectives and live bytes (the op analysis's input)."""
    rec = _Recorder(work=True)
    with rec:
        out = fn(*args)
    rec.poll_launches()
    return Recording(tuple(rec.records), rec.peak_bytes, rec.live_bytes(), out)


def total_ops(trace: Sequence[OpRecord]) -> int:
    """The op count, kernel launches included: the invariance metric."""
    return len(trace)


def kernel_launches(trace: Sequence[OpRecord]) -> Dict[str, int]:
    """Launches per C entry in ``trace``."""
    out: Dict[str, int] = {}
    for r in trace:
        if r.is_kernel:
            entry = r.op.split(":", 1)[1]
            out[entry] = out.get(entry, 0) + 1
    return dict(sorted(out.items()))


# ---------------------------------------------------------------------------
# What each record is
# ---------------------------------------------------------------------------


def _copy_devices(rec: OpRecord) -> Optional[Tuple[str, str]]:
    """(source device, destination device) of a copy op, else None."""
    if rec.name == "copy_" and len(rec.inputs) >= 2:
        return rec.inputs[1].device, rec.inputs[0].device
    if rec.name in ("_to_copy", "_copy_from", "_copy_from_and_resize") \
            and rec.inputs and rec.outputs:
        return rec.inputs[0].device, rec.outputs[0].device
    return None


def is_host_sync(rec: OpRecord) -> bool:
    """``.item()`` and kin, a device->host copy, or an op whose output
    shape depends on the data (the host must read it)."""
    if rec.name == "_local_scalar_dense" or rec.name in DATA_DEPENDENT_OPS:
        return True
    if rec.name in ("index", "index_put", "index_put_") and any(
            t.dtype == "bool" for t in rec.inputs[1:]):
        return True  # a boolean mask's selection is data-dependent
    devs = _copy_devices(rec)
    return devs is not None and devs[0] != "cpu" and devs[1] == "cpu"


def is_host_to_device(rec: OpRecord) -> bool:
    """``torch.tensor(...)`` of host data (``lift_fresh``) or a copy from
    the host to a device."""
    if rec.name in ("lift_fresh", "lift_fresh_copy"):
        return True
    devs = _copy_devices(rec)
    return devs is not None and devs[0] == "cpu" and devs[1] != "cpu"


def _scope_ok(rule: OpRule, scope: Tuple[str, ...]) -> bool:
    if rule.within is None:
        return True
    kernels = [s for s in scope if s.startswith(KERNEL_SCOPE + ":")]
    if rule.within == "top":
        return not kernels
    if rule.within == KERNEL_SCOPE:
        return bool(kernels)
    return rule.within in scope


def _in_kernel(scope: Tuple[str, ...]) -> bool:
    return any(s.startswith(KERNEL_SCOPE + ":") for s in scope)


def _op_matches(rule: OpRule, rec: OpRecord) -> bool:
    return rule.op is None or rule.op in (rec.op, rec.name)


def _ops(metas) -> str:
    return "[" + ", ".join(str(m) for m in metas) + "]"


def _depth(scope: Tuple[str, ...]) -> str:
    return "[" + ", ".join(scope) + "]"


def check_trace(trace: Sequence[OpRecord], contract: TraceContract,
                where: str) -> List[Finding]:
    """Run every op rule of ``contract`` over one recorded program.
    Returns deduplicated, deterministic findings."""
    found: List[Finding] = []

    def emit(rule: str, message: str, severity: str = "P1") -> None:
        found.append(Finding(severity=severity, engine="ops", rule=rule,
                             where=where, message=message))

    syncs = h2d = 0
    for rec in trace:
        if is_host_sync(rec):
            syncs += 1
        if is_host_to_device(rec):
            h2d += 1
        if contract.no_pad_on_dtypes and rec.name in PAD_OPS | {"cat"}:
            src = rec.inputs[:1] if rec.name in PAD_OPS else rec.inputs
            for t in src:
                if t.dtype in contract.no_pad_on_dtypes:
                    emit("pad-on-dtype",
                         f"{rec.name} on {t} operand (depth {_depth(rec.scope)}) "
                         f"-- forbidden dtypes {list(contract.no_pad_on_dtypes)}")
        if contract.accum_dtype and rec.name in ACCUM_OPS and _in_kernel(rec.scope):
            got = rec.outputs[0].dtype if rec.outputs else "?"
            if got != contract.accum_dtype:
                emit("accum-dtype",
                     f"{rec.name} inside {_depth(rec.scope)} accumulates in {got}, "
                     f"contract requires {contract.accum_dtype} "
                     f"(operands {_ops(rec.inputs)})")
        for rule in contract.forbid_ops:
            if not _op_matches(rule, rec) or not _scope_ok(rule, rec.scope):
                continue
            if rule.when is not None and not rule.when(rec):
                continue
            emit(rule.rule,
                 f"forbidden {rec.name} (depth {_depth(rec.scope)}, operands "
                 f"{_ops(rec.inputs)})" + (f": {rule.reason}" if rule.reason else ""))
        for dtype_name, shape in contract.forbid_dtype_shapes:
            for t in rec.outputs:
                if t.dtype == dtype_name and t.shape == tuple(shape):
                    emit("forbid-dtype-shape",
                         f"{rec.name} produces {dtype_name}{list(shape)} "
                         f"(depth {_depth(rec.scope)}) -- forbidden by contract")
    if contract.max_host_syncs is not None and syncs > contract.max_host_syncs:
        emit("max-host-syncs",
             f"{syncs} host sync(s) in the program, contract allows "
             f"{contract.max_host_syncs} -- a host wait inside the step breaks "
             f"the one-fetch-per-step serving discipline")
    if contract.max_host_to_device is not None and h2d > contract.max_host_to_device:
        emit("max-host-to-device",
             f"{h2d} host->device cop(ies) in the program, contract allows "
             f"{contract.max_host_to_device} -- a captured CUDA graph cannot "
             f"hold one")
    n = total_ops(trace)
    if contract.max_ops is not None and n > contract.max_ops:
        emit("max-ops", f"{n} ops > contract cap {contract.max_ops}")
    return _dedupe(found)


def _dedupe(findings: List[Finding]) -> List[Finding]:
    seen, unique = set(), []
    for f in findings:
        if f not in seen:
            seen.add(f)
            unique.append(f)
    return unique


def sass_skips(contract: TraceContract) -> List[str]:
    """The contract's SASS pins, as the skips of a run that reads no
    SASS."""
    return [f"sass {pin.describe()}: read from the card's SASS (chip_smoke.py)"
            for pin in contract.sass_pins]


def check_sass(contract: TraceContract, where: str,
               instances: Dict[str, Dict[str, str]]) -> List[Finding]:
    """Apply ``contract``'s SASS pins: ``instances`` maps a C entry to
    {instance name: its SASS text}. An entry with no instance is itself
    a finding."""
    found: List[Finding] = []
    for pin in contract.sass_pins:
        texts = instances.get(pin.entry) or {}
        if not texts:
            found.append(Finding("P1", "sass", pin.rule, where,
                                 f"no SASS instance of {pin.entry} to check "
                                 f"{pin.describe()}"))
        for name in sorted(texts):
            text = texts[name]
            missing = pin.require and not any(op in text for op in pin.require)
            present = [op for op in pin.forbid if op in text]
            if missing or present:
                found.append(Finding(
                    "P1", "sass", pin.rule, where,
                    f"{pin.entry} instance {name}: SASS breaks {pin.describe()}"
                    + (f": {pin.reason}" if pin.reason else "")))
    return _dedupe(found)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def audit(fn, args: tuple, contract: TraceContract, *,
          name: str = "<adhoc>") -> List[Finding]:
    """Run ``fn(*args)`` under the recorder and check ``contract``'s op
    rules. The direct, test-friendly entry point; registered contracts
    add the invariance axes on top (:func:`run_contract`)."""
    return check_trace(trace_ops(fn, args), contract, name)


def _label(kv: Dict[str, Any]) -> str:
    return ",".join(f"{k}={v}" for k, v in kv.items()) or "-"


def _combos(axes: Dict[str, Tuple[Any, ...]]) -> List[Dict[str, Any]]:
    names = sorted(axes)
    return [dict(zip(names, c))
            for c in (list(itertools.product(*(axes[a] for a in names))) or [()])]


def _run_build(build, kv: Dict[str, Any]):
    """(trace, None) or (None, skip message) of one combination."""
    try:
        fn, args = build(**kv)
    except SkipTrace as e:
        return None, str(e)
    return trace_ops(fn, args), None


def _assemble(name: str, contract: TraceContract,
              results: List[Tuple[Dict[str, Any], Optional[Tuple[OpRecord, ...]],
                                  Optional[str]]],
              extra_skips: Sequence[str] = ()
              ) -> Tuple[List[Finding], Dict[str, Any]]:
    """Findings and meta of one contract from its combinations' results
    ((combo, trace or None, skip message or None)): the op rules on every
    trace, one op count across the combos of each TP degree, and a count
    that does not grow with the degree above 1."""
    findings: List[Finding] = []
    counts: Dict[str, int] = {}
    skipped: List[str] = list(extra_skips)
    by_tp: Dict[Any, Dict[str, int]] = {}
    for kv, trace, skip in results:
        label = _label(kv)
        if trace is None:
            skipped.append(f"{label}: {skip}")
            continue
        counts[label] = by_tp.setdefault(kv.get(TP_AXIS), {})[label] = total_ops(trace)
        findings.extend(check_trace(trace, contract, name))
    for group in by_tp.values():
        if len(set(group.values())) > 1:
            others = sorted(a for a in results[0][0] if a != TP_AXIS)
            findings.append(Finding(
                severity="P1", engine="ops", rule="op-count-variant", where=name,
                message=(
                    f"op count varies with {others}: "
                    f"{ {k: group[k] for k in sorted(group)} } "
                    "-- the step must stay one fixed batched program "
                    "(per-slot python work is leaking into it)"),
            ))
    # a rank runs an explicitly partitioned program: a degree adds its
    # collectives, so the count may differ from the unsplit one (tp 1),
    # but per-shard python work would make it grow with the degree
    per_tp = {d: max(g.values()) for d, g in by_tp.items() if d is not None and d > 1}
    degrees = sorted(per_tp)
    if any(per_tp[b] > per_tp[a] for a, b in zip(degrees, degrees[1:])):
        findings.append(Finding(
            severity="P1", engine="ops", rule="op-count-variant", where=name,
            message=(
                f"op count grows with tp: { {f'tp={d}': per_tp[d] for d in degrees} } "
                "-- per-shard python work is leaking into the rank's program"),
        ))
    meta = {"op_counts": {k: counts[k] for k in sorted(counts)},
            "skipped": sorted(skipped)}
    return _dedupe(findings), meta


def audit_invariance(
    build,
    axes: Dict[str, Tuple[Any, ...]],
    *,
    contract: Optional[TraceContract] = None,
    name: str = "<adhoc>",
) -> Tuple[List[Finding], Dict[str, Any]]:
    """Run ``build(**combo)`` over the cross product of ``axes`` in this
    process and require a single op count; additionally check
    ``contract``'s op rules (when given) on every variant.

    Returns ``(findings, meta)`` with ``meta["op_counts"]`` mapping the
    axis combo (as a stable string) to its count and ``meta["skipped"]``
    listing combos a builder refused (:class:`SkipTrace`)."""
    contract = contract or TraceContract()
    results = [(kv,) + _run_build(build, kv) for kv in _combos(dict(axes))]
    return _assemble(name, contract, results)


def _rank_traces(mesh, jobs):
    """Rank function of a spawned group: run the registered builders of
    ``jobs`` ((contract name, combo) pairs) under this rank's mesh;
    returns rank 0's traces or skip messages, in order."""
    set_rank_mesh(mesh)
    try:
        out = []
        for name, kv in jobs:
            out.append(_run_build(get_trace_contract(name).build, kv))
        return out
    finally:
        set_rank_mesh(None)


def _spawned(jobs_by_tp: Dict[int, List[Tuple[str, Dict[str, Any]]]]):
    """Run each degree's jobs in one spawned gloo group of that size
    (rank 0's results), the groups at once; a group that cannot spawn
    skips its jobs."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.mesh import spawn_tp

    def group(tp):
        jobs = jobs_by_tp[tp]
        try:
            return spawn_tp(_rank_traces, tp, jobs, timeout=RANK_TIMEOUT_S, threads=1)
        except (RuntimeError, TimeoutError, OSError) as e:
            first = str(e).strip().splitlines()[0] if str(e).strip() else type(e).__name__
            return [(None, f"the tp={tp} rank group failed: {first}")] * len(jobs)

    degrees = sorted(jobs_by_tp)
    with ThreadPoolExecutor(max_workers=len(degrees)) as pool:
        outs = dict(zip(degrees, pool.map(group, degrees)))
    results: Dict[Tuple[str, str], Tuple[Any, Optional[str]]] = {}
    for tp in degrees:
        for (name, kv), res in zip(jobs_by_tp[tp], outs[tp]):
            results[(name, _label(kv))] = tuple(res)
    return results


def run_contracts(points: Sequence[TracePoint]
                  ) -> Dict[str, Tuple[List[Finding], Dict[str, Any]]]:
    """Run registered points: op rules on every axis combination plus
    op-count invariance. Combinations with ``tp`` > 1 run in rank 0 of
    one spawned group per degree, which every point shares; the rest in
    this process. A contract's SASS pins are recorded as skips."""
    remote: Dict[int, List[Tuple[str, Dict[str, Any]]]] = {}
    local: Dict[Tuple[str, str], Tuple[Any, Optional[str]]] = {}
    for point in points:
        for kv in _combos(dict(point.axes)):
            tp = int(kv.get(TP_AXIS, 1))
            if tp > 1:
                remote.setdefault(tp, []).append((point.name, kv))
            else:
                local[(point.name, _label(kv))] = _run_build(point.build, kv)
    if remote:
        local.update(_spawned(remote))
    out = {}
    for point in points:
        results = [(kv,) + tuple(local[(point.name, _label(kv))])
                   for kv in _combos(dict(point.axes))]
        out[point.name] = _assemble(point.name, point.contract, results,
                                    sass_skips(point.contract))
    return out


def run_contract(point_or_name) -> Tuple[List[Finding], Dict[str, Any]]:
    """Run one registered :class:`TracePoint` (by object or name): op
    rules on every axis combination plus op-count invariance. The unit
    the tests call; the CLI runs all of them at once
    (:func:`run_contracts`)."""
    point: TracePoint = (
        point_or_name if isinstance(point_or_name, TracePoint)
        else get_trace_contract(point_or_name)
    )
    return run_contracts([point])[point.name]

