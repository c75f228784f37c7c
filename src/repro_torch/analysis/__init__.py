"""repro_torch.analysis: static analysis for the tracing contracts that
keep the port's serving fast paths honest (port of ``repro.analysis``).

Two engines share one declarative vocabulary:

  * the **op auditor** (:mod:`repro_torch.analysis.op_audit`) runs a
    function once, records the aten ops it dispatches (and every
    hand-written kernel launch as a ``kernel:<C entry>`` pseudo-op) and
    checks :class:`TraceContract` rules: host-sync and host-to-device
    caps, pad-free dtypes, forbidden ops, the kernels' plain versions'
    accumulation dtype, op-count invariance across config axes; the
    kernels' SASS pins are applied on the card (``chip_smoke.py``);
  * the **source linter** (:mod:`repro_torch.analysis.lint`) flags
    host-sync idioms and tensor branching in step-reachable code.

Contracts are registered at their definition sites
(``core/execution.py``, ``kernels/packed_mac.py``, ``serve/engine.py``,
``serve/frontdoor/worker.py``, ``profile/trace.py``) and drive the
tests, the ``python -m repro_torch.analysis`` CLI, and the
``ANALYSIS_torch_baseline.json`` ratchet alike.
"""
from repro_torch.analysis.contracts import (
    OpRule,
    SassPin,
    SkipTrace,
    TraceContract,
    TracePoint,
    forbid_convert,
    get_trace_contract,
    kernel_scope,
    register_trace_contract,
    registered_trace_contracts,
)
from repro_torch.analysis.op_audit import (
    Finding,
    OpRecord,
    audit,
    audit_invariance,
    check_sass,
    check_trace,
    run_contract,
    run_contracts,
    total_ops,
    trace_ops,
)
from repro_torch.analysis.lint import lint_paths, lint_source
from repro_torch.analysis.report import build_report, diff_against_baseline

__all__ = [
    "Finding",
    "OpRecord",
    "OpRule",
    "SassPin",
    "SkipTrace",
    "TraceContract",
    "TracePoint",
    "audit",
    "audit_invariance",
    "build_report",
    "check_sass",
    "check_trace",
    "diff_against_baseline",
    "forbid_convert",
    "get_trace_contract",
    "kernel_scope",
    "lint_paths",
    "lint_source",
    "register_trace_contract",
    "registered_trace_contracts",
    "run_contract",
    "run_contracts",
    "total_ops",
    "trace_ops",
]
