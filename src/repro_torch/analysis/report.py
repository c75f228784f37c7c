"""Report assembly, the baseline ratchet, and the CLI behind
``python -m repro_torch.analysis`` (port of ``repro/analysis/report.py``).

The report is deterministic by construction (sorted findings, stable
messages, no timestamps): running the CLI twice on the same tree
produces byte-identical JSON, and ``ANALYSIS_torch_baseline.json`` is
exactly the canonical serialization of the current findings. ``--check``
is the gate: any finding not in the baseline fails (regression), and any
baseline entry no longer found also fails (the ratchet must shrink:
rerun with ``--write-baseline`` and commit the smaller file).

The contracts whose builds need the card (a ``cuda`` backend, the
kernels' launches) run on it where ``torch.cuda.is_available()``, and
are recorded as skips elsewhere; the rest run on the CPU at smoke size,
as the reference's traces do. Both give the same findings.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.analysis.op_audit import Finding

BASELINE_NAME = "ANALYSIS_torch_baseline.json"


def repo_root(start: Optional[Path] = None) -> Path:
    """Nearest ancestor holding src/repro_torch (the tree the lint walks
    and the baseline lives in)."""
    p = Path(start or __file__).resolve()
    for parent in (p, *p.parents):
        if (parent / "src" / "repro_torch").is_dir():
            return parent
    raise FileNotFoundError("no src/repro_torch above " + str(p))


def build_report(
    root: Optional[Path] = None, *, lint: bool = True, audit: bool = True
) -> Dict[str, Any]:
    """Run both engines and assemble the full report: sorted findings,
    per-severity/per-rule summary, and per-contract metadata (op counts
    per axis combination, skipped combos and SASS pins)."""
    from repro_torch.analysis import contracts as C
    from repro_torch.analysis import lint as L
    from repro_torch.analysis import op_audit as O

    root = Path(root) if root else repo_root()
    findings: List[Finding] = []
    contract_meta: Dict[str, Any] = {}
    if lint:
        findings.extend(L.lint_paths(root))
        findings.extend(L.docstring_findings(root))
    if audit:
        for name, (f, meta) in O.run_contracts(C.registered_trace_contracts()).items():
            findings.extend(f)
            contract_meta[name] = meta
    findings = sorted(set(findings))
    summary: Dict[str, Any] = {
        "total": len(findings),
        "by_severity": {},
        "by_rule": {},
    }
    for f in findings:
        summary["by_severity"][f.severity] = summary["by_severity"].get(f.severity, 0) + 1
        summary["by_rule"][f.rule] = summary["by_rule"].get(f.rule, 0) + 1
    summary["by_severity"] = dict(sorted(summary["by_severity"].items()))
    summary["by_rule"] = dict(sorted(summary["by_rule"].items()))
    return {
        "version": 1,
        "findings": [f.to_dict() for f in findings],
        "summary": summary,
        "contracts": dict(sorted(contract_meta.items())),
    }


def baseline_payload(report: Dict[str, Any]) -> Dict[str, Any]:
    """The ratcheted subset of a report: what the committed baseline
    pins byte for byte."""
    return {"version": report["version"], "findings": report["findings"]}


def canonical_json(payload: Dict[str, Any]) -> str:
    return json.dumps(payload, indent=2, sort_keys=True) + "\n"


def _key(d: Dict[str, str]) -> Tuple[str, str, str, str, str]:
    return (d["engine"], d["rule"], d["where"], d["severity"], d["message"])


def diff_against_baseline(
    report: Dict[str, Any], baseline: Dict[str, Any]
) -> Tuple[List[Dict], List[Dict]]:
    """(new findings not in the baseline, stale baseline entries no
    longer found)."""
    now = {_key(f): f for f in report["findings"]}
    base = {_key(f): f for f in baseline.get("findings", [])}
    new = [now[k] for k in sorted(now.keys() - base.keys())]
    fixed = [base[k] for k in sorted(base.keys() - now.keys())]
    return new, fixed


def _print_findings(findings: List[Dict], out=sys.stdout) -> None:
    for f in findings:
        print(f"  [{f['severity']}] {f['rule']} @ {f['where']}\n"
              f"      {f['message']}", file=out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis: op-level tracing contracts + source "
                    f"lint, ratcheted against {BASELINE_NAME}.",
    )
    ap.add_argument("--check", action="store_true",
                    help="fail (exit 1) on any finding not in the "
                         "baseline, or any stale baseline entry")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from this run's findings")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full report (findings + summary + "
                         "per-contract metadata) to PATH")
    ap.add_argument("--baseline", metavar="PATH",
                    help=f"baseline file (default <root>/{BASELINE_NAME})")
    ap.add_argument("--root", metavar="PATH",
                    help="repo root (default: auto-detected)")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the source AST lint engine")
    ap.add_argument("--no-audit", action="store_true",
                    help="skip the op contract auditor")
    args = ap.parse_args(argv)

    root = Path(args.root) if args.root else repo_root()
    report = build_report(root, lint=not args.no_lint, audit=not args.no_audit)
    baseline_path = Path(args.baseline) if args.baseline else root / BASELINE_NAME

    if args.json:
        Path(args.json).write_text(canonical_json(report))

    s = report["summary"]
    print(f"repro_torch.analysis: {s['total']} finding(s) "
          f"{s['by_severity'] or ''}  rules {s['by_rule'] or ''}")
    for name, meta in report["contracts"].items():
        counts = meta["op_counts"]
        uniq = sorted(set(counts.values()))
        tag = "ops=" + ("/".join(map(str, uniq)) if uniq else "-")
        skip = f" (skipped: {len(meta['skipped'])})" if meta["skipped"] else ""
        print(f"  contract {name}: {len(counts)} trace(s), {tag}{skip}")

    if args.write_baseline:
        baseline_path.write_text(canonical_json(baseline_payload(report)))
        print(f"wrote {baseline_path} ({s['total']} finding(s))")
        return 0

    if args.check:
        if not baseline_path.exists():
            print(f"ERROR: no baseline at {baseline_path} "
                  f"(run --write-baseline and commit it)", file=sys.stderr)
            return 1
        baseline = json.loads(baseline_path.read_text())
        new, fixed = diff_against_baseline(report, baseline)
        if new:
            print(f"\nFAIL: {len(new)} new finding(s) vs baseline:")
            _print_findings(new)
        if fixed:
            print(f"\nFAIL: {len(fixed)} baseline entr{'y' if len(fixed) == 1 else 'ies'} "
                  f"no longer found -- ratchet down: rerun with "
                  f"--write-baseline and commit the smaller baseline:")
            _print_findings(fixed)
        if new or fixed:
            return 1
        print(f"check ok: findings match {baseline_path.name} exactly")
        return 0

    _print_findings(report["findings"])
    return 0
