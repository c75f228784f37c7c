"""Least-squares calibration of the hardware model against measured
kernel times (port of ``repro/profile/calibrate.py``): the "calibrate"
leg of profile → calibrate → replay (DESIGN.md §11).

``repro_torch.hw`` costs the paper's arrays *analytically* (registered
ns/pJ parameters, Figs 9–13). This module fits the same cost structure to
what the execution layer measured: on the card, the port's CUDA kernels
(the events ``execution._profiled_call`` emits for eager ``execute`` /
``execute_packed`` calls, each timed to the device's completion, or,
inside ``execution.graph_kernel_events``, as the device time of a
CUDA-graph replay, which is what a captured serve step pays)::

    wall_us ≈ fixed_us + us_per_mmac · (M·K·N / 1e6)
                       + us_per_mb   · (weight_bytes / 1e6)

per ``(exec_spec, shape_class)``: ``fixed_us`` is the per-call fixed
overhead (dispatch, launch and the profiler's sync), ``us_per_mmac`` the
measured per-MAC latency scale (the fitted analog of the array's
``t_cim_mac_ns``), and ``us_per_mb`` the weight-traffic term (the fitted
analog of the macro's weight-traffic model). The fit is plain
non-negative least squares over trace events
(:mod:`repro_torch.profile.trace`); residuals ship with the table so a
bad fit is visible, never silent.

The result is a **versioned** :class:`CalibrationTable`, the reference's
JSON layout: a table saved by either package loads in the other. Its
consumers:

  * ``hw.project(..., calibration=table)`` adds a ``"calibrated"`` block,
    the workload's GEMMs costed from the fitted parameters, beside the
    analytic projection;
  * ``execution.autotune(spec, calibration=table)`` installs the table's
    recorded tile winners (for the port: launch grids, ``(rows, cluster)``
    or ``(rows, cluster, nbuf)``) instead of timing them again;
  * ``profile.replay`` predicts serve tok/s and step latency from it.

Engine-level fits (:func:`fit_engines`) capture what the kernel model
cannot: the per-decode-step fixed overhead of the serving loop (host
bookkeeping, sampling, cache plumbing; on the card the replay of the
captured step) per (arch, mesh), fitted against the batcher's
``serve.decode_step`` events with the kernel model's
occupancy-dependent share subtracted.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.kernels import DECODE_M_MAX
from repro_torch.profile.trace import TraceEvent

#: bump when the table layout changes; loaders reject unknown versions
CALIBRATION_VERSION = 1


def kernel_key(exec_spec: str, shape_class: str) -> str:
    """The table key of one fitted kernel model."""
    return f"{exec_spec}|{shape_class}"


def engine_key(arch: str, mesh: str) -> str:
    """The table key of one fitted serving-step model."""
    return f"{arch}|{mesh}"


def mesh_tag(mesh: Optional[Mapping[str, int]]) -> str:
    """Canonical mesh description for table keys: ``"tp1"`` unsharded,
    else ``"tpN"`` from the 'model' axis."""
    if not mesh:
        return "tp1"
    return f"tp{int(mesh.get('model', 1))}"


@dataclasses.dataclass(frozen=True)
class KernelFit:
    """One fitted kernel cost model (see the module docstring for the
    functional form). ``bytes_per_weight`` records the storage format
    the events measured (2.0 for unpacked bf16/f32 operands, 0.25 for
    2-bit packed planes) so predictions can reconstruct weight bytes
    from (K, N). ``residual_pct`` is the median relative error of the
    fit over its own events — the honesty metric the fit reports."""

    fixed_us: float
    us_per_mmac: float
    us_per_mb: float
    bytes_per_weight: float
    n_events: int
    residual_pct: float

    def predict_us(self, m: int, k: int, n: int) -> float:
        """Predicted wall time of one (M, K) x (K, N) MAC."""
        macs = float(m) * k * n
        weight_bytes = float(k) * n * self.bytes_per_weight
        return (self.fixed_us + self.us_per_mmac * macs * 1e-6
                + self.us_per_mb * weight_bytes * 1e-6)


@dataclasses.dataclass(frozen=True)
class EngineFit:
    """Per-(arch, mesh) serving-step overheads fitted from engine
    events: ``decode_fixed_us`` is the measured fused-step cost with the
    kernel model's occupancy share removed; ``prefill_us`` the median
    batched-prefill wall."""

    arch: str
    mesh: str
    exec_spec: str
    decode_fixed_us: float
    prefill_us: float
    n_decode: int
    n_prefill: int
    residual_pct: float


@dataclasses.dataclass(frozen=True)
class CalibrationTable:
    """The versioned fit artifact (see module docstring). ``backend``
    records where the measurements ran (``"cpu"`` for the plain versions,
    ``"cuda"`` for the port's kernels on the card): fitted numbers are
    only meaningful on the backend that produced them, the analytic /
    fitted split docs/calibration.md documents. ``tile_winners`` maps a
    spec name to ``{shape_class: tuple}``; the tuples are whatever grid
    the fitting package tunes (the reference's ``(bm, bk, bn)``, the
    port's launch grids), validated by the ``autotune`` that installs
    them."""

    version: int
    backend: str
    default_spec: str
    kernels: Mapping[str, KernelFit]
    engines: Mapping[str, EngineFit] = dataclasses.field(default_factory=dict)
    tile_winners: Mapping[str, Mapping[str, Tuple[int, ...]]] = (
        dataclasses.field(default_factory=dict))

    def predict_gemm_us(self, m: int, k: int, n: int,
                        spec: Optional[str] = None) -> float:
        """Predicted wall time of one GEMM under the fitted model for
        ``spec`` (default: the table's ``default_spec``), dispatched by
        shape class like the execution API."""
        spec = spec or self.default_spec
        cls = "decode" if m <= DECODE_M_MAX else "prefill"
        fit = self.kernels.get(kernel_key(spec, cls))
        if fit is None:
            # one-class sweeps still answer for the other class —
            # extrapolation, but a prediction with a residual story
            # beats a KeyError in a projection pipeline
            other = "prefill" if cls == "decode" else "decode"
            fit = self.kernels.get(kernel_key(spec, other))
        if fit is None:
            known = ", ".join(sorted(self.kernels))
            raise KeyError(f"no kernel fit for spec {spec!r} (known: {known})")
        return fit.predict_us(m, k, n)

    def engine_fit(self, arch: str, mesh: str = "tp1") -> EngineFit:
        fit = self.engines.get(engine_key(arch, mesh))
        if fit is None:
            known = ", ".join(sorted(self.engines))
            raise KeyError(
                f"no engine fit for {arch!r} on {mesh!r} (known: {known})")
        return fit

    # -- serialization ------------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "backend": self.backend,
            "default_spec": self.default_spec,
            "kernels": {k: dataclasses.asdict(v)
                        for k, v in sorted(self.kernels.items())},
            "engines": {k: dataclasses.asdict(v)
                        for k, v in sorted(self.engines.items())},
            "tile_winners": {
                s: {c: list(t) for c, t in sorted(classes.items())}
                for s, classes in sorted(self.tile_winners.items())
            },
        }

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "CalibrationTable":
        v = d.get("version")
        if v != CALIBRATION_VERSION:
            raise ValueError(
                f"calibration table version {v!r} != {CALIBRATION_VERSION} "
                f"(re-fit with this tree)")
        return cls(
            version=CALIBRATION_VERSION,
            backend=str(d["backend"]),
            default_spec=str(d["default_spec"]),
            kernels={k: KernelFit(**f) for k, f in d["kernels"].items()},
            engines={k: EngineFit(**f) for k, f in d.get("engines", {}).items()},
            tile_winners={
                s: {c: tuple(int(x) for x in t) for c, t in classes.items()}
                for s, classes in d.get("tile_winners", {}).items()
            },
        )

    def save(self, path: Union[str, Path]) -> None:
        Path(path).write_text(json.dumps(self.to_json(), indent=2,
                                         sort_keys=True) + "\n")

    @classmethod
    def load(cls, path: Union[str, Path]) -> "CalibrationTable":
        return cls.from_json(json.loads(Path(path).read_text()))


# ---------------------------------------------------------------------------
# Fitting
# ---------------------------------------------------------------------------


def _nnls(rows: Sequence[Sequence[float]], y: Sequence[float]) -> List[float]:
    """Tiny non-negative least squares: solve, clamp negative
    coefficients to zero, refit the surviving columns (repeat until
    stable). Good enough for a 3-parameter cost model; keeps fitted
    rates physical (a negative per-MAC latency is a fit artifact, not a
    speedup)."""
    ncol = len(rows[0])
    active = list(range(ncol))
    coef = [0.0] * ncol
    for _ in range(ncol + 1):
        a = [[row[j] for j in active] for row in rows]
        sol, *_ = np.linalg.lstsq(a, list(y), rcond=None)
        neg = [j for j, v in zip(active, sol) if v < 0]
        for j, v in zip(active, sol):
            coef[j] = float(v)
        if not neg:
            break
        for j in neg:
            coef[j] = 0.0
        active = [j for j in active if j not in neg]
        if not active:
            break
    return coef


def _event_features(e: TraceEvent) -> Optional[Tuple[float, float, float]]:
    """(macs, weight_bytes, wall_us) of one kernel event, or None when
    the event lacks the kernel meta."""
    meta = e.meta
    if "m" not in meta or "k" not in meta or "n" not in meta:
        return None
    macs = float(meta["m"]) * meta["k"] * meta["n"]
    wb = float(meta.get("weight_bytes", 2.0 * meta["k"] * meta["n"]))
    return macs, wb, float(e.wall_us)


def fit_kernel(events: Sequence[TraceEvent]) -> KernelFit:
    """Fit one kernel cost model to a homogeneous event group (same
    exec_spec and shape class)."""
    feats = [f for f in (_event_features(e) for e in events) if f is not None]
    if not feats:
        raise ValueError("no kernel events with m/k/n meta to fit")
    rows = [[1.0, macs * 1e-6, wb * 1e-6] for macs, wb, _ in feats]
    y = [wall for _, _, wall in feats]
    fixed, per_mmac, per_mb = _nnls(rows, y)
    fixed = max(fixed, 0.0)
    preds = [fixed + per_mmac * r[1] + per_mb * r[2] for r in rows]
    resid = [abs(p - w) / max(w, 1e-9) for p, w in zip(preds, y)]
    # bytes-per-weight is a property of the storage format: recover it
    # from the first event's (weight_bytes, k*n)
    first = next(e.meta for e in events
                 if _event_features(e) is not None)
    bpw = float(first.get("weight_bytes", 2.0 * first["k"] * first["n"]))
    bpw /= float(first["k"]) * first["n"]
    return KernelFit(
        fixed_us=round(fixed, 4),
        us_per_mmac=round(per_mmac, 6),
        us_per_mb=round(per_mb, 6),
        bytes_per_weight=bpw,
        n_events=len(feats),
        residual_pct=round(100.0 * float(np.median(resid)), 2),
    )


def fit_kernels(events: Sequence[TraceEvent]) -> Dict[str, KernelFit]:
    """Group kernel-level events (``execution.*`` entry points) by
    (exec_spec, shape_class) and fit each group."""
    groups: Dict[str, List[TraceEvent]] = {}
    for e in events:
        if not e.entry_point.startswith("execution."):
            continue
        groups.setdefault(kernel_key(e.exec_spec, e.shape_class), []).append(e)
    return {k: fit_kernel(v) for k, v in sorted(groups.items())}


def fit_engines(
    events: Sequence[TraceEvent],
    kernel_model: Optional[Callable[[str, int], float]] = None,
) -> Dict[str, EngineFit]:
    """Fit per-(arch, mesh) serving-step overheads from engine events.

    ``kernel_model(arch, occupancy) -> us`` supplies the model-side MAC
    share of one fused decode step (see
    :func:`repro_torch.profile.replay.make_kernel_model`); the fitted
    ``decode_fixed_us`` is the median residual after subtracting it.
    Without a kernel model the whole measured step is fixed overhead —
    still a valid (occupancy-insensitive) replay basis.
    """
    decode: Dict[str, List[TraceEvent]] = {}
    prefill: Dict[str, List[TraceEvent]] = {}
    for e in events:
        arch = str(e.meta.get("arch", "?"))
        key = engine_key(arch, mesh_tag(e.mesh))
        if e.entry_point == "serve.decode_step":
            decode.setdefault(key, []).append(e)
        elif e.entry_point == "serve.prefill":
            prefill.setdefault(key, []).append(e)
    out: Dict[str, EngineFit] = {}
    for key in sorted(set(decode) | set(prefill)):
        dev = decode.get(key, [])
        pev = prefill.get(key, [])
        arch, mesh = key.rsplit("|", 1)
        spec = dev[0].exec_spec if dev else (pev[0].exec_spec if pev else "?")
        fixed = 0.0
        resid_pct = 0.0
        if dev:
            kern = [
                kernel_model(arch, int(e.meta.get("occupancy", 1)))
                if kernel_model is not None else 0.0
                for e in dev
            ]
            fixed = max(0.0, float(np.median(
                [e.wall_us - k for e, k in zip(dev, kern)])))
            preds = [fixed + k for k in kern]
            resid = [abs(p - e.wall_us) / max(e.wall_us, 1e-9)
                     for p, e in zip(preds, dev)]
            resid_pct = round(100.0 * float(np.median(resid)), 2)
        pre = float(np.median([e.wall_us for e in pev])) if pev else 0.0
        out[key] = EngineFit(
            arch=arch, mesh=mesh, exec_spec=spec,
            decode_fixed_us=round(fixed, 2),
            prefill_us=round(pre, 2),
            n_decode=len(dev), n_prefill=len(pev),
            residual_pct=resid_pct,
        )
    return out


def calibrate(
    events: Sequence[TraceEvent],
    *,
    backend: str = "cpu",
    default_spec: Optional[str] = None,
    kernel_model: Optional[Callable[[str, int], float]] = None,
    tile_winners: Optional[Mapping[str, Mapping[str, Tuple[int, ...]]]] = None,
) -> CalibrationTable:
    """Build a :class:`CalibrationTable` from a trace: kernel fits from
    the ``execution.*`` events, engine fits from the ``serve.*`` events.
    ``default_spec`` defaults to the first fitted spec name."""
    kernels = fit_kernels(events)
    if default_spec is None:
        specs = sorted({k.rsplit("|", 1)[0] for k in kernels})
        default_spec = specs[0] if specs else "exact/torch/none"
    engines = fit_engines(events, kernel_model)
    return CalibrationTable(
        version=CALIBRATION_VERSION,
        backend=backend,
        default_spec=default_spec,
        kernels=kernels,
        engines=engines,
        tile_winners=dict(tile_winners or {}),
    )
