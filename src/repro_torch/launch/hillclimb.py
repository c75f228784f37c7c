"""Perf-iteration driver (the counterpart of ``repro/launch/hillclimb.py``).

Runs one hillclimb cell — an (arch, shape) pair with config overrides —
through the dry run (``launch.dryrun.lower_cell``, the meta device) and
records the roofline JSON:

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch starcoder2-7b --shape train_4k --name A1 \\
        --quant cim_fused --cfg '{"attn_chunk": 2048}' \\
        --qc '{"pre_quantized": true}' --out results/perf

With ``--calibration PATH`` (a saved
:class:`repro_torch.profile.calibrate.CalibrationTable`, fitted on the
card) the cell is additionally *scored* with the fitted per-(exec-spec,
shape-class) kernel costs, the measured analog of the analytic roofline:
the cell's weight-bearing GEMM workload (``hw.workload.workload_layers``)
is costed through each fit's ``predict_us`` and the score lands in the
cell JSON under ``"calibrated"``. Scores whose consulted fits carry a
residual above ``RESIDUAL_GATE_PCT`` are marked untrusted (``"trusted":
false``) — :func:`rank_candidates` sorts them last so a noisy fit never
silently reorders a perf iteration. ``--fsdp`` spreads the decode cell's
large leaves over the data axis (``lower_cell(fsdp=True)``).
"""
import argparse
import dataclasses
import json
import os

#: fits with a median relative error above this are scoring-ineligible:
#: the score is still reported, but flagged untrusted and ranked last
RESIDUAL_GATE_PCT = 25.0


def score_cell(arch, shape, table, spec=None,
               residual_gate_pct: float = RESIDUAL_GATE_PCT) -> dict:
    """Score one (arch, shape) cell with a fitted calibration table.

    Costs every weight-bearing GEMM of one forward
    (``hw.workload.workload_layers`` — the same workload the analytic
    system projection uses) through the table's kernel fits under
    ``spec`` (default: the table's ``default_spec``), dispatched per
    layer by shape class exactly like the execution API. Returns::

        {"spec", "predicted_us", "layers", "classes",
         "worst_residual_pct", "trusted"}

    ``trusted`` is False when any consulted fit's ``residual_pct``
    exceeds ``residual_gate_pct`` (or a shape class had to borrow the
    other class's fit) — the fit may rank candidates wrong, so
    :func:`rank_candidates` pushes such scores below every trusted one.
    """
    from repro_torch.hw.workload import _resolve, workload_layers
    from repro_torch.profile.calibrate import DECODE_M_MAX, kernel_key

    cfg, shape_cell = _resolve(arch, shape)
    layers = workload_layers(cfg, shape_cell)
    spec = spec or table.default_spec
    total = 0.0
    classes = set()
    worst = 0.0
    trusted = True
    for layer, count in layers:
        cls = "decode" if layer.m <= DECODE_M_MAX else "prefill"
        classes.add(cls)
        fit = table.kernels.get(kernel_key(spec, cls))
        if fit is None:
            # the other class's fit: usable, but extrapolated — never
            # trust a ranking built on it
            trusted = False
            other = "prefill" if cls == "decode" else "decode"
            fit = table.kernels.get(kernel_key(spec, other))
        if fit is None:
            known = ", ".join(sorted(table.kernels))
            raise KeyError(f"no kernel fit for spec {spec!r} (known: {known})")
        worst = max(worst, float(fit.residual_pct))
        total += fit.predict_us(layer.m, layer.k, layer.n) * count
    if worst > residual_gate_pct:
        trusted = False
    return {
        "spec": spec,
        "predicted_us": round(total, 3),
        "layers": len(layers),
        "classes": sorted(classes),
        "worst_residual_pct": worst,
        "trusted": trusted,
    }


def rank_candidates(candidates, table,
                    residual_gate_pct: float = RESIDUAL_GATE_PCT) -> list:
    """Rank perf-iteration candidates by fitted cost, fastest first.

    ``candidates``: iterable of ``(name, arch, shape)`` or
    ``(name, arch, shape, spec)`` tuples. Returns
    ``[(name, score_dict), ...]`` sorted by ``predicted_us`` ascending
    with every untrusted score (high-residual or borrowed-class fit)
    after every trusted one, so calibration noise cannot promote a
    candidate."""
    scored = []
    for cand in candidates:
        name, arch, shape = cand[0], cand[1], cand[2]
        spec = cand[3] if len(cand) > 3 else None
        scored.append((name, score_cell(
            arch, shape, table, spec=spec,
            residual_gate_pct=residual_gate_pct)))
    return sorted(scored,
                  key=lambda ns: (not ns[1]["trusted"], ns[1]["predicted_us"]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--name", required=True)
    ap.add_argument("--quant", default=None)
    ap.add_argument("--cfg", default=None, help="JSON ArchConfig overrides")
    ap.add_argument("--qc", default=None, help="JSON QuantConfig overrides")
    ap.add_argument("--array-spec", default=None,
                    help="hardware binding: TECH[/DESIGN][/RxC][/aN][/pP] "
                         "(e.g. 3T-FEMFET/CiM-I); recorded in the "
                         "roofline JSON so perf cells say what hardware "
                         "they were costed on")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--calibration", default=None, metavar="PATH",
                    help="saved CalibrationTable JSON (profile.calibrate); "
                         "scores the cell's GEMM workload with the fitted "
                         "per-(spec, shape-class) costs next to the "
                         "analytic roofline")
    ap.add_argument("--out", default="results/perf")
    args = ap.parse_args(argv)

    table = None
    if args.calibration is not None:
        from repro_torch.profile.calibrate import CalibrationTable

        try:
            table = CalibrationTable.load(args.calibration)
        except (OSError, ValueError, KeyError) as e:
            ap.error(f"bad --calibration {args.calibration!r}: {e}")

    # Validate registry-facing arguments up front with the valid sets in
    # the message
    from repro_torch.models.registry import ARCH_IDS, SHAPES

    if args.arch not in ARCH_IDS:
        ap.error(f"unknown --arch {args.arch!r}; registered archs: "
                 f"{', '.join(ARCH_IDS)}")
    if args.shape not in SHAPES:
        ap.error(f"unknown --shape {args.shape!r}; registered shapes: "
                 f"{', '.join(SHAPES)}")
    if args.array_spec is not None:
        from repro_torch import hw

        try:
            hw.parse_array_spec(args.array_spec)
        except ValueError as e:
            ap.error(f"bad --array-spec: {e}")

    from repro_torch.launch.dryrun import lower_cell

    res = lower_cell(
        args.arch,
        args.shape,
        multi_pod=args.multi_pod,
        quant_mode=args.quant,
        cfg_overrides=json.loads(args.cfg) if args.cfg else None,
        quant_overrides=json.loads(args.qc) if args.qc else None,
        fsdp=args.fsdp,
        array_spec=args.array_spec,
    )
    if table is not None and res.ok and not (res.error or "").startswith("SKIP"):
        try:
            res.calibrated = score_cell(args.arch, args.shape, table)
        except KeyError as e:
            res.calibrated = {"error": str(e)}
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.arch}__{args.shape}__{args.name}.json")
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(res), f, indent=1)
    print("saved", path)
    if res.roofline:
        r = res.roofline
        print(
            f"Tc={r['t_compute_s']:.3e} Tm={r['t_memory_s']:.3e} "
            f"Tx={r['t_collective_s']:.3e} bottleneck={r['bottleneck']}"
        )
        if res.calibrated and "predicted_us" in res.calibrated:
            c = res.calibrated
            print(f"calibrated[{c['spec']}]: {c['predicted_us']:.1f}us "
                  f"(worst residual {c['worst_residual_pct']}%, "
                  f"{'trusted' if c['trusted'] else 'UNTRUSTED'})")
        return 0
    print("ERROR:", res.error)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
