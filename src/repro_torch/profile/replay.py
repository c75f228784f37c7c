"""Trace replay (port of ``repro/profile/replay.py``): the "replay" leg
of profile → calibrate → replay (DESIGN.md §11).

A discrete-event simulator that mirrors the port's ``ContinuousBatcher``'s
slot discipline (fill slots → batched left-padded prefill → fused
decode step over all slots, until the queue drains) and advances a
simulated clock by **predicted** segment times from a
:class:`~repro_torch.profile.calibrate.CalibrationTable` — so serve tok/s and
p50/p99 step latency can be projected for arbitrary
(arch × ArraySpec × mesh × slot-occupancy) points without running the
model.

The replay builds an explicit dependency graph (:class:`Node`): every
prefill/decode node depends on the nodes whose cache state it consumes.
In the current single-stream engine the graph is a chain — kept
explicit because the node set is what a multi-stream scheduler would
re-order, and because the graph is the honest record of *why* the
predicted wall is the sum it is.

Step-time model::

    decode_step_us(occupancy) = engines[arch|mesh].decode_fixed_us
                              + Σ_gemms kernel_fit.predict_us(occupancy, k, n)
    prefill_us                = engines[arch|mesh].prefill_us

With ``array=`` (an :class:`repro_torch.hw.ArraySpec`), the kernel share is
costed by the **analytic** hardware model instead
(:func:`repro_torch.hw.macro.layer_cost` on the paper's macro) while the
fitted per-step fixed overhead is kept — projecting what this host's
serving loop would sustain if the MACs ran inside CiM arrays. That is
the bridge between the measured engine and the paper's Figs 12/13
claims.

Validated by a predicted-vs-measured error bound on the decode-step
p50 of a holdout profiled run: 50% on the CPU at smoke size
(``tests/test_torch_calibrate.py``, the reference's own bound) and 25%
on the card at full size (``chip_smoke.py`` phase 20).

One difference from the reference, where its replay disagrees with its
own engine: a slot is freed when its next cache write would reach
``s_max`` (the batcher's ``slot_pos >= s_max``, the reference engine's
too), where the reference's :func:`simulate` frees it one step earlier
(``>= s_max - 1``). The two agree on every workload that never fills a
cache.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.profile.calibrate import CalibrationTable, EngineFit, mesh_tag
from repro_torch.profile.trace import TraceEvent


@dataclasses.dataclass(frozen=True)
class ReplayRequest:
    """One simulated request: the lengths drive the work, and
    ``arrival_us`` (0 = offered up front, the offline-replay default)
    drives *when* the simulated engine may admit it — the traffic-model
    axis of the reference's benchmarks/bench_traffic.py."""

    rid: int
    prompt_len: int
    max_new: int
    arrival_us: float = 0.0


@dataclasses.dataclass(frozen=True)
class Node:
    """One node of the replay dependency graph."""

    nid: int
    kind: str                  # "prefill" | "decode"
    deps: Tuple[int, ...]      # node ids whose outputs this node consumes
    us: float                  # predicted duration
    start_us: float            # max(end of deps)
    occupancy: int             # active slots (decode) / filled slots (prefill)

    @property
    def end_us(self) -> float:
        return self.start_us + self.us


def requests_like_bench(vocab: int, n_requests: int, max_new: int
                        ) -> List[ReplayRequest]:
    """The deterministic ragged mix the reference's benchmarks/bench_serve.py submits,
    reduced to its lengths (prompt 1–4 tokens, ragged max_new)."""
    return [ReplayRequest(i, 1 + i % 4, 2 + i % max_new)
            for i in range(n_requests)]


def requests_from_trace(events: Sequence[TraceEvent]) -> List[ReplayRequest]:
    """Reconstruct the request mix a profiled serve run processed, from
    its prefill events' ``prompts`` meta (recorded by the engine hook)."""
    out: List[ReplayRequest] = []
    for e in events:
        if e.entry_point != "serve.prefill":
            continue
        for rid, p_len, max_new in e.meta.get("prompts", []):
            out.append(ReplayRequest(int(rid), int(p_len), int(max_new)))
    return sorted(out, key=lambda r: r.rid)


def poisson_requests(
    rate_rps: float,
    seed: int = 0,
    n_requests: int = 16,
    prompt_len_max: int = 4,
    max_new: int = 8,
) -> List[ReplayRequest]:
    """Synthetic Poisson traffic: ``n_requests`` arrivals with
    exponential inter-arrival gaps at ``rate_rps`` requests/second,
    prompt lengths uniform in [1, prompt_len_max] and ``max_new``
    uniform in [2, max_new] — the same ragged family as
    :func:`requests_like_bench`, but with a real arrival process.

    Deterministic in ``seed`` (one ``numpy`` Generator drives gaps and
    lengths), so the *same* workload can be replayed through
    :func:`simulate` for capacity planning and driven through the real
    front door by the reference's ``benchmarks/bench_traffic.py`` — closing the loop
    between predicted and measured load points (DESIGN.md §12)."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if max_new < 2:
        raise ValueError(f"max_new must be >= 2, got {max_new}")
    rng = np.random.default_rng(seed)
    gaps_us = rng.exponential(1e6 / rate_rps, size=n_requests)
    arrivals = np.cumsum(gaps_us)
    return [
        ReplayRequest(
            rid=i,
            prompt_len=int(rng.integers(1, prompt_len_max + 1)),
            max_new=int(rng.integers(2, max_new + 1)),
            arrival_us=float(arrivals[i]),
        )
        for i in range(n_requests)
    ]


def _next_pow2(n: int, lo: int = 4) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def make_kernel_model(
    table: CalibrationTable,
    cfgs: Mapping[str, object],
    spec: Optional[str] = None,
) -> Callable[[str, int], float]:
    """``(arch, occupancy) -> us``: the fitted kernel model summed over
    the arch's weight-bearing decode GEMMs at M = occupancy
    (``repro_torch.hw.workload`` owns the GEMM enumeration). Unknown archs
    cost 0 — the engine fit then absorbs everything into the fixed
    term."""
    from repro_torch.hw.workload import workload_layers
    from repro_torch.models.registry import ShapeCell

    cache: Dict[Tuple[str, int], float] = {}

    def kernel_us(arch: str, occupancy: int) -> float:
        key = (arch, occupancy)
        if key not in cache:
            cfg = cfgs.get(arch)
            if cfg is None:
                cache[key] = 0.0
            else:
                shape = ShapeCell("replay_decode", "decode", 1,
                                  max(1, occupancy))
                cache[key] = sum(
                    table.predict_gemm_us(layer.m, layer.k, layer.n, spec)
                    * count
                    for layer, count in workload_layers(cfg, shape)
                )
        return cache[key]

    return kernel_us


def make_array_kernel_model(
    cfgs: Mapping[str, object],
    array,
    macro=None,
) -> Callable[[str, int], float]:
    """Analytic variant of :func:`make_kernel_model`: cost the decode
    GEMMs on a CiM ``array`` through the paper's macro model instead of
    the fitted host kernels (the ArraySpec axis of the replay space)."""
    from repro_torch.hw.array import array_cost
    from repro_torch.hw.macro import PAPER_MACRO, layer_cost
    from repro_torch.hw.workload import workload_layers
    from repro_torch.models.registry import ShapeCell

    macro = macro or PAPER_MACRO
    cost = array_cost(array)
    cache: Dict[Tuple[str, int], float] = {}

    def kernel_us(arch: str, occupancy: int) -> float:
        key = (arch, occupancy)
        if key not in cache:
            cfg = cfgs.get(arch)
            if cfg is None:
                cache[key] = 0.0
            else:
                shape = ShapeCell("replay_decode", "decode", 1,
                                  max(1, occupancy))
                t_ns = sum(
                    layer_cost(layer, array, macro.n_arrays, macro,
                               cost=cost)[0] * count
                    for layer, count in workload_layers(cfg, shape)
                )
                cache[key] = t_ns * 1e-3
        return cache[key]

    return kernel_us


def predict_decode_step_us(
    table: CalibrationTable,
    arch: str,
    occupancy: int,
    *,
    mesh: str = "tp1",
    kernel_model: Optional[Callable[[str, int], float]] = None,
) -> float:
    """Predicted wall time of one fused decode step at ``occupancy``
    active slots: the fitted per-step fixed overhead plus the kernel
    model's share (0 when no kernel model is supplied — the fixed term
    then already contains the median MAC cost it was fitted with)."""
    fit = table.engine_fit(arch, mesh)
    kern = kernel_model(arch, occupancy) if kernel_model is not None else 0.0
    return fit.decode_fixed_us + kern


def simulate(
    table: CalibrationTable,
    arch: str,
    requests: Sequence[ReplayRequest],
    *,
    n_slots: int = 4,
    s_max: int = 64,
    mesh: str = "tp1",
    kernel_model: Optional[Callable[[str, int], float]] = None,
) -> Dict[str, object]:
    """Replay one continuous-batching workload through the predicted
    clock. Mirrors ``ContinuousBatcher``'s host discipline exactly
    (batched pow-2-bucketed prefill, one captured graph per bucket; a
    fused step over all slots, its occupancy the active ones; immediate
    refill; a slot freed when its next write would reach ``s_max``) so
    predicted step *counts* match the engine's and only the *durations*
    come from the calibration.

    Requests with a nonzero ``arrival_us`` (e.g. from
    :func:`poisson_requests`) are admitted only once the simulated
    clock reaches them — an idle engine fast-forwards to the next
    arrival — so the replay covers *traffic-shaped* load points, not
    just offered-up-front batches. With all arrivals at 0 (the
    default) the behavior is the original offline replay, unchanged.

    Returns predicted ``tok_s``, ``p50_step_us`` / ``p99_step_us`` over
    the decode steps, totals, and the dependency ``graph`` (the Node
    list, JSON-ready)."""
    fit = table.engine_fit(arch, mesh)
    # stable sort: equal arrivals (the offline all-zero case) keep
    # submission order, so pre-arrival replays are byte-identical
    queue = sorted(requests, key=lambda r: r.arrival_us)
    slots: List[Optional[ReplayRequest]] = [None] * n_slots
    produced: List[int] = [0] * n_slots
    pos: List[int] = [0] * n_slots

    nodes: List[Node] = []
    last_nid: Optional[int] = None  # chain dep: the node owning cache state
    step_durs: List[float] = []
    ttfts: List[float] = []         # per request: arrival -> first token
    tokens = 0
    clock = 0.0

    def _finish(s: int) -> None:
        slots[s] = None

    while queue or any(r is not None for r in slots):
        # -- fill slots + batched prefill (engine: _fill_slots_fused) --
        # only *arrived* requests are admissible at the current clock
        newly = []
        for s in range(n_slots):
            if slots[s] is None and queue and queue[0].arrival_us <= clock:
                slots[s] = queue.pop(0)
                newly.append(s)
        if newly:
            max_len = max(slots[s].prompt_len for s in newly)
            s_pad = _next_pow2(max_len)
            if s_pad >= s_max:
                s_pad = max_len
            deps = (last_nid,) if last_nid is not None else ()
            start = max((nodes[d].end_us for d in deps), default=clock)
            start = max(start, clock)
            node = Node(len(nodes), "prefill", deps, fit.prefill_us,
                        start, len(newly))
            nodes.append(node)
            last_nid = node.nid
            clock = node.end_us
            for s in newly:
                produced[s] = 1           # prefill samples the first token
                tokens += 1
                pos[s] = s_pad
                ttfts.append(node.end_us - slots[s].arrival_us)
                if produced[s] >= slots[s].max_new:
                    _finish(s)
        active = [s for s in range(n_slots) if slots[s] is not None]
        if not active:
            if queue:
                # idle engine waiting on traffic: fast-forward to the
                # next arrival (never backwards)
                clock = max(clock, queue[0].arrival_us)
                continue
            break
        # -- one fused decode step (engine: _step_fused) ---------------
        occ = len(active)
        us = predict_decode_step_us(table, arch, occ, mesh=mesh,
                                    kernel_model=kernel_model)
        deps = (last_nid,) if last_nid is not None else ()
        start = max((nodes[d].end_us for d in deps), default=clock)
        node = Node(len(nodes), "decode", deps, us, start, occ)
        nodes.append(node)
        last_nid = node.nid
        clock = node.end_us
        step_durs.append(us)
        for s in active:
            produced[s] += 1
            tokens += 1
            pos[s] += 1
            if produced[s] >= slots[s].max_new or pos[s] >= s_max:
                _finish(s)

    total_us = max((n.end_us for n in nodes), default=0.0)
    return {
        "arch": arch,
        "mesh": mesh,
        "n_slots": n_slots,
        "s_max": s_max,
        "tokens": tokens,
        "decode_steps": len(step_durs),
        "prefill_batches": sum(1 for n in nodes if n.kind == "prefill"),
        "total_us": round(total_us, 2),
        "tok_s": round(tokens / max(total_us * 1e-6, 1e-12), 2),
        "p50_step_us": round(float(np.percentile(step_durs, 50)), 2)
        if step_durs else 0.0,
        "p99_step_us": round(float(np.percentile(step_durs, 99)), 2)
        if step_durs else 0.0,
        "ttft_p50_us": round(float(np.percentile(ttfts, 50)), 2)
        if ttfts else 0.0,
        "ttft_p99_us": round(float(np.percentile(ttfts, 99)), 2)
        if ttfts else 0.0,
        "graph": [dataclasses.asdict(n) for n in nodes],
    }


def compare_to_measured(
    predicted: Mapping[str, object],
    events,
) -> Dict[str, float]:
    """Predicted-vs-measured validation.

    ``events`` is either a profiled run's trace events (the original
    path: relative error of the p50 decode-step time — the bound
    BENCH_calib.json gates on — plus tok/s on the same event-time
    basis) or **one committed BENCH_traffic.json row** (a mapping with
    ``goodput_tok_s``): then the comparison is goodput and TTFT-p50 of
    the replayed Poisson workload against what the live front door
    measured — the loop :func:`replay_traffic_bench` closes and
    ``benchmarks/bench_traffic.py`` gates under its stated error bound.
    """
    if isinstance(events, Mapping) and "goodput_tok_s" in events:
        row = events
        meas_good = float(row["goodput_tok_s"])
        meas_ttft = float(row["ttft_us"]["p50"])
        pred_good = float(predicted["tok_s"])
        pred_ttft = float(predicted.get("ttft_p50_us", 0.0))
        return {
            "measured_goodput_tok_s": round(meas_good, 2),
            "predicted_goodput_tok_s": round(pred_good, 2),
            "goodput_error_pct": round(
                100.0 * abs(pred_good - meas_good) / max(meas_good, 1e-9), 2),
            "measured_ttft_p50_us": round(meas_ttft, 2),
            "predicted_ttft_p50_us": round(pred_ttft, 2),
            "ttft_error_pct": round(
                100.0 * abs(pred_ttft - meas_ttft) / max(meas_ttft, 1e-9), 2),
            "measured_tokens": int(row["tokens_out"]),
            "predicted_tokens": int(predicted["tokens"]),
        }
    walls = [e.wall_us for e in events if e.entry_point == "serve.decode_step"]
    pre = [e.wall_us for e in events if e.entry_point == "serve.prefill"]
    if not walls:
        raise ValueError("no measured serve.decode_step events to compare")
    meas_p50 = float(np.percentile(walls, 50))
    meas_p99 = float(np.percentile(walls, 99))
    meas_total_us = float(sum(walls) + sum(pre))
    tokens = int(predicted["tokens"])
    pred_p50 = float(predicted["p50_step_us"])
    return {
        "measured_steps": len(walls),
        "measured_p50_us": round(meas_p50, 2),
        "measured_p99_us": round(meas_p99, 2),
        "predicted_p50_us": round(pred_p50, 2),
        "predicted_p99_us": float(predicted["p99_step_us"]),
        "measured_tok_s": round(tokens / max(meas_total_us * 1e-6, 1e-12), 2),
        "predicted_tok_s": float(predicted["tok_s"]),
        "p50_error_pct": round(
            100.0 * abs(pred_p50 - meas_p50) / max(meas_p50, 1e-9), 2),
    }


def table_from_traffic_row(row: Mapping[str, object], arch: str,
                           *, backend: str = "cpu") -> CalibrationTable:
    """Fit a minimal engine-only table from one measured
    BENCH_traffic.json row: the fused decode-step time is the measured
    inter-token cadence (``tok_latency_us.p50`` — host step plus the
    modeled device pace), the prefill time the first-token latency with
    queueing removed (``ttft_us.p50 - queue_wait_us.p50``). Nothing is
    re-measured: the table is exactly what the committed artifact
    already states, in replayable form."""
    fit = EngineFit(
        arch=arch, mesh="tp1", exec_spec="measured/traffic",
        decode_fixed_us=float(row["tok_latency_us"]["p50"]),
        prefill_us=max(0.0, float(row["ttft_us"]["p50"])
                       - float(row["queue_wait_us"]["p50"])),
        n_decode=int(row["decode_steps"]),
        n_prefill=int(row["prefill_batches"]),
        residual_pct=0.0,
    )
    from repro_torch.profile.calibrate import (
        CALIBRATION_VERSION, engine_key)

    return CalibrationTable(
        version=CALIBRATION_VERSION, backend=backend,
        default_spec=fit.exec_spec, kernels={},
        engines={engine_key(arch, "tp1"): fit})


def replay_traffic_bench(
    bench: Mapping[str, object], row_key: str = "1",
) -> Tuple[Dict[str, object], Dict[str, float]]:
    """Close the predicted-vs-measured loop on a committed
    BENCH_traffic.json: rebuild the exact Poisson workload the bench
    drove (same rate/seed/lengths — :func:`poisson_requests` is
    deterministic), replay it through :func:`simulate` with the
    row's own measured segment times (:func:`table_from_traffic_row`,
    with the prefill time sharpened from the row's wall-clock residual
    when the TTFT split is queueing-dominated), and return
    ``(predicted, comparison)`` where ``comparison`` is
    :func:`compare_to_measured` of the replay against the row's
    goodput/TTFT. ``benchmarks/bench_traffic.py`` records this under
    ``"replay_check"`` and its validator gates the errors under the
    stated bound."""
    row = bench["rows"][row_key]
    if int(row["replicas"]) != 1:
        raise ValueError(
            f"replay_traffic_bench replays the single-engine row; "
            f"rows[{row_key!r}] has replicas={row['replicas']}")
    arch = str(bench["arch"])
    backend = bench.get("backend", "cpu")
    if isinstance(backend, Mapping):  # provenance block (profile.backend_block)
        backend = str(backend.get("platform", "cpu"))
    table = table_from_traffic_row(row, arch, backend=str(backend))
    fit = next(iter(table.engines.values()))
    if fit.prefill_us <= 0.0 and fit.n_prefill > 0:
        # the tracker's TTFT starts at arrival, so under saturation
        # ttft == queue_wait at p50 and the split carries no prefill
        # signal; recover it from the row's wall-clock residual after
        # the decode cadence is accounted for
        residual = (float(row["wall_s"]) * 1e6
                    - fit.n_decode * fit.decode_fixed_us)
        fit = dataclasses.replace(
            fit, prefill_us=max(0.0, residual / fit.n_prefill))
        table = dataclasses.replace(
            table, engines={k: fit for k in table.engines})
    reqs = poisson_requests(
        float(row["rate_rps"]), seed=int(bench["seed"]),
        n_requests=int(row["n_requests"]), prompt_len_max=4,
        max_new=int(bench.get("max_new", 8)))
    predicted = simulate(table, arch, reqs,
                         n_slots=int(bench["n_slots"]),
                         s_max=int(bench["s_max"]))
    return predicted, compare_to_measured(predicted, row)
