"""The port's calibrate and replay legs of ``profile`` against the JAX
package's, and the port's tile sweep.

Against the reference, with ``==`` (the same numpy arithmetic on the same
numbers): ``calibrate(events).to_json()`` on one seeded synthetic trace
(kernel events of two specs in both shape classes, engine events with
occupancies and prompts), the kernel models, ``simulate`` and
``compare_to_measured`` on ``requests_like_bench`` / ``poisson_requests``,
and ``replay_traffic_bench`` on the committed ``BENCH_traffic.json`` (read,
never written). Tables cross between the packages both ways.

On the port alone: its ``ContinuousBatcher(profile=...)`` replayed with
the exact step and fill counts and the p50 step within 50% (the
reference's own smoke bounds), also where a request fills its cache; and
the tile sweep's rules, pure functions beside ``launch_plan``."""
import dataclasses
import json
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

import repro.profile as JP
from repro.core import execution as JX
from repro.hw import ArraySpec as JArraySpec
from repro.hw import project as jproject
from repro.models.registry import get_config as jget_config
from repro_torch import hw
from repro_torch import profile as P
from repro_torch.core import execution as X
from repro_torch.core import ternary as tern
from repro_torch.kernels import plan as kp
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config
from repro_torch.serve.engine import ContinuousBatcher, Request
from torch_threads import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPECS = ("blocked/cuda/none", "blocked/cuda/bitplane_u8")


def _synthetic(mod, seed=0):
    """Kernel events of two specs in both classes (walls from a known
    model plus seeded noise; 2-bit planes for the packed spec), then
    decode-step events at occupancies 1-4 and prefill events with their
    prompts, for two archs."""
    rng = np.random.default_rng(seed)
    out = []
    shapes = {"decode": [(1, 576, 576), (4, 576, 1536), (8, 1536, 576), (2, 576, 192)],
              "prefill": [(64, 576, 576), (128, 576, 1536), (1024, 1536, 576),
                          (512, 576, 192)]}
    for spec, bpw, fixed in ((SPECS[0], 1.0, 20.0), (SPECS[1], 0.25, 24.0)):
        for cls, grid in shapes.items():
            for m, k, n in grid:
                for _ in range(3):
                    wall = (fixed + 0.05 * m * k * n * 1e-6 + 9.0 * k * n * bpw * 1e-6
                            + float(rng.normal(0.0, 0.3)))
                    out.append(mod.TraceEvent(
                        "execution.execute" if bpw == 1.0 else "execution.execute_packed",
                        spec, cls, None, wall, wall / 3,
                        {"m": m, "k": k, "n": n, "macs": m * k * n,
                         "weight_bytes": int(k * n * bpw)}))
    for arch in ("smollm-135m", "mamba2-780m"):
        for step in range(12):
            occ = 1 + step % 4
            wall = 900.0 + 40.0 * occ + float(rng.normal(0.0, 5.0))
            out.append(mod.TraceEvent("serve.decode_step", "blocked/cuda/none", "decode",
                                      None, wall, wall / 5,
                                      {"arch": arch, "step": step, "occupancy": occ,
                                       "n_slots": 4}))
        for i in range(3):
            out.append(mod.TraceEvent("serve.prefill", "blocked/cuda/none", "prefill",
                                      None, 2000.0 + 100 * i, 50.0,
                                      {"arch": arch, "prompts": [[i, 3 + i, 8]],
                                       "s_pad": 4, "filled": 1}))
    return out


CFGS = {"smollm-135m": get_config("smollm-135m"), "mamba2-780m": get_config("mamba2-780m")}
JCFGS = {a: jget_config(a) for a in CFGS}


@pytest.fixture(scope="module")
def tables():
    """The same synthetic trace calibrated by both packages, with each
    package's kernel model of its own first fit."""
    mine = P.calibrate(_synthetic(P), backend="cuda",
                       tile_winners={SPECS[0]: {"decode": (8, 2)}})
    theirs = JP.calibrate(_synthetic(JP), backend="cuda",
                          tile_winners={SPECS[0]: {"decode": (8, 2)}})
    km = P.make_kernel_model(mine, CFGS)
    jkm = JP.make_kernel_model(theirs, JCFGS)
    return (mine, theirs,
            P.calibrate(_synthetic(P), backend="cuda", kernel_model=km),
            JP.calibrate(_synthetic(JP), backend="cuda", kernel_model=jkm), km, jkm)


@pytest.fixture(autouse=True)
def clean_sweep():
    X.clear_tile_cache()
    yield
    X.clear_tile_cache()
    X.set_shape_class_override(None)


# ---------------------------------------------------------------------------
# Calibration: fits and the table
# ---------------------------------------------------------------------------


def test_calibrate_matches_reference(tables):
    mine, theirs, mine_km, theirs_km, _, _ = tables
    assert mine.to_json() == theirs.to_json()
    assert mine_km.to_json() == theirs_km.to_json()
    assert set(mine.kernels) == {f"{s}|{c}" for s in SPECS for c in ("decode", "prefill")}
    # the kernel share moves the fixed term, not the step counts
    fit, kfit = mine.engine_fit("smollm-135m"), mine_km.engine_fit("smollm-135m")
    assert kfit.decode_fixed_us < fit.decode_fixed_us
    assert (kfit.n_decode, kfit.n_prefill) == (fit.n_decode, fit.n_prefill) == (12, 3)


def test_fits_match_reference():
    events, jevents = _synthetic(P, seed=3), _synthetic(JP, seed=3)
    assert ({k: dataclasses.asdict(v) for k, v in P.fit_kernels(events).items()}
            == {k: dataclasses.asdict(v) for k, v in JP.fit_kernels(jevents).items()})
    rows = [[1.0, float(i), float(i * i % 7)] for i in range(1, 9)]
    y = [5.0 - 0.5 * i for i in range(1, 9)]     # a negative slope clamps to 0
    assert P.calibrate.__module__ == "repro_torch.profile.calibrate"
    mine = sys.modules["repro_torch.profile.calibrate"]._nnls(rows, y)
    theirs = sys.modules["repro.profile.calibrate"]._nnls(rows, y)
    assert mine == theirs and min(mine) >= 0.0
    share = lambda arch, occ: 25.0 * occ  # noqa: E731
    assert ({k: dataclasses.asdict(v) for k, v in P.fit_engines(events, share).items()}
            == {k: dataclasses.asdict(v) for k, v in JP.fit_engines(jevents, share).items()})


def test_decode_boundary_is_the_execution_layers():
    mine = sys.modules["repro_torch.profile.calibrate"]
    assert mine.DECODE_M_MAX == X.DECODE_M_MAX == JX.DECODE_M_MAX


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_tables_cross_between_packages(tables, tmp_path, writer):
    mine, theirs = tables[:2]
    path = tmp_path / "calib.json"
    (mine if writer == "port" else theirs).save(path)
    assert P.CalibrationTable.load(path).to_json() == theirs.to_json()
    assert JP.CalibrationTable.load(path).to_json() == mine.to_json()
    assert P.CalibrationTable.load(path) == mine
    bad = json.loads(path.read_text())
    bad["version"] = 2
    with pytest.raises(ValueError, match="version"):
        P.CalibrationTable.from_json(bad)


def test_predictions_match_reference(tables):
    mine, theirs = tables[:2]
    for m, k, n in ((1, 576, 576), (8, 576, 1536), (9, 576, 576), (300, 1536, 576)):
        for spec in SPECS:
            assert mine.predict_gemm_us(m, k, n, spec) == theirs.predict_gemm_us(m, k, n, spec)
    with pytest.raises(KeyError, match="no kernel fit"):
        mine.predict_gemm_us(4, 8, 8, "exact/cuda/none")
    with pytest.raises(KeyError, match="no engine fit"):
        mine.engine_fit("yi-34b")


def test_project_with_calibration_matches_reference(tables):
    mine, theirs = tables[:2]
    for tech in hw.PAPER_TECHNOLOGIES:
        for design in ("CiM-I", "CiM-II"):
            got = hw.project("smollm-135m", "decode_32k",
                             hw.ArraySpec(technology=tech, design=design), calibration=mine)
            want = jproject("smollm-135m", "decode_32k",
                            JArraySpec(technology=tech, design=design), calibration=theirs)
            assert got == want
            assert got["calibrated"]["source"] == {"version": 1, "backend": "cuda"}
    engine_only = dataclasses.replace(mine, kernels={})
    with pytest.raises(ValueError, match="no kernel fits"):
        hw.project("smollm-135m", "decode_32k", hw.ArraySpec(), calibration=engine_only)


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------


def test_kernel_models_match_reference(tables):
    mine, theirs, _, _, km, jkm = tables
    arr = hw.ArraySpec(technology="8T-SRAM", design="CiM-I")
    akm = P.make_array_kernel_model(CFGS, arr)
    jakm = JP.make_array_kernel_model(JCFGS, JArraySpec(technology="8T-SRAM", design="CiM-I"))
    for arch in ("smollm-135m", "mamba2-780m", "yi-34b"):
        for occ in (0, 1, 2, 3, 4, 8):
            assert km(arch, occ) == jkm(arch, occ)
            assert akm(arch, occ) == jakm(arch, occ)
            assert (P.predict_decode_step_us(mine, "smollm-135m", occ, kernel_model=km)
                    == JP.predict_decode_step_us(theirs, "smollm-135m", occ,
                                                 kernel_model=jkm))
    assert km("yi-34b", 4) == 0.0        # an arch the model was not given


def _workloads(mod):
    return {"bench": mod.requests_like_bench(64, 10, 5),
            "poisson": mod.poisson_requests(300.0, seed=4, n_requests=12, max_new=9),
            "poisson_slow": mod.poisson_requests(20.0, seed=1, n_requests=6)}


@pytest.mark.parametrize("name", ["bench", "poisson", "poisson_slow"])
def test_simulate_and_compare_match_reference(tables, name):
    mine, theirs, _, _, km, jkm = tables
    reqs, jreqs = _workloads(P)[name], _workloads(JP)[name]
    assert [dataclasses.asdict(r) for r in reqs] == [dataclasses.asdict(r) for r in jreqs]
    for kw, jkw in (({}, {}), ({"kernel_model": km}, {"kernel_model": jkm})):
        for slots in (2, 4):
            got = P.simulate(mine, "smollm-135m", reqs, n_slots=slots, s_max=64, **kw)
            want = JP.simulate(theirs, "smollm-135m", jreqs, n_slots=slots, s_max=64, **jkw)
            assert got == want
    events = [e for e in _synthetic(P) if e.meta.get("arch") == "smollm-135m"]
    jevents = [e for e in _synthetic(JP) if e.meta.get("arch") == "smollm-135m"]
    assert P.compare_to_measured(got, events) == JP.compare_to_measured(want, jevents)
    assert [dataclasses.asdict(r) for r in P.requests_from_trace(events)] == \
        [dataclasses.asdict(r) for r in JP.requests_from_trace(jevents)]
    with pytest.raises(ValueError, match="no measured"):
        P.compare_to_measured(got, [])


def test_replay_traffic_bench_matches_reference():
    bench = json.loads((ROOT / "BENCH_traffic.json").read_text())
    assert P.replay_traffic_bench(bench) == JP.replay_traffic_bench(bench)
    row = bench["rows"]["1"]
    assert (P.table_from_traffic_row(row, "smollm-135m").to_json()
            == JP.table_from_traffic_row(row, "smollm-135m").to_json())
    multi = [k for k, r in bench["rows"].items() if int(r["replicas"]) != 1]
    for key in multi[:1]:
        with pytest.raises(ValueError, match="single-engine"):
            P.replay_traffic_bench(bench, key)


def test_capacity_cutoff_is_the_batchers():
    """A slot frees when its next write would reach s_max, as both
    packages' batchers free it; the reference's replay frees it one step
    earlier, so the two replays differ exactly where a cache fills."""
    fit = P.EngineFit("a", "tp1", "s", 100.0, 50.0, 1, 1, 0.0)
    table = P.CalibrationTable(1, "cpu", "s", {}, {"a|tp1": fit})
    jtable = JP.CalibrationTable.from_json(table.to_json())
    reqs = [P.ReplayRequest(0, 3, 40)]
    got = P.simulate(table, "a", reqs, n_slots=2, s_max=16)
    want = JP.simulate(jtable, "a", [JP.ReplayRequest(0, 3, 40)], n_slots=2, s_max=16)
    assert got["decode_steps"] == 16 - 4           # writes at slots 4..15
    assert want["decode_steps"] == got["decode_steps"] - 1


@pytest.fixture(scope="module")
def smoke_params():
    cfg = get_config("smollm-135m", smoke=True)
    return cfg, T.init_params(cfg, device="cpu")


def _serve(cfg, params, reqs, s_max=32, profile=None):
    b = ContinuousBatcher(params, cfg, n_slots=3, s_max=s_max, device="cpu",
                          profile=profile)
    for r in reqs:
        b.submit(r)
    b.run()
    return b


def _mix(n=6):
    return [Request(i, [1 + i % 7] * (1 + i % 3), max_new=2 + i % 3) for i in range(n)]


def _counts_match(b, prof, pred):
    decode = [e for e in prof.events if e.entry_point == "serve.decode_step"]
    prefill = [e for e in prof.events if e.entry_point == "serve.prefill"]
    assert pred["decode_steps"] == b.decode_steps == len(decode)
    assert pred["prefill_batches"] == b.prefill_batches == len(prefill)
    assert pred["tokens"] == (sum(e.meta["occupancy"] for e in decode)
                              + sum(e.meta["filled"] for e in prefill))


def test_replay_of_the_ports_batcher(smoke_params):
    """The reference's smoke checks on the port's batcher: the replay's
    step, fill and token counts are the batcher's, and its p50 step is
    within 50% of the measured p50 (a CPU host)."""
    cfg, params = smoke_params
    prof = P.Profiler()
    b = _serve(cfg, params, _mix(), profile=prof)
    table = P.calibrate(prof.events, backend="cpu")
    reqs = P.requests_from_trace(prof.events)
    pred = P.simulate(table, cfg.name, reqs, n_slots=3, s_max=32)
    _counts_match(b, prof, pred)
    cmp = P.compare_to_measured(pred, prof.events)
    assert cmp["measured_steps"] == pred["decode_steps"]
    assert cmp["p50_error_pct"] <= 50.0, cmp


def test_replay_counts_where_a_cache_fills(smoke_params):
    cfg, params = smoke_params
    prof = P.Profiler()
    reqs = [Request(0, [3, 4, 5], max_new=30), Request(1, [2], max_new=4),
            Request(2, [6] * 5, max_new=9), Request(3, [1, 1], max_new=12)]
    b = _serve(cfg, params, reqs, s_max=16, profile=prof)
    assert reqs[0].truncated
    table = P.calibrate(prof.events, backend="cpu")
    pred = P.simulate(table, cfg.name, P.requests_from_trace(prof.events),
                      n_slots=3, s_max=16)
    _counts_match(b, prof, pred)
    assert pred["tokens"] == sum(len(r.generated) for r in reqs)


# ---------------------------------------------------------------------------
# The tile sweep
# ---------------------------------------------------------------------------


TILED = [s.name for s in X.registered_specs() if X.get_backend(s).tiles is not None]


def _spec(name):
    f, b, p = name.split("/")
    return X.CiMExecSpec(formulation=f, backend=b, packing=p)


@pytest.mark.parametrize("name", TILED)
def test_candidate_grid(name):
    spec = _spec(name)
    for cls in X.SHAPE_CLASSES:
        grid = X.tile_candidates(spec, cls)
        fixed_rows = spec.packing == "bitplane_u8" and cls == "decode"
        rows = {8} if fixed_rows else {8, 32}
        assert {g[0] for g in grid} == rows
        assert {g[1] for g in grid} == {1, 2, 4, 8}
        if spec.backend == "cuda_stream":
            assert {g[2] for g in grid} == ({2, 3} if cls == "decode" else {2})
        else:
            assert all(len(g) == 2 for g in grid)
        assert len(set(grid)) == len(grid) == len(rows) * 4 * (
            2 if spec.backend == "cuda_stream" and cls == "decode" else 1)
        # bounded by K as launch_plan bounds its cluster
        assert {g[1] for g in X.tile_candidates(spec, cls, 16)} == {1}
        assert {g[1] for g in X.tile_candidates(spec, cls, 40)} == {1, 2}
        # launch_plan's own grid is always a candidate
        for m in ((1, 4, 8) if cls == "decode" else (9, 64, 1024)):
            for k, n in ((576, 576), (576, 192), (1536, 576), (40, 33)):
                plan = kp.launch_plan(m, k, n)
                default = (8 if fixed_rows else plan.rows, plan.cluster)
                assert any(g[:2] == default for g in X.tile_candidates(spec, cls, k))


@pytest.mark.parametrize("sms", [16, 66, 132])
def test_empty_cache_plan_is_launch_plan(sms):
    for name in TILED:
        spec = _spec(name)
        for m in (1, 3, 4, 8, 9, 64, 128, 1023, 1024):
            for k, n in ((576, 576), (576, 192), (576, 1536), (1536, 576), (16, 8),
                         (40, 33), (592, 200), (0, 16)):
                want = kp.launch_plan(m, k, n, sms)
                assert X.kernel_plan(spec, m, k, n, sms) == want
                assert kp.tuned_plan(m, k, n, sms) == want
                assert kp.tuned_plan(m, k, n, sms, cls=X.shape_class(m)) == want


def _table(winners):
    return P.CalibrationTable(P.CALIBRATION_VERSION, "cuda", "blocked/cuda/none", {},
                              tile_winners=winners)


def test_calibration_installs_winners_without_timing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _spec("blocked/cuda/none")
    stream = _spec("blocked/cuda_stream/bitplane_u8")
    table = _table({spec.name: {"decode": (8, 2), "prefill": (32, 8)},
                    stream.name: {"decode": (8, 4, 3)}})
    report = X.autotune(spec, calibration=table)
    assert report == {"decode": {"tiles": (8, 2), "us": None, "candidates": {},
                                 "source": "calibration"},
                      "prefill": {"tiles": (32, 8), "us": None, "candidates": {},
                                  "source": "calibration"}}
    assert X.autotune(stream, calibration=table)["decode"]["tiles"] == (8, 4, 3)
    assert X.kernel_plan(spec, 4, 576, 1536) == kp.LaunchPlan(8, (96, 1, 2), 2)
    assert X.kernel_plan(spec, 1024, 576, 1536) == kp.LaunchPlan(32, (96, 32, 8), 8)
    # a winner's cluster is bounded by K; #2 and #3 keep their 8-row tile
    assert X.kernel_plan(spec, 100, 40, 33).cluster == 2
    assert X.kernel_plan(stream, 4, 576, 1536, rows=8).cluster == 4
    # another spec, or the other class of an untuned one, keeps launch_plan
    exact = _spec("exact/cuda/none")
    assert X.kernel_plan(exact, 4, 576, 1536) == kp.launch_plan(4, 576, 1536)
    assert X.kernel_plan(stream, 64, 576, 1536) == kp.launch_plan(64, 576, 1536)
    # the outputs do not depend on the grid (the plain versions here)
    x = torch.randint(-1, 2, (4, 64)).float()
    w = torch.randint(-1, 2, (64, 24)).float()
    assert torch.equal(X.execute(spec, x, w), X.execute(_spec("blocked/torch/none"), x, w))
    X.clear_tile_cache()
    assert X.kernel_plan(spec, 4, 576, 1536) == kp.launch_plan(4, 576, 1536)


@pytest.mark.parametrize("winners,match", [
    ({"blocked/cuda/none": {"decode": (8, 128, 128)}}, "invalid"),       # Pallas
    ({"blocked/cuda/none": {"decode": (32, 3)}}, "invalid"),
    ({"blocked/cuda/none": {"decode": (16, 2)}}, "invalid"),
    ({"blocked/cuda/none": {"warmup": (8, 2)}}, "unknown shape class"),
    ({"exact/cuda/none": {"decode": (8, 2)}}, "no tile winners"),
    ({}, "no tile winners"),
])
def test_calibration_rejects_what_the_grid_has_not(winners, match):
    with pytest.raises(ValueError, match=match):
        X.autotune(_spec("blocked/cuda/none"), calibration=_table(winners))


def test_calibration_rejects_the_references_pallas_winners(tmp_path):
    jtable = JP.CalibrationTable(
        JP.CALIBRATION_VERSION, "tpu", "blocked/pallas/bitplane_u8", {},
        tile_winners={"blocked/cuda/bitplane_u8": {"decode": (8, 256, 128)},
                      "blocked/cuda_stream/bitplane_u8": {"decode": (8, 256, 128, 2)}})
    jtable.save(tmp_path / "t.json")
    table = P.CalibrationTable.load(tmp_path / "t.json")
    for name in ("blocked/cuda/bitplane_u8", "blocked/cuda_stream/bitplane_u8"):
        with pytest.raises(ValueError, match="invalid"):
            X.autotune(_spec(name), calibration=table)
    # stream grids are triples; a dense grid pair is not one of them
    with pytest.raises(ValueError, match="invalid"):
        X.autotune(_spec("blocked/cuda_stream/bitplane_u8"),
                   calibration=_table({"blocked/cuda_stream/bitplane_u8":
                                       {"decode": (8, 2)}}))


def test_untiled_and_unknown_specs_raise(monkeypatch):
    for name in ("blocked/torch/none", "exact/torch/bitplane_u8", "fused/torch/none"):
        with pytest.raises(ValueError, match="no launch grid"):
            X.autotune(_spec(name))
        with pytest.raises(ValueError, match="no launch grid"):
            X.tile_candidates(_spec(name), "decode")
    with pytest.raises(KeyError, match="no backend registered"):
        X.autotune(X.CiMExecSpec(formulation="corrected", backend="cuda"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        X.autotune(_spec("blocked/cuda/none"))


def test_override_is_a_context_manager_and_reaches_the_plan_only():
    spec = _spec("blocked/cuda/bitplane_u8")
    with X.set_shape_class_override("prefill"):
        assert X.kernel_plan(spec, 4, 576, 576) == kp.tuned_plan(4, 576, 576, cls="prefill")
        assert X.kernel_plan(spec, 4, 576, 576).rows == kp.PREFILL_ROWS
        # #2 keeps its own tile, only the cluster comes from the class
        assert X.kernel_plan(spec, 4, 576, 576, rows=8).rows == 8
        with X.set_shape_class_override("decode"):
            assert X.kernel_plan(spec, 64, 576, 576) == kp.tuned_plan(
                64, 576, 576, cls="decode")
        assert X._CLASS_OVERRIDE == "prefill"
    assert X._CLASS_OVERRIDE is None
    X.set_shape_class_override("decode")
    X.set_shape_class_override(None)
    assert X.kernel_plan(spec, 64, 576, 576) == kp.launch_plan(64, 576, 576)
    with pytest.raises(ValueError, match="unknown shape class"):
        X.set_shape_class_override("train")
    # a winner of the forced class applies at any M
    X.autotune(spec, calibration=_table({spec.name: {"prefill": (8, 4)}}))
    with X.set_shape_class_override("prefill"):
        assert X.kernel_plan(spec, 4, 576, 576) == kp.LaunchPlan(8, (36, 1, 4), 4)
    assert X.kernel_plan(spec, 4, 576, 576) == kp.launch_plan(4, 576, 576)
    # the packed kernels stay chosen by M (the plain versions: int32 at decode)
    x = torch.randint(-1, 2, (4, 64)).float()
    w = torch.randint(-1, 2, (64, 24)).to(torch.int8)
    planes = tern.pack_ternary(w, axis=0)
    plain = X.execute_packed(_spec("blocked/torch/bitplane_u8"), x, *planes)
    with X.set_shape_class_override("prefill"):
        assert torch.equal(X.execute_packed(spec, x, *planes), plain)


def test_override_and_cache_under_threads():
    """More threads than cores entering and leaving overrides and
    installing and clearing winners, with a short switch interval: no
    lookup fails, and once the overrides are off and the cache is clear
    the plan is launch_plan's again."""
    spec = _spec("exact/cuda/none")
    errors = []

    def worker(i):
        try:
            for j in range(200):
                with X.set_shape_class_override(("decode", "prefill")[(i + j) % 2]):
                    X.kernel_plan(spec, 4, 576, 576)
                if j % 50 == 0:
                    X.autotune(spec, calibration=_table({spec.name: {"decode": (8, 2)}}))
                    X.clear_tile_cache()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    X.set_shape_class_override(None)
    X.clear_tile_cache()
    assert X.kernel_plan(spec, 4, 576, 576) == kp.launch_plan(4, 576, 576)


def test_tiles_for_under_override_matches_reference():
    for f, p in (("blocked", "none"), ("exact", "none"), ("blocked", "bitplane_u8")):
        mine = X.CiMExecSpec(formulation=f, backend="cuda", packing=p)
        theirs = JX.CiMExecSpec(formulation=f, backend="pallas", packing=p)
        for cls in (None, "decode", "prefill"):
            with X.set_shape_class_override(cls), JX.set_shape_class_override(cls):
                for m in (1, 4, 8, 9, 256):
                    assert X.tiles_for(mine, m, 1024, 512) == tuple(
                        JX.tiles_for(theirs, m, 1024, 512))
    mine = X.CiMExecSpec("blocked", "cuda_stream", "bitplane_u8")
    theirs = JX.CiMExecSpec("blocked", "pallas_stream", "bitplane_u8")
    with X.set_shape_class_override("prefill"), JX.set_shape_class_override("prefill"):
        assert X.tiles_for(mine, 4, 1024, 512) == tuple(JX.tiles_for(theirs, 4, 1024, 512))


def test_kernel_events_record_the_forced_class_as_reference():
    x = np.sign(np.random.default_rng(2).standard_normal((4, 64))).astype(np.float32)
    w = np.sign(np.random.default_rng(3).standard_normal((64, 32))).astype(np.float32)
    import jax.numpy as jnp

    prof, jprof = P.Profiler(), JP.Profiler()
    prev, jprev = P.set_profiler(prof), JP.set_profiler(jprof)
    try:
        for cls in (None, "prefill"):
            with X.set_shape_class_override(cls), JX.set_shape_class_override(cls):
                X.execute(X.CiMExecSpec("blocked", "torch"), torch.from_numpy(x),
                          torch.from_numpy(w))
                JX.execute(JX.CiMExecSpec("blocked", "jnp"), jnp.asarray(x), jnp.asarray(w))
    finally:
        P.set_profiler(prev)
        JP.set_profiler(jprev)
    assert [e.shape_class for e in prof.events] == [e.shape_class for e in jprof.events] \
        == ["decode", "prefill"]


def test_graph_kernel_events_time_cpu_calls_eagerly():
    """Graph timing is for calls on the card: a CPU call inside
    ``graph_kernel_events`` records as outside it, with the same result,
    and the context restores the eager timing it found."""
    spec = _spec("blocked/cuda/none")
    g = torch.Generator().manual_seed(3)
    x = torch.randint(-1, 2, (4, 64), generator=g).float()
    w = torch.randint(-1, 2, (64, 32), generator=g).float()
    prof = P.Profiler()
    prev = P.set_profiler(prof)
    try:
        eager = X.execute(spec, x, w)
        with X.graph_kernel_events(copies=2):
            with X.graph_kernel_events():
                timed = X.execute(spec, x, w)
            assert X._STEP.graph_copies == 2
        assert X._STEP.graph_copies == 0
    finally:
        P.set_profiler(prev)
    assert torch.equal(eager, timed)
    assert len(prof.events) == 2
    assert [e.meta for e in prof.events] == [prof.events[0].meta] * 2
    assert "timing" not in prof.events[1].meta
