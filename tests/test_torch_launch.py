"""The port's launch/ twins against the JAX package's, on the CPU: the
roofline (``launch/roofline.py``), the op accounting
(``launch/op_analysis.py``, the counterpart of ``hlo_analysis.py``), the
dry run (``launch/dryrun.py``) on the meta device and its FSDP
placement, and the hillclimb's calibrated scoring
(``launch/hillclimb.py``).

The contract:

  * ``model_flops_estimate`` equals the reference's for every arch x
    shape; ``Roofline.to_dict()`` has the reference's keys, plus the FLOPs
    and compute time by dtype (the float64 term among them);
  * op analysis: one ``mm`` is 2MNK, a 10-layer loop 10x one layer (the
    answer to the reference's scan trip-count test), a CiM MAC two
    ternary products and an exact one one product, on the plain version
    as on a launch, and each collective's ring bytes equal
    ``hlo_analysis._collective_moved``'s on the same (bytes, n);
  * the dry run's per-rank FLOPs of smoke smollm-135m over a (2, 2) grid
    (a mode-"off" prefill and a CiM train step) equal
    ``hlo_analysis.analyze`` of the reference's compiled sharded step
    exactly (the bound is 1%);
  * every arch's decode_32k cell dry-runs on the meta device, at a cut
    depth (``n_layers`` 2; zamba2 6, one application of its shared
    block: the full-depth sweep is ``python -m repro_torch.launch.dryrun
    --all``, whose wall time PERF.md records), allocating nothing, and
    its resident parameter bytes under ``fsdp=True`` equal the bytes the
    reference's ``param_specs(fsdp=True)`` gives over
    ``jax.eval_shape(init_params)``; FSDP lowers the resident bytes and
    adds all-gather bytes;
  * the hillclimb's validation and calibrated scoring mirror
    ``tests/test_hw.py``'s, and on one table built in both packages
    ``score_cell`` and ``rank_candidates`` give the reference's numbers
    and order.

``repro.launch.dryrun`` is not imported here: it rewrites ``XLA_FLAGS``
at import.
"""
import dataclasses
import functools
import importlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from torch_threads import one_thread  # noqa: F401

from repro.dist import sharding as jshd
from repro.launch import hlo_analysis as ha
from repro.launch import roofline as jrl
from repro.models import transformer as JT
from repro.models.registry import SHAPES as JSHAPES, get_config as jget_config
from repro.optim import adamw as jadamw
from repro_torch.analysis import contracts
from repro_torch.dist import collectives as C
from repro_torch.kernels import ternary_mac as tm
from repro_torch.launch import dryrun, hillclimb, op_analysis as oa
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import AbstractMesh, dry_mesh, make_production_mesh
from repro_torch.models.registry import ARCH_IDS, SHAPES, ShapeCell, get_config

jts = importlib.import_module("repro.train.train_step")

PRODUCTION = {"data": 16, "model": 16}


def _cut(arch):
    """The depth the per-arch dry runs here take: 2 layers, zamba2 6 (one
    application of its shared block)."""
    return 6 if arch.startswith("zamba2") else 2


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_estimate_matches_reference(arch, shape):
    want = jrl.model_flops_estimate(jget_config(arch), JSHAPES[shape], JSHAPES[shape].kind)
    got = rl.model_flops_estimate(get_config(arch), SHAPES[shape], SHAPES[shape].kind)
    assert got == want


def _roofs(**kw):
    args = dict(arch="a", shape="s", mesh="16x16", chips=4, flops=8e12,
                bytes_accessed=4e12, coll_bytes=1e9, coll_breakdown={"all-reduce": 1e9},
                model_flops=6e12)
    return jrl.Roofline(**args), rl.Roofline(**args, **kw)


def test_roofline_keys_are_the_reference_keys_plus_dtypes():
    ref, port = _roofs(flops_by_dtype={"bf16": 4e12, "f64": 4e12})
    want, got = ref.to_dict(), port.to_dict()
    assert set(want) <= set(got)
    assert set(got) - set(want) == {"flops_by_dtype", "t_compute_by_dtype_s",
                                    "t_compute_f64_s"}
    assert got["t_compute_f64_s"] == 4e12 / (4 * rl.PEAK_F64)
    assert got["t_compute_s"] == pytest.approx(4e12 / (4 * rl.PEAK_BF16)
                                               + 4e12 / (4 * rl.PEAK_F64))


def test_roofline_prices_each_dtype_at_its_peak():
    _, port = _roofs(flops_by_dtype={"int8": 1979e12, "f32": 67e12})
    assert port.t_compute_by_dtype == {"f32": 0.25, "int8": 0.25}
    assert port.t_memory == 4e12 / (4 * rl.HBM_BW)
    assert port.t_collective == 1e9 / rl.NVLINK_BW
    # no split: all at the bf16 peak, the reference's formula on H100's rate
    _, plain = _roofs()
    assert plain.t_compute == 8e12 / (4 * rl.PEAK_BF16)
    assert rl.fmt_table([plain]).splitlines()[2].startswith("a ")


# ---------------------------------------------------------------------------
# op analysis
# ---------------------------------------------------------------------------


def test_one_mm_is_2mnk():
    a, b = torch.ones((64, 32)), torch.ones((32, 48))
    cost = oa.analyze(oa.record(torch.mm, a, b).trace)
    assert cost.flops == 2 * 64 * 32 * 48
    assert dict(cost.flops_by_dtype) == {"f32": 2 * 64 * 32 * 48}
    assert cost.hbm_bytes == (64 * 32 + 32 * 48 + 64 * 48) * 4


def test_ten_layer_loop_is_ten_times_one_layer():
    """The port's answer to the reference's scan trip-count test: an
    eager loop dispatches every iteration."""
    x = torch.ones((64, 64), dtype=torch.bfloat16)
    ws = torch.ones((12, 64, 64), dtype=torch.bfloat16)

    def run(n):
        def f():
            c = x
            for i in range(n):
                c = torch.tanh(c @ ws[i])
            return c
        return oa.analyze(oa.record(f).trace)

    one, ten = run(1), run(10)
    assert ten.flops == 10 * one.flops == 10 * 2 * 64 ** 3
    assert ten.hbm_bytes == 10 * one.hbm_bytes
    assert dict(ten.flops_by_dtype) == {"bf16": ten.flops}


def test_flops_split_by_dtype():
    def f():
        torch.ones((8, 16), dtype=torch.float64) @ torch.ones((16, 4), dtype=torch.float64)
        torch.bmm(torch.ones((3, 8, 16)), torch.ones((3, 16, 4)))
    cost = oa.analyze(oa.record(f).trace)
    assert dict(cost.flops_by_dtype) == {"f64": 2 * 8 * 16 * 4, "f32": 3 * 2 * 8 * 16 * 4}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_mac_calls_count_their_logical_work(device):
    """A CiM MAC is two ternary products of M*K*N, an exact MAC one, on
    the plain version (CPU or meta) as on a launch; the plain version's
    own ops cost nothing."""
    x = torch.ones((5, 48), dtype=torch.int8, device=device)
    w = torch.ones((48, 7), dtype=torch.int8, device=device)
    cim = oa.analyze(oa.record(tm.ternary_cim_matmul, x, w).trace)
    exact = oa.analyze(oa.record(tm.ternary_exact_matmul, x, w).trace)
    assert cim.flops == 2 * 2 * 5 * 48 * 7 and exact.flops == 2 * 5 * 48 * 7
    assert dict(cim.flops_by_dtype) == {"int8": cim.flops}
    assert dict(cim.kernel_calls) == {"ternary_cim_mac": 1}
    assert dict(exact.kernel_calls) == {"ternary_exact_mac": 1}
    assert cim.hbm_bytes == exact.hbm_bytes == 5 * 48 + 48 * 7 + 4 * 5 * 7


def test_plain_calls_report_only_to_a_recorder():
    x = torch.ones((2, 16), dtype=torch.int8)
    seen = []
    contracts._CALL_SINKS.append(lambda *a: seen.append(a[:2]))
    try:
        tm.ternary_cim_matmul(x, torch.ones((16, 3), dtype=torch.int8))
    finally:
        contracts._CALL_SINKS.pop()
    assert seen == [("ternary_cim_mac", (2, 16, 3, 2, 2 * 16 + 16 * 3 + 4 * 2 * 3))]
    assert not contracts._CALL_SINKS and not C._SINKS


def test_launches_carry_their_own_work_and_replays_none():
    """A launch reports its own (M, K, N) where the wrapper launches it, so
    two back-to-back launches of different shapes keep theirs; a launch
    no wrapper reported (a CUDA graph's replay) records no work, which
    ``analyze`` refuses."""
    from repro_torch.kernels import mac_call

    fn, before = tm.ternary_cim_matmul, tm.ternary_cim_matmul.launches

    def launch(m, k, n):   # what the wrapper does where it launches
        out = torch.empty((m, n))
        fn.launches += 1
        contracts.report_call(fn.entry, mac_call(m, k, n, 2, k * n), out, launched=True)

    def replay(times):     # a graph replay: the counter moves, nothing reports
        fn.launches += times

    try:
        rec = oa.record(lambda: (launch(4, 32, 8), launch(64, 16, 24)))
        assert [r.info[:3] for r in rec.trace if r.is_kernel] == [(4, 32, 8), (64, 16, 24)]
        assert oa.analyze(rec.trace).flops == 2 * 2 * (4 * 32 * 8 + 64 * 16 * 24)
        rec = oa.record(lambda: (replay(2), launch(4, 32, 8)))
        assert [r.info[:3] for r in rec.trace if r.is_kernel] == [(), (), (4, 32, 8)]
        with pytest.raises(ValueError, match="carries no call work"):
            oa.analyze(rec.trace)
    finally:
        fn.launches = before


@pytest.mark.parametrize("op", oa.COLLECTIVES)
def test_collective_bytes_match_reference_ring_model(op):
    for n in (1, 2, 3, 4, 16):
        line = (f"%c = f32[1024]{{0}} {op}(%p), replica_groups=[{max(1, 16 // n)},{n}]"
                f"<=[{16 // n * n}]")
        inst = ha.Instr("c", "f32[1024]{0}", op, "%p)", line)
        assert ha._collective_moved(inst, 16) == (op, oa.collective_moved(op, 4096, n))


def test_dry_collectives_move_nothing_and_count():
    mesh = dry_mesh(AbstractMesh((4, 2), ("data", "model")))
    x = torch.ones((3, 5), device="meta")
    C.reset_counts()

    def f():
        C.all_reduce(x, mesh.group)
        C.all_gather(x, mesh.data_group, dim=0)
        C.bucket_mean([x, x], mesh.data_group)
    rec = oa.record(f)
    assert dict(C.COUNTS) == {"all_reduce": 2, "all_gather": 1}
    assert [r.info for r in rec.trace if r.is_collective] == [(60, 2), (240, 4), (120, 4)]
    cost = oa.analyze(rec.trace)
    assert dict(cost.coll_calls) == {"all-reduce": 2, "all-gather": 1}
    assert cost.coll["all-reduce"] == 2 * 60 * 1 / 2 + 2 * 120 * 3 / 4
    assert cost.coll["all-gather"] == 240 * 3 / 4
    # only a DryGroup takes the seam: a real mesh's groups are gloo groups
    assert isinstance(mesh.group, C.DryGroup) and isinstance(mesh.data_group, C.DryGroup)
    assert not C._dry(None) and C.group_size(mesh.data_group) == 4


# ---------------------------------------------------------------------------
# the dry run against the reference's compiled step
# ---------------------------------------------------------------------------


def _reference_flops(cfg, kind, b, s, data, model):
    mesh = Mesh(np.asarray(jax.devices()[:data * model]).reshape(data, model),
                ("data", "model"))
    sizes = {"data": data, "model": model}
    pshape = jax.eval_shape(functools.partial(JT.init_params, cfg=cfg), jax.random.PRNGKey(0))
    pspec = jshd.param_specs(pshape, axis_sizes=sizes)
    ns = lambda t: jax.tree.map(lambda sp: NamedSharding(mesh, sp), t,
                                is_leaf=lambda sp: isinstance(sp, P))
    rows = NamedSharding(mesh, P(("data",), None))
    tok = jax.ShapeDtypeStruct((b, s), jnp.int32)
    jshd.enable_activation_sharding(multi_pod=False, batch_divisor=data, model_size=model)
    try:
        with jshd.use_mesh(mesh):
            if kind == "prefill":
                fn = jax.jit(lambda p, t: JT.forward(p, t, cfg),
                             in_shardings=(ns(pspec), {"tokens": rows}))
                compiled = fn.lower(pshape, {"tokens": tok}).compile()
            else:
                sshape = jax.eval_shape(functools.partial(jts.init_train_state, cfg=cfg),
                                        jax.random.PRNGKey(0))
                spec = jts.TrainState(pspec, type(sshape.opt)(step=P(), mu=pspec, nu=pspec),
                                      P(), None)
                opt = jadamw.AdamWConfig()
                fn = jax.jit(lambda st, bt: jts.train_step(st, bt, cfg, opt),
                             in_shardings=(ns(spec), {"tokens": rows, "labels": rows}))
                compiled = fn.lower(sshape, {"tokens": tok, "labels": tok}).compile()
    finally:
        jshd.disable_activation_sharding()
    return ha.analyze(compiled.as_text(), data * model).flops


@pytest.mark.parametrize("kind,mode", [("prefill", "off"), ("train", "cim")])
def test_dry_run_flops_match_reference_hlo_at_2x2(kind, mode):
    """Smoke smollm-135m, 4 x 32 tokens, over a (2, 2) grid: the port's
    per-rank FLOPs (its CiM MACs at two ternary products) equal the
    reference's per-device HLO FLOPs (its ``_blocked_jnp`` two dots)."""
    b, s = 4, 32
    jcfg = jget_config("smollm-135m", smoke=True)
    jcfg = jcfg.replace(quant=dataclasses.replace(jcfg.quant, mode=mode))
    want = _reference_flops(jcfg, kind, b, s, 2, 2)
    res = dryrun.lower_cell(get_config("smollm-135m", smoke=True), ShapeCell("x", kind, s, b),
                            quant_mode=mode, mesh=AbstractMesh((2, 2), ("data", "model")),
                            verbose=False)
    assert res.ok, res.error
    got = res.op_cost["flops"]
    assert abs(got - want) <= 0.01 * want, (got, want)
    assert got == want
    assert res.roofline["hlo_flops"] == got * 4
    if mode == "cim":
        assert set(res.op_cost["flops_by_dtype"]) == {"int8", "f32", "f64"}
        # 7 dense layers in each of 2 layers (the smoke config: no remat)
        assert res.op_cost["kernel_calls"] == {"ternary_cim_mac": 7 * 2}


def _reference_param_bytes(arch, n_layers, fsdp):
    cfg = jget_config(arch).replace(n_layers=n_layers)
    shapes = jax.eval_shape(functools.partial(JT.init_params, cfg=cfg), jax.random.PRNGKey(0))
    specs = jshd.param_specs(shapes, fsdp=fsdp, axis_sizes=PRODUCTION)
    leaves = jax.tree_util.tree_leaves(shapes)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda sp: isinstance(sp, P))
    assert len(leaves) == len(spec_leaves)
    total = 0.0
    for leaf, sp in zip(leaves, spec_leaves):
        split = math.prod(PRODUCTION[a] for a in sp if a)
        total += leaf.size * leaf.dtype.itemsize / split
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_dry_runs_decode_with_fsdp_bytes_of_reference(arch):
    n = _cut(arch)
    plain = dryrun.lower_cell(arch, "decode_32k", cfg_overrides={"n_layers": n},
                              verbose=False)
    fsdp = dryrun.lower_cell(arch, "decode_32k", cfg_overrides={"n_layers": n},
                             fsdp=True, verbose=False)
    for res in (plain, fsdp):
        assert res.ok and res.error is None, res.error
        assert res.mesh_name == "16x16" and res.roofline["chips"] == 256
        # nothing on any device: every tensor the step made was on meta
        assert res.memory["host_index_bytes"] == 0
        assert res.op_cost["kernel_calls"], "the CiM MACs ran through the kernels"
    assert plain.memory["param_bytes"] == _reference_param_bytes(arch, n, False)
    assert fsdp.memory["param_bytes"] == _reference_param_bytes(arch, n, True)
    assert fsdp.memory["param_bytes"] < plain.memory["param_bytes"]
    assert fsdp.memory["argument_bytes"] < plain.memory["argument_bytes"]
    gathered = lambda r: r.roofline["coll_breakdown"].get("all-gather", 0.0)
    assert gathered(fsdp) > gathered(plain)
    assert fsdp.op_cost["flops"] == plain.op_cost["flops"]


def test_long_context_skip_is_the_reference_skip():
    res = dryrun.lower_cell("smollm-135m", "long_500k", verbose=False)
    assert res.ok and res.error.startswith("SKIP: long_500k requires sub-quadratic")


def test_train_cell_is_sharded_over_both_axes():
    """A (2, 2) training step's rank runs its half of the rows on its
    shards: half the FLOPs of the (1, 2) step, and the data axis's
    gradient bucket and statistics in its all-reduces."""
    cfg = get_config("smollm-135m", smoke=True)
    cell = ShapeCell("x", "train", 32, 4)
    runs = {m: dryrun.lower_cell(cfg, cell, mesh=AbstractMesh(m, ("data", "model")),
                                 verbose=False) for m in ((1, 2), (2, 2))}
    assert all(r.ok for r in runs.values())
    assert runs[(2, 2)].op_cost["flops"] * 2 == runs[(1, 2)].op_cost["flops"]
    counts = runs[(2, 2)].op_cost["collective_counts"]
    assert counts["all_reduce"] > runs[(1, 2)].op_cost["collective_counts"]["all_reduce"]
    assert runs[(2, 2)].memory["peak_bytes"] > runs[(2, 2)].memory["argument_bytes"] > 0


def test_dryrun_cli_writes_the_cell_json(tmp_path, capsys):
    assert dryrun.main(["--arch", "mamba2-780m", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    cell = json.loads((tmp_path / "mamba2-780m__decode_32k__16x16.json").read_text())
    assert cell["ok"] and cell["roofline"]["bottleneck"] in ("compute", "memory",
                                                             "collective")
    assert set(jrl.Roofline("a", "s", "m", 1, 1.0, 1.0, 0.0, {}, 1.0).to_dict()) <= set(
        cell["roofline"])
    assert "OpMemoryStats(argument_size_in_bytes=" in cell["memory_analysis"]
    assert "1 cells, 0 failures" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# hillclimb (tests/test_hw.py::TestHillclimb* on the port)
# ---------------------------------------------------------------------------


class TestHillclimbValidation:
    def _err(self, capsys, argv):
        with pytest.raises(SystemExit) as e:
            hillclimb.main(argv)
        assert e.value.code == 2
        return capsys.readouterr().err

    def test_unknown_arch_friendly(self, capsys):
        err = self._err(capsys, ["--arch", "gpt-17", "--shape", "train_4k", "--name", "X"])
        assert "registered archs" in err and "yi-34b" in err

    def test_unknown_shape_friendly(self, capsys):
        err = self._err(capsys, ["--arch", "yi-34b", "--shape", "train_400k",
                                 "--name", "X"])
        assert "registered shapes" in err and "train_4k" in err

    def test_bad_array_spec_friendly(self, capsys):
        err = self._err(capsys, ["--arch", "yi-34b", "--shape", "train_4k",
                                 "--name", "X", "--array-spec", "unobtanium"])
        assert "unobtanium" in err and "8T-SRAM" in err

    def test_bad_calibration_friendly(self, capsys, tmp_path):
        bad = tmp_path / "cal.json"
        bad.write_text('{"version": 999}')
        err = self._err(capsys, ["--arch", "yi-34b", "--shape", "train_4k",
                                 "--name", "X", "--calibration", str(bad)])
        assert "calibration" in err


S1 = "blocked/cuda/bitplane_u8"
S2 = "blocked/cuda_stream/bitplane_u8"


def _table(pkg, mmac_by_spec):
    """One table in ``pkg`` ("repro" or "repro_torch"): a KernelFit per
    spec and shape class, with the given per-MMAC cost and residual."""
    cal = importlib.import_module(f"{pkg}.profile.calibrate")
    kern = {}
    for spec, (mmac, r) in mmac_by_spec.items():
        fit = cal.KernelFit(fixed_us=10.0, us_per_mmac=mmac, us_per_mb=0.5,
                            bytes_per_weight=0.25, n_events=20, residual_pct=r)
        kern[f"{spec}|decode"] = fit
        kern[f"{spec}|prefill"] = fit
    return cal.CalibrationTable(version=cal.CALIBRATION_VERSION, backend="cpu",
                                default_spec=S1, kernels=kern)


class TestHillclimbCalibratedScoring:
    def test_score_cell_costs_workload(self):
        s = hillclimb.score_cell("smollm-135m", "decode_32k",
                                 _table("repro_torch", {S1: (0.5, 1.0)}))
        assert s["trusted"] and s["predicted_us"] > 0 and s["layers"] > 0
        s10 = hillclimb.score_cell("smollm-135m", "decode_32k",
                                   _table("repro_torch", {S1: (5.0, 1.0)}))
        assert s10["predicted_us"] > s["predicted_us"]

    def test_calibrated_table_changes_ranking(self):
        cands = [("base", "smollm-135m", "decode_32k", S1),
                 ("stream", "smollm-135m", "decode_32k", S2)]
        r1 = hillclimb.rank_candidates(cands, _table(
            "repro_torch", {S1: (0.01, 1.0), S2: (0.5, 1.0)}))
        r2 = hillclimb.rank_candidates(cands, _table(
            "repro_torch", {S1: (0.5, 1.0), S2: (0.01, 1.0)}))
        assert [n for n, _ in r1] == ["base", "stream"]
        assert [n for n, _ in r2] == ["stream", "base"]
        assert all(s["trusted"] for _, s in r1 + r2)

    def test_high_residual_never_promotes(self):
        cands = [("base", "smollm-135m", "decode_32k", S1),
                 ("fast-noisy", "smollm-135m", "decode_32k", S2)]
        ranked = hillclimb.rank_candidates(cands, _table(
            "repro_torch", {S1: (0.5, 1.0), S2: (1e-6, 60.0)}))
        assert [n for n, _ in ranked] == ["base", "fast-noisy"]
        assert not ranked[1][1]["trusted"]


def test_hillclimb_scores_and_ranks_as_the_reference():
    """One table built in both packages: the same scores and order."""
    from repro.launch import hillclimb as jhc

    fits = {S1: (0.3, 2.0), S2: (0.2, 40.0)}
    cands = [(f"{arch}/{shape}/{spec}", arch, shape, spec)
             for arch in ("smollm-135m", "yi-34b", "deepseek-v2-236b", "whisper-large-v3")
             for shape in ("train_4k", "decode_32k") for spec in (S1, S2)]
    ref, port = _table("repro", fits), _table("repro_torch", fits)
    for _, arch, shape, spec in cands:
        assert hillclimb.score_cell(arch, shape, port, spec=spec) == jhc.score_cell(
            arch, shape, ref, spec=spec)
    assert hillclimb.rank_candidates(cands, port) == jhc.rank_candidates(cands, ref)
    assert hillclimb.RESIDUAL_GATE_PCT == jhc.RESIDUAL_GATE_PCT


def test_hillclimb_cli_scores_a_fsdp_cell(tmp_path, capsys):
    table = tmp_path / "cal.json"
    table.write_text(json.dumps(_table("repro_torch", {S1: (0.5, 1.0)}).to_json()))
    out = tmp_path / "perf"
    assert hillclimb.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--name", "A1",
                           "--fsdp", "--cfg", '{"n_layers": 2}', "--calibration",
                           str(table), "--out", str(out)]) == 0
    cell = json.loads((out / "smollm-135m__decode_32k__A1.json").read_text())
    assert cell["ok"] and cell["calibrated"]["trusted"]
    assert cell["roofline"]["coll_breakdown"]["all-gather"] > 0
    assert "calibrated[" in capsys.readouterr().out


def test_production_mesh_and_its_dry_rank():
    mesh = make_production_mesh()
    rank = dry_mesh(mesh)
    assert (mesh.size, rank.shape, rank.rank, rank.data_rank) == (
        256, {"data": 16, "model": 16}, 0, 0)
    pod = dry_mesh(make_production_mesh(multi_pod=True))
    assert pod.shape == {"data": 32, "model": 16} and pod.data_group.size == 32
