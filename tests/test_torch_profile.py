"""The port's trace leg of ``profile`` against the JAX package's: the
event schema and its JSON-lines file (each package reads the other's),
``validate_event``'s rejections, ``wrap_step``'s disabled path, the
execution layer's kernel-event sink (eager calls recorded with the
reference's meta, nothing inside a batcher or serve step), and one
batcher run in both packages giving the same sequence of step events
(smollm-135m smoke, f32, mode "off", params through the bridge), from
which the reference's ``replay.requests_from_trace`` rebuilds the
requests. A disabled profiler changes no token and no host sync."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.profile as JP
from repro.core import execution as JX
from repro.models import transformer as jT
from repro.models.layers import QuantConfig as JQuant
from repro.models.registry import get_config as jget_config
from repro.serve.engine import ContinuousBatcher as JBatcher
from repro.serve.engine import Request as JRequest
from repro_torch import profile as P
from repro_torch.bridge import params_from_numpy
from repro_torch.core import execution as X
from repro_torch.core import ternary as tern
from repro_torch.models.layers import QuantConfig
from repro_torch.models.registry import get_config
from repro_torch.serve.engine import ContinuousBatcher, Request, make_jit_serve_step
from repro_torch.models import transformer as T
from torch_threads import one_thread  # noqa: F401


def _event(mod, entry="execution.execute", spec="exact/torch/none", cls="decode",
           wall=100.0, **meta):
    return mod.TraceEvent(entry_point=entry, exec_spec=spec, shape_class=cls,
                          mesh=None, wall_us=wall, dispatch_us=wall / 2, meta=meta)


def _events(mod):
    return [_event(mod, wall=1.5, m=1, k=2, n=3),
            _event(mod, entry="serve.prefill", cls="prefill", wall=2.0,
                   prompts=[[0, 3, 6]], s_pad=4),
            mod.TraceEvent("serve.decode_step", "mode:off", "decode", {"model": 4},
                           812.4, 101.2, {"occupancy": 2})]


# ---------------------------------------------------------------------------
# Trace schema and file
# ---------------------------------------------------------------------------


def test_schema_constants_match_reference():
    assert P.TRACE_SCHEMA_VERSION == JP.TRACE_SCHEMA_VERSION
    assert P.REQUIRED_FIELDS == JP.trace.REQUIRED_FIELDS


def test_event_round_trip_and_json_match_reference():
    for mine, theirs in zip(_events(P), _events(JP)):
        d = mine.to_json()
        assert d == theirs.to_json()
        P.validate_event(d)
        assert P.event_from_json(json.loads(json.dumps(d))) == mine


def test_trace_files_are_byte_identical(tmp_path):
    paths = {}
    for name, mod in (("port", P), ("ref", JP)):
        paths[name] = tmp_path / f"{name}.jsonl"
        with mod.Profiler(paths[name]) as prof:
            for e in _events(mod):
                prof.record(e)
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_package_reads_the_others_trace(tmp_path, writer):
    w, r = (P, JP) if writer == "port" else (JP, P)
    path = tmp_path / "trace.jsonl"
    with w.Profiler(path) as prof:
        for e in _events(w):
            prof.record(e)
    got = r.read_trace(path)
    assert [e.to_json() for e in got] == [e.to_json() for e in prof.events]


# the reference's malformed cases (its tests/test_profile.py)
MUTATIONS = {
    "no-version": lambda d: d.pop("v"),
    "version-99": lambda d: d.update(v=99),
    "no-wall": lambda d: d.pop("wall_us"),
    "negative-wall": lambda d: d.update(wall_us=-1.0),
    "empty-entry": lambda d: d.update(entry_point=""),
    "string-mesh": lambda d: d.update(mesh="tp4"),
}


@pytest.mark.parametrize("mutate", list(MUTATIONS.values()), ids=list(MUTATIONS))
def test_validate_rejects_the_references_malformed_cases(mutate):
    d = _event(P).to_json()
    mutate(d)
    with pytest.raises(ValueError):
        P.validate_event(d)
    with pytest.raises(ValueError):
        JP.validate_event(d)


def test_read_trace_rejects_non_json(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text("{not json}\n")
    with pytest.raises(ValueError, match="not JSON"):
        P.read_trace(path)


def test_wrap_step_disabled_is_the_same_object():
    def step(x):
        return x

    assert P.wrap_step(step, None, "serve.decode_step") is step


def test_wrap_step_records_one_event_per_call():
    prof = P.Profiler()
    timed = P.wrap_step(lambda x: x + 1, prof, "serve.decode_step",
                        exec_spec="blocked/cuda/none", meta_fn=lambda x: {"x": int(x)})
    assert int(timed(torch.tensor(4))) == 5
    (e,) = prof.events
    assert (e.entry_point, e.exec_spec, e.shape_class, e.meta) == (
        "serve.decode_step", "blocked/cuda/none", "decode", {"x": 4})
    assert 0 <= e.dispatch_us <= e.wall_us


def test_backend_block_off_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert P.backend_block() == {"platform": "cpu", "device_kind": "cpu",
                                 "device_count": 1, "interpret": True}
    # the reference's keys
    assert set(P.backend_block()) == set(JP.backend_block())


# ---------------------------------------------------------------------------
# The execution layer's sink
# ---------------------------------------------------------------------------


def _operands():
    rng = np.random.default_rng(0)
    x = np.sign(rng.standard_normal((4, 64))).astype(np.float32)
    w = np.sign(rng.standard_normal((64, 32))).astype(np.float32)
    return x, w


@pytest.fixture
def installed():
    prof = P.Profiler()
    prev = P.set_profiler(prof)
    try:
        yield prof
    finally:
        assert P.set_profiler(prev) is prof


def test_eager_execute_records_the_references_meta(installed):
    x, w = _operands()
    X.execute(X.CiMExecSpec("exact", "torch"), torch.from_numpy(x), torch.from_numpy(w))
    (e,) = installed.events
    jprof = JP.Profiler()
    prev = JP.set_profiler(jprof)
    try:
        JX.execute(JX.CiMExecSpec(formulation="exact", backend="jnp"),
                   jnp.asarray(x), jnp.asarray(w))
    finally:
        JP.set_profiler(prev)
    (je,) = jprof.events
    assert (e.entry_point, e.shape_class, e.mesh, dict(e.meta)) == (
        je.entry_point, je.shape_class, je.mesh, dict(je.meta))
    assert e.exec_spec == "exact/torch/none" and je.exec_spec == "exact/jnp/none"
    assert e.meta == {"m": 4, "k": 64, "n": 32, "macs": 4 * 64 * 32,
                      "weight_bytes": 64 * 32 * 4}
    assert 0 <= e.dispatch_us <= e.wall_us


@pytest.mark.parametrize("m", [4, 40])
def test_eager_execute_packed_records(installed, m):
    rng = np.random.default_rng(m)
    x = torch.from_numpy(np.sign(rng.standard_normal((m, 64))).astype(np.float32))
    w = torch.from_numpy(np.sign(rng.standard_normal((64, 32))).astype(np.float32))
    pos, neg = tern.pack_ternary(w.to(torch.int8), axis=0)
    X.execute_packed(X.CiMExecSpec("blocked", "cuda", "bitplane_u8"), x, pos, neg)
    (e,) = installed.events
    assert e.entry_point == "execution.execute_packed"
    assert e.shape_class == X.shape_class(m)
    assert e.meta == {"m": m, "k": 64, "n": 32, "macs": m * 64 * 32,
                      "weight_bytes": 2 * 8 * 32}


def test_no_kernel_events_inside_a_step_scope(installed):
    x, w = _operands()
    spec = X.CiMExecSpec("blocked", "torch")
    with X.no_kernel_events():
        with X.no_kernel_events():
            X.execute(spec, torch.from_numpy(x), torch.from_numpy(w))
        X.execute(spec, torch.from_numpy(x), torch.from_numpy(w))
    assert installed.events == []
    X.execute(spec, torch.from_numpy(x), torch.from_numpy(w))
    assert len(installed.events) == 1


def test_set_profiler_returns_the_previous():
    assert P.current_profiler() is None
    p1, p2 = P.Profiler(), P.Profiler()
    assert P.set_profiler(p1) is None
    assert P.set_profiler(p2) is p1
    assert P.current_profiler() is p2
    assert P.set_profiler(None) is p2
    assert P.current_profiler() is None
    assert X._PROFILE_SINK is None


# ---------------------------------------------------------------------------
# One batcher run in both packages
# ---------------------------------------------------------------------------


def _requests(R, n=5):
    return [R(i, [1 + i % 7] * (1 + i % 3), max_new=2 + i % 3) for i in range(n)]


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("smollm-135m", smoke=True).replace(
        dtype="float32", quant=JQuant(mode="off"))
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    tcfg = get_config("smollm-135m", smoke=True).replace(
        dtype="float32", quant=QuantConfig(mode="off"))
    return jcfg, jparams, tcfg, params_from_numpy(tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def ref_run(models):
    """The reference batcher's profiled run (compiled once per module)."""
    jcfg, jparams, _, _ = models
    prof = JP.Profiler()
    b = JBatcher(jparams, jcfg, n_slots=3, s_max=32, profile=prof)
    reqs = _requests(JRequest)
    for r in reqs:
        b.submit(r)
    b.run()
    return prof.events, reqs, b.stats()


def _port_run(models, profile=None, seed=0):
    _, _, tcfg, tparams = models
    b = ContinuousBatcher(tparams, tcfg, n_slots=3, s_max=32, seed=seed,
                          device="cpu", profile=profile)
    reqs = _requests(Request)
    for r in reqs:
        b.submit(r)
    b.run()
    return b, reqs


def _step_events(events):
    """(entry_point, shape_class, exec_spec, meta) of the step events, meta
    through JSON (the trace file's form: tuples become lists)."""
    return [(e.entry_point, e.shape_class, e.exec_spec,
             json.loads(json.dumps(dict(e.meta))))
            for e in events if e.entry_point.startswith("serve.")]


def test_batcher_events_match_reference(models, ref_run, tmp_path):
    jevents, jreqs, jstats = ref_run
    path = tmp_path / "serve.jsonl"
    b, reqs = _port_run(models, profile=str(path))
    events = P.read_trace(path)            # closed by run(): whole and valid
    assert _step_events(events) == _step_events(jevents)
    assert b.stats() == jstats
    decode = [e for e in events if e.entry_point == "serve.decode_step"]
    prefill = [e for e in events if e.entry_point == "serve.prefill"]
    assert len(decode) == b.decode_steps and len(prefill) == b.prefill_batches
    assert [e.meta["step"] for e in decode] == list(range(b.decode_steps))
    assert all(e.meta["occupancy"] >= 1 and e.meta["arch"] == "smollm-135m"
               for e in decode)
    assert all(0 <= e.dispatch_us <= e.wall_us for e in decode + prefill)
    # no kernel event from inside a step
    assert {e.entry_point for e in events} == {"serve.decode_step", "serve.prefill"}
    # mode "off" at f32: the packages' tokens agree
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]


def test_reference_replay_rebuilds_requests_from_port_trace(models, tmp_path):
    from repro.profile.replay import requests_from_trace

    path = tmp_path / "serve.jsonl"
    _, reqs = _port_run(models, profile=str(path))
    got = requests_from_trace(JP.read_trace(path))
    assert [(r.rid, r.prompt_len, r.max_new) for r in got] == \
        [(r.rid, len(r.prompt), r.max_new) for r in reqs]


def test_disabled_profiler_changes_nothing(models):
    """The reference's ``profile.step_instrumentation.disabled`` contract:
    with no profiler the batcher holds no wrapper (it calls its captured
    step itself), and the profiled run's tokens and host syncs equal the
    unprofiled run's."""
    plain, plain_reqs = _port_run(models, seed=3)
    assert plain.profiler is None and plain._run_decode is plain._decode
    prof, prof_reqs = _port_run(models, profile=P.Profiler(), seed=3)
    assert prof._run_decode is not prof._decode
    assert [r.generated for r in plain_reqs] == [r.generated for r in prof_reqs]
    assert plain.stats() == prof.stats()
    st = plain.stats()
    assert st["host_syncs"] == st["decode_steps"] + st["prefill_batches"]


def test_batcher_and_serve_steps_record_no_kernel_events(models, installed):
    _, _, tcfg, tparams = models
    cim = tcfg.replace(quant=QuantConfig(mode="cim"))
    b = ContinuousBatcher(tparams, cim, n_slots=2, s_max=32, device="cpu")
    for r in _requests(Request, n=3):
        b.submit(r)
    b.run()
    looped = ContinuousBatcher(tparams, cim, n_slots=2, s_max=32, device="cpu",
                               fused=False)
    for r in _requests(Request, n=3):
        looped.submit(r)
    looped.run()
    step = make_jit_serve_step(cim)
    caches = T.init_caches(cim, 1, 16, device="cpu")
    step(tparams, torch.tensor([[3, 4]]), caches, 0)
    assert installed.events == []
    # an eager model call outside a step records, one event per dense layer
    T.decode_step(tparams, torch.tensor([[3]]), caches, 2, cim)
    assert len(installed.events) == 7 * cim.n_layers
    assert {e.entry_point for e in installed.events} == {"execution.execute"}


def test_prepare_weights_records_one_prepare_event(models):
    _, _, tcfg, tparams = models
    spec = X.CiMExecSpec("blocked", "cuda", "bitplane_u8")
    prof = P.Profiler()
    b = ContinuousBatcher(tparams, tcfg, n_slots=2, s_max=32, exec_spec=spec,
                          prepare_weights=True, device="cpu", profile=prof)
    (e,) = prof.events
    assert (e.entry_point, e.exec_spec, e.shape_class) == (
        "serve.prepare", "blocked/cuda/bitplane_u8", "prepare")
    assert b.spec_tag == "blocked/cuda/none"
