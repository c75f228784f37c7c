"""The captured decode step (``serve.graph``, ``serve.engine``) on the
CPU: what a CUDA-graph capture needs of the batcher (static storage),
``make_jit_serve_step`` against ``serve_step`` and the JAX package's
``serve_step`` (f32 logits, atol 1e-5: the sums run in another order in
the two frameworks), and the launch counters of a replayed step, through
a counter-only stand-in for the graph. The capture itself runs on the
card (``tests/test_torch_cuda.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jT
from repro.models.registry import get_config as jget_config
from repro.serve.engine import serve_step as jserve_step
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import packed_mac as pm
from repro_torch.kernels import ternary_mac as tm
from repro_torch.models import transformer as tT
from repro_torch.models.registry import get_config
from repro_torch.serve import graph
from repro_torch.serve.engine import (ContinuousBatcher, Request, make_jit_serve_step,
                                      serve_step)

ATOL = 1e-5


@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "sampled"])
def test_batcher_step_keeps_its_storage(temperature):
    """Across decode steps and slot refills the caches keep their
    storage, the step runs on the same static input tensors, and the host
    buffers it copies from are the arrays the batcher writes."""
    cfg = get_config("smollm-135m", smoke=True)
    params = tT.init_params(cfg, seed=0, device="cpu")
    batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=32,
                                temperature=temperature, device="cpu")
    ptrs = (batcher.caches.k.data_ptr(), batcher.caches.v.data_ptr())
    statics = tuple(t.data_ptr() for t in batcher._decode.inputs)
    assert [h.data_ptr() for h in batcher._host_inputs] == [
        a.ctypes.data for a in (batcher._last_tok, batcher.slot_pos, batcher.slot_start)]
    seen = []
    body = batcher._decode.fn

    def spy(*args):
        seen.append(tuple(a.data_ptr() for a in args))
        return body(*args)

    batcher._decode.fn = spy
    for i in range(5):
        batcher.submit(Request(i, [1 + i, 2, 3 + i][: 1 + i % 3], max_new=2 + i % 3))
    fills = 0
    while batcher.queue or any(r is not None for r in batcher.slot_req):
        before = batcher.prefill_batches
        batcher.step()
        fills += batcher.prefill_batches - before
        assert (batcher.caches.k.data_ptr(), batcher.caches.v.data_ptr()) == ptrs
    assert fills >= 2 and len(seen) == batcher.decode_steps >= 3
    assert set(seen) == {statics}
    assert batcher.capture_seconds is None      # the CPU runs the step eagerly


def _smoke_pair():
    jcfg = jget_config("smollm-135m", smoke=True)
    jcfg = jcfg.replace(dtype="float32", quant=dataclasses.replace(jcfg.quant, mode="off"))
    tcfg = get_config("smollm-135m", smoke=True)
    tcfg = tcfg.replace(dtype="float32", quant=dataclasses.replace(tcfg.quant, mode="off"))
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, device="cpu")


def test_jit_serve_step_matches_serve_step_and_jax():
    """make_jit_serve_step on the CPU == serve_step, and both == the JAX
    package's serve_step on bridged params, after a prompt and over
    decode steps at a scalar index and at a (B,) index."""
    jcfg, tcfg, jparams, tparams = _smoke_pair()
    rng = np.random.default_rng(4)
    prompt = rng.integers(1, jcfg.vocab, (2, 5)).astype(np.int32)
    s_max = 16
    jc = jT.init_caches(jcfg, 2, s_max, dtype=jnp.float32)
    tc = tT.init_caches(tcfg, 2, s_max, dtype=torch.float32, device="cpu")
    tc_jit = tT.init_caches(tcfg, 2, s_max, dtype=torch.float32, device="cpu")
    jit = make_jit_serve_step(tcfg)
    steps = [(prompt, 0), (rng.integers(1, jcfg.vocab, (2, 1)), 5),
             (rng.integers(1, jcfg.vocab, (2, 1)), np.array([6, 6])),
             (rng.integers(1, jcfg.vocab, (2, 1)), np.array([7, 7]))]
    for tokens, index in steps:
        tokens = tokens.astype(np.int32)
        t_index = torch.from_numpy(index).long() if isinstance(index, np.ndarray) else index
        jl, jc = jserve_step(jparams, jnp.asarray(tokens), jc, jnp.asarray(index, jnp.int32),
                             jcfg)
        tl, tc = serve_step(tparams, torch.from_numpy(tokens).long(), tc, t_index, tcfg)
        gl, tc_jit = jit(tparams, torch.from_numpy(tokens).long(), tc_jit, t_index)
        assert torch.equal(gl, tl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tc_jit.k.numpy(), np.asarray(jc.k), atol=ATOL)
    assert torch.equal(tc_jit.v, tc.v)


class _CounterOnlyGraph:
    """Stands in for a CUDA graph: its replay launches nothing here."""

    def replay(self):
        pass


class _CounterOnlyStep(graph.CapturedStep):
    """CapturedStep with the device parts replaced: the warm-up runs the
    step, the 'capture' runs it once more (so the wrappers' counters move
    as a real capture moves them) and records a counter-only graph."""

    def _warm_up(self):
        return self.fn(*self.inputs)

    def _record(self):
        self.output = self.fn(*self.inputs)
        return _CounterOnlyGraph()


def _zero_counters(monkeypatch):
    for fn in graph.launch_counted():
        monkeypatch.setattr(fn, "launches", 0)


def _fake_step(x):
    # what one step of a 2-layer model launches: 14 of #1, 2 of #3
    tm.ternary_cim_matmul.launches += 14
    pm.packed_cim_matmul_decode_stream.launches += 2
    return x + 1


@pytest.mark.parametrize("replays", [1, 5])
def test_replay_adds_the_launches_seen_at_capture(monkeypatch, replays):
    """After the first call (a warm-up that really runs, and a capture
    whose counter ticks launch nothing) and N replays, each counter reads
    (1 + N) x what one step launches."""
    _zero_counters(monkeypatch)
    step = _CounterOnlyStep(_fake_step, [torch.zeros(3)], "cpu")
    step.graphed = True
    assert torch.equal(step(), torch.ones(3))
    assert step.captured_launches == {tm.ternary_cim_matmul: 14,
                                      pm.packed_cim_matmul_decode_stream: 2}
    assert (tm.ternary_cim_matmul.launches,
            pm.packed_cim_matmul_decode_stream.launches) == (14, 2)
    assert step.capture_seconds is not None
    for _ in range(replays):
        assert torch.equal(step(), torch.ones(3))
    got = {fn: fn.launches for fn in graph.launch_counted()}
    assert got == {fn: (1 + replays) * step.captured_launches.get(fn, 0)
                   for fn in graph.launch_counted()}
    assert step.replays == replays


def test_failed_capture_raises_and_restores_counters(monkeypatch):
    _zero_counters(monkeypatch)

    class Failing(_CounterOnlyStep):
        def _record(self):
            self.fn(*self.inputs)
            raise RuntimeError("capture invalidated")

    step = Failing(_fake_step, [torch.zeros(3)], "cpu")
    step.graphed = True
    with pytest.raises(RuntimeError, match="capture invalidated"):
        step()
    assert step.graph is None
    assert tm.ternary_cim_matmul.launches == 14       # the warm-up's only


def test_capture_runs_with_the_collector_off(monkeypatch):
    """A capture collects garbage first and keeps the collector off until
    it ends (a graph freed by the collector mid-capture would end the
    capture), then restores it, also when the capture raises; the pool
    bytes are what the capture added to the reserved memory."""
    import contextlib
    import gc

    class Graph:
        def register_generator_state(self, generator):
            pass

    reserved = iter([100, 164, 200])
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: next(reserved))
    seen = []

    class Step(graph.CapturedStep):
        def _warm_up(self):
            self._stream = None
            return self.fn(*self.inputs)

    def fn(x):
        seen.append(gc.isenabled())
        return x + 1

    def failing(x):
        if not gc.isenabled():
            raise RuntimeError("capture invalidated")
        return x + 1

    assert gc.isenabled()
    step = Step(fn, [torch.zeros(2)], "cpu")
    step.graphed = True
    step()
    assert seen == [True, False] and gc.isenabled() and step.pool_bytes == 64
    again = Step(failing, [torch.zeros(2)], "cpu")
    again.graphed = True
    with pytest.raises(RuntimeError, match="capture invalidated"):
        again()
    assert gc.isenabled() and again.graph is None
