"""Serving: the port's generate() against the JAX package's (greedy
prefix under mode="cim"), the port's fused batcher against its own
generate() (exact under act_scale="per_row"), batcher bookkeeping, the
stored-plane path (prepare_for_spec byte-identical to the JAX package;
execute_packed on the prepared planes == execute), a slot freed at
capacity, the quantized KV caches and the looped baseline (fused=False)
against generate() and the JAX batcher."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.execution import CiMExecSpec as JSpec
from repro.models import transformer as jT
from repro.models.registry import get_config as jget_config
from repro.quant.prepare import prepare_for_spec as jprepare
from repro.serve.engine import ContinuousBatcher as JBatcher
from repro.serve.engine import Request as JRequest
from repro.serve.engine import generate as jgenerate
from repro_torch import api
from repro_torch.bridge import params_from_numpy
from repro_torch.core import execution
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.models.registry import get_config
from repro_torch.quant.prepare import prepare_for_spec, tree_paths
from repro_torch.serve.engine import ContinuousBatcher, Request, generate
from torch_threads import one_thread  # noqa: F401

PACKED_SPEC = api.CiMExecSpec("blocked", "cuda", "bitplane_u8")


def _jax_params(dtype):
    jcfg = jget_config("smollm-135m", smoke=True).replace(dtype=dtype)
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    tcfg = get_config("smollm-135m", smoke=True).replace(dtype=dtype)
    return jcfg, jparams, tcfg, params_from_numpy(tree, tcfg, device="cpu")


def _per_row(cfg):
    return cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))


@pytest.fixture(scope="module")
def port_model():
    cfg = _per_row(get_config("smollm-135m", smoke=True))
    return cfg, tT.init_params(cfg, seed=0, device="cpu")


def test_generate_greedy_prefix_matches_jax():
    """mode="cim" (the config's own), bf16: a float ulp can flip an
    activation code, so the bound is a greedy prefix of 4 of 8 tokens."""
    jcfg, jparams, tcfg, tparams = _jax_params("bfloat16")
    prompt = np.array([[5, 17, 33, 2, 90]], np.int32)
    want = np.asarray(jgenerate(jparams, jnp.asarray(prompt), jcfg, max_new=8,
                                s_max=32))[0]
    got = generate(tparams, prompt, tcfg, max_new=8, s_max=32, device="cpu")[0].numpy()
    assert np.array_equal(got[:4], want[:4]), (got, want)


_WANT = {}


def _want(params, prompt, cfg, max_new, s_max=32):
    """generate() of one prompt alone, memoized for the module per
    (params, cfg, prompt, max_new, s_max): tests that hold batchers of
    one config against the same prompts share the runs (the memo keeps
    its params alive, so an id is never reused)."""
    key = (id(params), cfg, tuple(prompt), max_new, s_max)
    if key not in _WANT:
        _WANT[key] = (params, generate(params, [prompt], cfg, max_new=max_new,
                                       s_max=s_max, device="cpu")[0].tolist())
    return _WANT[key][1]


def _requests():
    return [Request(i, [1 + (i * 7 + j) % 250 for j in range(1 + i % 5)],
                    max_new=3 + i % 4) for i in range(6)]


@pytest.mark.parametrize("exec_spec", [None, api.CiMExecSpec("blocked", "cuda")],
                         ids=["auto", "blocked-cuda"])
def test_fused_batcher_matches_generate(port_model, exec_spec):
    cfg, params = port_model
    batcher = ContinuousBatcher(params, cfg, n_slots=3, s_max=32,
                                exec_spec=exec_spec, device="cpu")
    reqs = _requests()
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    stats = batcher.stats()
    assert stats["host_syncs"] == stats["decode_steps"] + stats["prefill_batches"]
    for r in reqs:
        assert r.done and not r.truncated
        want = generate(params, [r.prompt], cfg, max_new=r.max_new, s_max=32,
                        exec_spec=exec_spec, device="cpu")[0].tolist()
        assert r.generated == want, r.rid


def test_truncated_at_exact_s_max(port_model):
    cfg, params = port_model
    s_max = 8
    batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=s_max, device="cpu")
    req = Request(0, [3, 4, 5], max_new=20)     # prefill pads to 4 slots
    batcher.submit(req)
    batcher.run()
    assert req.done and req.truncated
    # first token from prefill, then one per free cache slot 4..7
    assert len(req.generated) == 1 + (s_max - 4)
    # a prompt of s_max - 1 tokens (the pow2 bucket falls back to the exact
    # length) leaves exactly one decode slot
    edge = Request(1, list(range(1, s_max)), max_new=5)
    batcher.submit(edge)
    batcher.run()
    assert edge.truncated and len(edge.generated) == 2
    with pytest.raises(ValueError):
        batcher.submit(Request(2, list(range(1, s_max + 1)), max_new=2))


def test_cancel(port_model):
    cfg, params = port_model
    batcher = ContinuousBatcher(params, cfg, n_slots=1, s_max=32, device="cpu")
    a, b, c = (Request(i, [1 + i, 2], max_new=6) for i in range(3))
    for r in (a, b, c):
        batcher.submit(r)
    assert batcher.cancel(2) and c.cancelled and c.done and not c.generated
    batcher.step()
    batcher.step()
    assert batcher.cancel(0) and a.cancelled and a.truncated
    assert 1 <= len(a.generated) < 6
    assert not batcher.cancel(0) and not batcher.cancel(99)
    batcher.run()
    assert b.done and not b.cancelled and len(b.generated) == 6
    want = generate(params, [b.prompt], cfg, max_new=6, s_max=32, device="cpu")
    assert b.generated == want[0].tolist()


def test_prepare_for_spec_bytes_match_jax():
    jcfg, jparams, tcfg, tparams = _jax_params("float32")
    jfolded, jpacked = jprepare(jparams, JSpec("blocked", "pallas", "bitplane_u8"))
    tfolded, tpacked = prepare_for_spec(tparams, PACKED_SPEC)
    assert set(tpacked) == set(jpacked)
    for path, planes in tpacked.items():
        jp = jpacked[path]
        assert (planes.k, planes.n, planes.layout_version) == (jp.k, jp.n, jp.layout_version)
        assert planes.pos.shape[-2] % 32 == 0 and planes.pos.shape[-1] % 128 == 0
        np.testing.assert_array_equal(planes.pos.numpy(), np.asarray(jp.pos))
        np.testing.assert_array_equal(planes.neg.numpy(), np.asarray(jp.neg))
        np.testing.assert_allclose(planes.scale.numpy(), np.asarray(jp.scale), rtol=1e-6)
    jflat = dict((p, np.asarray(a)) for p, a in zip(
        [p for p, _ in tree_paths(tfolded)], jax.tree_util.tree_leaves(jfolded)))
    for path, leaf in tree_paths(tfolded):
        np.testing.assert_allclose(leaf.numpy(), jflat[path], rtol=1e-6)


def test_prepared_batcher_planes_equal_execute(port_model):
    cfg, params = port_model
    batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=32,
                                exec_spec=PACKED_SPEC, prepare_weights=True,
                                device="cpu")
    assert batcher.cfg.quant.exec_spec.packing == "none"
    assert batcher.cfg.quant.pre_quantized
    for r in _requests()[:3]:
        batcher.submit(r)
    batcher.run()
    rng = np.random.default_rng(0)
    folded = dict(tree_paths(batcher.params))
    for path, planes in batcher.packed.items():
        for layer in range(cfg.n_layers):
            one = planes.layer(layer)
            w = folded[path][layer]
            codes = w / torch.clamp(w.abs().amax(dim=0, keepdim=True), min=1e-12)
            for m in (4, 16):
                x = torch.from_numpy(rng.integers(-1, 2, (m, one.k)).astype(np.float32))
                got = api.execute_packed(PACKED_SPEC, x, one)
                want = api.execute(api.CiMExecSpec("blocked", "cuda"), x, codes.float())
                assert torch.equal(got, want), (path, layer, m)


@pytest.mark.parametrize("backend", ["cuda", "auto"])
def test_prepared_batcher_without_dense_kernel_raises(port_model, backend,
                                                       monkeypatch):
    # exact/cuda/none is registered (kernel #5), so the exact spec's dense
    # path is served through it (auto on CPU operands is the plain
    # formulation, by design)
    cfg, params = port_model
    spec = api.CiMExecSpec("exact", backend, "bitplane_u8")
    batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=32,
                                exec_spec=spec, prepare_weights=True,
                                device="cpu")
    assert batcher.cfg.quant.exec_spec.name == f"exact/{backend}/none"
    assert batcher.packed
    # with no dense kernel for the formulation on this device, neither
    # under the spec's backend nor under auto, the batcher refuses the
    # spec instead of serving something else
    for key in (("exact", "cuda", "none"), ("exact", "torch", "none")):
        monkeypatch.delitem(execution._REGISTRY, key)
    with pytest.raises(KeyError, match="exact/torch/none"):
        ContinuousBatcher(params, cfg, n_slots=2, s_max=32, exec_spec=spec,
                          prepare_weights=True, device="cpu")


def test_dense_pre_quantized_codes_exact():
    w = torch.randn((32, 8), generator=torch.Generator().manual_seed(0))
    t, s = tL.tern.ternarize(w, axis=(0,))
    qc = tL.QuantConfig(mode="cim", pre_quantized=True)
    codes, sw = tL._weight_codes((t * s).to(torch.bfloat16), qc)
    assert torch.equal(codes.float(), t)


# ---------------------------------------------------------------------------
# capacity, quantized KV caches and the looped baseline
# ---------------------------------------------------------------------------

# the reference's tests/test_kv_quant.py request mix
PROMPTS = [[3, 1, 4], [9, 8], [2, 7, 1, 8, 2], [6]]
MAX_NEWS = [4, 5, 3, 4]
# a slot freed at s_max while another keeps decoding: its dead lane
# writes at offset s_max on the next step (n_slots=2, s_max=8)
CAPACITY_MIX = [([1, 2, 3], 100), ([4], 2), ([5, 6], 6)]


def _mix_requests(mix):
    return [Request(i, list(p), max_new=m) for i, (p, m) in enumerate(mix)]


def _serve_mix(batcher, mix):
    reqs = _mix_requests(mix)
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    assert all(r.done for r in reqs)
    return reqs


def _with_quant(cfg, **kw):
    return cfg.replace(quant=dataclasses.replace(cfg.quant, **kw))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "looped"])
def test_capacity_mix_matches_generate_and_jax(port_model, fused):
    """A slot freed at s_max rides on as a dead lane whose cache write is
    clamped to the last slot of its row (the reference's
    dynamic_update_slice): the mix finishes with each request's tokens
    == generate(), and token counts and truncation flags == the JAX
    batcher's."""
    cfg, params = port_model
    batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=8, fused=fused,
                                device="cpu")
    reqs = _serve_mix(batcher, CAPACITY_MIX)
    for r in reqs:
        assert r.generated == _want(params, r.prompt, cfg, len(r.generated), s_max=8), \
            r.rid
    jcfg = jget_config("smollm-135m", smoke=True)
    jb = JBatcher(jT.init_params(jax.random.PRNGKey(0), jcfg), jcfg, n_slots=2,
                  s_max=8, fused=fused)
    jreqs = [JRequest(i, list(p), max_new=m) for i, (p, m) in enumerate(CAPACITY_MIX)]
    for r in jreqs:
        jb.submit(r)
    jb.run()
    assert [len(r.generated) for r in reqs] == [len(r.generated) for r in jreqs]
    assert [r.truncated for r in reqs] == [r.truncated for r in jreqs]
    assert batcher.stats() == jb.stats()
    if fused:
        assert [len(r.generated) for r in reqs] == [5, 2, 5]
        assert [r.truncated for r in reqs] == [True, False, True]


def test_engine_cache_dtype_overrides_config(port_model):
    cfg, params = port_model
    batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=16,
                                cache_dtype="int8", device="cpu")
    assert batcher.cfg.quant.cache_dtype == "int8"
    assert batcher.caches.k.dtype == torch.int8
    assert ContinuousBatcher(params, cfg, n_slots=2, s_max=16,
                             device="cpu").caches.k.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="cache_dtype"):
        ContinuousBatcher(params, cfg, n_slots=2, s_max=16, cache_dtype="int4",
                          device="cpu")


@pytest.mark.parametrize("mode", ["off", "cim"])
@pytest.mark.parametrize("cache_dtype", ["int8", "ternary"])
def test_quant_cache_batcher_matches_generate(port_model, cache_dtype, mode):
    """Per-(row, position) scales make the cache's quantization a
    function of each row's own vectors: fused serving is token-identical
    to generate() under the same cache_dtype (mode "off" as in the
    reference's test, and the config's cim under per_row)."""
    cfg, params = port_model
    cfg = _with_quant(cfg, mode=mode, cache_dtype=cache_dtype)
    batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=32, device="cpu")
    reqs = _serve_mix(batcher, zip(PROMPTS, MAX_NEWS))
    for r in reqs:
        assert r.generated == _want(params, r.prompt, cfg, r.max_new), r.rid


@pytest.mark.parametrize("cache_dtype", ["int8", "ternary"])
def test_quant_cache_batcher_greedy_prefix_matches_jax(cache_dtype):
    """The port's batcher against the JAX batcher on bridged bf16 params
    (mode "off"): a float ulp between the frameworks can flip a late
    greedy token, so each request must agree on a prefix of >= 2."""
    jcfg, jparams, tcfg, tparams = _jax_params("bfloat16")
    jcfg = _with_quant(jcfg, mode="off", cache_dtype=cache_dtype)
    tcfg = _with_quant(tcfg, mode="off", cache_dtype=cache_dtype)
    jb = JBatcher(jparams, jcfg, n_slots=2, s_max=32)
    jreqs = [JRequest(i, p, max_new=m) for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEWS))]
    for r in jreqs:
        jb.submit(r)
    jb.run()
    reqs = _serve_mix(ContinuousBatcher(tparams, tcfg, n_slots=2, s_max=32,
                                        device="cpu"), zip(PROMPTS, MAX_NEWS))
    for got, want in zip(reqs, jreqs):
        prefix = next((i for i, (a, b) in enumerate(zip(got.generated, want.generated))
                       if a != b), len(want.generated))
        assert prefix >= 2, (got.generated, want.generated)


@pytest.mark.parametrize("cache_dtype", ["int8", "ternary"])
def test_refilled_slot_rebuilt_in_cache_layout(port_model, cache_dtype):
    """A freed slot is refilled from fresh caches in the cache_dtype
    layout: past what its prefill and first decode step wrote, its row
    holds zero codes (ternary: 0x11) and scales 1.0, though the request
    before it wrote there."""
    cfg, params = port_model
    batcher = ContinuousBatcher(params, cfg, n_slots=1, s_max=32,
                                cache_dtype=cache_dtype, device="cpu")
    first, second = Request(0, [1, 2, 3, 4, 5], max_new=12), Request(1, [7], max_new=4)
    batcher.submit(first)
    batcher.submit(second)
    while not first.done:
        batcher.step()
    assert int(batcher.slot_pos[0]) == 8 + 11
    batcher.step()                       # refill with the second request
    assert batcher.slot_req[0] is second
    pos = int(batcher.slot_pos[0])       # 4-token pad bucket + one decode
    assert pos == 5
    zero = 0x11 if cache_dtype == "ternary" else 0
    for leaf in batcher.caches.k, batcher.caches.v:
        assert (leaf[:, 0, pos:] == zero).all()
        assert not (leaf[:, 0, :pos] == zero).all()
    for leaf in batcher.caches.k_scale, batcher.caches.v_scale:
        assert (leaf[:, 0, pos:] == 1.0).all()
    batcher.run()
    want = generate(params, [second.prompt], batcher.cfg, max_new=4, s_max=32,
                    device="cpu")[0].tolist()
    assert second.generated == want


@pytest.fixture(scope="module")
def jax_looped_stats():
    """The JAX looped batcher's stats on PROMPTS/MAX_NEWS: its config has
    no cache dtype of the port's, so one run serves both cases below."""
    jcfg = jget_config("smollm-135m", smoke=True)
    jb = JBatcher(jT.init_params(jax.random.PRNGKey(0), jcfg), jcfg, n_slots=2,
                  s_max=32, fused=False)
    for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEWS)):
        jb.submit(JRequest(i, p, max_new=m))
    jb.run()
    return jb.stats()


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_looped_baseline_matches_generate_and_jax_counts(port_model, cache_dtype,
                                                         jax_looped_stats):
    """fused=False: per-slot prefill at index 0 and a per-slot loop of
    single-row steps; tokens == generate(), and host_syncs (one per
    prefill and per active slot a step) and prefill_batches (one per
    slot fill) == the JAX looped batcher's on the same requests."""
    cfg, params = port_model
    batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=32, fused=False,
                                cache_dtype=cache_dtype, device="cpu")
    reqs = _serve_mix(batcher, zip(PROMPTS, MAX_NEWS))
    for r in reqs:
        assert r.generated == _want(params, r.prompt, batcher.cfg, r.max_new), r.rid
    st = batcher.stats()
    assert st["host_syncs"] == sum(len(r.generated) for r in reqs)
    assert st["prefill_batches"] == len(reqs) and batcher.capture_seconds is None
    assert st == jax_looped_stats


def test_looped_baseline_is_greedy_only(port_model):
    cfg, params = port_model
    with pytest.raises(ValueError, match="greedy-only"):
        ContinuousBatcher(params, cfg, n_slots=2, s_max=32, fused=False,
                          temperature=0.5, device="cpu")


def test_serve_cli_loop_decode_on_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--smoke", "--device", "cpu", "--requests", "3", "--slots", "2",
                       "--s-max", "16", "--max-new", "3", "--loop-decode"]) == 0
    out = capsys.readouterr().out
    assert "per-slot loop baseline" in out and "3 prefill batches" in out
