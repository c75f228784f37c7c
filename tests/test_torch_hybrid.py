"""The ssm (mamba2-780m) and hybrid (zamba2-2.7b) families end to end:
forward and cached decode logits against the JAX package on bridged
params (f32, atol 1e-5 as in ``test_torch_models.py``), decode against
forward within the reference's own bf16 bounds, the port's fused and
looped batchers token-identical to its ``generate()`` (including
``test_kv_quant.py``'s 4-request mix at bf16, on which the reference's
hybrid batcher differs from its ``generate()``), the capacity mix and
the quantized shared-attention caches on zamba2, weight preparation, and
``generate()`` against the JAX package's to a greedy prefix.

Across packages the bar is a greedy prefix: at bf16 under mode="cim"
XLA computes the reference's scanned layer stack with excess precision
(``xla_allow_excess_precision``, on by default), so one flipped
activation code can change zamba2's first token; with that flag off the
port's bf16 CiM forward equals the reference's bit for bit. The prefix
is held at bf16 with mode "off" and at f32 with mode "cim"."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jT
from repro.models.registry import get_config as jget_config
from repro.serve.engine import ContinuousBatcher as JBatcher
from repro.serve.engine import Request as JRequest
from repro.serve.engine import generate as jgenerate
from repro_torch import api
from repro_torch.bridge import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tS
from repro_torch.models import transformer as tT
from repro_torch.models.registry import get_config
from repro_torch.quant.prepare import prepare_for_spec, tree_paths
from repro_torch.serve.engine import ContinuousBatcher, Request, generate
from torch_threads import one_thread  # noqa: F401

ATOL = 1e-5
ARCH = {"ssm": "mamba2-780m", "hybrid": "zamba2-2.7b"}
# tests/test_kv_quant.py's mix (2 slots, s_max 32)
PROMPTS = [[3, 1, 4], [9, 8], [2, 7, 1, 8, 2], [6]]
MAX_NEWS = [4, 5, 3, 4]
# a slot freed at s_max while another keeps decoding (2 slots, s_max 8);
# the reference's counts and flags for it: 5/2/5 tokens, 0 and 2 truncated
CAPACITY_MIX = [([1, 2, 3], 100), ([4], 2), ([5, 6], 6)]


def _with(cfg, **quant):
    return cfg.replace(quant=dataclasses.replace(cfg.quant, **quant))


def _jax_pair(arch, dtype="float32", mode="off"):
    jcfg = _with(jget_config(arch, smoke=True).replace(dtype=dtype), mode=mode)
    tcfg = _with(get_config(arch, smoke=True).replace(dtype=dtype), mode=mode)
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def models():
    """The port's own seeded smoke models of both families (bf16)."""
    out = {}
    for family, arch in ARCH.items():
        cfg = get_config(arch, smoke=True)
        out[family] = (cfg, tT.init_params(cfg, seed=0, device="cpu"))
    return out


@pytest.mark.parametrize("family", sorted(ARCH))
def test_forward_and_decode_logits_match_jax(family):
    """A left-padded prefill (start), then two ragged decode steps: logits
    and every cache leaf (hybrid: SSM conv/state and the shared block's
    k/v) against the JAX decode_step."""
    jcfg, tcfg, jparams, tparams = _jax_pair(ARCH[family])
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, jcfg.vocab, (2, 11)).astype(np.int32)
    np.testing.assert_allclose(
        tT.forward(tparams, torch.from_numpy(prompt).long(), tcfg).numpy(),
        np.asarray(jT.forward(jparams, {"tokens": jnp.asarray(prompt)}, jcfg)),
        atol=ATOL)
    prompt = prompt[:, :5]
    start = np.array([0, 2], np.int32)
    jc = jT.init_caches(jcfg, 2, 16, dtype=jnp.float32)
    tc = tT.init_caches(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    jl, jc = jT.decode_step(jparams, jnp.asarray(prompt), jc, jnp.int32(0), jcfg,
                            start=jnp.asarray(start))
    tl, tc = tT.decode_step(tparams, torch.from_numpy(prompt).long(), tc, 0, tcfg,
                            start=torch.from_numpy(start).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    index = np.array([5, 5], np.int32)
    for step in range(2):
        tok = rng.integers(1, jcfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jT.decode_step(jparams, jnp.asarray(tok), jc, jnp.asarray(index),
                                jcfg, start=jnp.asarray(start))
        tl, tc = tT.decode_step(tparams, torch.from_numpy(tok).long(), tc,
                                torch.from_numpy(index).long(), tcfg,
                                start=torch.from_numpy(start).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        index = index + np.array([1, 1 + step], np.int32)
    want = jax.tree_util.tree_leaves(jc)
    got = list(tT.cache_leaves(tc))
    assert len(got) == len(want) == (2 if family == "ssm" else 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("family", sorted(ARCH))
def test_decode_matches_forward(models, family):
    """bf16, mode off: eight S = 1 steps against the chunked forward,
    within the reference's own bounds (tests/test_models.py: 8e-2 ssm,
    1e-1 hybrid)."""
    cfg, _ = models[family]
    cfg = _with(cfg, mode="off")
    params = tT.init_params(cfg, seed=0, device="cpu")
    tol = {"ssm": 8e-2, "hybrid": 1e-1}[family]
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
    ref = tT.forward(params, toks, cfg)
    caches = tT.init_caches(cfg, 2, 32, device="cpu")
    dec = torch.cat([tT.decode_step(params, toks[:, t:t + 1], caches, t, cfg)[0]
                     for t in range(8)], dim=1)
    np.testing.assert_allclose(dec.float().numpy(), ref.float().numpy(), rtol=tol, atol=tol)


def _serve(params, cfg, prompts=PROMPTS, max_news=MAX_NEWS, n_slots=2, s_max=32,
           **kw):
    batcher = ContinuousBatcher(params, cfg, n_slots=n_slots, s_max=s_max,
                                device="cpu", **kw)
    reqs = [Request(i, list(p), max_new=m) for i, (p, m) in enumerate(zip(prompts, max_news))]
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    assert all(r.done for r in reqs)
    return batcher, reqs


_SOLOS = {}


def _solos(params, cfg, reqs, s_max=32):
    """generate() of each request alone, memoized per (params, cfg, prompt,
    length, s_max) for the module: a test's fused and looped cases are
    held against the same runs (the memo keeps its params alive, so an
    id is never reused)."""
    out = []
    for r in reqs:
        key = (id(params), cfg, tuple(r.prompt), len(r.generated), s_max)
        if key not in _SOLOS:
            _SOLOS[key] = (params, generate(params, [r.prompt], cfg,
                                            max_new=len(r.generated), s_max=s_max,
                                            device="cpu")[0].tolist())
        out.append(_SOLOS[key][1])
    return out


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "looped"])
@pytest.mark.parametrize("mode", ["off", "cim"])
@pytest.mark.parametrize("family", sorted(ARCH))
def test_batchers_match_generate(models, family, mode, fused):
    """bf16, test_kv_quant.py's mix (request 3 refills a slot): served
    tokens == the port's generate() for every request, under mode off and
    under the config's CiM mode with per-row activation scales; one host
    sync per step fused, one per token looped."""
    cfg, params = models[family]
    cfg = _with(cfg, mode=mode, act_scale="per_row")
    batcher, reqs = _serve(params, cfg, fused=fused)
    assert [r.generated for r in reqs] == _solos(params, cfg, reqs)
    st = batcher.stats()
    if fused:
        assert st["host_syncs"] == st["decode_steps"] + st["prefill_batches"]
    else:
        assert st["host_syncs"] == sum(len(r.generated) for r in reqs)


def test_looped_refill_starts_from_fresh_state():
    """The looped baseline prefills a refilled slot from a fresh cache
    row: on mamba2 (f32, mode off) its tokens == generate() for every
    request. The reference's looped baseline continues the refilled row's
    SSM state from the request before, and request 3 (a refill) differs
    from its generate() there."""
    jcfg, tcfg, jparams, tparams = _jax_pair("mamba2-780m")
    _, reqs = _serve(tparams, tcfg, fused=False)
    assert [r.generated for r in reqs] == _solos(tparams, tcfg, reqs)
    jb = JBatcher(jparams, jcfg, n_slots=2, s_max=32, fused=False)
    jreqs = [JRequest(i, list(p), max_new=m) for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEWS))]
    for r in jreqs:
        jb.submit(r)
    jb.run()
    jsolo = [np.asarray(jgenerate(jparams, jnp.asarray([r.prompt], jnp.int32), jcfg,
                                  max_new=r.max_new, s_max=32))[0].tolist() for r in jreqs]
    assert [r.generated for r in jreqs][:3] == jsolo[:3]
    assert jreqs[3].generated != jsolo[3]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "looped"])
def test_capacity_mix_on_zamba2(models, fused):
    """A slot freed at s_max rides on as a dead lane (its KV write clamped
    to its row's last slot, its SSM state evolving until a refill
    overwrites the row): the reference's counts and flags, and each
    request's tokens == generate()."""
    cfg, params = models["hybrid"]
    cfg = _with(cfg, act_scale="per_row")
    prompts, max_news = zip(*CAPACITY_MIX)
    _, reqs = _serve(params, cfg, prompts, max_news, s_max=8, fused=fused)
    assert [r.generated for r in reqs] == _solos(params, cfg, reqs, s_max=8)
    if fused:
        assert [len(r.generated) for r in reqs] == [5, 2, 5]
        assert [r.truncated for r in reqs] == [True, False, True]


@pytest.mark.parametrize("cache_dtype", ["int8", "ternary"])
def test_quant_cache_on_zamba2(models, cache_dtype):
    """zamba2's shared-attention KV stack quantized, the SSM leaves still
    f32: int8 fused and looped tokens == generate() under the same
    cache_dtype; ternary to the reference's greedy-prefix bound (>= 2)."""
    cfg, params = models["hybrid"]
    cfg = _with(cfg, act_scale="per_row", cache_dtype=cache_dtype)
    caches = tT.init_caches(cfg, 2, 32, device="cpu")
    ssm_caches, kv = caches
    assert type(ssm_caches) is tS.SSMCache and type(kv) is tattn.QuantKVCache
    assert [a.dtype for a in ssm_caches] == [torch.float32] * 2
    assert kv.k.dtype == (torch.int8 if cache_dtype == "int8" else torch.uint8)
    assert kv.k.shape[0] == cfg.n_layers // cfg.hybrid_attn_every
    for fused in (True, False):
        _, reqs = _serve(params, cfg, fused=fused)
        solos = _solos(params, cfg, reqs)
        if cache_dtype == "int8":
            assert [r.generated for r in reqs] == solos, fused
        for r, want in zip(reqs, solos):
            assert r.generated[:2] == want[:2], (fused, r.rid)


@pytest.mark.parametrize("dtype,mode", [("bfloat16", "off"), ("float32", "cim")])
@pytest.mark.parametrize("family", sorted(ARCH))
def test_generate_greedy_prefix_matches_jax(family, dtype, mode):
    jcfg, tcfg, jparams, tparams = _jax_pair(ARCH[family], dtype, mode)
    prompt = np.array([[100, 3, 44]], np.int32)
    want = np.asarray(jgenerate(jparams, jnp.asarray(prompt), jcfg, max_new=8,
                                s_max=32))[0]
    got = generate(tparams, prompt, tcfg, max_new=8, s_max=32, device="cpu")[0].numpy()
    assert np.array_equal(got[:4], want[:4]), (got, want)


def test_batcher_keeps_cache_storage(models):
    """Every leaf of hybrid's cache pair keeps its storage across
    prefills (the in-place index_copy_ merge) and decode steps (the
    in-place SSM and KV writes): what a captured step binds."""
    cfg, params = models["hybrid"]
    batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=32, device="cpu")
    ptrs = [a.data_ptr() for a in tT.cache_leaves(batcher.caches)]
    assert len(ptrs) == 4
    for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEWS)):
        batcher.submit(Request(i, p, max_new=m))
    while batcher.queue or any(r is not None for r in batcher.slot_req):
        batcher.step()
        assert [a.data_ptr() for a in tT.cache_leaves(batcher.caches)] == ptrs
    assert batcher.prefill_batches >= 2


def test_cancel_on_mamba2(models):
    cfg, params = models["ssm"]
    cfg = _with(cfg, act_scale="per_row")
    batcher = ContinuousBatcher(params, cfg, n_slots=1, s_max=32, device="cpu")
    a, b = (Request(i, [1 + i, 2], max_new=6) for i in range(2))
    batcher.submit(a)
    batcher.submit(b)
    batcher.step()
    batcher.step()
    assert batcher.cancel(0) and a.cancelled and a.truncated
    batcher.run()
    assert b.generated == _solos(params, cfg, [b])[0]


def test_prepare_for_spec_folds_only_projections(models):
    """prepare_for_spec folds every mamba projection and the shared
    block's attention and MLP weights, leaves A_log, D, dt_bias, conv_w,
    conv_b, norm, the norms and the embeddings alone, and a prepared
    batcher serves."""
    cfg, params = models["hybrid"]
    spec = api.CiMExecSpec("blocked", "cuda")
    folded = dict(tree_paths(prepare_for_spec(params, spec)))
    changed = {p for p, leaf in tree_paths(params)
               if folded[p].dtype != leaf.dtype or not torch.equal(folded[p], leaf)}
    assert changed == {"blocks/mamba/w_in", "blocks/mamba/w_out"} | {
        f"shared_attn/attn/{w}" for w in ("wq", "wk", "wv", "wo")} | {
        f"shared_attn/mlp/{w}" for w in ("w_gate", "w_up", "w_down")}
    assert folded["blocks/mamba/A_log"].dtype == torch.float32
    cfg = _with(cfg, act_scale="per_row")
    batcher, reqs = _serve(params, cfg, exec_spec=spec, prepare_weights=True)
    assert batcher.cfg.quant.pre_quantized
    pcfg = _with(batcher.cfg, pre_quantized=True)
    assert [r.generated for r in reqs] == _solos(batcher.params, pcfg, reqs)
