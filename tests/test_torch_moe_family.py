"""The moe family end to end (deepseek-v2-236b with MLA, grok-1-314b
with GQA, at smoke size): whole-model logits and caches against the JAX
package on bridged params, decode after prefill against ``forward``,
``generate()`` against the JAX package's, the port's batchers against
its own ``generate()``, weight preparation, the CLI, and drops in a
batched prefill.

Tolerances: f32 logits atol 1e-5 (as ``test_torch_models.py``); decode
after prefill against ``forward`` at the reference's own bound for a
cached prefill against stepwise decode (``tests/test_serve.py``, rtol =
atol = 1e-5). Across packages the served tokens are held to a greedy
prefix at bf16 with mode "off" (ROADMAP Queue C: XLA's excess precision
in the reference's scanned stack); at f32 under mode "cim" the packages
are held at the logits, since ``generate()`` keeps a bf16 KV cache in
both, and grok-1 smoke's third token is a near tie there. Inside the
port the tokens are held equal. The batcher tests use the capacity
factor 8.0 of the reference's own batcher tests: a batched prefill
routes its left pad like real tokens, which under 1.25 can drop a real
token's assignment that a solo ``generate()`` keeps."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jT
from repro.models.registry import get_config as jget_config
from repro.quant.prepare import ternarize_params as jternarize_params
from repro.serve.engine import generate as jgenerate
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tT
from repro_torch.models.registry import get_config
from repro_torch.quant.prepare import ternarize_params, tree_paths
from repro_torch.serve.engine import ContinuousBatcher, Request, generate
from torch_threads import one_thread  # noqa: F401

ARCHS = ("deepseek-v2-236b", "grok-1-314b")
# tests/test_serve.py's MLA mix (2 slots, s_max 32) and tests/test_kv_quant.py's
MIXES = {"test_serve": ([[3, 1, 4], [9, 8]], [4, 5]),
         "test_kv_quant": ([[3, 1, 4], [9, 8], [2, 7, 1, 8, 2], [6]], [4, 5, 3, 4])}
# the capacity factor the reference's batcher tests use: no drops at smoke size
NO_DROP_CF = 8.0


def _with(cfg, **quant):
    return cfg.replace(quant=dataclasses.replace(cfg.quant, **quant))


def _model_pair(arch, dtype="float32", mode="off", **fields):
    jcfg = _with(jget_config(arch, smoke=True).replace(dtype=dtype, **fields), mode=mode)
    tcfg = _with(get_config(arch, smoke=True).replace(dtype=dtype, **fields), mode=mode)
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, device="cpu")


# full-size published widths: (d_model, n_heads, n_kv_heads, head_dim or the
# MLA dims (kv_lora, rope, nope, v), n_experts, n_shared, top_k, expert_d_ff,
# vocab, n_layers)
WIDTHS = {"deepseek-v2-236b": (5120, 128, 128, (512, 64, 128, 128), 160, 2, 6, 1536,
                               102400, 60),
          "grok-1-314b": (6144, 48, 8, 128, 8, 0, 2, 32768, 131072, 64)}


def _same_fields(port, ref):
    for f in dataclasses.fields(port):
        mine, theirs = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "quant":
            _same_fields(mine, theirs)
        else:
            assert mine == theirs, (f.name, mine, theirs)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch, smoke):
    """Field for field, with the reference's param_count and
    active_param_count; the full configs at their published widths."""
    port, ref = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    _same_fields(port, ref)
    assert port.family == "moe" and port.quant.mode == "cim"
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    if not smoke:
        head = ((port.kv_lora_rank, port.qk_rope_head_dim, port.qk_nope_head_dim,
                 port.v_head_dim) if port.mla else port.resolved_head_dim)
        assert (port.d_model, port.n_heads, port.n_kv_heads, head, port.n_experts,
                port.n_shared_experts, port.top_k, port.expert_d_ff, port.vocab,
                port.n_layers) == WIDTHS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_logits_match_jax(arch):
    """f32, mode cim: the whole smoke model's forward logits, then a
    left-padded prefill and two ragged decode steps through decode_step
    (logits and every cache leaf) against the JAX package's."""
    jcfg, tcfg, jparams, tparams = _model_pair(arch, mode="cim")
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, jcfg.vocab, (2, 11)).astype(np.int32)
    np.testing.assert_allclose(
        tT.forward(tparams, torch.from_numpy(prompt).long(), tcfg).numpy(),
        np.asarray(jT.forward(jparams, {"tokens": jnp.asarray(prompt)}, jcfg)),
        atol=1e-5)
    prompt = prompt[:, :5]
    start = np.array([0, 2], np.int32)
    jc = jT.init_caches(jcfg, 2, 16, dtype=jnp.float32)
    tc = tT.init_caches(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    jl, jc = jT.decode_step(jparams, jnp.asarray(prompt), jc, jnp.int32(0), jcfg,
                            start=jnp.asarray(start))
    tl, tc = tT.decode_step(tparams, torch.from_numpy(prompt).long(), tc, 0, tcfg,
                            start=torch.from_numpy(start).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    index = np.array([5, 5], np.int32)
    for step in range(2):
        tok = rng.integers(1, jcfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jT.decode_step(jparams, jnp.asarray(tok), jc, jnp.asarray(index),
                                jcfg, start=jnp.asarray(start))
        tl, tc = tT.decode_step(tparams, torch.from_numpy(tok).long(), tc,
                                torch.from_numpy(index).long(), tcfg,
                                start=torch.from_numpy(start).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
        index = index + np.array([1, 1 + step], np.int32)
    want = jax.tree_util.tree_leaves(jc)
    got = list(tT.cache_leaves(tc))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_matches_forward(arch):
    """f32, mode off: a 4-token cached prefill, then 4 single-token
    steps, against forward over all 8 tokens, under the capacity factor
    8.0 (under 1.25 forward's 16 tokens overflow an expert's 8 rows, and
    the dropped assignments change its logits: the drop semantics)."""
    _, tcfg, _, tparams = _model_pair(arch, moe_capacity_factor=NO_DROP_CF)
    toks = torch.randint(0, tcfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
    ref = tT.forward(tparams, toks, tcfg)
    caches = tT.init_caches(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    pre, _ = tT.decode_step(tparams, toks[:, :4], caches, 0, tcfg)
    steps = [tT.decode_step(tparams, toks[:, t:t + 1], caches, t, tcfg)[0]
             for t in range(4, 8)]
    dec = torch.cat([pre] + steps, dim=1)
    np.testing.assert_allclose(dec.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_prefix_matches_jax(arch):
    jcfg, tcfg, jparams, tparams = _model_pair(arch, "bfloat16", "off")
    prompt = np.array([[100, 3, 44]], np.int32)
    want = np.asarray(jgenerate(jparams, jnp.asarray(prompt), jcfg, max_new=8,
                                s_max=32))[0]
    got = generate(tparams, prompt, tcfg, max_new=8, s_max=32, device="cpu")[0].numpy()
    assert np.array_equal(got[:4], want[:4]), (got, want)


@pytest.fixture(scope="module")
def models():
    """The port's own seeded bf16 smoke models, under the reference
    batcher tests' capacity factor."""
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True).replace(moe_capacity_factor=NO_DROP_CF)
        out[arch] = (cfg, tT.init_params(cfg, seed=0, device="cpu"))
    return out


def _serve(params, cfg, mix, **kw):
    prompts, max_news = MIXES[mix]
    batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=32, device="cpu", **kw)
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
@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batchers_match_generate(models, arch, mix, mode, fused):
    """bf16, capacity factor 8.0: served tokens == the port's generate()
    for every request, under mode off and under the config's CiM mode
    with per-row activation scales; one host sync per step fused, one
    per token looped."""
    cfg, params = models[arch]
    cfg = _with(cfg, mode=mode, act_scale="per_row")
    batcher, reqs = _serve(params, cfg, mix, fused=fused)
    assert [r.generated for r in reqs] == _solos(params, cfg, reqs)
    st = batcher.stats()
    if fused:
        assert st["host_syncs"] == st["decode_steps"] + st["prefill_batches"]
    else:
        assert st["host_syncs"] == sum(len(r.generated) for r in reqs)


@pytest.mark.parametrize("cache_dtype", ["int8", "ternary"])
def test_quant_mla_cache_batchers_match_generate(models, cache_dtype):
    """deepseek-v2's latent cache quantized: fused and looped tokens ==
    generate() under the same cache_dtype, CiM mode, per-row scales."""
    cfg, params = models["deepseek-v2-236b"]
    cfg = _with(cfg, act_scale="per_row", cache_dtype=cache_dtype)
    caches = tT.init_caches(cfg, 2, 32, device="cpu")
    assert type(caches) is tattn.QuantMLACache
    assert caches.ckv.dtype == (torch.int8 if cache_dtype == "int8" else torch.uint8)
    for fused in (True, False):
        _, reqs = _serve(params, cfg, "test_kv_quant", fused=fused)
        assert [r.generated for r in reqs] == _solos(params, cfg, reqs), fused


def test_batcher_keeps_cache_storage(models):
    """Every MLA cache leaf keeps its storage across prefills and decode
    steps: what a captured step binds."""
    cfg, params = models["deepseek-v2-236b"]
    batcher = ContinuousBatcher(params, _with(cfg, cache_dtype="int8"), n_slots=2,
                                s_max=32, device="cpu")
    ptrs = [a.data_ptr() for a in tT.cache_leaves(batcher.caches)]
    assert len(ptrs) == 4
    for i, (p, m) in enumerate(zip(*MIXES["test_kv_quant"])):
        batcher.submit(Request(i, p, max_new=m))
    while batcher.queue or any(r is not None for r in batcher.slot_req):
        batcher.step()
        assert [a.data_ptr() for a in tT.cache_leaves(batcher.caches)] == ptrs
    assert batcher.prefill_batches >= 2


@pytest.mark.parametrize("arch", ARCHS)
def test_prepare_folds_the_reference_leaves(arch):
    """ternarize_params folds the leaves the reference's _QUANT_RE /
    _NO_QUANT_RE select: the attention projections (MLA's w_uk and w_uv
    too), the 4-D (L, E, K, N) expert stacks per (layer, expert,
    out-channel) and the shared experts, and never the router, the
    norms or the embeddings; the folded values agree (f32)."""
    jcfg, tcfg, jparams, tparams = _model_pair(arch)
    jfolded = dict(jax.tree_util.tree_flatten_with_path(jternarize_params(jparams))[0])
    jfolded = {"/".join(k.key for k in path): v for path, v in jfolded.items()}
    jorig = {"/".join(k.key for k in path): v for path, v in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}
    want = {p for p in jorig if not np.array_equal(np.asarray(jorig[p]),
                                                   np.asarray(jfolded[p]))}
    folded = dict(tree_paths(ternarize_params(tparams)))
    got = {p for p, leaf in tree_paths(tparams) if not torch.equal(folded[p], leaf)}
    assert got == want
    expect = {f"blocks/moe/{w}" for w in ("w_gate", "w_up", "w_down")}
    expect |= ({f"blocks/attn/{w}" for w in ("wq", "w_dkv", "w_uk", "w_uv", "wo")}
               | {f"blocks/moe/shared/{w}" for w in ("w_gate", "w_up", "w_down")}
               if arch == "deepseek-v2-236b" else
               {f"blocks/attn/{w}" for w in ("wq", "wk", "wv", "wo")})
    assert got == expect
    assert folded["blocks/moe/router"].dtype == torch.float32
    for p in got:
        np.testing.assert_allclose(folded[p].numpy(), np.asarray(jfolded[p]),
                                   rtol=1e-6, atol=1e-7)
    # per (layer, expert, out-channel): one magnitude a column
    w = folded["blocks/moe/w_gate"].abs()
    nz = torch.where(w > 0, w, torch.nan)
    assert torch.equal(nz.nan_to_num(0).amax(dim=2),
                       nz.nan_to_num(float("inf")).amin(dim=2))


@pytest.mark.parametrize("arch", ARCHS)
def test_prepared_weights_change_only_mla(arch):
    """Folding is idempotent wherever the model ternarizes per step (the
    dense layers, and the expert stacks that _tern3 ternarizes again), so
    prepared grok-1 serves the unprepared model (f32 logits within 1e-5).
    MLA's w_uk and w_uv are folded too, as the reference's _QUANT_RE
    folds them, but mla_attention uses them as float weights: prepared
    deepseek-v2 is another model, in the port as in the reference."""
    _, tcfg, _, tparams = _model_pair(arch, mode="cim", moe_capacity_factor=NO_DROP_CF)
    toks = torch.tensor([[5, 17, 33, 2, 9]])
    pcfg = _with(tcfg, pre_quantized=True)
    same = tT.forward(tparams, toks, tcfg)
    prepared = tT.forward(ternarize_params(tparams), toks, pcfg)
    if arch == "grok-1-314b":
        np.testing.assert_allclose(prepared.numpy(), same.numpy(), atol=1e-5)
    else:
        assert (prepared - same).abs().max() > 0.1
        folded = dict(tree_paths(ternarize_params(tparams)))
        keep_uk = {**folded, "blocks/attn/w_uk": tparams["blocks"]["attn"]["w_uk"],
                   "blocks/attn/w_uv": tparams["blocks"]["attn"]["w_uv"]}
        params = {}
        for path, leaf in keep_uk.items():
            node = params
            *parents, name = path.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[name] = leaf
        np.testing.assert_allclose(tT.forward(params, toks, pcfg).numpy(),
                                   same.numpy(), atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    assert serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--requests", "3", "--slots", "2", "--s-max", "16",
                           "--max-new", "3"]) == 0
    assert "tok/s on cpu" in capsys.readouterr().out


def test_drops_show_in_a_batched_prefill(models):
    """Under the config's own capacity factor (1.25), a batched prefill
    routes left-pad columns like real tokens: they take capacity, and
    assignments drop that a solo prefill keeps (the reference's tests
    raise the factor for this). route() counts them."""
    cfg, params = models["grok-1-314b"]
    cfg = cfg.replace(moe_capacity_factor=1.25)
    p0 = tT.layer_params(params["blocks"], 0)["moe"]
    x = torch.randn((4, 16, cfg.d_model), generator=torch.Generator().manual_seed(0))
    x[:, :10] = x[0, 0]           # 40 identical pad columns
    _, _, keep = tmoe.route(p0, x.to(torch.bfloat16).reshape(-1, cfg.d_model), cfg)
    assert int((~keep).sum()) > 0
    _, _, solo = tmoe.route(p0, x[3:, 10:].to(torch.bfloat16).reshape(-1, cfg.d_model),
                            cfg)
    assert bool(solo.all())
