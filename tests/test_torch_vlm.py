"""The vlm family (llava-next-34b at smoke size): the projector in
``embed_inputs``, ``forward`` with patches, decoding over the Yi-34B
backbone, serving, weight preparation and the CLI, against the JAX
package on the same inputs (made with numpy) and bridged params.

Tolerances: f32 outputs atol 1e-5 (as ``test_torch_models.py``: the
sums run in another order in the two frameworks); decode against
``forward`` at the reference's own bound (``tests/test_models.py``:
rtol = atol = 4e-2 at bf16, where its decode==forward test compares
vlm against ``family="dense"``: image tokens enter only ``forward``).
Across packages the served tokens are held to a greedy prefix at bf16
with mode "off" (ROADMAP Queue C). Inside the port the tokens are held
equal."""
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
from repro_torch.models import transformer as tT
from repro_torch.models.registry import get_config
from repro_torch.quant.prepare import ternarize_params, tree_paths
from repro_torch.serve.engine import ContinuousBatcher, Request, generate
from torch_threads import one_thread  # noqa: F401

ARCH = "llava-next-34b"
ATOL = 1e-5
MIX = ([[3, 1, 4], [9, 8], [2, 7, 1, 8, 2], [6]], [4, 5, 3, 4])


def _with(cfg, **quant):
    return cfg.replace(quant=dataclasses.replace(cfg.quant, **quant))


def _model_pair(dtype="float32", mode="off"):
    jcfg = _with(jget_config(ARCH, smoke=True).replace(dtype=dtype), mode=mode)
    tcfg = _with(get_config(ARCH, smoke=True).replace(dtype=dtype), mode=mode)
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, device="cpu")


def _inputs(cfg, b=2, s=7, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    patches = rng.standard_normal((b, cfg.n_image_tokens, cfg.d_vision)).astype(np.float32)
    return toks, patches


def _same_fields(port, ref):
    for f in dataclasses.fields(port):
        mine, theirs = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "quant":
            _same_fields(mine, theirs)
        else:
            assert mine == theirs, (f.name, mine, theirs)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_config_matches_jax(smoke):
    """Field for field with the reference's config, and its param_count
    (the projector included); the full config at its published widths,
    the Yi-34B backbone's."""
    port, ref = get_config(ARCH, smoke=smoke), jget_config(ARCH, smoke=smoke)
    _same_fields(port, ref)
    assert port.family == "vlm" and port.quant.mode == "cim"
    assert port.param_count() == ref.param_count()
    if not smoke:
        assert (port.n_layers, port.d_model, port.n_heads, port.n_kv_heads,
                port.resolved_head_dim, port.d_ff, port.vocab, port.n_image_tokens,
                port.d_vision, port.rope_theta) == \
            (60, 7168, 56, 8, 128, 20480, 64000, 2880, 1024, 5e6)
        yi = get_config("yi-34b")
        assert port.param_count() == yi.param_count() + 1024 * 7168
        assert port.replace(n_layers=8).param_count() == 5_387_583_488


def test_init_params_tree_matches_jax():
    """The port's own init gives the reference's tree: the dense
    decoder's leaves and the projector (d_vision, d_model)."""
    jcfg, tcfg, jparams, _ = _model_pair()
    want = {"/".join(k.key for k in path): tuple(v.shape) for path, v in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = {p: tuple(v.shape) for p, v in
           tree_paths(tT.init_params(tcfg, seed=0, device="cpu"))}
    assert got == want
    assert got["projector"] == (32, 64)


@pytest.mark.parametrize("mode", ["off", "cim"])
def test_embed_inputs_matches_jax(mode):
    """The projected patches (a dense layer: ternarized under cim) ahead
    of the token embeddings."""
    jcfg, tcfg, jparams, tparams = _model_pair(mode=mode)
    toks, patches = _inputs(jcfg)
    got = tT.embed_inputs(tparams, torch.from_numpy(toks).long(), tcfg,
                          torch.from_numpy(patches))
    assert got.shape == (2, jcfg.n_image_tokens + 7, jcfg.d_model)
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(jT.embed_inputs(jparams, {"tokens": jnp.asarray(toks),
                                             "patches": jnp.asarray(patches)}, jcfg)),
        atol=ATOL)


@pytest.mark.parametrize("mode", ["off", "cim"])
def test_forward_with_patches_matches_jax(mode):
    """Teacher-forced logits over n_img + S positions; without patches
    the vlm forward raises, as the reference's batch["patches"]."""
    jcfg, tcfg, jparams, tparams = _model_pair(mode=mode)
    toks, patches = _inputs(jcfg, seed=1)
    got = tT.forward(tparams, torch.from_numpy(toks).long(), tcfg,
                     patches=torch.from_numpy(patches))
    assert got.shape == (2, jcfg.n_image_tokens + 7, jcfg.vocab)
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(jT.forward(jparams, {"tokens": jnp.asarray(toks),
                                        "patches": jnp.asarray(patches)}, jcfg)),
        atol=ATOL)
    with pytest.raises(ValueError, match="needs patches"):
        tT.forward(tparams, torch.from_numpy(toks).long(), tcfg)


def test_decode_step_matches_jax():
    """f32, mode cim: vlm decodes tokens only; a 5-token prefill and two
    decode steps (logits and caches) against the reference's."""
    jcfg, tcfg, jparams, tparams = _model_pair(mode="cim")
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, jcfg.vocab, (2, 5)).astype(np.int32)
    jc = jT.init_caches(jcfg, 2, 16, dtype=jnp.float32)
    tc = tT.init_caches(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    jl, jc = jT.decode_step(jparams, jnp.asarray(prompt), jc, jnp.int32(0), jcfg)
    tl, tc = tT.decode_step(tparams, torch.from_numpy(prompt).long(), tc, 0, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for step in range(2):
        tok = rng.integers(1, jcfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jT.decode_step(jparams, jnp.asarray(tok), jc, jnp.int32(5 + step), jcfg)
        tl, tc = tT.decode_step(tparams, torch.from_numpy(tok).long(), tc, 5 + step, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for g, w in zip(tT.cache_leaves(tc), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_decode_matches_forward():
    """The pattern of tests/test_models.py::test_decode_matches_forward
    at its bf16 tolerance: 8 single-token decode steps against the
    forward of the same config as family "dense" (decode carries no
    image tokens)."""
    cfg = _with(get_config(ARCH, smoke=True), mode="off")
    params = tT.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
    ref = tT.forward(params, toks, cfg.replace(family="dense"))
    caches = tT.init_caches(cfg, 2, 32, device="cpu")
    dec = torch.cat([tT.decode_step(params, toks[:, t:t + 1], caches, t, cfg)[0]
                     for t in range(8)], dim=1)
    np.testing.assert_allclose(dec.float().numpy(), ref.float().numpy(),
                               rtol=4e-2, atol=4e-2)


def test_generate_greedy_prefix_matches_jax():
    jcfg, tcfg, jparams, tparams = _model_pair("bfloat16", "off")
    prompt = np.array([[100, 3, 44]], np.int32)
    want = np.asarray(jgenerate(jparams, jnp.asarray(prompt), jcfg, max_new=8,
                                s_max=32))[0]
    got = generate(tparams, prompt, tcfg, max_new=8, s_max=32, device="cpu")[0].numpy()
    assert np.array_equal(got[:4], want[:4]), (got, want)


@pytest.fixture(scope="module")
def model():
    """The port's own seeded bf16 smoke model."""
    cfg = get_config(ARCH, smoke=True)
    return cfg, tT.init_params(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "looped"])
@pytest.mark.parametrize("mode", ["off", "cim"])
def test_batchers_match_generate(model, mode, fused):
    """bf16: the batcher serves llava's token stream token-identical to
    the port's generate(), under mode off and the config's CiM mode with
    per-row scales."""
    cfg, params = model
    cfg = _with(cfg, mode=mode, act_scale="per_row")
    prompts, max_news = MIX
    batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=32, device="cpu",
                                fused=fused)
    reqs = [Request(i, list(p), max_new=m) for i, (p, m) in enumerate(zip(prompts, max_news))]
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    assert all(r.done for r in reqs)
    solos = [generate(params, [r.prompt], cfg, max_new=len(r.generated), s_max=32,
                      device="cpu")[0].tolist() for r in reqs]
    assert [r.generated for r in reqs] == solos


def test_prepare_folds_the_reference_leaves():
    """ternarize_params folds the leaves the reference folds: the
    attention projections, the MLP and the projector; the folded values
    agree (f32)."""
    _, _, jparams, tparams = _model_pair()
    jfolded = {"/".join(k.key for k in path): v for path, v in
               jax.tree_util.tree_flatten_with_path(jternarize_params(jparams))[0]}
    jorig = {"/".join(k.key for k in path): v for path, v in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}
    want = {p for p in jorig if not np.array_equal(np.asarray(jorig[p]),
                                                   np.asarray(jfolded[p]))}
    folded = dict(tree_paths(ternarize_params(tparams)))
    got = {p for p, leaf in tree_paths(tparams) if not torch.equal(folded[p], leaf)}
    assert got == want
    assert got == ({"projector"} | {f"blocks/attn/{w}" for w in ("wq", "wk", "wv", "wo")}
                   | {f"blocks/mlp/{w}" for w in ("w_gate", "w_up", "w_down")})
    for p in got:
        np.testing.assert_allclose(folded[p].numpy(), np.asarray(jfolded[p]),
                                   rtol=1e-6, atol=1e-7)


def test_serve_cli_on_cpu(capsys):
    assert serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--requests", "3", "--slots", "2", "--s-max", "16",
                           "--max-new", "3"]) == 0
    assert "tok/s on cpu" in capsys.readouterr().out
