"""The encdec family (whisper-large-v3 at smoke size): cross attention,
the encoder, the decoder with cross attention, serving with an encoder
output, weight preparation and the CLI, against the JAX package on the
same inputs (made with numpy) and bridged params.

Tolerances: f32 outputs atol 1e-5 (as ``test_torch_models.py``: the
sums run in another order in the two frameworks); decode after prefill
against ``forward`` at the reference's own bound for a cached prefill
against stepwise decode (``tests/test_serve.py``, rtol = atol = 1e-5);
``layer_norm`` at rtol = atol = 1e-6 (one or two f32 ulps: the mean
and variance are summed in another order). Across packages the served tokens are held
to a greedy prefix at bf16 with mode "off" (ROADMAP Queue C: XLA's
excess precision in the reference's scanned stack). Inside the port the
tokens are held equal. The reference's batcher takes no encoder output,
so the batcher serves whisper's decoder without cross attention."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models import transformer as jT
from repro.models.registry import get_config as jget_config
from repro.quant.prepare import ternarize_params as jternarize_params
from repro.serve.engine import generate as jgenerate
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.models.registry import get_config
from repro_torch.quant.prepare import ternarize_params, tree_paths
from repro_torch.serve.engine import (ContinuousBatcher, Request, generate,
                                      make_jit_serve_step, serve_step)
from torch_threads import one_thread  # noqa: F401

ARCH = "whisper-large-v3"
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


def _frames(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


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
    (encoder blocks and cross attention included)."""
    port, ref = get_config(ARCH, smoke=smoke), jget_config(ARCH, smoke=smoke)
    _same_fields(port, ref)
    assert port.family == "encdec" and port.quant.mode == "cim"
    assert port.param_count() == ref.param_count()
    if not smoke:
        assert (port.n_layers, port.n_encoder_layers, port.d_model, port.n_heads,
                port.resolved_head_dim, port.d_ff, port.vocab, port.encoder_seq) == \
            (32, 32, 1280, 20, 64, 5120, 51866, 1500)
        assert port.param_count() == 2_020_213_760


def test_init_params_tree_matches_jax():
    """The port's own init gives the reference's tree: every leaf path
    and shape (enc_blocks stacked over n_encoder_layers, blocks/cross
    and blocks/ln_x, enc_norm, enc_pos)."""
    jcfg, tcfg, jparams, _ = _model_pair()
    want = {"/".join(k.key for k in path): tuple(v.shape) for path, v in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = {p: tuple(v.shape) for p, v in
           tree_paths(tT.init_params(tcfg, seed=0, device="cpu"))}
    assert got == want
    assert got["enc_blocks/attn/wq"] == (2, 64, 64)
    assert got["blocks/cross/wk"] == (2, 64, 64)
    assert got["enc_pos"] == (32, 64)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (3 + 2 * rng.standard_normal((2, 5, 48))).astype(np.float32)
    gamma, beta = rng.standard_normal((2, 48)).astype(np.float32)
    np.testing.assert_allclose(
        tL.layer_norm(torch.from_numpy(x), torch.from_numpy(gamma),
                      torch.from_numpy(beta)).numpy(),
        np.asarray(jL.layer_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["off", "cim"])
def test_cross_attention_matches_jax(mode):
    """init_cross's shapes, and cross_attention of 5 queries to 32
    encoder rows on the reference's weights (f32)."""
    jcfg, tcfg, _, _ = _model_pair(mode=mode)
    jp = jattn.init_cross(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = tattn.init_cross(torch.Generator().manual_seed(3), tcfg, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        tattn.cross_attention(tp, torch.from_numpy(x), torch.from_numpy(enc), tcfg).numpy(),
        np.asarray(jattn.cross_attention(jp, jnp.asarray(x), jnp.asarray(enc), jcfg)),
        atol=ATOL)


@pytest.mark.parametrize("mode", ["off", "cim"])
def test_run_encoder_matches_jax(mode):
    jcfg, tcfg, jparams, tparams = _model_pair(mode=mode)
    frames = _frames(jcfg)
    np.testing.assert_allclose(
        tT.run_encoder(tparams, torch.from_numpy(frames), tcfg).numpy(),
        np.asarray(jT.run_encoder(jparams, jnp.asarray(frames), jcfg)), atol=ATOL)


@pytest.mark.parametrize("mode", ["off", "cim"])
def test_forward_with_frames_matches_jax(mode):
    """Teacher-forced logits with the encoder run over frames; without
    frames the encdec forward raises, as the reference's batch["frames"]."""
    jcfg, tcfg, jparams, tparams = _model_pair(mode=mode)
    frames = _frames(jcfg)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        tT.forward(tparams, torch.from_numpy(toks).long(), tcfg,
                   frames=torch.from_numpy(frames)).numpy(),
        np.asarray(jT.forward(jparams, {"tokens": jnp.asarray(toks),
                                        "frames": jnp.asarray(frames)}, jcfg)),
        atol=ATOL)
    with pytest.raises(ValueError, match="needs frames"):
        tT.forward(tparams, torch.from_numpy(toks).long(), tcfg)


def test_decode_step_with_enc_matches_jax():
    """f32, mode cim: a 5-token prefill and two decode steps through
    decode_step with the encoder output (logits and both cache leaves),
    and a step without it (no cross attention), against the reference."""
    jcfg, tcfg, jparams, tparams = _model_pair(mode="cim")
    frames = _frames(jcfg)
    jenc = jT.run_encoder(jparams, jnp.asarray(frames), jcfg)
    tenc = tT.run_encoder(tparams, torch.from_numpy(frames), tcfg)
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, jcfg.vocab, (2, 5)).astype(np.int32)
    jc = jT.init_caches(jcfg, 2, 16, dtype=jnp.float32)
    tc = tT.init_caches(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    jl, jc = jT.decode_step(jparams, jnp.asarray(prompt), jc, jnp.int32(0), jcfg, jenc)
    tl, tc = tT.decode_step(tparams, torch.from_numpy(prompt).long(), tc, 0, tcfg,
                            enc=tenc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for step, with_enc in enumerate((True, True, False)):
        tok = rng.integers(1, jcfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jT.decode_step(jparams, jnp.asarray(tok), jc, jnp.int32(5 + step), jcfg,
                                jenc if with_enc else None)
        tl, tc = tT.decode_step(tparams, torch.from_numpy(tok).long(), tc, 5 + step,
                                tcfg, enc=tenc if with_enc else None)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    want = jax.tree_util.tree_leaves(jc)
    got = list(tT.cache_leaves(tc))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_decode_after_prefill_matches_forward():
    """f32, mode off: a 4-token cached prefill with enc, then 4
    single-token steps, against forward over all 8 tokens with frames."""
    _, tcfg, _, tparams = _model_pair()
    frames = torch.from_numpy(_frames(tcfg))
    toks = torch.randint(0, tcfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
    ref = tT.forward(tparams, toks, tcfg, frames=frames)
    enc = tT.run_encoder(tparams, frames, tcfg)
    caches = tT.init_caches(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    pre, _ = tT.decode_step(tparams, toks[:, :4], caches, 0, tcfg, enc=enc)
    steps = [tT.decode_step(tparams, toks[:, t:t + 1], caches, t, tcfg, enc=enc)[0]
             for t in range(4, 8)]
    dec = torch.cat([pre] + steps, dim=1)
    np.testing.assert_allclose(dec.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_generate_with_enc_greedy_prefix_matches_jax():
    """bf16, mode off: generate(enc=) against the reference's, as a greedy
    prefix, on the bridged encoder output of each package."""
    jcfg, tcfg, jparams, tparams = _model_pair("bfloat16", "off")
    frames = _frames(jcfg, b=1)
    jenc = jT.run_encoder(jparams, jnp.asarray(frames, jnp.bfloat16), jcfg)
    tenc = tT.run_encoder(tparams, torch.from_numpy(frames).to(torch.bfloat16), tcfg)
    prompt = np.array([[100, 3, 44]], np.int32)
    want = np.asarray(jgenerate(jparams, jnp.asarray(prompt), jcfg, max_new=8,
                                s_max=32, enc=jenc))[0]
    got = generate(tparams, prompt, tcfg, max_new=8, s_max=32, device="cpu",
                   enc=tenc)[0].numpy()
    assert np.array_equal(got[:4], want[:4]), (got, want)
    # the encoder output is read: without it the tokens change
    plain = generate(tparams, prompt, tcfg, max_new=8, s_max=32, device="cpu")[0]
    assert not np.array_equal(plain.numpy(), got)


@pytest.fixture(scope="module")
def model():
    """The port's own seeded bf16 smoke model."""
    cfg = get_config(ARCH, smoke=True)
    return cfg, tT.init_params(cfg, seed=0, device="cpu")


def _enc(params, cfg, b, seed=0):
    frames = torch.from_numpy(_frames(cfg, b, seed)).to(torch.bfloat16)
    return tT.run_encoder(params, frames, cfg)


@pytest.mark.parametrize("mode", ["off", "cim"])
def test_generate_rows_match_batched(model, mode):
    """Under per_row activation scales (a cross K/V projection's
    per-tensor scale would couple every row of enc), generate(enc=) over
    3 rows == each row's own generate() on its own encoder row."""
    cfg, params = model
    cfg = _with(cfg, mode=mode, act_scale="per_row")
    enc = _enc(params, cfg, 3)
    prompt = torch.randint(1, cfg.vocab, (3, 6), generator=torch.Generator().manual_seed(4))
    batched = generate(params, prompt, cfg, max_new=6, s_max=32, device="cpu", enc=enc)
    for i in range(3):
        solo = generate(params, prompt[i:i + 1], cfg, max_new=6, s_max=32,
                        device="cpu", enc=enc[i:i + 1])
        assert torch.equal(solo[0], batched[i]), i


def test_jit_serve_step_with_enc_on_cpu_is_serve_step(model):
    """On the CPU make_jit_serve_step(enc=) is serve_step: the same
    logits and caches, step by step, through prefill and ragged decode."""
    cfg, params = model
    enc = _enc(params, cfg, 2)
    jit = make_jit_serve_step(cfg)
    mine = tT.init_caches(cfg, 2, 32, device="cpu")
    ref = tT.init_caches(cfg, 2, 32, device="cpu")
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(1, cfg.vocab, (2, 4), generator=g)
    got, _ = jit(params, prompt, mine, 0, enc=enc)
    want, _ = serve_step(params, prompt, ref, 0, cfg, enc=enc)
    assert torch.equal(got, want)
    for i in range(3):
        tok = torch.randint(1, cfg.vocab, (2, 1), generator=g)
        index = torch.tensor([4 + i, 4 + i])
        got, _ = jit(params, tok, mine, index, enc=enc)
        want, _ = serve_step(params, tok, ref, index, cfg, enc=enc)
        assert torch.equal(got, want), i
    assert torch.equal(mine.k, ref.k) and torch.equal(mine.v, ref.v)


def _serve(params, cfg, **kw):
    prompts, max_news = MIX
    batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=32, device="cpu", **kw)
    reqs = [Request(i, list(p), max_new=m) for i, (p, m) in enumerate(zip(prompts, max_news))]
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    assert all(r.done for r in reqs)
    return batcher, reqs


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "looped"])
@pytest.mark.parametrize("mode", ["off", "cim"])
def test_batchers_match_generate(model, mode, fused):
    """bf16: the batcher (no encoder output, as the reference's) serves
    whisper's decoder token-identical to the port's generate() without
    enc, under mode off and the config's CiM mode with per-row scales."""
    cfg, params = model
    cfg = _with(cfg, mode=mode, act_scale="per_row")
    batcher, reqs = _serve(params, cfg, fused=fused)
    solos = [generate(params, [r.prompt], cfg, max_new=len(r.generated), s_max=32,
                      device="cpu")[0].tolist() for r in reqs]
    assert [r.generated for r in reqs] == solos
    st = batcher.stats()
    if fused:
        assert st["host_syncs"] == st["decode_steps"] + st["prefill_batches"]


def test_prepare_folds_the_reference_leaves():
    """ternarize_params folds the leaves the reference folds: the
    decoder's self and cross projections and MLP, and the encoder's
    projections and MLP; never enc_pos, the norms or the embeddings; the
    folded values agree (f32)."""
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
    proj = ("wq", "wk", "wv", "wo")
    mlp = ("w_gate", "w_up", "w_down")
    assert got == ({f"blocks/attn/{w}" for w in proj} | {f"blocks/cross/{w}" for w in proj}
                   | {f"blocks/mlp/{w}" for w in mlp} | {f"enc_blocks/attn/{w}" for w in proj}
                   | {f"enc_blocks/mlp/{w}" for w in mlp})
    assert "enc_pos" not in got
    for p in got:
        np.testing.assert_allclose(folded[p].numpy(), np.asarray(jfolded[p]),
                                   rtol=1e-6, atol=1e-7)


def test_serve_cli_on_cpu(capsys):
    assert serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--requests", "3", "--slots", "2", "--s-max", "16",
                           "--max-new", "3"]) == 0
    assert "tok/s on cpu" in capsys.readouterr().out
