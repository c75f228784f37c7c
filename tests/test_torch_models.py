"""Differential tests: the port's layers, attention and dense decoder
against the JAX package on the same inputs and bridged params (f32,
atol 1e-5: the sums run in another order in the two frameworks)."""
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
from repro_torch.bridge import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.models.registry import get_config
from torch_threads import one_thread  # noqa: F401

ATOL = 1e-5


def _smoke_pair(mode="off"):
    jcfg = jget_config("smollm-135m", smoke=True)
    jcfg = jcfg.replace(dtype="float32",
                        quant=dataclasses.replace(jcfg.quant, mode=mode))
    tcfg = get_config("smollm-135m", smoke=True)
    tcfg = tcfg.replace(dtype="float32",
                        quant=dataclasses.replace(tcfg.quant, mode=mode))
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, device="cpu")


def test_smoke_config_matches_jax():
    j, t = jget_config("smollm-135m", smoke=True), get_config("smollm-135m", smoke=True)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
              "vocab", "tie_embeddings", "dtype", "rope_theta"):
        assert getattr(j, f) == getattr(t, f), f
    full = get_config("smollm-135m")
    assert (full.n_layers, full.d_model, full.vocab, full.quant.mode) == \
        (30, 576, 49152, "cim")
    assert full.param_count() == jget_config("smollm-135m").param_count()
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper-tiny")


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    gamma = rng.standard_normal((16,)).astype(np.float32)
    np.testing.assert_allclose(
        tL.rms_norm(torch.from_numpy(x), torch.from_numpy(gamma)).numpy(),
        np.asarray(jL.rms_norm(jnp.asarray(x), jnp.asarray(gamma))), atol=ATOL)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jL.apply_rope(jnp.asarray(x), jnp.asarray(pos))), atol=ATOL)


@pytest.mark.parametrize("ragged", [False, True])
def test_sdpa_masks_match_jax(ragged):
    rng = np.random.default_rng(1)
    b, sq, sk, h, hkv, dh = 3, 2, 12, 4, 2, 8
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, dh)).astype(np.float32)
    if ragged:
        off = np.array([3, 7, 9], np.int32)
        kw = dict(length=np.array([5, 9, 11], np.int32), start=np.array([0, 2, 4], np.int32))
    else:
        off, kw = 4, {}
    want = jattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(off), **{n: jnp.asarray(a) for n, a in kw.items()})
    t_off = torch.from_numpy(off) if ragged else off
    got = tattn._sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                      t_off, **{n: torch.from_numpy(a) for n, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_dense_cim_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 4, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 24)) / 8).astype(np.float32)
    for qc_kw in (dict(mode="cim"), dict(mode="cim", act_scale="per_row"),
                  dict(mode="ternary"), dict(mode="cim_fused")):
        want = jL.dense(jnp.asarray(x), jnp.asarray(w), jL.QuantConfig(**qc_kw))
        got = tL.dense(torch.from_numpy(x), torch.from_numpy(w), tL.QuantConfig(**qc_kw))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    # pre-quantized weights: the folded codes recover exactly
    t, s = tL.tern.ternarize(torch.from_numpy(w), axis=(0,))
    folded = (t * s).numpy()
    want = jL.dense(jnp.asarray(x), jnp.asarray(folded),
                    jL.QuantConfig(mode="cim", pre_quantized=True))
    got = tL.dense(torch.from_numpy(x), torch.from_numpy(folded),
                   tL.QuantConfig(mode="cim", pre_quantized=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_forward_and_decode_logits_match_jax():
    jcfg, tcfg, jparams, tparams = _smoke_pair()
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, jcfg.vocab, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tT.forward(tparams, torch.from_numpy(prompt).long(), tcfg).numpy(),
        np.asarray(jT.forward(jparams, {"tokens": jnp.asarray(prompt)}, jcfg)),
        atol=ATOL)

    # scalar index: left-padded prefill with a dead zone (start), ...
    s_max = 16
    start = np.array([0, 2], np.int32)
    jc = jT.init_caches(jcfg, 2, s_max, dtype=jnp.float32)
    tc = tT.init_caches(tcfg, 2, s_max, dtype=torch.float32, device="cpu")
    jl, jc = jT.decode_step(jparams, jnp.asarray(prompt), jc, jnp.int32(0), jcfg,
                            start=jnp.asarray(start))
    tl, tc = tT.decode_step(tparams, torch.from_numpy(prompt).long(), tc, 0, tcfg,
                            start=torch.from_numpy(start).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=ATOL)
    # ... then (B,) ragged decode steps at per-row positions
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
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=ATOL)


def test_write_cache_rows_ragged():
    buf = torch.zeros((3, 6, 1))
    tattn.write_cache_rows(buf, torch.ones((3, 2, 1)), torch.tensor([0, 2, 4]))
    want = np.zeros((3, 6, 1), np.float32)
    want[0, 0:2], want[1, 2:4], want[2, 4:6] = 1, 1, 1
    np.testing.assert_array_equal(buf.numpy(), want)
    tattn.write_cache_rows(buf, torch.full((3, 1, 1), 2.0), 5)
    assert (buf[:, 5] == 2).all()


def test_bridge_rejects_non_f32():
    cfg = get_config("smollm-135m", smoke=True)
    with pytest.raises(TypeError):
        params_from_numpy({"embed": np.zeros((2, 2), np.float16)}, cfg, device="cpu")


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-780m", "zamba2-2.7b",
                                  "deepseek-v2-236b", "whisper-large-v3", "llava-next-34b"])
def test_init_block_matches_jax(arch):
    """``init_block``, one layer's params by family, against the
    reference's ``init_block``: the same leaves, each of the same shape
    and dtype (the draws differ: a torch generator, not a JAX key)."""
    jcfg, tcfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jblock = jT.init_block(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    tblock = tT.init_block(torch.Generator().manual_seed(0), tcfg, torch.bfloat16,
                           device="cpu")

    def leaves(tree, prefix=""):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield prefix + k, tuple(v.shape), str(v.dtype).replace("torch.", "")

    assert list(leaves(tblock)) == list(leaves(jblock))
