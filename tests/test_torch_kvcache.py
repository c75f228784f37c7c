"""The port's quantized KV cache against the JAX package's (DESIGN.md
§13): ``quantize_kv`` codes and scales, the ternary nibble packing,
``_sdpa``/``_sdpa_chunked`` with scales (f32, atol 1e-5 as in
``test_torch_models.py``: the sums run in another order in the two
frameworks), the cache layouts and their exact capacity ratios, and
quantized decode logits against the JAX ``decode_step``."""
import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import transformer as jT
from repro.models.registry import get_config as jget_config
from repro_torch.bridge import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.models.registry import get_config
from torch_threads import one_thread  # noqa: F401

ATOL = 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_int8_bit_identical(dtype):
    x = np.random.default_rng(0).standard_normal((3, 5, 2, 8)).astype(np.float32)
    x[1, 2] = 0.0                             # an all-zero slice: scale 1.0
    x[0, 0, 0, :4] = [0.5, -1.5, 2.5, 127.0]  # ties: round half to even
    jx = jnp.asarray(x, dtype)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    want_q, want_s = jattn.quantize_kv(jx, "int8")
    got_q, got_s = tattn.quantize_kv(tx, "int8")
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[1, 2] == 1.0 and (got_q[1, 2] == 0).all()


def test_quantize_kv_ternary_matches_jax_away_from_threshold():
    """TWN codes are compared where no element lies within 1e-6 relative
    of its slice's threshold (the frameworks' f32 means differ in the
    last ulp); the scales at rtol 1e-6."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 6, 2, 16)).astype(np.float32)
    delta = 0.7 * np.abs(x).mean(axis=(2, 3), keepdims=True)
    near = np.abs(np.abs(x) - delta) <= 1e-6 * delta
    assert not near.any()
    want_p, want_s = jattn.quantize_kv(jnp.asarray(x), "ternary")
    got_p, got_s = tattn.quantize_kv(torch.from_numpy(x), "ternary")
    assert got_p.dtype == torch.uint8 and got_p.shape == (4, 6, 2, 8)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)


def test_pack_unpack_round_trip_and_bytes():
    t = np.random.default_rng(0).integers(-1, 2, (3, 8)).astype(np.int8)
    p = tattn.pack_ternary_kv(torch.from_numpy(t))
    assert p.dtype == torch.uint8 and p.shape == (3, 4)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jattn.pack_ternary_kv(jnp.asarray(t))))
    # high nibble first: (t0 + 1) << 4 | (t1 + 1)
    assert int(p[0, 0]) == ((int(t[0, 0]) + 1) << 4) | (int(t[0, 1]) + 1)
    np.testing.assert_array_equal(
        tattn.unpack_ternary_kv(p, torch.float32).numpy(), t.astype(np.float32))


def test_odd_last_dim_rejected():
    with pytest.raises(ValueError, match="odd"):
        tattn.QuantKVCache.zeros(2, 8, 2, 15, cache_dtype="ternary")
    with pytest.raises(ValueError, match="cache_dtype"):
        tattn.quantize_kv(torch.zeros((1, 1, 2)), "int4")


def test_cache_dtype_validated():
    with pytest.raises(ValueError, match="unknown cache_dtype 'int4'"):
        tL.QuantConfig(mode="off", cache_dtype="int4")
    with pytest.raises(ValueError, match="cache_dtype"):
        jattn.L.QuantConfig(mode="off", cache_dtype="int4")


def _quant_kv(rng, cache_dtype, b, sk, hkv, dh):
    """Codes and scales as a cache holds them: quantize_kv of random KV."""
    k = rng.standard_normal((b, sk, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, dh)).astype(np.float32)
    (kq, ks), (vq, vs) = (jattn.quantize_kv(jnp.asarray(a), cache_dtype) for a in (k, v))
    return [np.array(a) for a in (kq, vq, ks, vs)]


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("cache_dtype", ["int8", "ternary"])
def test_sdpa_with_scales_matches_jax(cache_dtype, ragged):
    rng = np.random.default_rng(2)
    b, sq, sk, h, hkv, dh = 3, 2, 12, 4, 2, 8
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    kq, vq, ks, vs = _quant_kv(rng, cache_dtype, b, sk, hkv, dh)
    if ragged:
        off = np.array([3, 7, 9], np.int32)
        kw = dict(length=np.array([5, 9, 11], np.int32), start=np.array([0, 2, 4], np.int32))
    else:
        off, kw = 4, {}
    kw.update(k_scale=ks, v_scale=vs)
    want = jattn._sdpa(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                       jnp.asarray(off), **{n: jnp.asarray(a) for n, a in kw.items()})
    t_off = torch.from_numpy(off) if ragged else off
    got = tattn._sdpa(torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq),
                      t_off, **{n: torch.from_numpy(a) for n, a in kw.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("cache_dtype", [None, "int8", "ternary"])
def test_sdpa_chunked_matches_jax(cache_dtype):
    rng = np.random.default_rng(3)
    b, s, h, hkv, dh, chunk = 2, 12, 4, 2, 8, 4
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    if cache_dtype is None:
        k, v = (rng.standard_normal((b, s, hkv, dh)).astype(np.float32) for _ in "kv")
        kw = {}
    else:
        k, v, ks, vs = _quant_kv(rng, cache_dtype, b, s, hkv, dh)
        kw = dict(k_scale=ks, v_scale=vs)
    want = jattn._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk,
                               **{n: jnp.asarray(a) for n, a in kw.items()})
    got = tattn._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              chunk, **{n: torch.from_numpy(a) for n, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if cache_dtype is None:   # and the chunked path is the full causal _sdpa
        full = tattn._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal_offset=0)
        np.testing.assert_allclose(got.numpy(), full.numpy(), atol=ATOL)


def _cfg(cache_dtype, arch="smollm-135m", smoke=True):
    cfg = get_config(arch, smoke=smoke)
    return cfg.replace(quant=dataclasses.replace(cfg.quant, cache_dtype=cache_dtype))


def _cache_bytes(cfg, n_slots, s_max):
    caches = tT.init_caches(cfg, n_slots, s_max, device="meta")
    return sum(leaf.numel() * leaf.element_size() for leaf in caches)


def test_capacity_ratios_exact():
    """Per-slot cache bytes: bf16 4D per position against int8 2D + 8
    and ternary D + 8 (D = n_kv * head_dim; two f32 scales), so the
    ratios are exactly 4D/(2D+8) and 4D/(D+8)."""
    cfg = _cfg("bf16")
    d = cfg.n_kv_heads * cfg.resolved_head_dim
    got = {cd: _cache_bytes(_cfg(cd), 2, 32) for cd in ("bf16", "int8", "ternary")}
    assert Fraction(got["bf16"], got["int8"]) == Fraction(4 * d, 2 * d + 8)
    assert Fraction(got["bf16"], got["ternary"]) == Fraction(4 * d, d + 8)
    # full-size smollm-135m, one slot at s_max 256 (D = 192: 1.959x, 3.84x)
    full = {cd: _cache_bytes(_cfg(cd, smoke=False), 1, 256)
            for cd in ("bf16", "int8", "ternary")}
    assert full == {"bf16": 5_898_240, "int8": 3_010_560, "ternary": 1_536_000}


def test_bf16_default_caches_unchanged():
    cfg = get_config("smollm-135m", smoke=True)
    assert cfg.quant.cache_dtype == "bf16"
    caches = tT.init_caches(cfg, 2, 8, device="cpu")
    assert type(caches) is tattn.KVCache
    assert caches.k.dtype == caches.v.dtype == torch.bfloat16
    assert caches.k.shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert tT.init_caches(cfg, 1, 4, dtype=torch.float32, device="cpu").k.dtype == torch.float32


@pytest.mark.parametrize("cache_dtype", ["int8", "ternary"])
def test_quant_cache_layout(cache_dtype):
    cfg = _cfg(cache_dtype)
    caches = tT.init_caches(cfg, 2, 8, device="cpu")
    assert type(caches) is tattn.QuantKVCache
    hd = cfg.resolved_head_dim // (2 if cache_dtype == "ternary" else 1)
    code = torch.uint8 if cache_dtype == "ternary" else torch.int8
    for leaf in caches.k, caches.v:
        assert leaf.dtype == code and leaf.shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads, hd)
        assert (leaf == (0x11 if cache_dtype == "ternary" else 0)).all()
    for leaf in caches.k_scale, caches.v_scale:
        assert leaf.dtype == torch.float32 and leaf.shape == (cfg.n_layers, 2, 8)
        assert (leaf == 1.0).all()
    # four leaves of their own storage (the port writes them in place)
    assert len({leaf.data_ptr() for leaf in caches}) == 4


@pytest.mark.parametrize("cache_dtype", ["int8", "ternary"])
def test_write_cache_rows_clamps_scale_rows(cache_dtype):
    buf = torch.ones((2, 4))
    tattn.write_cache_rows(buf, torch.full((2, 1), 5.0), torch.tensor([1, 4]))
    assert buf.tolist() == [[1, 5, 1, 1], [1, 1, 1, 5]]
    caches = tattn.QuantKVCache.zeros(2, 4, 1, 2, cache_dtype)
    codes, scale = tattn.quantize_kv(torch.ones((2, 1, 1, 2)), cache_dtype)
    tattn.write_cache_rows(caches.k, codes, 6)     # past the end: the last slot
    tattn.write_cache_rows(caches.k_scale, scale, 6)
    assert torch.equal(caches.k[:, 3:], codes) and torch.equal(caches.k_scale[:, 3:], scale)


@pytest.mark.parametrize("cache_dtype", ["int8", "ternary"])
def test_quant_decode_logits_match_jax(cache_dtype):
    """The smoke model in f32 over a quantized cache: a left-padded
    prefill then ragged decode steps, logits against the JAX
    decode_step at the f32 tolerance, and the stored codes equal (no
    element of these inputs sits on a rounding or threshold edge)."""
    jcfg = jget_config("smollm-135m", smoke=True).replace(dtype="float32")
    jcfg = jcfg.replace(quant=dataclasses.replace(jcfg.quant, mode="off",
                                                  cache_dtype=cache_dtype))
    tcfg = _cfg(cache_dtype).replace(dtype="float32")
    tcfg = tcfg.replace(quant=dataclasses.replace(tcfg.quant, mode="off"))
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams), tcfg,
        device="cpu")
    rng = np.random.default_rng(4)
    prompt = rng.integers(1, jcfg.vocab, (2, 5)).astype(np.int32)
    start = np.array([0, 2], np.int32)
    jc = jT.init_caches(jcfg, 2, 16)
    tc = tT.init_caches(tcfg, 2, 16, device="cpu")
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
    for got, want in zip(tc, jc):
        if got.dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
