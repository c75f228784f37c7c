"""MLA attention (``attention.mla_attention`` with ``MLACache`` and
``QuantMLACache``, deepseek-v2's attention) against the JAX package's on
bridged weights at smoke width: prefill without a cache, and cached
steps (a left-padded prefill, decode at a (B,) and at a scalar index)
over bf16, int8 and ternary caches; and the caches' layout and bytes.

Tolerances: f32 atol 1e-5 (as ``test_torch_models.py``: the sums run
in another order; the port accumulates the attention contractions in
float64); bf16, called op by op, bit for bit up to one rounding step
(rtol 2^-7, atol 2^-10, as ``test_torch_moe.py``); quantized-cache
codes equal and their scales at rtol 1e-6 (as
``test_torch_kvcache.py``: no element of these inputs sits on a
rounding or TWN-threshold edge)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models.registry import get_config as jget_config
from repro_torch.bridge import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tT
from repro_torch.models.registry import get_config
from torch_threads import one_thread  # noqa: F401

TOL = {"float32": dict(rtol=0, atol=1e-5),
       "bfloat16": dict(rtol=2.0 ** -7, atol=2.0 ** -10)}


def _with(cfg, **quant):
    return cfg.replace(quant=dataclasses.replace(cfg.quant, **quant))


def _tdtype(dtype):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def _jdtype(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _mla_pair(dtype, mode):
    jcfg = _with(jget_config("deepseek-v2-236b", smoke=True).replace(dtype=dtype),
                 mode=mode)
    tcfg = _with(get_config("deepseek-v2-236b", smoke=True).replace(dtype=dtype),
                 mode=mode)
    jparams = jattn.init_mla(jax.random.PRNGKey(0), jcfg, _jdtype(dtype))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, device="cpu")


def _caches(cache, dtype, b=2, s_max=12):
    """A (JAX, port) pair of one layer's empty MLA caches."""
    r, dr = 32, 8
    if cache == "bf16":
        return (jattn.MLACache.zeros(b, s_max, r, dr, _jdtype(dtype)),
                tattn.MLACache.zeros(b, s_max, r, dr, _tdtype(dtype)))
    return (jattn.QuantMLACache.zeros(b, s_max, r, dr, cache),
            tattn.QuantMLACache.zeros(b, s_max, r, dr, cache))


def _assert_caches_equal(got, want, dtype):
    for g, w in zip(got, want):
        w = np.asarray(w)
        if g.dtype in (torch.int8, torch.uint8):
            np.testing.assert_array_equal(g.numpy(), w)
        elif g.dtype == torch.float32 and w.dtype == np.float32 and g.dim() == 2:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)   # scales
        else:
            np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32),
                                       **TOL[dtype])


@pytest.mark.parametrize("mode", ["off", "cim"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_without_cache_matches_jax(dtype, mode):
    jcfg, tcfg, jparams, tparams = _mla_pair(dtype, mode)
    x = np.random.default_rng(0).standard_normal((2, 7, 64)).astype(np.float32)
    pos = np.tile(np.arange(7, dtype=np.int32), (2, 1))
    want, jc = jattn.mla_attention(jparams, jnp.asarray(x).astype(_jdtype(dtype)),
                                   jcfg, jnp.asarray(pos))
    got, tc = tattn.mla_attention(tparams, torch.from_numpy(x).to(_tdtype(dtype)),
                                  tcfg, torch.from_numpy(pos).long())
    assert jc is None and tc is None and got.dtype == _tdtype(dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("cache", ["bf16", "int8", "ternary"])
@pytest.mark.parametrize("mode", ["off", "cim"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_cached_steps_match_jax(dtype, mode, cache):
    """A left-padded prefill at index 0 (``start`` masks row 1's 2 pad
    slots), a decode step at a (B,) index, then one at a scalar index:
    outputs and every cache leaf against the reference's (which returns
    the new token slices: written here with its write_cache_rows)."""
    jcfg, tcfg, jparams, tparams = _mla_pair(dtype, mode)
    jc, tc = _caches(cache, dtype)
    assert type(tc).__name__ == type(jc).__name__
    rng = np.random.default_rng(1)
    start = np.array([0, 2], np.int32)
    steps = [(rng.standard_normal((2, 5, 64)), 0, True),
             (rng.standard_normal((2, 1, 64)), np.array([5, 5], np.int32), True),
             (rng.standard_normal((2, 1, 64)), 6, False)]
    for x, index, vector in steps:
        x = x.astype(np.float32)
        s = x.shape[1]
        base = np.broadcast_to(np.asarray(index, np.int32), (2,)) - start
        pos = (base[:, None] + np.arange(s, dtype=np.int32)[None]).astype(np.int32)
        jidx = jnp.asarray(index, jnp.int32)
        want, new = jattn.mla_attention(
            jparams, jnp.asarray(x).astype(_jdtype(dtype)), jcfg, jnp.asarray(pos), jc,
            jidx, jnp.asarray(start))
        jc = type(jc)(*(jattn.write_cache_rows(a, n, jidx) for a, n in zip(jc, new)))
        tidx = torch.from_numpy(np.asarray(index)).long() if vector else index
        got, tc = tattn.mla_attention(
            tparams, torch.from_numpy(x).to(_tdtype(dtype)), tcfg,
            torch.from_numpy(pos).long(), tc, tidx, torch.from_numpy(start).long())
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   **TOL[dtype])
    _assert_caches_equal(tc, jc, dtype)


# deepseek-v2 at full width, 4 layers, s_max 128: bytes per slot by cache
# dtype: 4 x 128 x (512 + 64) codes at 2, 1 and 1/2 bytes, plus 2 f32
# scales a position for the quantized caches
MLA_BYTES_PER_SLOT = {"bf16": 589_824, "int8": 299_008, "ternary": 151_552}


@pytest.mark.parametrize("cache_dtype", sorted(MLA_BYTES_PER_SLOT))
def test_mla_cache_layout_and_bytes(cache_dtype):
    cfg = _with(get_config("deepseek-v2-236b").replace(n_layers=4),
                cache_dtype=cache_dtype)
    caches = tT.init_caches(cfg, 2, 128, device="cpu")
    leaves = list(tT.cache_leaves(caches))
    assert all(a.shape[:3] == (4, 2, 128) for a in leaves)
    assert sum(a.numel() * a.element_size() for a in leaves) // 2 == \
        MLA_BYTES_PER_SLOT[cache_dtype]
    grok = get_config("grok-1-314b").replace(n_layers=2)
    kv = tT.init_caches(grok, 1, 128, device="cpu")
    assert type(kv) is tattn.KVCache
    assert sum(a.numel() * a.element_size() for a in kv) == 1_048_576
