"""The three dense configs beside smollm-135m (starcoder2-7b,
starcoder2-15b, yi-34b): the port's configs equal the JAX package's
field for field, and at smoke size the port's forward (full and chunked
attention) and cached decode logits match the JAX package's on bridged
params, through the untied unembedding (f32, atol 1e-5 as in
``test_torch_models.py``: the sums run in another order in the two
frameworks)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jT
from repro.models.registry import get_config as jget_config
from repro_torch.bridge import params_from_numpy
from repro_torch.models import transformer as tT
from repro_torch.models.registry import ARCH_IDS, get_config
from torch_threads import one_thread  # noqa: F401

ATOL = 1e-5
ARCHS = ("starcoder2-7b", "starcoder2-15b", "yi-34b")
# full-size (n_layers, d_model, n_heads, n_kv_heads, head_dim, d_ff, vocab)
WIDTHS = {"starcoder2-7b": (32, 4608, 36, 4, 128, 18432, 49152),
          "starcoder2-15b": (40, 6144, 48, 4, 128, 24576, 49152),
          "yi-34b": (60, 7168, 56, 8, 128, 20480, 64000)}


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
    assert arch in ARCH_IDS
    port, ref = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    _same_fields(port, ref)
    assert not port.tie_embeddings and port.quant.mode == "cim"
    assert port.param_count() == ref.param_count()
    if not smoke:
        assert (port.n_layers, port.d_model, port.n_heads, port.n_kv_heads,
                port.head_dim, port.d_ff, port.vocab) == WIDTHS[arch]


def test_starcoder2_7b_size():
    cfg = get_config("starcoder2-7b")
    assert 10.0e9 < cfg.param_count() < 10.2e9    # ~20.2 GB in bf16


def _pair(arch):
    jcfg = jget_config(arch, smoke=True).replace(dtype="float32")
    jcfg = jcfg.replace(quant=dataclasses.replace(jcfg.quant, mode="off"))
    tcfg = get_config(arch, smoke=True).replace(dtype="float32")
    tcfg = tcfg.replace(quant=dataclasses.replace(tcfg.quant, mode="off"))
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    assert "unembed" in tparams
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_logits_match_jax(arch):
    jcfg, tcfg, jparams, tparams = _pair(arch)
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, jcfg.vocab, (2, 8)).astype(np.int32)
    tprompt = torch.from_numpy(prompt).long()
    want = np.asarray(jT.forward(jparams, {"tokens": jnp.asarray(prompt)}, jcfg))
    np.testing.assert_allclose(tT.forward(tparams, tprompt, tcfg).numpy(), want,
                               atol=ATOL)
    # attn_chunk dividing S: the online-softmax path, against the JAX one
    jchunk = np.asarray(jT.forward(jparams, {"tokens": jnp.asarray(prompt)},
                                   jcfg.replace(attn_chunk=4)))
    np.testing.assert_allclose(
        tT.forward(tparams, tprompt, tcfg.replace(attn_chunk=4)).numpy(), jchunk,
        atol=ATOL)

    s_max = 16
    start = np.array([0, 3], np.int32)
    jc = jT.init_caches(jcfg, 2, s_max, dtype=jnp.float32)
    tc = tT.init_caches(tcfg, 2, s_max, dtype=torch.float32, device="cpu")
    jl, jc = jT.decode_step(jparams, jnp.asarray(prompt), jc, jnp.int32(0), jcfg,
                            start=jnp.asarray(start))
    tl, tc = tT.decode_step(tparams, tprompt, tc, 0, tcfg,
                            start=torch.from_numpy(start).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    index = np.array([8, 8], np.int32)
    for step in range(2):
        tok = rng.integers(1, jcfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jT.decode_step(jparams, jnp.asarray(tok), jc, jnp.asarray(index),
                                jcfg, start=jnp.asarray(start))
        tl, tc = tT.decode_step(tparams, torch.from_numpy(tok).long(), tc,
                                torch.from_numpy(index).long(), tcfg,
                                start=torch.from_numpy(start).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        index = index + np.array([1, 1 + step], np.int32)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=ATOL)
