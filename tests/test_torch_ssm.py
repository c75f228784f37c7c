"""Differential tests of the port's mamba2 layer (``models/ssm.py``)
against the JAX package's on the same numpy-seeded inputs and bridged
params (f32, atol 1e-5 as in ``test_torch_models.py``: the sums run in
another order in the two frameworks): the causal conv and silu (also
bit for bit in bf16), softplus, ``_ssd_chunked`` (atol 1e-5 on inputs
at the block's own scale, measured max |err| 1.2e-6; on strong-decay
inputs whose outputs reach 85-178 the f32 error of the exp-sums grows
with them: measured 1.5e-5 to 2.8e-5, held at atol 1e-4),
``mamba2_block`` without a cache (S a whole chunk and padded) and with
one (S = 1, and S = 4 with a left-pad ``valid`` mask; outputs and both
cache leaves), cached prefill against stepwise decode, the CiM dense
layer on the block's weights, the bridge's f32 leaves, and the configs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.execution import CiMExecSpec as JSpec
from repro.models import layers as jL
from repro.models import ssm as jS
from repro.models import transformer as jT
from repro.models.registry import get_config as jget_config
from repro_torch.bridge import params_from_numpy
from repro_torch.models import layers as tL
from repro_torch.models import ssm as tS
from repro_torch.models import transformer as tT
from repro_torch.models.registry import ARCH_IDS, get_config
from torch_threads import one_thread  # noqa: F401

ATOL = 1e-5
ARCHS = ("mamba2-780m", "zamba2-2.7b")
# full-size (n_layers, d_model, d_inner, ssm heads, head dim, state, vocab)
WIDTHS = {"mamba2-780m": (48, 1536, 3072, 48, 64, 128, 50280),
          "zamba2-2.7b": (54, 2560, 5120, 80, 64, 64, 32000)}
# the reference's own band (tests/test_models.py::test_param_counts_in_range)
BANDS = {"mamba2-780m": (0.6e9, 1.0e9), "zamba2-2.7b": (2.0e9, 3.4e9)}


def _tree(jparams):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)


@pytest.fixture(scope="module")
def layer():
    """Layer 0's mamba params of the f32 mamba2 smoke model, both sides."""
    jcfg = jget_config("mamba2-780m", smoke=True).replace(dtype="float32")
    jcfg = jcfg.replace(quant=dataclasses.replace(jcfg.quant, mode="off"))
    tcfg = get_config("mamba2-780m", smoke=True).replace(dtype="float32")
    tcfg = tcfg.replace(quant=dataclasses.replace(tcfg.quant, mode="off"))
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(_tree(jparams), tcfg, device="cpu")
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["mamba"])
    return jcfg, tcfg, jp, tT.layer_params(tparams["blocks"], 0)["mamba"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_and_silu_match_jax(dtype):
    rng = np.random.default_rng(0)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((2, 11, 40), (4, 40), (40,)))
    jx, jw, jb = (jnp.asarray(a, dtype) for a in (x, w * 0.5, b))
    tx, tw, tb = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype))
                  for a in (jx, jw, jb))
    conv = tS._causal_conv(tx, tw, tb)
    np.testing.assert_array_equal(conv.float().numpy(),
                                  np.asarray(jS._causal_conv(jx, jw, jb).astype(jnp.float32)))
    got, want = tL.silu(tx).float().numpy(), np.asarray(jax.nn.silu(jx).astype(jnp.float32))
    if dtype == "bfloat16":   # stepwise bf16 rounding: bit for bit
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_softplus_is_jax_logaddexp():
    """The port's softplus (JAX's logaddexp(x, 0) formula) against
    jax.nn.softplus over [-120, 120] and the extremes: within one ulp
    (measured 2.4e-7 at x = 2.35; the exp/log1p implementations differ),
    values below f32's normal range aside, which XLA flushes to zero."""
    v = np.concatenate([np.linspace(-120, 120, 20001),
                        [-1e30, 1e30, 19.9, 20.0, 20.1, 0.0, -0.0]]).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(v)))
    got = tS.softplus(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=np.finfo(np.float32).tiny)
    assert got[-5:-2].tolist() == want[-5:-2].tolist()   # about the threshold of 20


def _ssd_inputs(rng, b, l, h, p, g, n, scale):
    x = (rng.standard_normal((b, l, h, p)) * scale).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)) - 1.0)).astype(np.float32)
    if scale > 1:   # strong decay: |dt| ~ 1
        dt = np.abs(rng.standard_normal((b, l, h))).astype(np.float32)
    a = (-np.exp(np.log(np.linspace(1.0, 16.0, h)))).astype(np.float32)
    bb, cc = ((rng.standard_normal((b, l, g, n)) * scale).astype(np.float32) for _ in "BC")
    d = rng.standard_normal((h,)).astype(np.float32)
    return x, dt, a, bb, cc, d


@pytest.mark.parametrize("scale", [0.5, 1.5], ids=["block_scale", "strong_decay"])
@pytest.mark.parametrize("l,chunk,g", [(16, 8, 1), (24, 8, 2), (16, 16, 1)])
def test_ssd_chunked_matches_jax(l, chunk, g, scale):
    rng = np.random.default_rng(l + chunk + g)
    args = _ssd_inputs(rng, 2, l, 4, 8, g, 16, scale)
    jy, jh = jS._ssd_chunked(*(jnp.asarray(a) for a in args), chunk)
    ty, th = tS._ssd_chunked(*(torch.from_numpy(a) for a in args), chunk)
    jy, jh = np.asarray(jy), np.asarray(jh)
    tol = ATOL if scale < 1 else 1e-4
    np.testing.assert_allclose(ty.numpy(), jy, atol=tol)
    np.testing.assert_allclose(th.numpy(), jh, atol=tol)


@pytest.mark.parametrize("s", [16, 11], ids=["whole_chunks", "padded"])
def test_mamba2_block_without_cache_matches_jax(layer, s):
    jcfg, tcfg, jp, tp = layer
    x = np.random.default_rng(s).standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    want, wc = jS.mamba2_block(jp, jnp.asarray(x), jcfg)
    got, tc = tS.mamba2_block(tp, torch.from_numpy(x), tcfg)
    assert wc is None and tc is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("s,padded", [(1, False), (4, True)], ids=["decode", "left_pad"])
def test_mamba2_block_with_cache_matches_jax(layer, s, padded):
    """From a nonzero cache: the output and both cache leaves; the port's
    leaves are written in place."""
    jcfg, tcfg, jp, tp = layer
    rng = np.random.default_rng(7 + s)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    zero = jS.SSMCache.zeros(2, jcfg)
    conv, state = (rng.standard_normal(a.shape).astype(np.float32) * 0.3 for a in zero)
    valid = None
    if padded:
        valid = np.array([[True] * s, [False, False] + [True] * (s - 2)])
    want, jc = jS.mamba2_block(jp, jnp.asarray(x), jcfg,
                               jS.SSMCache(jnp.asarray(conv), jnp.asarray(state)),
                               valid=None if valid is None else jnp.asarray(valid))
    tc = tS.SSMCache(torch.from_numpy(conv.copy()), torch.from_numpy(state.copy()))
    ptrs = [a.data_ptr() for a in tc]
    got, tc2 = tS.mamba2_block(tp, torch.from_numpy(x), tcfg, tc,
                               valid=None if valid is None else torch.from_numpy(valid))
    assert tc2 is tc and [a.data_ptr() for a in tc] == ptrs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(tc.conv.numpy(), np.asarray(jc.conv), atol=ATOL)
    np.testing.assert_allclose(tc.state.numpy(), np.asarray(jc.state), atol=ATOL)


def test_mamba2_cached_prefill_matches_stepwise():
    """The reference's test_serve.py::test_mamba2_cached_prefill_matches_stepwise
    held in the port: decode_step with S = 4 from empty caches == four
    S = 1 steps, in logits and in every cache leaf (bf16, mode off)."""
    cfg = get_config("mamba2-780m", smoke=True)
    cfg = cfg.replace(quant=tL.QuantConfig(mode="off"))
    params = tT.init_params(cfg, seed=0, device="cpu")
    prompt = torch.tensor([[5, 9, 2, 7]])
    c_pf = tT.init_caches(cfg, 1, 32, device="cpu")
    lg_pf, _ = tT.decode_step(params, prompt, c_pf, 0, cfg)
    c = tT.init_caches(cfg, 1, 32, device="cpu")
    for t in range(4):
        lg, _ = tT.decode_step(params, prompt[:, t:t + 1], c, t, cfg)
    np.testing.assert_allclose(lg_pf[:, -1:].float().numpy(), lg.float().numpy(),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(tT.cache_leaves(c_pf), tT.cache_leaves(c)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act_scale", ["per_tensor", "per_row"])
@pytest.mark.parametrize("name", ["w_in", "w_out"])
def test_dense_cim_on_mamba_weights_matches_jax(layer, name, act_scale):
    """mode="cim" through dense() on the block's own projections against
    the reference's jnp backend (the MAC counts are integers: rtol 1e-6
    covers the scale fold)."""
    _, _, jp, tp = layer
    w = tp[name].numpy()
    x = np.random.default_rng(3).standard_normal((2, 5, w.shape[0])).astype(np.float32)
    want = jL.dense(jnp.asarray(x), jnp.asarray(w), jL.QuantConfig(
        mode="cim", act_scale=act_scale, exec_spec=JSpec("blocked", "jnp")))
    got = tL.dense(torch.from_numpy(x), tp[name],
                   tL.QuantConfig(mode="cim", act_scale=act_scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_keeps_the_reference_f32_leaves(arch):
    """Under a bf16 config the reference keeps A_log, D and dt_bias in f32:
    the bridge carries them over exactly, casts every other leaf, and the
    port's own init_params reads the same list."""
    jcfg = jget_config(arch, smoke=True)
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = get_config(arch, smoke=True)
    tparams = params_from_numpy(_tree(jparams), tcfg, device="cpu")
    mamba = tparams["blocks"]["mamba"]
    for name in tS.F32_LEAVES:
        assert mamba[name].dtype == torch.float32, name
        np.testing.assert_array_equal(mamba[name].numpy(),
                                      np.asarray(jparams["blocks"]["mamba"][name]))
    assert mamba["w_in"].dtype == mamba["conv_w"].dtype == torch.bfloat16
    assert tparams["embed"].dtype == torch.bfloat16
    own = tT.init_params(tcfg, seed=0, device="cpu")["blocks"]["mamba"]
    assert {k for k, v in own.items() if v.dtype == torch.float32} == set(tS.F32_LEAVES)


def _same_fields(port, ref):
    for f in dataclasses.fields(port):
        mine, theirs = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "quant":
            _same_fields(mine, theirs)
        else:
            assert mine == theirs, (f.name, mine, theirs)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_count_match_jax(arch, smoke):
    assert arch in ARCH_IDS
    port, ref = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    _same_fields(port, ref)
    assert (port.ssm_d_inner, port.ssm_n_heads) == (ref.ssm_d_inner, ref.ssm_n_heads)
    assert port.param_count() == ref.param_count()
    if not smoke:
        assert (port.n_layers, port.d_model, port.ssm_d_inner, port.ssm_n_heads,
                port.ssm_head_dim, port.ssm_state, port.vocab) == WIDTHS[arch]
        lo, hi = BANDS[arch]
        assert lo < port.param_count() < hi


def test_ssm_cache_layout_and_bytes():
    """Stacked f32 leaves of their own storage; full-size bytes per slot
    are independent of s_max (mamba2-780m: conv 1,916,928 + state
    75,497,472)."""
    cfg = get_config("mamba2-780m")
    caches = tT.init_caches(cfg, 1, 256, device="meta")
    assert type(caches) is tS.SSMCache
    assert [a.dtype for a in caches] == [torch.float32] * 2
    assert caches.conv.shape == (48, 1, 3, 3072 + 128 + 128)
    assert caches.state.shape == (48, 1, 48, 64, 128)
    assert [a.numel() * 4 for a in caches] == [1_916_928, 75_497_472]
