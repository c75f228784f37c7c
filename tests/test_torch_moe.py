"""The port's MoE block (``models/moe.py``) against the JAX package's on
the same numpy inputs, weights carried across by
``bridge.params_from_numpy``, at smoke width: deepseek-v2 (8 experts,
top-2, one shared expert) and grok-1 (4 experts, top-2, none shared).

Tolerances: f32 atol 1e-5 (the port accumulates the router and the
expert products in float64, the reference in f32; the sums run in
another order). bf16 rtol 2^-7, atol 2^-10: one bf16 rounding step.
Called op by op, the reference rounds each product to bf16 as the port
does, and the two agree bit for bit on these inputs; the bound leaves
room for one rounding step taken the other way."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.registry import get_config as jget_config
from repro_torch.bridge import params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import get_config
from torch_threads import one_thread  # noqa: F401

ARCHS = ("deepseek-v2-236b", "grok-1-314b")
TOL = {"float32": dict(rtol=0, atol=1e-5),
       "bfloat16": dict(rtol=2.0 ** -7, atol=2.0 ** -10)}


def _pair(arch, dtype, mode, **fields):
    jcfg, tcfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jcfg = jcfg.replace(dtype=dtype, quant=dataclasses.replace(jcfg.quant, mode=mode),
                        **fields)
    tcfg = tcfg.replace(dtype=dtype, quant=dataclasses.replace(tcfg.quant, mode=mode),
                        **fields)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jparams = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jdt)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    tparams = params_from_numpy({"moe": tree}, tcfg, device="cpu")["moe"]
    return jcfg, tcfg, jparams, tparams


def _both(arch, dtype, mode, x, **fields):
    jcfg, tcfg, jparams, tparams = _pair(arch, dtype, mode, **fields)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(jmoe.moe_block(jparams, jnp.asarray(x).astype(jdt), jcfg),
                      np.float32)
    tx = torch.from_numpy(x).to(tdt)
    got = tmoe.moe_block(tparams, tx, tcfg)
    assert got.dtype == tdt and got.shape == tx.shape
    return got.float().numpy(), want, (tcfg, tparams, tx)


def _x(shape=(4, 16, 64), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["off", "cim"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax(arch, dtype, mode):
    """64 tokens under the config's capacity factor (nothing drops at
    smoke size), with the shared expert on (deepseek) and off (grok)."""
    got, want, (tcfg, tparams, _) = _both(arch, dtype, mode, _x())
    assert ("shared" in tparams) == (arch == "deepseek-v2-236b")
    assert tparams["router"].dtype == torch.float32
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_drops_the_same_assignments(arch, dtype):
    """A capacity factor of 0.25 leaves 8 rows an expert for 32 or 16
    assignments on average: tokens drop. The port's output equals the
    reference's, so it dropped the same (token, expert) assignments (a
    different drop would move a whole expert's contribution), and it
    differs from the undropped output where tokens lost an expert."""
    x = _x()
    got, want, (tcfg, tparams, tx) = _both(arch, dtype, "cim", x,
                                           moe_capacity_factor=0.25)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    _, slot, keep = tmoe.route(tparams, tx.reshape(-1, tcfg.d_model), tcfg)
    cap = tmoe.moe_capacity(x.shape[0] * x.shape[1], tcfg)
    assert cap == 8 and int((~keep).sum()) > 0
    assert bool((slot[~keep] == tcfg.n_experts * cap).all())
    # every expert filled its 8 rows, each row once, before dropping
    assert sorted(slot[keep].tolist()) == list(range(tcfg.n_experts * cap))
    full = tmoe.moe_block(tparams, tx, tcfg.replace(moe_capacity_factor=100.0))
    lost = (~keep).reshape(-1, tcfg.top_k).any(-1).reshape(x.shape[:2]).numpy()
    moved = np.abs(full.float().numpy() - got).max(-1) > 0
    assert np.array_equal(moved, lost)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tern3_matches_jax(dtype):
    """Equal codes; the per-(expert, out-channel) scales equal in bf16 and
    within f32's last-ulp sum order (rtol 1e-6, as the KV scales)."""
    w = np.random.default_rng(1).standard_normal((3, 48, 20)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(jmoe._tern3(jnp.asarray(w).astype(jdt)), np.float32)
    got = tmoe._tern3(torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt
    got = got.float().numpy()
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    np.testing.assert_allclose(got, want, rtol=1e-6 if dtype == "float32" else 0)
    # one nonzero magnitude per (expert, out-channel)
    mags = np.where(want == 0, np.nan, np.abs(want))
    assert np.allclose(np.nanmin(mags, axis=1), np.nanmax(mags, axis=1), rtol=0)


@pytest.mark.parametrize("arch", ARCHS + ("deepseek-v2-236b/full", "grok-1-314b/full"))
def test_moe_capacity_matches_jax_at_the_boundaries(arch):
    """Equal to the reference's for every token count up to past the
    first two steps above the floor of 8, which holds below them."""
    name, _, full = arch.partition("/")
    tcfg, jcfg = get_config(name, smoke=not full), jget_config(name, smoke=not full)
    caps = [tmoe.moe_capacity(t, tcfg) for t in range(1, 4097)]
    assert caps == [jmoe.moe_capacity(t, jcfg) for t in range(1, 4097)]
    e, k, cf = tcfg.n_experts, tcfg.top_k, tcfg.moe_capacity_factor
    first9 = caps.index(9) + 1
    assert caps[0] == 8 and set(caps[:first9 - 1]) == {8}
    assert int(first9 * k * cf / e) == 9 > int((first9 - 1) * k * cf / e)
    assert caps == sorted(caps) and caps[-1] == int(4096 * k * cf / e)


def test_expert_chunks_do_not_change_the_result(monkeypatch):
    """The float64 products go through the experts in chunks bounded by
    CHUNK_BYTES; one expert a chunk gives the same output as all at
    once (ternarization is per expert)."""
    x = _x()
    _, tcfg, _, tparams = _pair("deepseek-v2-236b", "bfloat16", "cim")
    tx = torch.from_numpy(x).to(torch.bfloat16)
    whole = tmoe.moe_block(tparams, tx, tcfg)
    monkeypatch.setattr(tmoe, "CHUNK_BYTES", 1)
    assert torch.equal(tmoe.moe_block(tparams, tx, tcfg), whole)


def test_combine_is_batch_invariant():
    """A token's output does not depend on its batchmates, nor on where
    it sits in the buffer or on cap: each of 8 tokens alone (cap 8)
    equals its row of the 8-token batch (under a capacity factor large
    enough that nothing drops either way)."""
    _, tcfg, _, tparams = _pair("grok-1-314b", "bfloat16", "cim",
                                moe_capacity_factor=4.0)
    tx = torch.from_numpy(_x((1, 8, 64), seed=2)).to(torch.bfloat16)
    batch = tmoe.moe_block(tparams, tx, tcfg)
    for i in range(8):
        assert torch.equal(tmoe.moe_block(tparams, tx[:, i:i + 1], tcfg),
                           batch[:, i:i + 1]), i
