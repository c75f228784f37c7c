"""The near-memory baseline in the port against the JAX package: kernel
#5's plain version (``ternary_exact_matmul``) against the Pallas kernel in
interpret mode and the exact oracle, the ``exact/cuda/none`` spec, the
operands ``dense`` gives it, a decode step of the smoke model, and fused
serving under ``exact/cuda``. On the CPU the wrapper runs the plain
version; ``tests/test_torch_cuda.py`` holds the CUDA kernel against it
on the card. Every MAC comparison has tolerance 0 (exact integers)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels import ternary_mac as jtm
from repro.kernels.ref import ref_exact_matmul as jref_exact
from repro.models import transformer as jT
from repro.models.registry import get_config as jget_config
from repro_torch import api
from repro_torch.bridge import params_from_numpy
from repro_torch.core import execution
from repro_torch.kernels import ternary_mac as tm
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.models.registry import get_config
from repro_torch.serve.engine import ContinuousBatcher, Request, generate
from torch_threads import one_thread  # noqa: F401

NM = api.CiMExecSpec("exact", "cuda")


def _tern(rng, shape, p_zero=0.2):
    vals = rng.choice([-1, 1], size=shape) * (rng.random(shape) >= p_zero)
    return vals.astype(np.int8)


@pytest.mark.parametrize("m,bm", [(8, 8), (128, 128)])
def test_exact_plain_matches_pallas(m, bm):
    """One (bm, 512, 128) tile, the Pallas kernel's decode and prefill
    tiles; dense codes (|sum| up to 512) leave no room for rounding."""
    rng = np.random.default_rng(m)
    x, w = _tern(rng, (m, 512), 0.02), _tern(rng, (512, 128), 0.02)
    want = jtm.ternary_exact_matmul(jnp.asarray(x, jnp.bfloat16),
                                    jnp.asarray(w, jnp.bfloat16),
                                    bm=bm, bk=512, bn=128, interpret=True)
    before = tm.ternary_exact_matmul.launches
    got = tm.ternary_exact_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tm.ternary_exact_matmul.launches == before  # the plain path is no launch


@pytest.mark.parametrize("m,k,n", [(3, 40, 9), (13, 600, 70), (1, 1536, 5),
                                   (200, 576, 33)])
def test_exact_plain_ragged_matches_oracle(m, k, n):
    rng = np.random.default_rng(k + n)
    x, w = _tern(rng, (m, k)), _tern(rng, (k, n))
    got = tm.ternary_exact_matmul(torch.from_numpy(x), torch.from_numpy(w))
    want = jref_exact(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tm.exact_matmul_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        got.numpy())


def test_exact_wrapper_validates_inputs():
    x8 = torch.zeros((2, 32), dtype=torch.int8)
    w8 = torch.zeros((32, 4), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        tm.ternary_exact_matmul(x8.float(), w8)
    with pytest.raises(TypeError, match="int8"):
        tm.ternary_exact_matmul(x8, w8.to(torch.bfloat16))
    with pytest.raises(ValueError, match="need x"):
        tm.ternary_exact_matmul(x8, w8[:16])
    with pytest.raises(ValueError, match="need x"):
        tm.ternary_exact_matmul(x8[0], w8)


@pytest.mark.parametrize("lead", [(2, 3), (3, 7)], ids=["decode", "prefill"])
def test_exact_cuda_spec_matches_jax(lead):
    rng = np.random.default_rng(sum(lead))
    k, n = 45, 19                                  # ragged K and N
    x = _tern(rng, lead + (k,)).astype(np.float32)
    w = _tern(rng, (k, n)).astype(np.float32)
    got = api.execute(NM, torch.from_numpy(x), torch.from_numpy(w))
    want = japi.execute(japi.CiMExecSpec("exact", "pallas"), jnp.asarray(x),
                        jnp.asarray(w))
    assert got.shape == lead + (n,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_exact_cuda_registry_and_tiles_match_jax():
    entry = api.get_backend(NM)
    assert entry.clamps is False
    jspec = japi.CiMExecSpec("exact", "pallas")
    for m in (1, 8, 9, 300):
        assert api.tiles_for(NM, m, 576, 1536) == japi.tiles_for(jspec, m, 576, 1536)
    assert api.tiles_for(NM, 4, 576, 576) == (8, 512, 128)
    assert api.canonical_plane_layout(NM) == japi.canonical_plane_layout(jspec)


def test_dense_gives_cuda_backends_int8_weight_codes(monkeypatch):
    """exact/cuda gets int8 weight codes (1 B per weight into kernel #5),
    as clamping specs do, and the same result as exact/torch in f32."""
    seen = []
    real = execution.ternary_exact_matmul

    def spy(x, w, **kw):
        seen.append((x.dtype, w.dtype))
        return real(x, w, **kw)

    monkeypatch.setattr(execution, "ternary_exact_matmul", spy)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 4, 64)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((64, 24)) / 8).astype(np.float32))
    got = tL.dense(x, w, tL.QuantConfig(mode="cim", exec_spec=NM))
    assert seen == [(torch.int8, torch.int8)]
    want = tL.dense(x, w, tL.QuantConfig(mode="ternary"))   # exact/torch
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _nm_pair():
    jcfg = jget_config("smollm-135m", smoke=True)
    jcfg = jcfg.replace(dtype="float32", quant=dataclasses.replace(
        jcfg.quant, exec_spec=japi.CiMExecSpec("exact", "pallas")))
    tcfg = get_config("smollm-135m", smoke=True)
    tcfg = tcfg.replace(dtype="float32",
                        quant=dataclasses.replace(tcfg.quant, exec_spec=NM))
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, device="cpu")


def test_decode_step_exact_cuda_matches_jax_exact_pallas():
    """The slice end to end at smoke size, f32: every dense layer through
    kernel #5's plain version against the Pallas kernel in interpret
    mode; logits within 1e-5 (float code around the exact MACs sums in
    another order in the two frameworks)."""
    jcfg, tcfg, jparams, tparams = _nm_pair()
    rng = np.random.default_rng(6)
    prompt = rng.integers(1, jcfg.vocab, (2, 5)).astype(np.int32)
    jc = jT.init_caches(jcfg, 2, 16, dtype=jnp.float32)
    tc = tT.init_caches(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    jl, jc = jT.decode_step(jparams, jnp.asarray(prompt), jc, jnp.int32(0), jcfg)
    tl, tc = tT.decode_step(tparams, torch.from_numpy(prompt).long(), tc, 0, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    tok = rng.integers(1, jcfg.vocab, (2, 1)).astype(np.int32)
    jl, _ = jT.decode_step(jparams, jnp.asarray(tok), jc, jnp.int32(5), jcfg)
    tl, _ = tT.decode_step(tparams, torch.from_numpy(tok).long(), tc, 5, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


def test_nm_batcher_matches_generate():
    cfg = get_config("smollm-135m", smoke=True)
    cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))
    params = tT.init_params(cfg, seed=0, device="cpu")
    batcher = ContinuousBatcher(params, cfg, n_slots=3, s_max=32, exec_spec=NM,
                                device="cpu")
    assert batcher.cfg.quant.exec_spec == NM
    reqs = [Request(i, [1 + (i * 7 + j) % 250 for j in range(1 + i % 5)],
                    max_new=3 + i % 4) for i in range(5)]
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    st = batcher.stats()
    assert st["host_syncs"] == st["decode_steps"] + st["prefill_batches"]
    for r in reqs:
        want = generate(params, [r.prompt], cfg, max_new=r.max_new, s_max=32,
                        exec_spec=NM, device="cpu")[0].tolist()
        assert r.done and r.generated == want, r.rid
