"""Serving: the port's generate() against the JAX package's (greedy
prefix under mode="cim"), the port's fused batcher against its own
generate() (exact under act_scale="per_row"), batcher bookkeeping, and
the stored-plane path (prepare_for_spec byte-identical to the JAX
package; execute_packed on the prepared planes == execute)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.execution import CiMExecSpec as JSpec
from repro.models import transformer as jT
from repro.models.registry import get_config as jget_config
from repro.quant.prepare import prepare_for_spec as jprepare
from repro.serve.engine import generate as jgenerate
from repro_torch import api
from repro_torch.bridge import params_from_numpy
from repro_torch.core import execution
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.models.registry import get_config
from repro_torch.quant.prepare import prepare_for_spec, tree_paths
from repro_torch.serve.engine import ContinuousBatcher, Request, generate

PACKED_SPEC = api.CiMExecSpec("blocked", "cuda", "bitplane_u8")


def _jax_params(dtype):
    jcfg = jget_config("smollm-135m", smoke=True).replace(dtype=dtype)
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    tcfg = get_config("smollm-135m", smoke=True).replace(dtype=dtype)
    return jcfg, jparams, tcfg, params_from_numpy(tree, tcfg, device="cpu")


def _per_row(cfg):
    return cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))


@pytest.fixture(scope="module")
def port_model():
    cfg = _per_row(get_config("smollm-135m", smoke=True))
    return cfg, tT.init_params(cfg, seed=0, device="cpu")


def test_generate_greedy_prefix_matches_jax():
    """mode="cim" (the config's own), bf16: a float ulp can flip an
    activation code, so the bound is a greedy prefix of 4 of 8 tokens."""
    jcfg, jparams, tcfg, tparams = _jax_params("bfloat16")
    prompt = np.array([[5, 17, 33, 2, 90]], np.int32)
    want = np.asarray(jgenerate(jparams, jnp.asarray(prompt), jcfg, max_new=8,
                                s_max=32))[0]
    got = generate(tparams, prompt, tcfg, max_new=8, s_max=32, device="cpu")[0].numpy()
    assert np.array_equal(got[:4], want[:4]), (got, want)


def _requests():
    return [Request(i, [1 + (i * 7 + j) % 250 for j in range(1 + i % 5)],
                    max_new=3 + i % 4) for i in range(6)]


@pytest.mark.parametrize("exec_spec", [None, api.CiMExecSpec("blocked", "cuda")],
                         ids=["auto", "blocked-cuda"])
def test_fused_batcher_matches_generate(port_model, exec_spec):
    cfg, params = port_model
    batcher = ContinuousBatcher(params, cfg, n_slots=3, s_max=32,
                                exec_spec=exec_spec, device="cpu")
    reqs = _requests()
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    stats = batcher.stats()
    assert stats["host_syncs"] == stats["decode_steps"] + stats["prefill_batches"]
    for r in reqs:
        assert r.done and not r.truncated
        want = generate(params, [r.prompt], cfg, max_new=r.max_new, s_max=32,
                        exec_spec=exec_spec, device="cpu")[0].tolist()
        assert r.generated == want, r.rid


def test_truncated_at_exact_s_max(port_model):
    cfg, params = port_model
    s_max = 8
    batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=s_max, device="cpu")
    req = Request(0, [3, 4, 5], max_new=20)     # prefill pads to 4 slots
    batcher.submit(req)
    batcher.run()
    assert req.done and req.truncated
    # first token from prefill, then one per free cache slot 4..7
    assert len(req.generated) == 1 + (s_max - 4)
    # a prompt of s_max - 1 tokens (the pow2 bucket falls back to the exact
    # length) leaves exactly one decode slot
    edge = Request(1, list(range(1, s_max)), max_new=5)
    batcher.submit(edge)
    batcher.run()
    assert edge.truncated and len(edge.generated) == 2
    with pytest.raises(ValueError):
        batcher.submit(Request(2, list(range(1, s_max + 1)), max_new=2))


def test_cancel(port_model):
    cfg, params = port_model
    batcher = ContinuousBatcher(params, cfg, n_slots=1, s_max=32, device="cpu")
    a, b, c = (Request(i, [1 + i, 2], max_new=6) for i in range(3))
    for r in (a, b, c):
        batcher.submit(r)
    assert batcher.cancel(2) and c.cancelled and c.done and not c.generated
    batcher.step()
    batcher.step()
    assert batcher.cancel(0) and a.cancelled and a.truncated
    assert 1 <= len(a.generated) < 6
    assert not batcher.cancel(0) and not batcher.cancel(99)
    batcher.run()
    assert b.done and not b.cancelled and len(b.generated) == 6
    want = generate(params, [b.prompt], cfg, max_new=6, s_max=32, device="cpu")
    assert b.generated == want[0].tolist()


def test_prepare_for_spec_bytes_match_jax():
    jcfg, jparams, tcfg, tparams = _jax_params("float32")
    jfolded, jpacked = jprepare(jparams, JSpec("blocked", "pallas", "bitplane_u8"))
    tfolded, tpacked = prepare_for_spec(tparams, PACKED_SPEC)
    assert set(tpacked) == set(jpacked)
    for path, planes in tpacked.items():
        jp = jpacked[path]
        assert (planes.k, planes.n, planes.layout_version) == (jp.k, jp.n, jp.layout_version)
        assert planes.pos.shape[-2] % 32 == 0 and planes.pos.shape[-1] % 128 == 0
        np.testing.assert_array_equal(planes.pos.numpy(), np.asarray(jp.pos))
        np.testing.assert_array_equal(planes.neg.numpy(), np.asarray(jp.neg))
        np.testing.assert_allclose(planes.scale.numpy(), np.asarray(jp.scale), rtol=1e-6)
    jflat = dict((p, np.asarray(a)) for p, a in zip(
        [p for p, _ in tree_paths(tfolded)], jax.tree_util.tree_leaves(jfolded)))
    for path, leaf in tree_paths(tfolded):
        np.testing.assert_allclose(leaf.numpy(), jflat[path], rtol=1e-6)


def test_prepared_batcher_planes_equal_execute(port_model):
    cfg, params = port_model
    batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=32,
                                exec_spec=PACKED_SPEC, prepare_weights=True,
                                device="cpu")
    assert batcher.cfg.quant.exec_spec.packing == "none"
    assert batcher.cfg.quant.pre_quantized
    for r in _requests()[:3]:
        batcher.submit(r)
    batcher.run()
    rng = np.random.default_rng(0)
    folded = dict(tree_paths(batcher.params))
    for path, planes in batcher.packed.items():
        for layer in range(cfg.n_layers):
            one = planes.layer(layer)
            w = folded[path][layer]
            codes = w / torch.clamp(w.abs().amax(dim=0, keepdim=True), min=1e-12)
            for m in (4, 16):
                x = torch.from_numpy(rng.integers(-1, 2, (m, one.k)).astype(np.float32))
                got = api.execute_packed(PACKED_SPEC, x, one)
                want = api.execute(api.CiMExecSpec("blocked", "cuda"), x, codes.float())
                assert torch.equal(got, want), (path, layer, m)


@pytest.mark.parametrize("backend", ["cuda", "auto"])
def test_prepared_batcher_without_dense_kernel_raises(port_model, backend,
                                                       monkeypatch):
    # exact/cuda/none is registered (kernel #5), so the exact spec's dense
    # path is served through it (auto on CPU operands is the plain
    # formulation, by design)
    cfg, params = port_model
    spec = api.CiMExecSpec("exact", backend, "bitplane_u8")
    batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=32,
                                exec_spec=spec, prepare_weights=True,
                                device="cpu")
    assert batcher.cfg.quant.exec_spec.name == f"exact/{backend}/none"
    assert batcher.packed
    # with no dense kernel for the formulation on this device, neither
    # under the spec's backend nor under auto, the batcher refuses the
    # spec instead of serving something else
    for key in (("exact", "cuda", "none"), ("exact", "torch", "none")):
        monkeypatch.delitem(execution._REGISTRY, key)
    with pytest.raises(KeyError, match="exact/torch/none"):
        ContinuousBatcher(params, cfg, n_slots=2, s_max=32, exec_spec=spec,
                          prepare_weights=True, device="cpu")


def test_dense_pre_quantized_codes_exact():
    w = torch.randn((32, 8), generator=torch.Generator().manual_seed(0))
    t, s = tL.tern.ternarize(w, axis=(0,))
    qc = tL.QuantConfig(mode="cim", pre_quantized=True)
    codes, sw = tL._weight_codes((t * s).to(torch.bfloat16), qc)
    assert torch.equal(codes.float(), t)
