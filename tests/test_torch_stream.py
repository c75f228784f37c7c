"""The streaming stored-plane path in the port against the JAX package:
kernel #3's plain version (``packed_cim_matmul_decode_stream``) against
the Pallas stream kernel in interpret mode and the port's decode plain
version, the ``cuda_stream`` specs (registry, tiles, canonical layout,
``execute_packed`` on both plane layouts), layout-1 planes from
``prepare_for_spec``, and a prepared batcher under the stream spec. On
the CPU the wrapper runs the plain version; ``tests/test_torch_cuda.py``
holds the CUDA kernel against it on the card. Every MAC comparison has
tolerance 0 (exact integers). Mirrors ``tests/test_stream_decode.py``
and ``tests/test_decode_fastpath.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import ternary as jt
from repro.kernels import packed_mac as jpm
from repro.models import transformer as jT
from repro.models.registry import get_config as jget_config
from repro.quant.prepare import prepare_for_spec as jprepare
from repro_torch import api
from repro_torch.bridge import params_from_numpy
from repro_torch.core import ternary as tt
from repro_torch.kernels import packed_mac as pm
from repro_torch.models import transformer as tT
from repro_torch.models.registry import get_config
from repro_torch.quant.prepare import prepare_for_spec, tree_paths
from repro_torch.serve.engine import ContinuousBatcher, Request, generate
from torch_threads import one_thread  # noqa: F401

STREAM = {f: api.CiMExecSpec(f, "cuda_stream", "bitplane_u8")
          for f in ("blocked", "exact")}


def _tern(rng, shape, p_zero=0.1):
    vals = rng.choice([-1, 1], size=shape) * (rng.random(shape) >= p_zero)
    return vals.astype(np.int8)


def _planes(w):
    """JAX and port (pos, neg) planes of the same int8 weight."""
    j1, j2 = jt.pack_ternary(jnp.asarray(w), axis=0)
    return (j1, j2), (torch.from_numpy(np.array(j1)), torch.from_numpy(np.array(j2)))


@pytest.mark.parametrize("nbuf", [2, 3])
@pytest.mark.parametrize("cim", [True, False], ids=["blocked", "exact"])
@pytest.mark.parametrize("m", [1, 2, 3, 5, 7, 8])
def test_stream_plain_matches_pallas_and_decode(m, cim, nbuf):
    """Two K tiles, decode M: the Pallas stream kernel (interpret) ==
    the port's stream plain version == the port's decode plain version."""
    rng = np.random.default_rng(100 * m + 10 * cim + nbuf)
    x, w = _tern(rng, (m, 512)), _tern(rng, (512, 128))
    (j1, j2), (p1, p2) = _planes(w)
    want = jpm.packed_cim_matmul_decode_stream(
        jnp.asarray(x), jt.interleave_planes(j1, j2), cim=cim, nbuf=nbuf,
        interpret=True)
    before = pm.packed_cim_matmul_decode_stream.launches
    got = pm.packed_cim_matmul_decode_stream(
        torch.from_numpy(x), tt.interleave_planes(p1, p2), cim=cim, nbuf=nbuf)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    decode = pm.packed_cim_matmul_decode(torch.from_numpy(x), p1, p2, cim=cim)
    np.testing.assert_array_equal(got.numpy(), decode.numpy())
    assert pm.packed_cim_matmul_decode_stream.launches == before  # no launch


@pytest.mark.parametrize("nbuf", [2, 3])
@pytest.mark.parametrize("cim", [True, False], ids=["blocked", "exact"])
def test_stream_plain_matches_pallas_on_overlapping_planes(cim, nbuf):
    """An interleaved array of independent pos and neg byte-rows, so many
    weights have both bits set (pos - neg = 0 in the reference): the
    Pallas stream kernel (interpret) == the port's stream plain version
    == the port's decode plain version, tolerance 0."""
    rng = np.random.default_rng(40 + 2 * cim + nbuf)
    x = _tern(rng, (5, 512))
    wi = rng.integers(0, 256, (128, 128), dtype=np.uint8)
    assert (wi[0::2] & wi[1::2]).any()
    want = jpm.packed_cim_matmul_decode_stream(jnp.asarray(x), jnp.asarray(wi),
                                               cim=cim, nbuf=nbuf, interpret=True)
    got = pm.packed_cim_matmul_decode_stream(torch.from_numpy(x),
                                             torch.from_numpy(wi), cim=cim, nbuf=nbuf)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    decode = pm.packed_cim_matmul_decode(torch.from_numpy(x),
                                         *tt.deinterleave_planes(torch.from_numpy(wi)),
                                         cim=cim)
    np.testing.assert_array_equal(got.numpy(), decode.numpy())


def test_stream_single_k_tile():
    rng = np.random.default_rng(9)
    x, w = _tern(rng, (4, 256)), _tern(rng, (256, 128))
    (j1, j2), (p1, p2) = _planes(w)
    want = jpm.packed_cim_matmul_decode_stream(
        jnp.asarray(x), jt.interleave_planes(j1, j2), interpret=True)
    got = pm.packed_cim_matmul_decode_stream(torch.from_numpy(x),
                                             tt.interleave_planes(p1, p2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stream_plain_short_x_and_n_out():
    """x shorter than the planes' K reads as zero-extended and n_out
    keeps the logical columns of canonically padded layout-1 planes."""
    rng = np.random.default_rng(11)
    x, w = _tern(rng, (5, 40)), _tern(rng, (40, 20))
    wz = np.zeros((256, 128), np.int8)
    wz[:40, :20] = w
    _, (p1, p2) = _planes(wz)
    got = pm.packed_cim_matmul_decode_stream(
        torch.from_numpy(x), tt.interleave_planes(p1, p2), n_out=20)
    want = pm.packed_cim_matmul_decode(torch.from_numpy(x), p1, p2, n_out=20)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got.shape == (5, 20)


def test_stream_wrapper_rejects_bad_inputs():
    x = torch.zeros((4, 256), dtype=torch.int8)
    wi = torch.zeros((64, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="buffer depth"):
        pm.packed_cim_matmul_decode_stream(x, wi, nbuf=4)
    with pytest.raises(ValueError, match="block=16"):
        pm.packed_cim_matmul_decode_stream(x, wi, block=8)
    with pytest.raises(ValueError, match="M <= 8"):
        pm.packed_cim_matmul_decode_stream(torch.zeros((9, 256), dtype=torch.int8), wi)
    with pytest.raises(ValueError, match="even row count"):
        pm.packed_cim_matmul_decode_stream(x, wi[:63])
    with pytest.raises(TypeError, match="int8"):
        pm.packed_cim_matmul_decode_stream(x.float(), wi)
    with pytest.raises(ValueError, match="exceeds"):
        pm.packed_cim_matmul_decode_stream(torch.zeros((2, 512), dtype=torch.int8), wi)


def test_stream_registry_tiles_and_layout_match_jax():
    names = {s.name for s in api.registered_specs()}
    assert {"exact/cuda/none", "exact/cuda_stream/bitplane_u8",
            "blocked/cuda_stream/bitplane_u8"} <= names
    assert "cuda_stream" in api.BACKENDS
    for f, spec in STREAM.items():
        jspec = japi.CiMExecSpec(f, "pallas_stream", "bitplane_u8")
        assert api.get_backend(spec).clamps == japi.get_backend(jspec).clamps
        for m in (1, 4, 8, 9, 128, 300):
            assert api.tiles_for(spec, m, 576, 1536) == japi.tiles_for(jspec, m, 576, 1536)
        assert api.canonical_plane_layout(spec) == japi.canonical_plane_layout(jspec)
    assert api.tiles_for(STREAM["blocked"], 4, 576, 576) == (8, 256, 128, 2)


def _stored(w, version):
    """JAX and port PackedPlanes of the same canonical (256, 128)-padded
    planes, in plane layout ``version``."""
    wp = np.zeros((-(-w.shape[0] // 256) * 256, 128), np.int8)
    wp[: w.shape[0], : w.shape[1]] = w
    (j1, j2), (p1, p2) = _planes(wp)
    k, n, ones = w.shape[0], w.shape[1], np.ones((1, w.shape[1]), np.float32)
    if version == tt.PLANE_LAYOUT_STREAM:
        ji, ti = jt.interleave_planes(j1, j2), tt.interleave_planes(p1, p2)
        return (jt.PackedPlanes(ji, ji[..., :0, :], jnp.asarray(ones), k=k, n=n,
                                layout_version=version),
                tt.PackedPlanes(ti, ti[..., :0, :], torch.from_numpy(ones), k=k,
                                n=n, layout_version=version))
    return (jt.PackedPlanes(j1, j2, jnp.asarray(ones), k=k, n=n),
            tt.PackedPlanes(p1, p2, torch.from_numpy(ones), k=k, n=n))


@pytest.mark.parametrize("version", [tt.PLANE_LAYOUT_LEGACY, tt.PLANE_LAYOUT_STREAM])
@pytest.mark.parametrize("formulation", ["blocked", "exact"])
def test_execute_packed_stream_matches_jax(formulation, version):
    """Ragged decode M and M=128 (the prefill delegate), both layouts,
    against JAX under pallas_stream; raw planes too."""
    rng = np.random.default_rng(21 + version)
    k, n = 300, 19
    w = _tern(rng, (k, n))
    jplanes, tplanes = _stored(w, version)
    jspec = japi.CiMExecSpec(formulation, "pallas_stream", "bitplane_u8")
    for lead in ((1,), (3,), (5,), (7,), (2, 4), (128,)):
        x = _tern(rng, lead + (k,)).astype(np.float32)
        want = np.asarray(japi.execute_packed(jspec, jnp.asarray(x), jplanes))
        got = api.execute_packed(STREAM[formulation], torch.from_numpy(x), tplanes)
        assert got.shape == lead + (n,)
        np.testing.assert_array_equal(got.numpy(), want)
    x = _tern(rng, (4, 512)).astype(np.float32)
    raw = api.execute_packed(STREAM[formulation], torch.from_numpy(x),
                             *tplanes.planes())
    want = japi.execute_packed(jspec, jnp.asarray(x), *jplanes.planes())
    np.testing.assert_array_equal(raw.numpy(), np.asarray(want))


def _jax_params():
    jcfg = jget_config("smollm-135m", smoke=True).replace(dtype="float32")
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    tcfg = get_config("smollm-135m", smoke=True).replace(dtype="float32")
    return jparams, params_from_numpy(tree, tcfg, device="cpu")


@pytest.mark.parametrize("formulation", ["blocked", "exact"])
def test_prepare_for_spec_stream_layout_matches_jax(formulation):
    jparams, tparams = _jax_params()
    _, jpacked = jprepare(jparams, japi.CiMExecSpec(formulation, "pallas_stream",
                                                    "bitplane_u8"))
    _, tpacked = prepare_for_spec(tparams, STREAM[formulation])
    assert set(tpacked) == set(jpacked)
    for path, planes in tpacked.items():
        jp = jpacked[path]
        assert planes.layout_version == jp.layout_version == tt.PLANE_LAYOUT_STREAM
        assert (planes.k, planes.n) == (jp.k, jp.n)
        assert planes.pos.is_contiguous() and planes.neg.shape[-2] == 0
        np.testing.assert_array_equal(planes.pos.numpy(), np.asarray(jp.pos))
        np.testing.assert_allclose(planes.scale.numpy(), np.asarray(jp.scale), rtol=1e-6)


def test_prepared_stream_batcher():
    """A prepared batcher under the stream spec: layout-1 planes, the
    in-model dense path under auto, fused == generate(), and
    execute_packed on its planes == the */cuda/bitplane_u8 spec ==
    execute on the folded weights."""
    cfg = get_config("smollm-135m", smoke=True)
    cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))
    params = tT.init_params(cfg, seed=0, device="cpu")
    batcher = ContinuousBatcher(params, cfg, n_slots=3, s_max=32,
                                exec_spec=STREAM["blocked"], prepare_weights=True,
                                device="cpu")
    assert batcher.cfg.quant.exec_spec.name == "blocked/auto/none"
    assert batcher.cfg.quant.pre_quantized
    assert batcher.packed and all(p.layout_version == tt.PLANE_LAYOUT_STREAM
                                  for p in batcher.packed.values())
    reqs = [Request(i, [1 + (i * 7 + j) % 250 for j in range(1 + i % 5)],
                    max_new=3 + i % 4) for i in range(5)]
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    for r in reqs:
        want = generate(batcher.params, [r.prompt], batcher.cfg, max_new=r.max_new,
                        s_max=32, device="cpu")[0].tolist()
        assert r.done and r.generated == want, r.rid
    rng = np.random.default_rng(0)
    folded = dict(tree_paths(batcher.params))
    for path, planes in batcher.packed.items():
        for layer in range(cfg.n_layers):
            one = planes.layer(layer)
            w = folded[path][layer]
            codes = w / torch.clamp(w.abs().amax(dim=0, keepdim=True), min=1e-12)
            for m in (1, 8, 16):
                x = torch.from_numpy(rng.integers(-1, 2, (m, one.k)).astype(np.float32))
                for f, spec in STREAM.items():
                    got = api.execute_packed(spec, x, one)
                    twin = api.execute_packed(api.CiMExecSpec(f, "cuda", "bitplane_u8"),
                                              x, one)
                    dense = api.execute(api.CiMExecSpec(f, "cuda"), x, codes.float())
                    assert torch.equal(got, twin) and torch.equal(got, dense), \
                        (path, layer, m, f)
