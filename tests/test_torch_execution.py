"""Differential tests: repro_torch.core.execution against the JAX
package's execution API — every registered spec bit-exact with ragged K
and batched leading dims, execute_packed on both plane layouts, and the
spec / tile-table / canonical-layout metadata."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import ternary as jt
from repro_torch import api
from repro_torch.core import ternary as tt
from torch_threads import one_thread  # noqa: F401

# port backend -> the JAX backend computing the same function (the cuda
# entries run their kernels' plain versions on CPU tensors and are held
# against the Pallas kernels in interpret mode)
JAX_BACKEND = {"torch": "jnp", "cuda": "pallas", "cuda_stream": "pallas_stream"}

EXPECTED_KEYS = {
    "exact/torch/none", "blocked/torch/none", "corrected/torch/none",
    "bitplane/torch/none", "fused/torch/none", "exact/torch/bitplane_u8",
    "blocked/torch/bitplane_u8", "blocked/cuda/none",
    "blocked/cuda/bitplane_u8", "exact/cuda/bitplane_u8", "exact/cuda/none",
    "exact/cuda_stream/bitplane_u8", "blocked/cuda_stream/bitplane_u8",
}


def _tern(rng, shape, p_zero=0.1):
    vals = rng.choice([-1, 1], size=shape) * (rng.random(shape) >= p_zero)
    return vals.astype(np.float32)


def _jax_spec(spec):
    return japi.CiMExecSpec(formulation=spec.formulation,
                            backend=JAX_BACKEND[spec.backend],
                            packing=spec.packing)


def test_registry_keys():
    assert {s.name for s in api.registered_specs()} == EXPECTED_KEYS


@pytest.mark.parametrize("spec", list(api.registered_specs()), ids=lambda s: s.name)
def test_every_spec_matches_jax(spec):
    rng = np.random.default_rng(sum(map(ord, spec.name)))
    k, n = 45, 19                        # ragged K and N
    x = _tern(rng, (2, 3, k))            # batched leading dims, decode-class M
    w = _tern(rng, (k, n))
    got = api.execute(spec, torch.from_numpy(x), torch.from_numpy(w))
    want = japi.execute(_jax_spec(spec), jnp.asarray(x), jnp.asarray(w))
    assert got.shape == (2, 3, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_blocked_prefill_class_matches_jax(backend):
    rng = np.random.default_rng(3)
    x, w = _tern(rng, (3, 7, 48)), _tern(rng, (48, 21))   # M = 21 > 8
    spec = api.CiMExecSpec("blocked", backend)
    got = api.execute(spec, torch.from_numpy(x), torch.from_numpy(w))
    want = japi.execute(japi.CiMExecSpec("blocked", "jnp"), jnp.asarray(x),
                        jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _planes_pair(w, version):
    """The same canonical (256, 128)-padded planes for both packages."""
    wp = np.zeros((256, 128), np.int8)
    wp[: w.shape[0], : w.shape[1]] = w
    j1, j2 = jt.pack_ternary(jnp.asarray(wp), axis=0)
    jplanes = jt.PackedPlanes(j1, j2, jnp.ones((1, w.shape[1])), k=w.shape[0],
                              n=w.shape[1])
    p1, p2 = torch.from_numpy(np.array(j1)), torch.from_numpy(np.array(j2))
    if version == tt.PLANE_LAYOUT_STREAM:
        wi = tt.interleave_planes(p1, p2)
        tplanes = tt.PackedPlanes(wi, wi[..., :0, :], torch.ones((1, w.shape[1])),
                                  k=w.shape[0], n=w.shape[1], layout_version=version)
    else:
        tplanes = tt.PackedPlanes(p1, p2, torch.ones((1, w.shape[1])),
                                  k=w.shape[0], n=w.shape[1])
    return jplanes, tplanes


@pytest.mark.parametrize("version", [tt.PLANE_LAYOUT_LEGACY, tt.PLANE_LAYOUT_STREAM])
@pytest.mark.parametrize("formulation", ["blocked", "exact"])
def test_execute_packed_matches_jax(formulation, version):
    rng = np.random.default_rng(17)
    k, n = 40, 19
    w = _tern(rng, (k, n)).astype(np.int8)
    jplanes, tplanes = _planes_pair(w, version)
    jspec = japi.CiMExecSpec(formulation, "jnp", "bitplane_u8")
    for lead in ((2, 3), (3, 6)):            # M = 6 (decode), 18 (prefill)
        x = _tern(rng, lead + (k,))
        want = np.asarray(japi.execute_packed(jspec, jnp.asarray(x), jplanes))
        for backend in ("torch", "cuda"):
            spec = api.CiMExecSpec(formulation, backend, "bitplane_u8")
            got = api.execute_packed(spec, torch.from_numpy(x), tplanes)
            np.testing.assert_array_equal(got.numpy(), want)
    raw = api.execute_packed(api.CiMExecSpec(formulation, "cuda", "bitplane_u8"),
                             torch.from_numpy(_tern(rng, (4, 256))),
                             *tplanes.planes())
    assert raw.shape == (4, 128)


def test_execute_packed_rejects_bad_inputs():
    planes = tt.PackedPlanes(torch.zeros((2, 32, 128), dtype=torch.uint8),
                             torch.zeros((2, 32, 128), dtype=torch.uint8),
                             torch.ones((2, 1, 8)), k=40, n=8)
    spec = api.CiMExecSpec("blocked", "torch", "bitplane_u8")
    x = torch.zeros((3, 40))
    with pytest.raises(ValueError, match="slice one layer"):
        api.execute_packed(spec, x, planes)
    with pytest.raises(ValueError, match="mismatch"):
        api.execute_packed(spec, torch.zeros((3, 48)), planes.layer(0))
    with pytest.raises(ValueError, match="bitplane_u8"):
        api.execute_packed(api.CiMExecSpec("blocked", "torch"), x, planes.layer(0))
    with pytest.raises(ValueError, match="exact|blocked"):
        api.execute_packed(api.CiMExecSpec("bitplane", "torch", "bitplane_u8"), x,
                           planes.layer(0))


def test_spec_validation_and_resolution():
    for bad in (dict(formulation="nope"), dict(backend="pallas"),
                dict(packing="nibble"), dict(flavor="III"), dict(block=0),
                dict(adc_max=0)):
        with pytest.raises(ValueError):
            api.CiMExecSpec(**bad)
    auto = api.CiMExecSpec("blocked", "auto")
    assert auto.resolve("cpu").backend == "torch"
    assert auto.resolve("cuda").backend == "cuda"
    # auto takes the kernel on the card whether or not one is registered
    # (as JAX's auto takes pallas on the TPU): no silent plain fallback
    assert api.CiMExecSpec("corrected", "auto").resolve("cuda").backend == "cuda"
    for formulation in ("exact", "corrected", "fused"):
        assert api.get_backend(api.CiMExecSpec(formulation, "auto"), "cpu")
    # exact has its CUDA kernel (#5); the others raise on the card
    assert api.get_backend(api.CiMExecSpec("exact", "auto"), "cuda").clamps is False
    for formulation in ("corrected", "fused"):
        with pytest.raises(KeyError, match=f"{formulation}/cuda/none"):
            api.get_backend(api.CiMExecSpec(formulation, "auto"), "cuda")
    assert api.CiMExecSpec("exact").clamps is False
    assert api.CiMExecSpec("bitplane").clamps is True
    with pytest.raises(KeyError):
        api.get_backend(api.CiMExecSpec("corrected", "cuda"))


def test_tiles_and_canonical_layout_match_jax():
    assert api.DECODE_M_MAX == japi.DECODE_M_MAX == 8
    for m in (1, 8, 9, 300):
        assert api.shape_class(m) == japi.shape_class(m)
    for f, p in (("blocked", "none"), ("blocked", "bitplane_u8"),
                 ("exact", "bitplane_u8")):
        spec = api.CiMExecSpec(f, "cuda", p)
        jspec = japi.CiMExecSpec(f, "pallas", p)
        for m in (1, 8, 64):
            assert api.tiles_for(spec, m, 576, 576) == japi.tiles_for(jspec, m, 576, 576)
        assert api.canonical_plane_layout(spec) == japi.canonical_plane_layout(jspec)
    assert api.canonical_plane_layout(api.CiMExecSpec("blocked", "cuda", "bitplane_u8")) \
        == (256, 128)
    assert api.canonical_plane_layout(api.CiMExecSpec("blocked", "torch", "bitplane_u8")) \
        == japi.canonical_plane_layout(japi.CiMExecSpec("blocked", "jnp", "bitplane_u8"))
    assert api.tiles_for(api.CiMExecSpec("blocked", "torch"), 4, 64, 64) is None


def test_sense_channel():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_tern(rng, (16, 64)))
    w = torch.from_numpy(_tern(rng, (64, 32)))
    noisy = api.CiMExecSpec("blocked", "torch", error_prob=0.3)
    clean = api.execute(dataclasses.replace(noisy, error_prob=0.0), x, w)
    with pytest.raises(ValueError, match="Generator"):
        api.execute(noisy, x, w)
    with pytest.raises(ValueError, match="no ADC"):
        api.execute(api.CiMExecSpec("exact", "torch", error_prob=0.3), x, w,
                    generator=torch.Generator().manual_seed(0))
    out = api.execute(noisy, x, w, generator=torch.Generator().manual_seed(0))
    delta = out - clean
    kb = 64 // 16
    assert torch.equal(delta, delta.round()) and delta.abs().max() <= kb
    assert (delta != 0).any()
    again = api.execute(noisy, x, w, generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
