"""Differential tests: repro_torch.core.ternary and kernels.ref against
the JAX package on the same numpy inputs (exact)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ternary as jt
from repro.kernels import ref as jref
from repro_torch.core import ternary as tt
from repro_torch.kernels import ref as tref
from torch_threads import one_thread  # noqa: F401


def _tern(rng, shape, p_zero=0.3):
    vals = rng.choice([-1, 1], size=shape) * (rng.random(shape) >= p_zero)
    return vals.astype(np.int8)


@pytest.mark.parametrize("axis", [None, 0, (0,), (1,), (0, 1)])
def test_ternarize_matches_jax(axis):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((12, 40)).astype(np.float32)
    t_j, s_j = jt.ternarize(jnp.asarray(x), axis=axis)
    t_t, s_t = tt.ternarize(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)
    np.testing.assert_allclose(
        tt.ternary_threshold(torch.from_numpy(x), axis=axis).numpy(),
        np.asarray(jt.ternary_threshold(jnp.asarray(x), axis=axis)), rtol=1e-6)


def test_bitplanes_roundtrip_matches_jax():
    t = _tern(np.random.default_rng(1), (24, 10))
    m1, m2 = tt.to_bitplanes(torch.from_numpy(t))
    j1, j2 = jt.to_bitplanes(jnp.asarray(t))
    np.testing.assert_array_equal(m1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(m2.numpy(), np.asarray(j2))
    np.testing.assert_array_equal(tt.from_bitplanes(m1, m2).numpy(), t)


@pytest.mark.parametrize("shape,axis", [((32, 12), 0), ((5, 16, 7), 1),
                                        ((3, 40), 1), ((2, 24, 9), -2)])
def test_pack_bytes_match_jax(shape, axis):
    t = _tern(np.random.default_rng(2), shape)
    p1, p2 = tt.pack_ternary(torch.from_numpy(t), axis=axis)
    j1, j2 = jt.pack_ternary(jnp.asarray(t), axis=axis % len(shape))
    assert p1.dtype == torch.uint8
    np.testing.assert_array_equal(p1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(p2.numpy(), np.asarray(j2))
    back = tt.unpack_ternary(p1, p2, axis=axis)
    np.testing.assert_array_equal(back.numpy(), t)


def test_pack_rejects_ragged_axis():
    with pytest.raises(ValueError):
        tt.pack_ternary(torch.zeros((12, 4), dtype=torch.int8), axis=0)


def test_interleave_matches_jax_and_roundtrips():
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 256, (2, 6, 5), dtype=np.uint8)
    neg = rng.integers(0, 256, (2, 6, 5), dtype=np.uint8)
    wi = tt.interleave_planes(torch.from_numpy(pos), torch.from_numpy(neg))
    np.testing.assert_array_equal(
        wi.numpy(), np.asarray(jt.interleave_planes(jnp.asarray(pos), jnp.asarray(neg))))
    p, n = tt.deinterleave_planes(wi)
    np.testing.assert_array_equal(p.numpy(), pos)
    np.testing.assert_array_equal(n.numpy(), neg)


@pytest.mark.parametrize("version", [tt.PLANE_LAYOUT_LEGACY, tt.PLANE_LAYOUT_STREAM])
def test_packed_planes_views(version):
    rng = np.random.default_rng(4)
    pos = torch.from_numpy(rng.integers(0, 256, (3, 4, 8), dtype=np.uint8))
    neg = torch.from_numpy(rng.integers(0, 256, (3, 4, 8), dtype=np.uint8))
    scale = torch.ones((3, 1, 8))
    if version == tt.PLANE_LAYOUT_STREAM:
        wi = tt.interleave_planes(pos, neg)
        planes = tt.PackedPlanes(wi, wi[..., :0, :], scale, k=32, n=8,
                                 layout_version=version)
    else:
        planes = tt.PackedPlanes(pos, neg, scale, k=32, n=8)
    p, n, s = planes
    assert torch.equal(p, pos) and torch.equal(n, neg) and s is scale
    assert torch.equal(planes.interleaved(), tt.interleave_planes(pos, neg))
    one = planes.layer(1)
    assert torch.equal(one.planes()[0], pos[1]) and torch.equal(one.planes()[1], neg[1])
    assert (one.k, one.n, one.layout_version) == (32, 8, version)
    with pytest.raises(ValueError):
        one.layer(0)


@pytest.mark.parametrize("m,k,n", [(3, 32, 5), (7, 48, 9), (1, 160, 33)])
def test_oracles_match_jax(m, k, n):
    rng = np.random.default_rng(m * k + n)
    x = _tern(rng, (m, k), p_zero=0.1)
    w = _tern(rng, (k, n), p_zero=0.1)
    xj, wj = jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32)
    xt, wt = torch.from_numpy(x).float(), torch.from_numpy(w).float()
    np.testing.assert_array_equal(tref.ref_cim_matmul(xt, wt).numpy(),
                                  np.asarray(jref.ref_cim_matmul(xj, wj)))
    np.testing.assert_array_equal(tref.ref_cim_matmul(xt, wt, adc_max=3).numpy(),
                                  np.asarray(jref.ref_cim_matmul(xj, wj, adc_max=3)))
    np.testing.assert_array_equal(tref.ref_exact_matmul(xt, wt).numpy(),
                                  np.asarray(jref.ref_exact_matmul(xj, wj)))
    p1, p2 = jt.pack_ternary(jnp.asarray(w), axis=0)
    q1, q2 = torch.from_numpy(np.array(p1)), torch.from_numpy(np.array(p2))
    for cim in (True, False):
        np.testing.assert_array_equal(
            tref.ref_packed_matmul(xt, q1, q2, cim=cim).numpy(),
            np.asarray(jref.ref_packed_matmul(xj, p1, p2, cim=cim)))
