"""The port's kernel wrappers against the JAX Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; here it
is held bit-exact against the Pallas kernel in interpret mode at
one-tile shapes (kernels #1 ternary_cim_matmul, #2
packed_cim_matmul_decode, #4 packed_cim_matmul), also on plane pairs
whose bits overlap, and #2 also at ragged M, K and N. The CUDA kernels are
held against those plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ternary import pack_ternary as jpack
from repro.kernels import packed_mac as jpm
from repro.kernels import ternary_mac as jtm
from repro_torch.core.ternary import pack_ternary
from repro_torch.kernels import packed_mac as pm
from repro_torch.kernels import ternary_mac as tm
from repro_torch.kernels.ref import ref_packed_matmul
from torch_threads import one_thread  # noqa: F401


def _tern(rng, shape, p_zero=0.2):
    vals = rng.choice([-1, 1], size=shape) * (rng.random(shape) >= p_zero)
    return vals.astype(np.int8)


@pytest.mark.parametrize("m,bm", [(8, 8), (128, 128)])
def test_cim_plain_matches_pallas(m, bm):
    rng = np.random.default_rng(m)
    x, w = _tern(rng, (m, 128), 0.05), _tern(rng, (128, 128), 0.05)
    want = jtm.ternary_cim_matmul(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(w, jnp.bfloat16),
                                  bm=bm, bk=128, bn=128, interpret=True)
    before = tm.ternary_cim_matmul.launches
    got = tm.ternary_cim_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tm.ternary_cim_matmul.launches == before  # the plain path is no launch


def test_cim_plain_over_row_slices_matches_pallas(monkeypatch):
    """At prefill-scale M the plain MAC runs over slices of x's rows (one
    call's intermediates would not fit); a slice budget of a few rows
    here, with a partial last slice, gives the Pallas kernel's result."""
    monkeypatch.setattr(tm, "PLAIN_SLICE_BYTES", 3 * 6 * 4 * 8 * 128)  # 3 rows
    rng = np.random.default_rng(11)
    x, w = _tern(rng, (16, 128)), _tern(rng, (128, 128))
    want = jtm.ternary_cim_matmul(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(w, jnp.bfloat16),
                                  bm=16, bk=128, bn=128, interpret=True)
    got = tm.ternary_cim_matmul_plain(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cim_plain_ragged_edges():
    rng = np.random.default_rng(5)
    x, w = _tern(rng, (3, 40)), _tern(rng, (40, 9))
    got = tm.ternary_cim_matmul(torch.from_numpy(x), torch.from_numpy(w))
    xp = np.zeros((8, 128), np.int8)
    wp = np.zeros((128, 128), np.int8)
    xp[:3, :40], wp[:40, :9] = x, w
    want = jtm.ternary_cim_matmul(jnp.asarray(xp, jnp.bfloat16),
                                  jnp.asarray(wp, jnp.bfloat16),
                                  bm=8, bk=128, bn=128, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:3, :9])


@pytest.mark.parametrize("cim", [True, False])
def test_packed_decode_plain_matches_pallas(cim):
    rng = np.random.default_rng(7)
    x, w = _tern(rng, (8, 256), 0.05), _tern(rng, (256, 128), 0.05)
    j1, j2 = jpack(jnp.asarray(w), axis=0)
    want = jpm.packed_cim_matmul_decode(jnp.asarray(x), j1, j2, cim=cim,
                                        bk=256, bn=128, interpret=True)
    p1, p2 = pack_ternary(torch.from_numpy(w), axis=0)
    got = pm.packed_cim_matmul_decode(torch.from_numpy(x), p1, p2, cim=cim)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cim", [True, False])
def test_packed_prefill_plain_matches_pallas(cim):
    rng = np.random.default_rng(9)
    x, w = _tern(rng, (128, 256), 0.05), _tern(rng, (256, 128), 0.05)
    j1, j2 = jpack(jnp.asarray(w), axis=0)
    want = jpm.packed_cim_matmul(jnp.asarray(x, jnp.bfloat16), j1, j2, cim=cim,
                                 bm=128, bk=256, bn=128, interpret=True)
    p1, p2 = pack_ternary(torch.from_numpy(w), axis=0)
    got = pm.packed_cim_matmul(torch.from_numpy(x), p1, p2, cim=cim)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cim", [True, False], ids=["blocked", "exact"])
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_packed_plain_matches_pallas_on_overlapping_planes(kernel, cim):
    """pos and neg drawn independently, so many weights have both bits
    set: the reference reads them as pos - neg = 0, and so must the plain
    versions (tolerance 0). The CUDA kernels are held to the same by
    ``tests/test_torch_cuda.py``."""
    rng = np.random.default_rng(13 + cim + 2 * (kernel == "prefill"))
    m = 8 if kernel == "decode" else 128
    x = _tern(rng, (m, 256), 0.05)
    pos = rng.integers(0, 256, (32, 128), dtype=np.uint8)
    neg = rng.integers(0, 256, (32, 128), dtype=np.uint8)
    assert (pos & neg).any()
    if kernel == "decode":
        want = jpm.packed_cim_matmul_decode(jnp.asarray(x), jnp.asarray(pos),
                                            jnp.asarray(neg), cim=cim, bk=256,
                                            bn=128, interpret=True)
        got = pm.packed_cim_matmul_decode(torch.from_numpy(x), torch.from_numpy(pos),
                                          torch.from_numpy(neg), cim=cim)
    else:
        want = jpm.packed_cim_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
                                     jnp.asarray(neg), cim=cim, bm=128, bk=256,
                                     bn=128, interpret=True)
        got = pm.packed_cim_matmul(torch.from_numpy(x), torch.from_numpy(pos),
                                   torch.from_numpy(neg), cim=cim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("overlap", [False, True], ids=["exclusive", "overlapping"])
@pytest.mark.parametrize("cim", [True, False], ids=["blocked", "exact"])
@pytest.mark.parametrize("m,k,n", [(1, 40, 33), (3, 300, 130), (8, 16, 8)])
def test_packed_decode_plain_ragged_matches_pallas_and_ref(m, k, n, cim, overlap):
    """#2's plain version at M in {1, 3, 8} and ragged K and N (x of K
    rows against canonically padded planes, n_out of their columns), on
    exclusive planes and on planes whose bits overlap: == the Pallas
    decode kernel (interpret, on x zero-extended to the planes' K) and ==
    ``kernels/ref.py``'s oracle; int32, tolerance 0. The CUDA kernel is
    held to it on the card by ``tests/test_torch_cuda.py``."""
    rng = np.random.default_rng(100 * m + k + n + 2 * cim + overlap)
    rows, width = -(-k // 256) * 32, -(-n // 128) * 128
    x = _tern(rng, (m, k))
    if overlap:
        pos = np.zeros((rows, width), np.uint8)
        neg = np.zeros((rows, width), np.uint8)
        pos[:-(-k // 8), :n] = rng.integers(0, 256, (-(-k // 8), n))
        neg[:-(-k // 8), :n] = rng.integers(0, 256, (-(-k // 8), n))
        assert (pos & neg).any()
        p1, p2 = torch.from_numpy(pos), torch.from_numpy(neg)
    else:
        wz = np.zeros((rows * 8, width), np.int8)
        wz[:k, :n] = _tern(rng, (k, n))
        p1, p2 = pack_ternary(torch.from_numpy(wz), axis=0)
    xz = np.zeros((m, rows * 8), np.int8)
    xz[:, :k] = x
    want = jpm.packed_cim_matmul_decode(jnp.asarray(xz), jnp.asarray(p1.numpy()),
                                        jnp.asarray(p2.numpy()), cim=cim, bk=256,
                                        bn=128, interpret=True)
    oracle = ref_packed_matmul(torch.from_numpy(xz), p1, p2, cim=cim)[:, :n]
    got = pm.packed_cim_matmul_decode(torch.from_numpy(x), p1, p2, n_out=n, cim=cim)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, :n])
    np.testing.assert_array_equal(got.numpy(), oracle.numpy().astype(np.int32))


def test_packed_plain_short_x_and_n_out():
    """x shorter than the planes' K reads as zero-extended; n_out keeps
    the logical columns of canonically padded planes."""
    rng = np.random.default_rng(11)
    x, w = _tern(rng, (5, 40)), _tern(rng, (40, 20))
    wz = np.zeros((256, 128), np.int8)
    wz[:40, :20] = w
    p1, p2 = pack_ternary(torch.from_numpy(wz), axis=0)
    want = tm.ternary_cim_matmul(torch.from_numpy(x), torch.from_numpy(w))
    got_d = pm.packed_cim_matmul_decode(torch.from_numpy(x), p1, p2, n_out=20)
    got_p = pm.packed_cim_matmul(torch.from_numpy(x), p1, p2, n_out=20)
    np.testing.assert_array_equal(got_d.numpy(), want.numpy().astype(np.int32))
    np.testing.assert_array_equal(got_p.numpy(), want.numpy())


def test_wrappers_validate_inputs():
    x8 = torch.zeros((2, 32), dtype=torch.int8)
    w8 = torch.zeros((32, 4), dtype=torch.int8)
    with pytest.raises(TypeError):
        tm.ternary_cim_matmul(x8.float(), w8)
    with pytest.raises(ValueError):
        tm.ternary_cim_matmul(x8, w8[:16])
    planes = torch.zeros((4, 4), dtype=torch.uint8)
    with pytest.raises(TypeError):
        pm.packed_cim_matmul(x8, planes.to(torch.int8), planes)
    with pytest.raises(ValueError):
        pm.packed_cim_matmul(torch.zeros((2, 40), dtype=torch.int8), planes, planes)
    with pytest.raises(ValueError):
        pm.packed_cim_matmul_decode(torch.zeros((9, 32), dtype=torch.int8),
                                    planes, planes)
