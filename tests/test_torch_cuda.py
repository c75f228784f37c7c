"""The port's hand-written CUDA kernels on the card.

Every test here is marked ``cuda`` and skips without a GPU. The module
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch; there, skip the JAX-importing ``conftest.py``:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import pytest
import torch

import torch_dp_ranks as DP
import torch_tp_ranks as R
import torch_tp_train_ranks as TPT
from repro_torch import profile as P
from repro_torch.core import execution as X
from repro_torch.core.execution import CiMExecSpec
from repro_torch.core.ternary import deinterleave_planes, interleave_planes, pack_ternary
from repro_torch.kernels import packed_mac as pm
from repro_torch.kernels import ternary_mac as tm
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import spawn_mesh, spawn_tp
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config
from repro_torch.serve.engine import (ContinuousBatcher, Request, generate,
                                      make_jit_serve_step, serve_step)
from repro_torch.serve.graph import CapturedStep


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels build there)")
    return torch.device("cuda")


def _launches():
    return (tm.ternary_cim_matmul.launches, pm.packed_cim_matmul_decode.launches,
            pm.packed_cim_matmul.launches, tm.ternary_exact_matmul.launches,
            pm.packed_cim_matmul_decode_stream.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(576, 576), (576, 1536), (1536, 576), (40, 33)])
def test_cuda_kernels_bit_exact(cuda_device, k, n):
    g = torch.Generator(device=cuda_device).manual_seed(k + n)
    for m in (1, 3, 8, 64, 200):
        x = torch.randint(-1, 2, (m, k), generator=g, device=cuda_device,
                          dtype=torch.int8)
        w = torch.randint(-1, 2, (k, n), generator=g, device=cuda_device,
                          dtype=torch.int8)
        torch.testing.assert_close(tm.ternary_cim_matmul(x, w),
                                   tm.ternary_cim_matmul_plain(x, w), rtol=0, atol=0)
        wz = torch.zeros((-(-k // 256) * 256, n + 5), dtype=torch.int8,
                         device=cuda_device)
        wz[:k, :n] = w
        p1, p2 = pack_ternary(wz, axis=0)
        # plane layout 1: the de-interleaved planes are strided views
        v1, v2 = deinterleave_planes(interleave_planes(p1, p2))
        for cim in (True, False):
            plain = pm.packed_matmul_plain(x, p1, p2, n_out=n, cim=cim)
            for a, b in ((p1, p2), (v1, v2)):
                if m <= 8:
                    got = pm.packed_cim_matmul_decode(x, a, b, n_out=n, cim=cim)
                    torch.testing.assert_close(got, plain.to(torch.int32),
                                               rtol=0, atol=0)
                got = pm.packed_cim_matmul(x, a, b, n_out=n, cim=cim)
                torch.testing.assert_close(got, plain, rtol=0, atol=0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_wrappers_count_launches_only(cuda_device):
    w = torch.ones((32, 8), dtype=torch.int8, device=cuda_device)
    planes = torch.zeros((4, 8), dtype=torch.uint8, device=cuda_device)
    before = _launches()
    wide = torch.zeros((8, 16), dtype=torch.uint8, device=cuda_device)  # layout 1
    empty = torch.zeros((0, 32), dtype=torch.int8, device=cuda_device)
    assert tm.ternary_cim_matmul(empty, w).shape == (0, 8)
    assert tm.ternary_exact_matmul(empty, w).shape == (0, 8)
    assert pm.packed_cim_matmul_decode(empty, planes, planes).shape == (0, 8)
    assert pm.packed_cim_matmul(empty, planes, planes).shape == (0, 8)
    assert pm.packed_cim_matmul_decode_stream(empty, wide).shape == (0, 16)
    assert _launches() == before            # nothing was launched
    x = torch.ones((2, 32), dtype=torch.int8, device=cuda_device)
    assert torch.equal(tm.ternary_cim_matmul(x, w),
                       torch.full((2, 8), 16.0, device=cuda_device))
    assert torch.equal(tm.ternary_exact_matmul(x, w),
                       torch.full((2, 8), 32.0, device=cuda_device))
    pm.packed_cim_matmul_decode(x, planes, planes)
    pm.packed_cim_matmul(x, planes, planes)
    pm.packed_cim_matmul_decode_stream(x, wide)
    torch.cuda.synchronize()
    assert _launches() == tuple(c + 1 for c in before)


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    x = torch.ones((2, 32), dtype=torch.int8, device=cuda_device)
    w = torch.ones((8, 32), dtype=torch.int8, device=cuda_device).t()
    with pytest.raises(ValueError, match="contiguous"):
        tm.ternary_cim_matmul(x, w)
    with pytest.raises(ValueError, match="block=16"):
        tm.ternary_cim_matmul(x, w.contiguous(), block=8)
    with pytest.raises(ValueError, match="different devices"):
        pm.packed_cim_matmul(x, torch.zeros((4, 8), dtype=torch.uint8),
                             torch.zeros((4, 8), dtype=torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(576, 576), (576, 192), (1536, 576), (40, 33)])
def test_cuda_exact_and_stream_kernels_bit_exact(cuda_device, k, n):
    """#5 against its plain version at decode and prefill M; #3 against
    its plain version and #2 on canonical layout-1 planes, nbuf 2 and 3,
    cim on and off."""
    g = torch.Generator(device=cuda_device).manual_seed(7 * k + n)
    w = torch.randint(-1, 2, (k, n), generator=g, device=cuda_device,
                      dtype=torch.int8)
    wz = torch.zeros((-(-k // 256) * 256, -(-n // 128) * 128), dtype=torch.int8,
                     device=cuda_device)
    wz[:k, :n] = w
    p1, p2 = pack_ternary(wz, axis=0)
    wi = interleave_planes(p1, p2)
    for m in (1, 3, 5, 8, 64, 200):
        x = torch.randint(-1, 2, (m, k), generator=g, device=cuda_device,
                          dtype=torch.int8)
        torch.testing.assert_close(tm.ternary_exact_matmul(x, w),
                                   tm.exact_matmul_plain(x, w), rtol=0, atol=0)
        if m > 8:
            continue
        for cim in (True, False):
            want = pm.stream_matmul_plain(x, wi, n_out=n, cim=cim).to(torch.int32)
            decode = pm.packed_cim_matmul_decode(x, p1, p2, n_out=n, cim=cim)
            for nbuf in (2, 3):
                got = pm.packed_cim_matmul_decode_stream(x, wi, n_out=n, cim=cim,
                                                         nbuf=nbuf)
                torch.testing.assert_close(got, want, rtol=0, atol=0)
                torch.testing.assert_close(got, decode, rtol=0, atol=0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_exact_and_stream_wrappers_raise(cuda_device):
    x = torch.ones((2, 256), dtype=torch.int8, device=cuda_device)
    wi = torch.zeros((64, 128), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="buffer depth"):
        pm.packed_cim_matmul_decode_stream(x, wi, nbuf=4)
    with pytest.raises(ValueError, match="block=16"):
        pm.packed_cim_matmul_decode_stream(x, wi, block=8)
    with pytest.raises(TypeError, match="int8"):
        pm.packed_cim_matmul_decode_stream(x.float(), wi)
    with pytest.raises(ValueError, match="multiples of 16"):
        pm.packed_cim_matmul_decode_stream(x, wi[:, :120])   # 16-byte copies
    with pytest.raises(ValueError, match="different devices"):
        pm.packed_cim_matmul_decode_stream(x, wi.cpu())
    w = torch.ones((256, 8), dtype=torch.int8, device=cuda_device)
    with pytest.raises(TypeError, match="int8"):
        tm.ternary_exact_matmul(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        tm.ternary_exact_matmul(x, w.t().contiguous().t())
    with pytest.raises(ValueError, match="operands on"):
        tm.ternary_exact_matmul(x, w.cpu())


@pytest.mark.cuda
def test_cuda_nm_serving_matches_generate(cuda_device):
    """Smoke-size serving under exact/cuda: every quantized dense layer
    is one launch of kernel #5, none of #1, and fused == generate()."""
    cfg = get_config("smollm-135m", smoke=True)
    cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))
    spec = CiMExecSpec("exact", "cuda")
    params = T.init_params(cfg, seed=0, device=cuda_device)
    batcher = ContinuousBatcher(params, cfg, n_slots=3, s_max=32, exec_spec=spec,
                                device=cuda_device)
    reqs = [Request(i, [1 + (i * 5 + j) % 250 for j in range(1 + i % 5)],
                    max_new=3 + i % 4) for i in range(5)]
    for r in reqs:
        batcher.submit(r)
    before = _launches()
    batcher.run()
    after = _launches()
    steps = batcher.stats()["decode_steps"] + batcher.stats()["prefill_batches"]
    assert after[3] - before[3] == 7 * cfg.n_layers * steps
    assert after[0] == before[0]
    for r in reqs:
        want = generate(params, [r.prompt], cfg, max_new=r.max_new, s_max=32,
                        exec_spec=spec, device=cuda_device)[0].tolist()
        assert r.done and r.generated == want, r.rid


@pytest.mark.cuda
def test_cuda_fused_serving_matches_generate(cuda_device):
    """Smoke-size serving on the card: every quantized dense layer is one
    launch of kernel #1, and fused tokens == generate() under per_row."""
    cfg = get_config("smollm-135m", smoke=True)
    cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))
    params = T.init_params(cfg, seed=0, device=cuda_device)
    batcher = ContinuousBatcher(params, cfg, n_slots=3, s_max=32, device=cuda_device)
    reqs = [Request(i, [1 + (i * 7 + j) % 250 for j in range(1 + i % 5)],
                    max_new=3 + i % 4) for i in range(5)]
    for r in reqs:
        batcher.submit(r)
    before = tm.ternary_cim_matmul.launches
    batcher.run()
    st = batcher.stats()
    steps = st["decode_steps"] + st["prefill_batches"]
    assert st["host_syncs"] == steps
    assert tm.ternary_cim_matmul.launches - before == 7 * cfg.n_layers * steps
    for r in reqs:
        want = generate(params, [r.prompt], cfg, max_new=r.max_new, s_max=32,
                        device=cuda_device)[0].tolist()
        assert r.done and r.generated == want, r.rid


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(16, 8), (40, 33), (592, 200), (576, 192),
                                 (576, 576), (1536, 576)])
def test_cuda_tile_kernels_bit_exact_at_ragged_shapes(cuda_device, k, n):
    """#1 and #5 at shapes that cut across their K split (592 = 37 blocks
    of 16, which no cluster size divides), their 16-column tiles (N = 8,
    33, 200) and both copy widths (16-byte copies and the byte path), at decode and
    prefill M, with adc_max small enough for the clamp to bite."""
    g = torch.Generator(device=cuda_device).manual_seed(3 * k + n)
    w = torch.randint(-1, 2, (k, n), generator=g, device=cuda_device,
                      dtype=torch.int8)
    for m in (1, 4, 8, 9, 64, 200):
        x = torch.randint(-1, 2, (m, k), generator=g, device=cuda_device,
                          dtype=torch.int8)
        torch.testing.assert_close(tm.ternary_exact_matmul(x, w),
                                   tm.exact_matmul_plain(x, w), rtol=0, atol=0)
        for adc_max in (8, 3):
            torch.testing.assert_close(
                tm.ternary_cim_matmul(x, w, adc_max=adc_max),
                tm.ternary_cim_matmul_plain(x, w, adc_max=adc_max), rtol=0, atol=0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_refused_cluster_launch_raises(cuda_device):
    """A cluster larger than the portable 8 is refused by the runtime: the
    launch raises, nothing falls back, and the next launch still works."""
    x = torch.ones((4, 576), dtype=torch.int8, device=cuda_device)
    w = torch.ones((576, 64), dtype=torch.int8, device=cuda_device)
    bad = tm.LaunchPlan(8, (4, 1, 16), 16)
    with pytest.raises(RuntimeError, match="launch failed"):
        tm._launch_codes("ternary_exact_mac", x, w, plan=bad)
    with pytest.raises(RuntimeError, match="launch failed"):
        tm._launch_codes("ternary_cim_mac", x, w, 8, plan=bad)
    assert torch.equal(tm.ternary_exact_matmul(x, w),
                       torch.full((4, 64), 576.0, device=cuda_device))
    assert torch.equal(tm.ternary_cim_matmul(x, w),
                       torch.full((4, 64), 36 * 8.0, device=cuda_device))


PLANE_SHAPES = [(576, 576), (576, 192), (576, 1536), (1536, 576), (16, 8), (40, 33),
                (592, 200)]


def _canonical_planes(w, width=None):
    """(pos, neg) of ``w`` padded to 256 K rows and ``width`` columns (a
    multiple of 128 by default, as prepared planes are)."""
    k, n = w.shape
    width = -(-n // 128) * 128 if width is None else width
    wz = torch.zeros((-(-k // 256) * 256, width), dtype=torch.int8, device=w.device)
    wz[:k, :n] = w
    return pack_ternary(wz, axis=0)


def _hold_plane_kernels(x, p1, p2, n, adc_max, cim, wi=None, narrow=()):
    """#2, #3 (nbuf 2 and 3, == #2) and #4 against the plain version on
    (p1, p2) (and ``wi``, their layout-1 array), and #2 (at M <= 8) or #4
    also on each plane pair of ``narrow``; tolerance 0."""
    want = pm.packed_matmul_plain(x, p1, p2, n_out=n, adc_max=adc_max, cim=cim)
    kw = dict(n_out=n, adc_max=adc_max, cim=cim)
    if x.shape[0] <= 8:
        decode = pm.packed_cim_matmul_decode(x, p1, p2, **kw)
        torch.testing.assert_close(decode, want.to(torch.int32), rtol=0, atol=0)
        for nbuf in (2, 3):
            got = pm.packed_cim_matmul_decode_stream(x, wi, nbuf=nbuf, **kw)
            torch.testing.assert_close(got, decode, rtol=0, atol=0)
        for a, b in narrow:
            torch.testing.assert_close(pm.packed_cim_matmul_decode(x, a, b, **kw),
                                       decode, rtol=0, atol=0)
        return
    for a, b in ((p1, p2),) + tuple(narrow):
        torch.testing.assert_close(pm.packed_cim_matmul(x, a, b, **kw), want,
                                   rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", PLANE_SHAPES)
def test_cuda_plane_tile_kernels_bit_exact(cuda_device, k, n):
    """#2, #3 and #4 on the tile machinery against their plain versions
    (and #3 against #2): canonical planes (x shorter than their K, n_out
    below their width), #2 and #3 at M in 1..8, #3 at nbuf 2 and 3, #4 at
    M in {9, 64, 128, 200}; #2 and #4 on the canonical planes (16-byte
    copies), on planes 5 columns wider than N (byte copies) and on the
    de-interleaved views of both as layout 1; cim on and off, adc_max 8
    and 3."""
    g = torch.Generator(device=cuda_device).manual_seed(5 * k + n)
    w = torch.randint(-1, 2, (k, n), generator=g, device=cuda_device, dtype=torch.int8)
    p1, p2 = _canonical_planes(w)
    wi = interleave_planes(p1, p2)
    q1, q2 = _canonical_planes(w, width=n + 5)
    narrow = ((q1, q2), deinterleave_planes(wi), deinterleave_planes(interleave_planes(q1, q2)))
    for m in tuple(range(1, 9)) + (9, 64, 128, 200):
        x = torch.randint(-1, 2, (m, k), generator=g, device=cuda_device, dtype=torch.int8)
        for cim, adc_max in ((True, 8), (True, 3), (False, 8)):
            _hold_plane_kernels(x, p1, p2, n, adc_max, cim, wi=wi, narrow=narrow)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("cim,adc_max", [(True, 8), (True, 3), (False, 8)],
                         ids=["cim-adc8", "cim-adc3", "exact"])
@pytest.mark.parametrize("k,n", PLANE_SHAPES)
def test_cuda_packed_kernels_on_overlapping_planes(cuda_device, k, n, cim, adc_max):
    """pos and neg drawn independently, so many weights have both bits
    set, which the reference reads as pos - neg = 0: #2, #3 and #4 must
    agree with the plain version bit for bit (the kernels of the port's
    first versions counted such a weight on both sides, which differs
    under the clamp: the cim cases fail on them, the exact case passes)."""
    g = torch.Generator(device=cuda_device).manual_seed(11 * k + n)
    rows, width = -(-k // 256) * 32, -(-n // 128) * 128
    pos = torch.randint(0, 256, (rows, width), generator=g, device=cuda_device,
                        dtype=torch.uint8)
    neg = torch.randint(0, 256, (rows, width), generator=g, device=cuda_device,
                        dtype=torch.uint8)
    wi = interleave_planes(pos, neg)
    narrow = (deinterleave_planes(wi),)
    for m in (1, 3, 4, 8, 9, 128):
        x = torch.randint(-1, 2, (m, k), generator=g, device=cuda_device, dtype=torch.int8)
        _hold_plane_kernels(x, pos, neg, n, adc_max, cim, wi=wi, narrow=narrow)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_plane_kernels_refused_cluster_launch_raises(cuda_device):
    """A 16-block cluster is refused by the runtime for #2, #3 and #4 too:
    the launch raises, nothing falls back, and the next launch still
    works."""
    w = torch.ones((576, 64), dtype=torch.int8, device=cuda_device)
    p1, p2 = _canonical_planes(w)
    wi = interleave_planes(p1, p2)
    x = torch.ones((4, 576), dtype=torch.int8, device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        pm._launch_stream(x, wi, 64, 8, True, 2, plan=tm.LaunchPlan(8, (4, 1, 16), 16))
    with pytest.raises(RuntimeError, match="launch failed"):
        pm._launch_prefill(x, p1, p2, 64, 8, True, plan=tm.LaunchPlan(32, (4, 1, 16), 16))
    with pytest.raises(RuntimeError, match="launch failed"):
        pm._launch_decode(x, p1, p2, 64, 8, True, plan=tm.LaunchPlan(8, (4, 1, 16), 16))
    assert torch.equal(pm.packed_cim_matmul_decode(x, p1, p2, n_out=64),
                       torch.full((4, 64), 36 * 8, dtype=torch.int32, device=cuda_device))
    assert torch.equal(pm.packed_cim_matmul_decode_stream(x, wi, n_out=64),
                       torch.full((4, 64), 36 * 8, dtype=torch.int32, device=cuda_device))
    assert torch.equal(pm.packed_cim_matmul(x, p1, p2, n_out=64),
                       torch.full((4, 64), 36 * 8.0, device=cuda_device))


def _smoke_model(cuda_device, act_scale="per_tensor"):
    cfg = get_config("smollm-135m", smoke=True)
    cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale=act_scale))
    return cfg, T.init_params(cfg, seed=0, device=cuda_device)


def _serve(batcher, n=5):
    reqs = [Request(i, [1 + (i * 7 + j) % 250 for j in range(1 + i % 5)],
                    max_new=3 + i % 4) for i in range(n)]
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    return [r.generated for r in reqs]


@pytest.mark.cuda
@pytest.mark.parametrize("act_scale", ["per_tensor", "per_row"])
@pytest.mark.parametrize("spec", [None, CiMExecSpec("exact", "cuda")], ids=["cim", "nm"])
def test_cuda_captured_step_matches_eager(cuda_device, spec, act_scale):
    """The batcher's decode step on the card is one CUDA graph, captured
    once at the first decode step and replayed after: its tokens equal
    the eager step's (the same batcher with the graph switched off), and
    generate()'s under per_row; the MAC kernel counts 7 x layers launches
    per decode step and prefill batch, replays included; one host sync
    per step."""
    cfg, params = _smoke_model(cuda_device, act_scale)
    kernel = tm.ternary_cim_matmul if spec is None else tm.ternary_exact_matmul
    got = {}
    for graphed in (True, False):
        batcher = ContinuousBatcher(params, cfg, n_slots=3, s_max=32, exec_spec=spec,
                                    device=cuda_device)
        batcher.graphed = graphed
        before = kernel.launches
        got[graphed] = _serve(batcher)
        st = batcher.stats()
        steps = st["decode_steps"] + st["prefill_batches"]
        assert st["host_syncs"] == steps
        assert kernel.launches - before == 7 * cfg.n_layers * steps
        if graphed:
            assert batcher._decode.graph is not None
            assert batcher.capture_seconds > 0
            assert batcher._decode.captured_launches == {kernel: 7 * cfg.n_layers}
        else:
            assert batcher._decode.graph is None and batcher.capture_seconds is None
    assert got[True] == got[False]
    if act_scale == "per_row":
        reqs = [Request(i, [1 + (i * 7 + j) % 250 for j in range(1 + i % 5)],
                        max_new=3 + i % 4) for i in range(5)]
        for r, toks in zip(reqs, got[True]):
            want = generate(params, [r.prompt], cfg, max_new=r.max_new, s_max=32,
                            exec_spec=spec, device=cuda_device)[0].tolist()
            assert toks == want, r.rid


@pytest.mark.cuda
def test_cuda_captured_step_sampled_matches_eager(cuda_device):
    """At temperature > 0 the sampling is in the graph, with the batcher's
    generator registered with it: under the same seed the captured
    batcher draws what the eager one draws, prefill's eager draws
    included."""
    cfg, params = _smoke_model(cuda_device)
    got = {}
    for graphed in (True, False):
        batcher = ContinuousBatcher(params, cfg, n_slots=3, s_max=32, temperature=0.9,
                                    seed=7, device=cuda_device)
        batcher.graphed = graphed
        got[graphed] = _serve(batcher)
    assert got[True] == got[False]


@pytest.mark.cuda
def test_cuda_jit_serve_step_replays_serve_step(cuda_device):
    """make_jit_serve_step: a graph per (batch, step length), replayed with
    new tokens and indices, == serve_step on its own caches; bound to the
    caches of its first call."""
    cfg, params = _smoke_model(cuda_device)
    jit = make_jit_serve_step(cfg)
    mine = T.init_caches(cfg, 2, 32, device=cuda_device)
    ref = T.init_caches(cfg, 2, 32, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    prompt = torch.randint(1, cfg.vocab, (2, 4), generator=g, device=cuda_device)
    for caches in (mine, ref):
        serve_step(params, prompt, caches, 0, cfg)
    for i in range(4):
        tok = torch.randint(1, cfg.vocab, (2, 1), generator=g, device=cuda_device)
        index = 4 + i if i % 2 else torch.tensor([4 + i, 4 + i], device=cuda_device)
        got, _ = jit(params, tok, mine, index)
        want, _ = serve_step(params, tok, ref, index, cfg)
        assert torch.equal(got, want), i
    assert torch.equal(mine.k, ref.k) and torch.equal(mine.v, ref.v)
    with pytest.raises(ValueError, match="bound to the params and caches"):
        jit(params, tok, ref, 9)


@pytest.mark.cuda
def test_cuda_failed_capture_raises(cuda_device):
    """A launch that CUDA refuses during the capture raises out of the
    step (no eager fallback), and the card still works after."""
    x = torch.ones((4, 576), dtype=torch.int8, device=cuda_device)
    w = torch.ones((576, 64), dtype=torch.int8, device=cuda_device)
    calls = []

    def fn(a):
        calls.append(len(calls))
        plan = None if len(calls) == 1 else tm.LaunchPlan(8, (4, 1, 16), 16)
        return tm._launch_codes("ternary_exact_mac", a, w, plan=plan)[0]

    step = CapturedStep(fn, [x], cuda_device)
    with pytest.raises(RuntimeError):
        step()
    assert len(calls) == 2 and step.graph is None
    torch.cuda.synchronize()
    assert torch.equal(tm.ternary_exact_matmul(x, w),
                       torch.full((4, 64), 576.0, device=cuda_device))


@pytest.mark.cuda
def test_cuda_capacity_mix_finishes(cuda_device):
    """A slot freed at s_max rides the captured step as a dead lane whose
    cache write is clamped to its row's last slot (an unclamped write
    would be an out-of-bounds index_put_ in the graph, a device assert):
    the mix finishes with the reference's counts and flags, and each
    request's tokens == generate() under per_row."""
    cfg, params = _smoke_model(cuda_device, "per_row")
    for cache_dtype in ("bf16", "int8"):
        batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=8,
                                    cache_dtype=cache_dtype, device=cuda_device)
        reqs = [Request(0, [1, 2, 3], 100), Request(1, [4], 2), Request(2, [5, 6], 6)]
        for r in reqs:
            batcher.submit(r)
        batcher.run()
        torch.cuda.synchronize()
        assert batcher._decode.graph is not None
        assert [len(r.generated) for r in reqs] == [5, 2, 5]
        assert [r.truncated for r in reqs] == [True, False, True]
        for r in reqs:
            want = generate(params, [r.prompt], batcher.cfg, max_new=len(r.generated),
                            s_max=8, device=cuda_device)[0].tolist()
            assert r.generated == want, (cache_dtype, r.rid)


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["int8", "ternary"])
def test_cuda_quant_cache_captured_matches_eager(cuda_device, cache_dtype):
    """The captured step over a quantized cache (four leaves per stack,
    prefill merging every leaf in place): tokens == the eager step's ==
    generate()'s under per_row, 7 x layers launches of #1 per decode step
    and prefill batch, one host sync per step."""
    cfg, params = _smoke_model(cuda_device, "per_row")
    got = {}
    for graphed in (True, False):
        batcher = ContinuousBatcher(params, cfg, n_slots=3, s_max=32,
                                    cache_dtype=cache_dtype, device=cuda_device)
        batcher.graphed = graphed
        ptrs = [leaf.data_ptr() for leaf in batcher.caches]
        before = tm.ternary_cim_matmul.launches
        got[graphed] = _serve(batcher)
        st = batcher.stats()
        steps = st["decode_steps"] + st["prefill_batches"]
        assert st["host_syncs"] == steps
        assert tm.ternary_cim_matmul.launches - before == 7 * cfg.n_layers * steps
        assert [leaf.data_ptr() for leaf in batcher.caches] == ptrs
        assert (batcher._decode.graph is not None) == graphed
    assert got[True] == got[False]
    reqs = [Request(i, [1 + (i * 7 + j) % 250 for j in range(1 + i % 5)],
                    max_new=3 + i % 4) for i in range(5)]
    for r, toks in zip(reqs, got[True]):
        want = generate(params, [r.prompt], batcher.cfg, max_new=r.max_new, s_max=32,
                        device=cuda_device)[0].tolist()
        assert toks == want, r.rid


@pytest.mark.cuda
def test_cuda_looped_baseline_matches_generate(cuda_device):
    """fused=False on the card: eager, no graph; tokens == generate(), one
    host sync per prefill and per active slot a step, one prefill batch
    per slot fill."""
    cfg, params = _smoke_model(cuda_device)
    batcher = ContinuousBatcher(params, cfg, n_slots=3, s_max=32, fused=False,
                                device=cuda_device)
    before = tm.ternary_cim_matmul.launches
    toks = _serve(batcher)
    st = batcher.stats()
    assert batcher.capture_seconds is None
    assert st["host_syncs"] == sum(len(t) for t in toks) and st["prefill_batches"] == 5
    # one single-row step per slot per decode step, one prefill per request
    assert (tm.ternary_cim_matmul.launches - before
            == 7 * cfg.n_layers * (3 * st["decode_steps"] + 5))
    reqs = [Request(i, [1 + (i * 7 + j) % 250 for j in range(1 + i % 5)],
                    max_new=3 + i % 4) for i in range(5)]
    for r, got in zip(reqs, toks):
        want = generate(params, [r.prompt], cfg, max_new=r.max_new, s_max=32,
                        device=cuda_device)[0].tolist()
        assert got == want, r.rid


# the ssm and hybrid families' dense layers: mamba2-780m's w_in and w_out,
# zamba2-2.7b's w_in, w_out, q/k/v/o and MLP (N = 6448 = 16 x 403 and
# 10448 = 16 x 653: multiples of 16 and of no larger power of two)
SSM_SHAPES = [(1536, 6448), (3072, 1536), (2560, 10448), (5120, 2560),
              (2560, 2560), (2560, 10240), (10240, 2560)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", SSM_SHAPES)
def test_cuda_cim_kernel_bit_exact_at_ssm_widths(cuda_device, k, n):
    g = torch.Generator(device=cuda_device).manual_seed(k + n)
    w = torch.randint(-1, 2, (k, n), generator=g, device=cuda_device, dtype=torch.int8)
    for m in (1, 4, 64):
        x = torch.randint(-1, 2, (m, k), generator=g, device=cuda_device, dtype=torch.int8)
        assert torch.equal(tm.ternary_cim_matmul(x, w), tm.ternary_cim_matmul_plain(x, w)), m


def _macs_per_step(cfg):
    """#1 launches per decode step or prefill batch: 7 per decoder layer
    (the batcher serves whisper without cross attention), 2
    per mamba layer (w_in, w_out), 7 per application of zamba2's shared
    block; per moe layer the attention's projections (3 MLA, 4 GQA) and
    the shared experts' MLP (3) where there is one (the routed experts
    are plain products)."""
    if cfg.family == "moe":
        return ((3 if cfg.mla else 4) + (3 if cfg.n_shared_experts else 0)) * cfg.n_layers
    if cfg.family in ("dense", "encdec", "vlm"):
        return 7 * cfg.n_layers
    return 2 * cfg.n_layers + (7 * (cfg.n_layers // cfg.hybrid_attn_every)
                               if cfg.family == "hybrid" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_cuda_ssm_captured_step_matches_generate(cuda_device, arch):
    """The captured step over SSM (and hybrid's KV) caches at 4 slots:
    tokens == the eager step's == generate()'s at 1 row under per_row
    (the recurrence's reductions must not depend on the batch), #1
    launched _macs_per_step x (decode steps + prefill batches), and every
    cache leaf keeps its storage across prefills and replays."""
    cfg = get_config(arch, smoke=True)
    cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))
    params = T.init_params(cfg, seed=0, device=cuda_device)
    got = {}
    for graphed in (True, False):
        batcher = ContinuousBatcher(params, cfg, n_slots=4, s_max=32, device=cuda_device)
        batcher.graphed = graphed
        ptrs = [a.data_ptr() for a in T.cache_leaves(batcher.caches)]
        before = tm.ternary_cim_matmul.launches
        got[graphed] = _serve(batcher, n=7)
        st = batcher.stats()
        steps = st["decode_steps"] + st["prefill_batches"]
        assert tm.ternary_cim_matmul.launches - before == _macs_per_step(cfg) * steps
        assert [a.data_ptr() for a in T.cache_leaves(batcher.caches)] == ptrs
        assert (batcher._decode.graph is not None) == graphed
    assert got[True] == got[False]
    reqs = [Request(i, [1 + (i * 7 + j) % 250 for j in range(1 + i % 5)],
                    max_new=3 + i % 4) for i in range(7)]
    for r, toks in zip(reqs, got[True]):
        want = generate(params, [r.prompt], cfg, max_new=r.max_new, s_max=32,
                        device=cuda_device)[0].tolist()
        assert toks == want, r.rid


@pytest.mark.cuda
def test_cuda_zamba2_capacity_mix_finishes(cuda_device):
    """test_cuda_capacity_mix_finishes on zamba2: the dead lane's KV write
    is clamped and its SSM state rides on until a refill overwrites the
    row; the reference's counts and flags, tokens == generate()."""
    cfg = get_config("zamba2-2.7b", smoke=True)
    cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))
    params = T.init_params(cfg, seed=0, device=cuda_device)
    batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=8, device=cuda_device)
    reqs = [Request(0, [1, 2, 3], 100), Request(1, [4], 2), Request(2, [5, 6], 6)]
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    torch.cuda.synchronize()
    assert batcher._decode.graph is not None
    assert [len(r.generated) for r in reqs] == [5, 2, 5]
    assert [r.truncated for r in reqs] == [True, False, True]
    for r in reqs:
        want = generate(params, [r.prompt], cfg, max_new=len(r.generated), s_max=8,
                        device=cuda_device)[0].tolist()
        assert r.generated == want, r.rid


# the moe family's dense layers: deepseek-v2's wq, w_dkv, wo and shared MLP
# (gate/up 5120 -> 3072, down 3072 -> 5120), grok-1's wq/wo and wk/wv
MOE_SHAPES = [(5120, 24576), (5120, 576), (16384, 5120), (5120, 3072), (3072, 5120),
              (6144, 6144), (6144, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", MOE_SHAPES)
def test_cuda_cim_kernel_bit_exact_at_moe_widths(cuda_device, k, n):
    g = torch.Generator(device=cuda_device).manual_seed(k + n)
    w = torch.randint(-1, 2, (k, n), generator=g, device=cuda_device, dtype=torch.int8)
    for m in (1, 4, 16, 64):
        x = torch.randint(-1, 2, (m, k), generator=g, device=cuda_device, dtype=torch.int8)
        assert torch.equal(tm.ternary_cim_matmul(x, w), tm.ternary_cim_matmul_plain(x, w)), m


@pytest.mark.cuda
@pytest.mark.parametrize("arch,cache_dtype", [("deepseek-v2-236b", "bf16"),
                                              ("deepseek-v2-236b", "int8"),
                                              ("grok-1-314b", "bf16")])
def test_cuda_moe_captured_step_matches_generate(cuda_device, arch, cache_dtype):
    """The captured step over the routed MoE block (and MLA's latent
    cache) at 4 slots: tokens == the eager step's == generate()'s at 1
    row under per_row and the capacity factor n_experts / top_k (no
    assignment drops), #1 launched _macs_per_step x (decode steps +
    prefill batches) and no other kernel, cache storage kept."""
    cfg = get_config(arch, smoke=True)
    cfg = cfg.replace(moe_capacity_factor=cfg.n_experts / cfg.top_k,
                      quant=dataclasses.replace(cfg.quant, act_scale="per_row",
                                                cache_dtype=cache_dtype))
    params = T.init_params(cfg, seed=0, device=cuda_device)
    got = {}
    for graphed in (True, False):
        batcher = ContinuousBatcher(params, cfg, n_slots=4, s_max=32, device=cuda_device)
        batcher.graphed = graphed
        ptrs = [a.data_ptr() for a in T.cache_leaves(batcher.caches)]
        before = _launches()
        got[graphed] = _serve(batcher, n=7)
        st = batcher.stats()
        steps = st["decode_steps"] + st["prefill_batches"]
        moved = [a - b for a, b in zip(_launches(), before)]
        assert moved == [_macs_per_step(cfg) * steps, 0, 0, 0, 0]
        assert [a.data_ptr() for a in T.cache_leaves(batcher.caches)] == ptrs
        assert (batcher._decode.graph is not None) == graphed
    assert got[True] == got[False]
    reqs = [Request(i, [1 + (i * 7 + j) % 250 for j in range(1 + i % 5)],
                    max_new=3 + i % 4) for i in range(7)]
    for r, toks in zip(reqs, got[True]):
        want = generate(params, [r.prompt], cfg, max_new=r.max_new, s_max=32,
                        device=cuda_device)[0].tolist()
        assert toks == want, r.rid


# whisper-large-v3's and llava-next-34b's (K, N) at prefill-scale M: whisper's
# encoder and cross K/V run at 1500 rows a request (6000 for 4 requests),
# llava's forward at 2880 image + 16 text rows (1501, 2897 and 6001 leave
# the last 32-row tile partial); the plain version runs over slices of x's rows
WHISPER_KN = [(1280, 1280), (1280, 5120), (5120, 1280)]
PREFILL_SHAPES = WHISPER_KN + [(7168, 1024), (1024, 7168)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", PREFILL_SHAPES)
def test_cuda_cim_kernel_bit_exact_at_prefill_m(cuda_device, k, n):
    g = torch.Generator(device=cuda_device).manual_seed(k + 3 * n)
    w = torch.randint(-1, 2, (k, n), generator=g, device=cuda_device, dtype=torch.int8)
    for m in (1501, 2897) + ((6001,) if (k, n) in WHISPER_KN else ()):
        x = torch.randint(-1, 2, (m, k), generator=g, device=cuda_device, dtype=torch.int8)
        assert torch.equal(tm.ternary_cim_matmul(x, w), tm.ternary_cim_matmul_plain(x, w)), m


def _encdec_smoke(device, mode="cim"):
    """whisper smoke at f32: seed-0 weights on ``device``, and 2 requests'
    seeded frames."""
    cfg = get_config("whisper-large-v3", smoke=True)
    cfg = cfg.replace(dtype="float32", quant=dataclasses.replace(cfg.quant, mode=mode))
    params = T.init_params(cfg, seed=0, device="cpu")
    frames = torch.randn((2, cfg.encoder_seq, cfg.d_model),
                         generator=torch.Generator().manual_seed(5))
    to = lambda tree: {k: to(v) if isinstance(v, dict) else v.to(device)  # noqa: E731
                       for k, v in tree.items()}
    return cfg, to(params), frames.to(device)


@pytest.mark.cuda
def test_cuda_cross_attention_and_encoder_match_cpu(cuda_device):
    """f32, mode cim: cross_attention and run_encoder on the card (#1 for
    every projection) against the port on the CPU at rtol = atol = 1e-4:
    the norms' means, the ternarization's mean and amax and the float64
    attention are summed in another order on the card."""
    from repro_torch.models import attention as attn

    cfg, params, frames = _encdec_smoke(cuda_device)
    _, cpu_params, cpu_frames = _encdec_smoke("cpu")
    p = T.layer_params(params["blocks"], 0)["cross"]
    cpu_p = T.layer_params(cpu_params["blocks"], 0)["cross"]
    x = frames[:, :5] * 0.5
    before = tm.ternary_cim_matmul.launches
    got = attn.cross_attention(p, x, frames, cfg)
    assert tm.ternary_cim_matmul.launches - before == 4
    torch.testing.assert_close(got.cpu(), attn.cross_attention(cpu_p, x.cpu(), cpu_frames, cfg),
                               rtol=1e-4, atol=1e-4)
    before = tm.ternary_cim_matmul.launches
    got = T.run_encoder(params, frames, cfg)
    assert tm.ternary_cim_matmul.launches - before == 7 * cfg.n_encoder_layers
    torch.testing.assert_close(got.cpu(), T.run_encoder(cpu_params, cpu_frames, cfg),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_jit_serve_step_with_enc_replays_serve_step(cuda_device):
    """make_jit_serve_step(enc=): the captured step copies enc in and
    recomputes the cross K/V on every replay (#1 launched 11 x layers a
    step), == serve_step on its own caches, bit for bit, for a new enc
    of the bound shape too; an enc of another shape raises."""
    cfg = get_config("whisper-large-v3", smoke=True)
    params = T.init_params(cfg, seed=0, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    frames = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=g,
                         device=cuda_device).to(torch.bfloat16)
    enc = T.run_encoder(params, frames, cfg)
    jit = make_jit_serve_step(cfg)
    mine = T.init_caches(cfg, 2, 32, device=cuda_device)
    ref = T.init_caches(cfg, 2, 32, device=cuda_device)
    prompt = torch.randint(1, cfg.vocab, (2, 4), generator=g, device=cuda_device)
    for caches in (mine, ref):
        serve_step(params, prompt, caches, 0, cfg, enc=enc)
    for i in range(4):
        if i == 2:   # another encoder output of the same shape
            enc = T.run_encoder(params, frames.flip(1), cfg)
        tok = torch.randint(1, cfg.vocab, (2, 1), generator=g, device=cuda_device)
        before = tm.ternary_cim_matmul.launches
        got, _ = jit(params, tok, mine, 4 + i, enc=enc)
        assert tm.ternary_cim_matmul.launches - before == 11 * cfg.n_layers
        want, _ = serve_step(params, tok, ref, 4 + i, cfg, enc=enc)
        assert torch.equal(got, want), i
    assert torch.equal(mine.k, ref.k) and torch.equal(mine.v, ref.v)
    with pytest.raises(ValueError, match="bound to the enc"):
        jit(params, tok, mine, 9, enc=enc[:, :16])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _smoke_train(device, remat=False, steps=1):
    """``steps`` smoke f32 CiM train steps from seed-0 params made on the
    CPU and moved to ``device``; returns (losses, params, #1 launches)."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import TrainState, make_train_step

    cfg = get_config("smollm-135m", smoke=True).replace(dtype="float32", remat=remat)
    params = adamw.tree_map(lambda p: p.to(device),
                            T.init_params(cfg, seed=0, device="cpu"))
    state = TrainState(params, adamw.init(params),
                       torch.Generator(device=device).manual_seed(1), None)
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    losses = []
    before = _launches()
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch(i).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    moved = tuple(a - b for a, b in zip(_launches(), before))
    return losses, state.params, moved, cfg


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda_device):
    """One smoke f32 CiM train step through #1 on the card == the port on
    the CPU, TF32 off: the loss at rtol 1e-5; the params at rtol 1e-4 with
    atol 1e-4 (a tenth of lr) and a mean difference under 1e-8. The atol:
    Adam's first update is lr·g/(|g| + eps), so where |g| is near eps
    (1e-8) the sums' order moves it by a visible fraction of lr (2% on
    one of the 16,384 weights of the embedding table in the first run)."""
    from repro_torch.optim.adamw import tree_leaves

    assert not torch.backends.cuda.matmul.allow_tf32
    losses, params, moved, _ = _smoke_train(cuda_device)
    want_losses, want_params, _, _ = _smoke_train(torch.device("cpu"))
    assert moved[0] > 0 and not any(moved[1:])
    torch.testing.assert_close(losses, want_losses, rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(params), tree_leaves(want_params)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
        assert float((a.cpu() - b).abs().mean()) < 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_cuda_train_step_launches(cuda_device, remat):
    """#1 runs once per dense layer in the forward, and under remat once
    more in the backward's recompute; no other MAC kernel runs, and the
    two give the same loss bit for bit."""
    losses, _, moved, cfg = _smoke_train(cuda_device, remat=remat, steps=2)
    per_step = 7 * cfg.n_layers * (2 if remat else 1)
    assert moved == (2 * per_step, 0, 0, 0, 0)
    other, _, _, _ = _smoke_train(cuda_device, remat=not remat, steps=2)
    assert losses == other


@pytest.mark.cuda
def test_cuda_dense_with_grad_params_captures_under_no_grad(cuda_device):
    """dense on params that require grad, under no_grad (serving a model
    being trained): the step captures into a CUDA graph as today (the MAC
    called directly, not through the STE Function), and its replays
    equal the eager calls bit for bit, #1 counted once per replay."""
    from repro_torch.models import layers as L

    g = torch.Generator(device=cuda_device).manual_seed(8)
    w = torch.randn((576, 1536), generator=g, device=cuda_device,
                    dtype=torch.bfloat16).requires_grad_()
    x = torch.randn((4, 576), generator=g, device=cuda_device, dtype=torch.bfloat16)
    qc = L.QuantConfig(mode="cim")

    def fn(a):
        with torch.no_grad():
            return L.dense(a, w, qc)

    step = CapturedStep(fn, [x], cuda_device)
    first = step()
    assert step.graph is not None and not first.requires_grad
    for i in range(3):
        x.copy_(torch.randn(x.shape, generator=g, device=cuda_device, dtype=x.dtype))
        before = tm.ternary_cim_matmul.launches
        got = step()
        assert tm.ternary_cim_matmul.launches - before == 1
        assert torch.equal(got, fn(x)), i


FAMILY_ARCHS = ("mamba2-780m", "zamba2-2.7b", "deepseek-v2-236b", "grok-1-314b",
                "whisper-large-v3", "llava-next-34b")


def _family_train(arch, device, remat=False, steps=1):
    """``steps`` smoke f32 CiM train steps of ``arch`` (moe at capacity
    factor 8.0: nothing drops) from seed-0 params made on the CPU and
    moved to ``device``, with seeded frames or patches where the family
    takes them; returns (losses, params, launches moved, cfg)."""
    import numpy as np

    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import TrainState, make_train_step

    cfg = get_config(arch, smoke=True).replace(dtype="float32", remat=remat)
    if cfg.family == "moe":
        cfg = cfg.replace(moe_capacity_factor=8.0)
    params = adamw.tree_map(lambda p: p.to(device),
                            T.init_params(cfg, seed=0, device="cpu"))
    state = TrainState(params, adamw.init(params),
                       torch.Generator(device=device).manual_seed(1), None)
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2))
    rng = np.random.default_rng(7)
    losses = []
    before = _launches()
    for i in range(steps):
        batch = pipe.batch(i)
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (2, cfg.n_image_tokens, cfg.d_vision)).astype(np.float32)
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    moved = tuple(a - b for a, b in zip(_launches(), before))
    return losses, state.params, moved, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cuda_family_train_step_matches_cpu(cuda_device, arch):
    """One smoke f32 CiM train step of each non-dense family through #1 on
    the card == the port on the CPU, TF32 off, at the dense family's
    bounds (test_cuda_train_step_matches_cpu): the loss at rtol 1e-5, the
    params at rtol 1e-4 with atol 1e-4 (a tenth of lr) and a mean
    difference under 1e-8."""
    from repro_torch.optim.adamw import tree_leaves

    assert not torch.backends.cuda.matmul.allow_tf32
    losses, params, moved, _ = _family_train(arch, cuda_device)
    want_losses, want_params, _, _ = _family_train(arch, torch.device("cpu"))
    assert moved[0] > 0 and not any(moved[1:])
    torch.testing.assert_close(losses, want_losses, rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(params), tree_leaves(want_params)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
        assert float((a.cpu() - b).abs().mean()) < 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cuda_family_train_step_launches(cuda_device, arch):
    """Under remat, #1 runs once per quantized dense layer in the forward
    and once more for each one under a checkpointed layer (the decoder or
    mamba layers; not whisper's encoder, zamba2's shared block or llava's
    projector); no other MAC kernel; remat on and off give the same losses
    bit for bit."""
    losses, _, moved, cfg = _family_train(arch, cuda_device, remat=True, steps=2)
    per_layer = {"ssm": 2, "hybrid": 2, "encdec": 11, "vlm": 7,
                 "moe": (3 if cfg.mla else 4) + (3 if cfg.n_shared_experts else 0)}
    under_remat = per_layer[cfg.family] * cfg.n_layers
    other = {"hybrid": 7 * (cfg.n_layers // max(cfg.hybrid_attn_every, 1)),
             "encdec": 7 * cfg.n_encoder_layers, "vlm": 1}.get(cfg.family, 0)
    assert moved == (2 * (2 * under_remat + other), 0, 0, 0, 0)
    plain, _, _, _ = _family_train(arch, cuda_device, remat=False, steps=2)
    assert losses == plain


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-780m", "deepseek-v2-236b"])
def test_cuda_trainer_replay_is_bit_equal(cuda_device, arch, tmp_path):
    """A failure at step 3 restores the checkpoint at 2 into the captured
    step's state: step 2 replays with its first pass's loss and grad norm
    bit for bit on the card. The
    test does not turn deterministic mode on: Trainer.run() does, and
    leaves it off again."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import FailureInjector, TrainConfig, Trainer

    assert not torch.are_deterministic_algorithms_enabled()
    cfg = get_config(arch, smoke=True)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    tr = Trainer(cfg, AdamWConfig(lr=1e-3), TrainConfig(
        num_steps=4, ckpt_dir=str(tmp_path), ckpt_every=2, log_every=0), pipe,
        failure_injector=FailureInjector([3]), device=cuda_device)
    log = tr.run()
    assert tr.restarts == 1 and [m["step"] for m in log] == [0, 1, 2, 2, 3]
    assert (log[2]["loss"], log[2]["grad_norm"]) == (log[3]["loss"], log[3]["grad_norm"])
    assert not torch.are_deterministic_algorithms_enabled()
    # every step after the first was a replay of the captured step
    assert tr.step_fn.captured.graph is not None and tr.step_fn.captured.replays == 4


# ---------------------------------------------------------------------------
# the captured prefill and train step
# ---------------------------------------------------------------------------

SERVE_ARCHS = ("smollm-135m", "mamba2-780m", "zamba2-2.7b", "deepseek-v2-236b",
               "grok-1-314b", "whisper-large-v3", "llava-next-34b")


def _prefill_replays(batcher):
    return sum(step.replays for _, step in batcher._prefill_steps.values())


def _family_cfg(arch):
    """A smoke config; moe at the capacity factor at which nothing drops."""
    cfg = get_config(arch, smoke=True)
    if cfg.family == "moe":
        cfg = cfg.replace(moe_capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "sampled"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_cuda_captured_prefill_matches_eager(cuda_device, arch, temperature):
    """Every family the batcher serves: with its prefill and decode
    graphs on, the tokens and the caches after the first fill and at the
    end equal the same batcher's with both graphs off, bit for bit (at
    temperature > 0 the generator registered with every graph); every
    fill after a bucket's first is a replay; #1 launches per fill and
    step are unchanged."""
    cfg = _family_cfg(arch)
    params = T.init_params(cfg, seed=0, device=cuda_device)
    runs = {}
    for graphed in (True, False):
        batcher = ContinuousBatcher(params, cfg, n_slots=3, s_max=32, seed=7,
                                    temperature=temperature, device=cuda_device)
        batcher.graphed = graphed
        reqs = [Request(i, [1 + (i * 7 + j) % 250 for j in range(1 + i % 6)],
                        max_new=2 + i % 4) for i in range(9)]
        for r in reqs:
            batcher.submit(r)
        before = _launches()
        batcher.step()
        first = [a.clone() for a in T.cache_leaves(batcher.caches)]
        batcher.run()
        st = batcher.stats()
        moved = [a - b for a, b in zip(_launches(), before)]
        assert moved == [_macs_per_step(cfg) * (st["decode_steps"] + st["prefill_batches"]),
                         0, 0, 0, 0]
        assert st["host_syncs"] == st["decode_steps"] + st["prefill_batches"]
        steps = [step for _, step in batcher._prefill_steps.values()]
        assert all((step.graph is not None) == graphed for step in steps)
        if graphed:
            assert _prefill_replays(batcher) == st["prefill_batches"] - len(steps) > 0
            assert batcher.prefill_capture_seconds > 0
        runs[graphed] = ([r.generated for r in reqs], first,
                         list(T.cache_leaves(batcher.caches)))
    assert runs[True][0] == runs[False][0]
    for i in (1, 2):
        for a, b in zip(runs[True][i], runs[False][i]):
            assert torch.equal(a, b), i


@pytest.mark.cuda
def test_cuda_replayed_fill_allocates_nothing(cuda_device):
    """A fill that replays its bucket's graph allocates no device memory
    (the fresh caches, static inputs and outputs were all made before),
    and the decode graph's replays neither."""
    cfg, params = _smoke_model(cuda_device)
    batcher = ContinuousBatcher(params, cfg, n_slots=2, s_max=32, device=cuda_device)
    for i in range(4):
        batcher.submit(Request(i, [3 + i, 4, 5], max_new=3))
    while batcher.queue:
        batcher.step()
    batcher.run()
    for i in range(2):
        batcher.submit(Request(4 + i, [7, 8 + i], max_new=3))
    torch.cuda.synchronize()
    replays = _prefill_replays(batcher)
    before = torch.cuda.memory_stats(cuda_device)["allocation.all.allocated"]
    batcher.run()
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats(cuda_device)["allocation.all.allocated"] == before
    assert _prefill_replays(batcher) == replays + 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch,compression", [
    ("smollm-135m", None), ("smollm-135m", "int8"), ("mamba2-780m", None),
    ("zamba2-2.7b", None), ("deepseek-v2-236b", None)])
def test_cuda_captured_train_step_matches_eager(cuda_device, arch, compression):
    """make_jit_train_step on the card (one graph: loss, autograd under
    remat, compression, in-place AdamW) == make_train_step over 5 steps
    bit for bit (losses, grad norms, params, moments), under
    deterministic mode as the Trainer runs it; #1 launches per step
    unchanged through the replays; a call on another state raises."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_step import (init_train_state, make_jit_train_step,
                                              make_train_step)

    cfg = _family_cfg(arch)
    opt = adamw.AdamWConfig(lr=1e-3)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    batches = [{k: torch.from_numpy(v) for k, v in pipe.batch(i).items()} for i in range(5)]
    enabled = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {}
        for captured in (True, False):
            state = init_train_state(cfg, seed=0, grad_compression=compression,
                                     device=cuda_device)
            step = (make_jit_train_step if captured else make_train_step)(
                cfg, opt, grad_compression=compression)
            before = _launches()
            metrics = []
            for b in batches:
                state, m = step(state, {k: v.to(cuda_device) for k, v in b.items()})
                metrics.append({k: float(v) for k, v in m.items()})
            moved = [a - b for a, b in zip(_launches(), before)]
            runs[captured] = (metrics, ckpt.tree_flatten(state), moved)
            if captured:
                assert step.captured.graph is not None and step.captured.replays == 4
                other = init_train_state(cfg, seed=0, grad_compression=compression,
                                         device=cuda_device)
                with pytest.raises(ValueError, match="bound to the state storage"):
                    step(other, batches[0])
    finally:
        torch.use_deterministic_algorithms(enabled)
    assert runs[True][0] == runs[False][0]
    assert runs[True][2] == runs[False][2] and runs[True][2][0] > 0
    for a, b in zip(runs[True][1], runs[False][1]):
        if torch.is_tensor(a):
            assert torch.equal(a, b)
        else:
            assert torch.equal(a.get_state(), b.get_state())


# ---------------------------------------------------------------------------
# The front door and the profiler on the card
# ---------------------------------------------------------------------------


def _front_door_requests(n=8):
    return [([1 + (i * 7 + j) % 250 for j in range(1 + i % 5)], 3 + i % 4)
            for i in range(n)]


@pytest.mark.cuda
def test_cuda_two_replicas_through_the_front_door(cuda_device):
    """Two replicas of the smoke model on one card behind the front door:
    each captures its decode step and its prefill buckets while the other
    steps, under the device's one lock, so no capture is invalidated and
    #1's process-wide count is exact: 7 x layers x (decode steps + prefill
    batches) summed over the replicas; every stream == generate() (per_row),
    one host sync per step and fill batch, and both replicas replayed."""
    import asyncio

    from repro_torch.serve.frontdoor import (EngineWorker, FrontDoor, ReplicaRouter,
                                             SLOTracker, WSClient)

    cfg, params = _smoke_model(cuda_device, "per_row")
    reqs = _front_door_requests()

    async def scenario():
        tracker = SLOTracker()
        workers = [EngineWorker(f"r{i}", ContinuousBatcher(
            params, cfg, n_slots=2, s_max=32, device=cuda_device), tracker)
            for i in range(2)]
        door = FrontDoor(ReplicaRouter(workers), tracker)
        await door.start()
        try:
            conns = [await WSClient.connect(door.host, door.port) for _ in reqs]
            results = await asyncio.gather(*[
                ws.generate(p, m) for ws, (p, m) in zip(conns, reqs)])
            for ws in conns:
                await ws.close()
        finally:
            await door.stop()
        return results, workers

    torch.cuda.synchronize()
    before = tm.ternary_cim_matmul.launches
    results, workers = asyncio.run(scenario())
    moved = tm.ternary_cim_matmul.launches - before
    assert workers[0]._lock is workers[1]._lock
    steps = 0
    for w in workers:
        b = w.batcher
        st = b.stats()
        assert st["host_syncs"] == st["decode_steps"] + st["prefill_batches"] > 0
        assert b._decode.graph is not None and b._decode.replays > 0
        assert all(step.graph is not None for _, step in b._prefill_steps.values())
        steps += st["decode_steps"] + st["prefill_batches"]
    assert moved == _macs_per_step(cfg) * steps
    for res, (p, m) in zip(results, reqs):
        want = generate(params, [p], cfg, max_new=m, s_max=32,
                        device=cuda_device)[0].tolist()
        assert res["tokens"] == want, p


@pytest.mark.cuda
def test_cuda_profiled_batcher_one_event_per_call(cuda_device):
    """A profiled batcher on the card: one serve.decode_step event per
    decode step (every one after the first a replay) and one
    serve.prefill per fill batch, wall >= dispatch; its tokens and host
    syncs equal the unprofiled batcher's."""
    from repro_torch.profile import Profiler

    cfg, params = _smoke_model(cuda_device)
    runs = {}
    for profiled in (False, True):
        prof = Profiler() if profiled else None
        batcher = ContinuousBatcher(params, cfg, n_slots=4, s_max=32,
                                    device=cuda_device, profile=prof)
        runs[profiled] = (_serve(batcher, n=7), batcher.stats(), batcher, prof)
    assert runs[True][0] == runs[False][0] and runs[True][1] == runs[False][1]
    _, st, batcher, prof = runs[True]
    decode = [e for e in prof.events if e.entry_point == "serve.decode_step"]
    prefill = [e for e in prof.events if e.entry_point == "serve.prefill"]
    assert len(decode) == st["decode_steps"] == batcher._decode.replays + 1
    assert len(prefill) == st["prefill_batches"] == sum(
        1 + step.replays for _, step in batcher._prefill_steps.values())
    assert len(prof.events) == len(decode) + len(prefill)
    assert all(0 <= e.dispatch_us <= e.wall_us for e in prof.events)
    assert runs[False][2]._run_decode is runs[False][2]._decode


@pytest.mark.cuda
def test_cuda_sink_silent_during_capture(cuda_device):
    """With a profiler installed, an eager execute on the card records
    one event; the same call captured into a graph records nothing (a
    sync there would invalidate the capture), and the graph replays."""
    from repro_torch.core.execution import execute
    from repro_torch.profile import Profiler, set_profiler

    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randint(-1, 2, (4, 576), generator=g, device=cuda_device).float()
    w = torch.randint(-1, 2, (576, 192), generator=g, device=cuda_device).float()
    spec = CiMExecSpec("blocked", "cuda")
    prof = Profiler()
    prev = set_profiler(prof)
    try:
        eager = execute(spec, x, w)
        assert len(prof.events) == 1 and prof.events[0].meta["m"] == 4
        side = torch.cuda.Stream(cuda_device)
        side.wait_stream(torch.cuda.current_stream(cuda_device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = execute(spec, x, w)
        assert len(prof.events) == 1
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    finally:
        set_profiler(prev)


# ---------------------------------------------------------------------------
# The tile sweep and the calibration sweep on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def clean_sweep():
    from repro_torch.core import execution as X

    X.clear_tile_cache()
    yield X
    X.clear_tile_cache()
    X.set_shape_class_override(None)


def _winners(spec, cls, tiles):
    from repro_torch.profile import CalibrationTable

    return CalibrationTable(1, "cuda", spec.name, {},
                            tile_winners={spec.name: {cls: tuple(tiles)}})


SWEEP_SHAPES = [(4, 576, 1536), (200, 576, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["blocked/cuda/none", "exact/cuda/none"])
def test_cuda_autotune_every_candidate_bit_exact(cuda_device, clean_sweep, name):
    """autotune of #1 and #5 at a decode and a prefill shape: every
    candidate grid, installed and run through execute, equals the plain
    version bit for bit, and the kernel launched on that grid."""
    X = clean_sweep
    f, b, p = name.split("/")
    spec = CiMExecSpec(f, b, p)
    kernel = tm.ternary_cim_matmul if f == "blocked" else tm.ternary_exact_matmul
    report = X.autotune(spec, shapes=SWEEP_SHAPES, repeats=2)
    for m, k, n in SWEEP_SHAPES:
        cls = X.shape_class(m)
        entry = report[cls]
        assert set(entry["candidates"]) == {
            "x".join(map(str, t)) for t in X.tile_candidates(spec, cls, k)}
        assert entry["us"] == min(entry["candidates"].values()) > 0
        assert entry["default_us"] == entry["candidates"][
            "x".join(map(str, entry["default"]))]
        g = torch.Generator(device=cuda_device).manual_seed(m + n)
        x = torch.randint(-1, 2, (m, k), generator=g, device=cuda_device).float()
        w = torch.randint(-1, 2, (k, n), generator=g, device=cuda_device).float()
        xc, wc = x.to(torch.int8), w.to(torch.int8)
        plain = (tm.ternary_cim_matmul_plain(xc, wc) if f == "blocked"
                 else tm.exact_matmul_plain(xc, wc))
        for tiles in X.tile_candidates(spec, cls, k):
            X.autotune(spec, calibration=_winners(spec, cls, tiles))
            assert torch.equal(X.execute(spec, x, w), plain), tiles
            assert kernel.last_plan == X.kernel_plan(spec, m, k, n,
                                                     X.kplan.device_sms(cuda_device))
            assert (kernel.last_plan.rows, kernel.last_plan.cluster) == tiles


@pytest.mark.cuda
def test_cuda_winner_reaches_the_kernel_and_clear_restores(cuda_device, clean_sweep):
    """A cached winner changes the launched grid and not the output, for
    #1 and for #2 / #3 through execute_packed; clear_tile_cache brings
    back launch_plan's grid."""
    from repro_torch.kernels import plan as kp

    X = clean_sweep
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randint(-1, 2, (4, 576), generator=g, device=cuda_device).float()
    w = torch.randint(-1, 2, (576, 1536), generator=g, device=cuda_device).float()
    default = kp.device_plan(4, 576, 1536)
    spec = CiMExecSpec("blocked", "cuda")
    before = X.execute(spec, x, w)
    assert tm.ternary_cim_matmul.last_plan == default
    other = (32, 1 if default.cluster != 1 else 2)
    X.autotune(spec, calibration=_winners(spec, "decode", other))
    assert torch.equal(X.execute(spec, x, w), before)
    assert tm.ternary_cim_matmul.last_plan != default
    assert (tm.ternary_cim_matmul.last_plan.rows,
            tm.ternary_cim_matmul.last_plan.cluster) == other
    X.clear_tile_cache()
    X.execute(spec, x, w)
    assert tm.ternary_cim_matmul.last_plan == default
    # the stored-plane decode kernels: the winner's cluster (and ring depth)
    w8 = w.to(torch.int8)
    p1, p2 = pack_ternary(w8, axis=0)
    packed = CiMExecSpec("blocked", "cuda", "bitplane_u8")
    stream = CiMExecSpec("blocked", "cuda_stream", "bitplane_u8")
    want = X.execute_packed(packed, x, p1, p2)
    cluster = 1 if default.cluster != 1 else 2
    X.autotune(packed, calibration=_winners(packed, "decode", (8, cluster)))
    X.autotune(stream, calibration=_winners(stream, "decode", (8, cluster, 3)))
    assert torch.equal(X.execute_packed(packed, x, p1, p2), want)
    assert pm.packed_cim_matmul_decode.last_plan.cluster == cluster
    assert torch.equal(X.execute_packed(stream, x, p1, p2), want)
    assert pm.packed_cim_matmul_decode_stream.last_plan.cluster == cluster
    assert pm.packed_cim_matmul_decode_stream.last_plan.rows == 8


@pytest.mark.cuda
def test_cuda_profiled_sweep_calibrates_both_classes(cuda_device, clean_sweep):
    """Eager execute calls with a profiler installed, at decode and
    prefill M: calibrate fits #1 in both shape classes with per-call
    fixed costs above 0 and the events' meta."""
    from repro_torch.profile import Profiler, calibrate, set_profiler

    X = clean_sweep
    spec = CiMExecSpec("blocked", "cuda")
    g = torch.Generator(device=cuda_device).manual_seed(9)
    prof = Profiler()
    shapes = [(m, k, n) for m in (1, 4, 8, 64, 512) for k, n in ((576, 576), (576, 1536),
                                                                  (1536, 576))]
    for m, k, n in shapes:
        x = torch.randint(-1, 2, (m, k), generator=g, device=cuda_device).float()
        w = torch.randint(-1, 2, (k, n), generator=g, device=cuda_device).float()
        X.execute(spec, x, w)  # warm-up, not recorded
        prev = set_profiler(prof)
        try:
            for _ in range(2):
                X.execute(spec, x, w)
        finally:
            set_profiler(prev)
    assert len(prof.events) == 2 * len(shapes)
    table = calibrate(prof.events, backend="cuda")
    assert set(table.kernels) == {"blocked/cuda/none|decode", "blocked/cuda/none|prefill"}
    for fit in table.kernels.values():
        # the events count the weight as passed: f32 here
        assert fit.fixed_us > 0 and fit.bytes_per_weight == 4.0
    assert table.kernels["blocked/cuda/none|decode"].n_events == 18


@pytest.mark.cuda
def test_cuda_tp_functions_bit_equal(cuda_device):
    """execute_tp through #1 and #5, execute_packed_tp through #2/#4 and
    #3/#4, on 2 gloo ranks sharing cuda:0, at smollm-135m's widths and
    M in {1, 4, 8, 128}: bit-equal to execute / execute_packed."""
    checks, launched = spawn_tp(R.cuda_tp_functions, 2, timeout=600.0)
    bad = [name for name, ok in checks.items() if not ok]
    assert not bad, bad
    assert len(checks) == 2 * 4 * 2 + 2 * 4 * 2
    assert all(launched[name] > 0 for name in (
        "ternary_cim_matmul", "ternary_exact_matmul", "packed_cim_matmul_decode",
        "packed_cim_matmul", "packed_cim_matmul_decode_stream")), launched


@pytest.mark.cuda
def test_cuda_tp_batcher_matches_captured_single_device(cuda_device):
    """Full-size smollm-135m over 3 gloo ranks on the one card (3 heads
    and 1 kv head a rank, d_ff 512, vocab 16384): the tokens and stats of
    the captured single-device batcher; #1 launched 210 per step or fill
    in the rank."""
    cfg = get_config("smollm-135m")
    requests = [([5, 17, 33], 6), ([2], 9), ([7, 1, 8, 2, 8, 1, 8], 5), ([40], 7),
                ([11, 12], 4)]
    params = T.init_params(cfg, seed=0, device=cuda_device)
    single = ContinuousBatcher(params, cfg, n_slots=4, s_max=64, device=cuda_device)
    reqs = [Request(i, p, max_new=m) for i, (p, m) in enumerate(requests)]
    for r in reqs:
        single.submit(r)
    single.run()
    assert single.graphed
    del single, params
    torch.cuda.empty_cache()
    toks, stats, launches = spawn_tp(R.cuda_tp_serve, 3, requests, timeout=600.0)
    assert toks == [r.generated for r in reqs]
    assert stats["host_syncs"] == stats["decode_steps"] + stats["prefill_batches"]
    assert launches == 210 * (stats["decode_steps"] + stats["prefill_batches"])


@pytest.mark.cuda
def test_graph_kernel_events_time_a_replay(cuda_device):
    """Inside ``graph_kernel_events`` an ``execute`` call on the card
    returns its eager result and records the device time of a graph
    replay, which pays no host dispatch: less than the eager call's."""
    spec = CiMExecSpec("blocked", "cuda")
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randint(-1, 2, (4, 576), generator=g, device=cuda_device).to(torch.bfloat16)
    w = torch.randint(-1, 2, (576, 1536), generator=g, device=cuda_device).to(torch.bfloat16)
    want = X.execute(spec, x, w)
    prof = P.Profiler()
    prev = P.set_profiler(prof)
    try:
        eager = [X.execute(spec, x, w) for _ in range(3)]
        with X.graph_kernel_events():
            timed = [X.execute(spec, x, w) for _ in range(3)]
    finally:
        P.set_profiler(prev)
    assert all(torch.equal(o, want) for o in eager + timed)
    walls = [e.wall_us for e in prof.events]
    assert [e.meta.get("timing") for e in prof.events] == [None] * 3 + ["graph"] * 3
    assert 0 < min(walls[3:]) and max(walls[3:]) < min(walls[:3])


@pytest.mark.cuda
def test_cuda_dp_step_matches_single_device(cuda_device):
    """The data-parallel step on 2 gloo ranks sharing cuda:0 (smollm-135m
    smoke, f32, per_row, #1 on the card): step 0's loss at rtol 1e-6 and
    gradients at rtol 1e-5 / atol 1e-6, three steps' losses at rtol 1e-6
    and every weight within lr/10 of the single device's on the card;
    the params bit-equal on both ranks (checked there); #1 launched 14
    times a forward or step in the rank (7 dense layers x 2, no remat at
    smoke size)."""
    cfg = DP.smoke_cfg("smollm-135m", "per_row")
    tree = DP.numpy_tree(cfg)
    run = spawn_mesh(DP.cuda_dp, 2, 1, tree, "smollm-135m", timeout=600.0)
    one = DP.train_record(DP.state_from(tree, cfg, cuda_device), DP.batches(cfg.vocab),
                          cfg, device=cuda_device)
    torch.testing.assert_close(run["loss0"], one["loss0"], rtol=1e-6, atol=0)
    for k in one["grads0"]:
        torch.testing.assert_close(torch.from_numpy(run["grads0"][k]),
                                   torch.from_numpy(one["grads0"][k]), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(run["losses"], one["losses"], rtol=1e-6, atol=0)
    for k in one["params"]:
        assert abs(run["params"][k] - one["params"][k]).max() <= DP.LR / 10, k
    assert run["launches"] == 7 * cfg.n_layers * (2 + DP.STEPS)


@pytest.mark.cuda
def test_cuda_tp_step_matches_single_device(cuda_device):
    """The model-axis step on 2 gloo ranks sharing cuda:0 (smollm-135m
    smoke, f32, per_row, #1 on the card on each rank's shards): step 0's
    loss bit for bit, its gradients at rtol 1e-5 / atol 1e-6, three
    steps' losses at rtol 1e-6 and every weight within lr/10 of one
    device's on the card; the replicated leaves and their gradients
    bit-equal on both ranks (checked there); #1 launched 7 x n_layers in
    the rank for step 0's gradients and for each of the 3 steps (no remat
    at smoke size)."""
    cfg = TPT.case_cfg("smollm-135m", "per_row")
    tree = DP.numpy_tree(cfg)
    run = spawn_mesh(TPT.cuda_tp, 1, 2, tree, "smollm-135m", timeout=600.0)
    one = TPT.tp_record(tree, cfg, None, device=cuda_device)
    assert run["loss0"] == one["loss0"]
    for k in one["grads0"]:
        torch.testing.assert_close(torch.from_numpy(run["grads0"][k]),
                                   torch.from_numpy(one["grads0"][k]), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(run["losses"], one["losses"], rtol=1e-6, atol=0)
    for k in one["params"]:
        assert abs(run["params"][k] - one["params"][k]).max() <= DP.LR / 10, k
    assert run["launches"] == 7 * cfg.n_layers * (1 + DP.STEPS)


@pytest.mark.cuda
def test_cuda_tp_encdec_step_matches_single_device(cuda_device):
    """The model-axis step of whisper (smoke, f32, per_row, with seeded
    frames) on 2 gloo ranks sharing cuda:0, its encoder, cross attention
    and decoder on each rank's shards through #1: step 0's loss bit for
    bit, its gradients at rtol 1e-5 / atol 1e-6, three steps' losses at
    rtol 1e-6 and every weight within lr/10 of one device's on the card;
    the replicated leaves and their gradients bit-equal on both ranks
    (checked there); #1 launched 7 a encoder layer and 11 a decoder layer
    (q/k/v/o, cross q/k/v/o, gate/up/down) in the rank for step 0's
    gradients and for each of the 3 steps (no remat at smoke size)."""
    cfg = TPT.case_cfg("whisper-large-v3", "per_row")
    tree = DP.numpy_tree(cfg)
    run = spawn_mesh(TPT.cuda_tp, 1, 2, tree, "whisper-large-v3", timeout=600.0)
    one = TPT.tp_record(tree, cfg, None, device=cuda_device)
    assert run["loss0"] == one["loss0"]
    for k in one["grads0"]:
        torch.testing.assert_close(torch.from_numpy(run["grads0"][k]),
                                   torch.from_numpy(one["grads0"][k]), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(run["losses"], one["losses"], rtol=1e-6, atol=0)
    for k in one["params"]:
        assert abs(run["params"][k] - one["params"][k]).max() <= DP.LR / 10, k
    per_forward = 7 * cfg.n_encoder_layers + 11 * cfg.n_layers
    assert run["launches"] == per_forward * (1 + DP.STEPS)


@pytest.mark.cuda
@pytest.mark.parametrize("divisor", [2, 4])
def test_cuda_grouped_moe_equals_row_blocks(cuda_device, divisor):
    """deepseek-v2 smoke (bf16, per_row) on the card: moe_block and the
    whole forward at ``divisor`` routing groups == torch.cat of the
    single-group calls on the row blocks, bit for bit."""
    cfg = get_config("deepseek-v2-236b", smoke=True).replace(dtype="bfloat16")
    cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))
    params = T.init_params(cfg, seed=0, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(divisor)
    x = torch.randn((4, 16, cfg.d_model), generator=g, device=cuda_device).to(torch.bfloat16)
    layer = {k: v[0] for k, v in params["blocks"]["moe"].items() if not isinstance(v, dict)}
    layer["shared"] = {k: v[0] for k, v in params["blocks"]["moe"]["shared"].items()}
    grouped, parts = DP.moe_halves(layer, cfg, x, divisor)
    assert torch.equal(grouped, parts)
    tokens = torch.randint(0, cfg.vocab, (4, 16), generator=g, device=cuda_device)
    n = 4 // divisor
    with torch.no_grad():
        shd.enable_activation_sharding(batch_divisor=divisor)
        try:
            whole = T.forward(params, tokens, cfg)
        finally:
            shd.disable_activation_sharding()
        blocks = torch.cat([T.forward(params, tokens[i * n:(i + 1) * n], cfg)
                            for i in range(divisor)])
    assert torch.equal(whole, blocks)



@pytest.mark.cuda
def test_cuda_op_analysis_counts_launches_and_meta_flops_equal(cuda_device):
    """One eager train step of smoke smollm-135m (remat, CiM: #1 on every
    dense layer) recorded on the card: every launch carries its (M, K, N),
    and the dry run of the same step on the meta device counts the same
    FLOPs by dtype and the same calls of #1."""
    from repro_torch.launch import op_analysis
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.registry import ShapeCell
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = get_config("smollm-135m", smoke=True).replace(remat=True)
    state = init_train_state(cfg, seed=0, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (4, 32), generator=g, device=cuda_device)
    batch = {"tokens": tokens, "labels": tokens}
    before = tm.ternary_cim_matmul.launches
    rec = op_analysis.record(make_train_step(cfg, AdamWConfig()), state, batch)
    calls = 2 * 7 * cfg.n_layers
    assert tm.ternary_cim_matmul.launches - before == calls
    launched = [r for r in rec.trace if r.is_kernel]
    assert len(launched) == calls
    assert all(r.op == "kernel:ternary_cim_mac" and r.info[0] == 4 * 32 and r.info[3] == 2
               for r in launched)
    cost = op_analysis.analyze(rec.trace)
    dry = lower_cell(cfg, ShapeCell("x", "train", 32, 4),
                     mesh=AbstractMesh((1, 1), ("data", "model")), verbose=False)
    assert dry.ok, dry.error
    assert dry.op_cost["flops_by_dtype"] == dict(cost.flops_by_dtype)
    assert dry.op_cost["kernel_calls"] == dict(cost.kernel_calls) == {"ternary_cim_mac": calls}
