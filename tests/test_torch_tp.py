"""Tensor-parallel serving of the port (``dist/``, ``execute_tp``,
``execute_packed_tp``, ``ContinuousBatcher(mesh=)``) against the port on
one device and against the JAX package's TP.

The port's ranks are processes of a gloo group on the CPU, spawned once
per degree for the whole module (``launch.mesh.spawn_tp``, the rank
functions in ``torch_tp_ranks.py``, every spawn under a deadline that
kills its ranks); the JAX side runs here on the 8 virtual devices of
``conftest.py``. The contract:

  * the TP batcher at tp=2 (heads split) and tp=4 (2 kv heads do not
    divide: attention replicated, the MLP and vocabulary split) gives the
    single-device batcher's tokens and stats, cim, f32 and bf16;
  * against the reference's TP batcher, a greedy prefix (a float ulp
    between the frameworks can flip a late token);
  * ``execute_tp`` == ``execute`` of both packages bit for bit on every
    unpacked spec; ``execute_packed_tp`` == the single-device
    ``execute_packed`` of both (the reference's own ``execute_packed_tp``
    fails on the installed jax, so it is not compared);
  * a decode step's collectives do not depend on ``n_slots``;
  * the guards raise, before any collective.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks as R
from repro.core.execution import CiMExecSpec as JSpec
from repro.core.execution import execute_packed as jexecute_packed
from repro.core.execution import execute_tp as jexecute_tp
from repro.dist.sharding import param_specs as jparam_specs
from repro.launch.mesh import make_tp_mesh as jmake_tp_mesh
from repro.models import transformer as jT
from repro.models.registry import get_config as jget_config
from repro.quant.prepare import prepare_for_spec as jprepare
from repro.serve.engine import ContinuousBatcher as JBatcher
from repro.serve.engine import Request as JRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.core.execution import (CiMExecSpec, canonical_plane_layout, execute,
                                        execute_packed, execute_packed_tp, execute_tp)
from repro_torch.dist import sharding as shd
from repro_torch.launch import serve as launcher
from repro_torch.launch.mesh import TPMesh, spawn_tp
from repro_torch.models import transformer as T
from repro_torch.models.layers import QuantConfig, dense
from repro_torch.models.registry import get_config
from repro_torch.quant.prepare import prepare_for_spec
from repro_torch.serve.engine import ContinuousBatcher
from torch_threads import one_thread  # noqa: F401

DTYPES = ("float32", "bfloat16")
SPAWN_TIMEOUT = 240.0


def _ternary(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-1, 2, shape) * (rng.random(shape) > 0.3)).astype(np.float32)


X = _ternary((8, 200), 1)          # K 200: not a multiple of 16 * tp
W = _ternary((200, 48), 2)
PLANES_W = _ternary((96, 200), 3)  # N 200: the canonical pad is 256


def _jax_tree(dtype):
    jcfg = jget_config("smollm-135m", smoke=True).replace(dtype=dtype)
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jparams)


@pytest.fixture(scope="module")
def trees():
    return {d: _jax_tree(d)[2] for d in DTYPES}


@pytest.fixture(scope="module")
def tp2(trees):
    return spawn_tp(R.tp_suite, 2, trees, X, W, PLANES_W, "all",
                    timeout=SPAWN_TIMEOUT, threads=1)


@pytest.fixture(scope="module")
def tp4(trees):
    return spawn_tp(R.tp_suite, 4, trees, X, W, PLANES_W, "serve",
                    timeout=SPAWN_TIMEOUT, threads=1)


@pytest.fixture(scope="module")
def single(trees):
    out = {}
    for dtype in DTYPES:
        cfg = R.smoke_cfg(dtype)
        out[dtype] = R.serve(params_from_numpy(trees[dtype], cfg, device="cpu"), cfg)
    return out


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("degree", ["tp2", "tp4"])
def test_tp_batcher_tokens_equal_single_device(request, single, degree, dtype):
    """cim mode: every statistic is taken over whole rows and weights as
    on one device and every partial sum is integer counts, so the ranks
    sample the single-device tokens; host_syncs and decode_steps too."""
    got = request.getfixturevalue(degree)[f"serve_{dtype}"]
    assert got[0] == single[dtype][0]
    assert got[1] == single[dtype][1]


def test_tp_batcher_greedy_prefix_vs_reference_tp(tp2, trees):
    """The port's TP tokens against the reference's ContinuousBatcher on
    a 2-device mesh (bf16, cim, per-row activation scales: under the
    per-tensor default the left-pad rows of a batched prefill enter
    every row's scale, and the frameworks fill them differently): a
    prefix of >= 2 tokens per request, and the port's TP equals its own
    single device."""
    jcfg, jparams, _ = _jax_tree("bfloat16")
    jcfg = jcfg.replace(quant=dataclasses.replace(jcfg.quant, act_scale="per_row"))
    jb = JBatcher(jparams, jcfg, n_slots=2, s_max=32, mesh=jmake_tp_mesh(2))
    jreqs = [JRequest(i, p, max_new=m) for i, (p, m) in
             enumerate(zip(R.PROMPTS, R.MAX_NEWS))]
    for r in jreqs:
        jb.submit(r)
    jb.run()
    toks, stats = tp2["serve_per_row"]
    for got, want in zip(toks, jreqs):
        prefix = next((i for i, (a, b) in enumerate(zip(got, want.generated))
                       if a != b), len(want.generated))
        assert prefix >= 2, (got, want.generated)
    assert stats == jb.stats()
    cfg = R.smoke_cfg("bfloat16", act_scale="per_row")
    assert (toks, stats) == R.serve(
        params_from_numpy(trees["bfloat16"], cfg, device="cpu"), cfg)


def test_prepared_planes_sharded_and_serving_token_identical(tp2, trees):
    """prepare_weights under the mesh: each rank stores its column shard
    of every plane (half the padded columns), and serving from the folded
    weights equals the single-device prepared batcher."""
    planes = tp2["prepared_planes"]
    assert planes and all(shards == 2 for _, shards in planes.values())
    cfg = R.smoke_cfg("bfloat16")
    params = params_from_numpy(trees["bfloat16"], cfg, device="cpu")
    whole = ContinuousBatcher(params, cfg, n_slots=2, s_max=32, device="cpu",
                              exec_spec=R.PREPARED_SPEC, prepare_weights=True).packed
    for path, (shape, _) in planes.items():
        assert shape == whole[path].pos.shape[:-1] + (whole[path].pos.shape[-1] // 2,)
    assert tp2["prepared"] == R.serve(params, cfg, exec_spec=R.PREPARED_SPEC,
                                      prepare_weights=True)


def test_compressed_tp_serves_with_the_same_discipline(tp2, single):
    toks, stats = tp2["compressed"]
    assert stats == single["float32"][1]
    cfg = R.smoke_cfg("float32")
    for t, m in zip(toks, R.MAX_NEWS):
        assert len(t) == m and all(0 <= x < cfg.vocab for x in t)


def test_compressed_tp_row_layers_within_bound_and_not_exact(tp2):
    """Under compress_tp every row-parallel MAC of a fill and a decode
    step goes through the int8 sum: within shards * amax/127 * 1.5 of the
    exact sum of the same partials (amax: the shared scale's), and not
    bit-equal to it; a decode step runs one MAX all-reduce (the shared
    scale) more per row-parallel layer than the exact step, and the same
    gathers."""
    calls, stats = tp2["compressed_layers"]
    n_layers = R.smoke_cfg("float32").n_layers
    steps = stats["decode_steps"] + stats["prefill_batches"]
    assert steps >= 2 and len(calls) == 2 * n_layers * steps
    for c in calls:
        assert c["compressed"] and not c["equal"], c
        assert c["err"] <= 2 * c["amax"] / 127.0 * 1.5, c
    exact, comp = tp2["step_collectives"][2], tp2["step_collectives_compressed"]
    assert comp == {"all_reduce": exact["all_reduce"] + 2 * n_layers,
                    "all_gather": exact["all_gather"]}


def test_decode_step_collectives_independent_of_slots(tp2):
    """One decode step: an embedding sum, per layer two row-parallel
    layers (a gather of the input and a sum of the partials), and the
    logits' gather, at any n_slots."""
    counts = tp2["step_collectives"]
    n_layers = R.smoke_cfg("float32").n_layers
    assert counts[2] == counts[4] == {"all_reduce": 1 + 2 * n_layers,
                                      "all_gather": 1 + 2 * n_layers}


# ---------------------------------------------------------------------------
# execute_tp / execute_packed_tp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", R.TP_SPECS)
def test_execute_tp_bit_equal(tp2, name):
    form, backend = name.split("/")
    spec = CiMExecSpec(formulation=form, backend=backend)
    got = tp2["execute_tp"][name]
    want = execute(spec, torch.from_numpy(X), torch.from_numpy(W)).numpy()
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(jexecute_tp(JSpec(formulation=form, backend="jnp"),
                                 jnp.asarray(X), jnp.asarray(W), jmake_tp_mesh(2)))
    np.testing.assert_array_equal(got, ref)


def test_execute_tp_compressed_within_bound(tp2):
    base = execute(CiMExecSpec("blocked", "torch"), torch.from_numpy(X),
                   torch.from_numpy(W)).numpy()
    bound = 2 * (np.abs(base).max() / 127.0 + 1e-6) * 1.5
    assert np.abs(tp2["execute_tp_compressed"] - base).max() <= bound
    first, second = tp2["execute_tp_compressed_default"]
    # the default stream is a pure function of the shapes and the rank
    np.testing.assert_array_equal(first, second)
    assert np.abs(first - base).max() <= bound


@pytest.mark.parametrize("name", R.PACKED_SPECS)
def test_execute_packed_tp_bit_equal(tp2, name):
    form, backend = name.split("/")
    spec = CiMExecSpec(formulation=form, backend=backend, packing="bitplane_u8")
    whole = prepare_for_spec({"wq": torch.from_numpy(PLANES_W)}, spec)[1]["wq"]
    jplanes = jprepare({"wq": jnp.asarray(PLANES_W)},
                       JSpec(formulation=form, backend="jnp",
                             packing="bitplane_u8"))[1]["wq"]
    for m in R.PACKED_M:
        xm, from_shard, from_whole = tp2["packed"][(name, m)]
        want = execute_packed(spec, torch.from_numpy(xm), whole).numpy()
        np.testing.assert_array_equal(from_shard, want, err_msg=f"M={m}")
        np.testing.assert_array_equal(from_whole, want, err_msg=f"M={m}")
        ref = np.asarray(jexecute_packed(
            JSpec(formulation=form, backend="jnp", packing="bitplane_u8"),
            jnp.asarray(xm), jplanes))
        np.testing.assert_array_equal(from_shard, ref, err_msg=f"M={m}")
    # the mesh's prepare pads N to tp tiles and keeps this rank's half
    _, n_mult = canonical_plane_layout(spec, "cpu")
    k_rows, n_pad = whole.pos.shape
    assert n_pad == -(-200 // n_mult) * n_mult
    assert tp2[f"shard_shape_{name}"] == ((k_rows, -(-200 // (2 * n_mult)) * n_mult), 2)


# ---------------------------------------------------------------------------
# Placement (no collective runs: a rank-0 view of a mesh with no group)
# ---------------------------------------------------------------------------


def _view(size, rank=0, axes=("data", "model")):
    return TPMesh(None, rank, size, tuple(range(size)), axes)


def test_param_specs_match_reference():
    cfg = get_config("smollm-135m")
    jcfg = jget_config("smollm-135m")
    shapes = jax.eval_shape(lambda: jT.init_params(jax.random.PRNGKey(0), jcfg))
    params = jax.tree_util.tree_map(lambda s: torch.empty(s.shape, device="meta"),
                                    shapes)
    for sizes, fsdp in (({"data": 1, "model": 2}, False), ({"data": 1, "model": 3}, False),
                        ({"data": 1, "model": 4}, False), ({"data": 2, "model": 4}, True)):
        want = jparam_specs(shapes, fsdp=fsdp, axis_sizes=sizes)
        got = shd.param_specs(params, fsdp=fsdp, axis_sizes=sizes)
        flat = dict(jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0])
        for path, spec in flat.items():
            node = got
            for k in path:
                node = node[k.key]
            assert node == tuple(spec) + (None,) * (len(node) - len(spec)), path
    assert shd.attention_splits(cfg, 3) and not shd.attention_splits(cfg, 2)
    planes = prepare_for_spec({"wq": torch.from_numpy(PLANES_W)},
                              CiMExecSpec("blocked", "torch", "bitplane_u8"))[1]
    assert shd.packed_specs(planes, {"data": 1, "model": 2})["wq"] == {
        "pos": (None, "model"), "neg": (None, "model"), "scale": (None, None)}
    assert shd.packed_specs(planes, {"data": 1, "model": 3})["wq"]["pos"] == (None, None)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_and_caches_layout(tp):
    cfg = get_config("smollm-135m", smoke=True)
    params = T.init_params(cfg, seed=0, device="cpu")
    mesh = _view(tp, rank=1)
    local = shd.shard_params(params, cfg, mesh)
    lcfg = shd.local_config(cfg, mesh)
    n, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    attn = shd.attention_splits(cfg, tp)
    assert attn == (tp == 2)
    up, down = local["blocks"]["mlp"]["w_up"], local["blocks"]["mlp"]["w_down"]
    assert (up.kind, tuple(up.w.shape), tuple(up.scale.shape)) == ("col", (n, d, f // tp),
                                                                    (n, 1, f // tp))
    assert (down.kind, tuple(down.w.shape), tuple(down.scale.shape)) == (
        "row", (n, f // tp, d), (n, 1, d))
    emb = local["embed"]
    assert (emb.offset, tuple(emb.table.shape)) == (cfg.vocab // tp, (cfg.vocab // tp, d))
    # the shards are slices of the whole weight's codes, taken layer by layer
    from repro_torch.models.layers import _weight_codes

    codes, scale = _weight_codes(params["blocks"]["mlp"]["w_down"][1], cfg.quant)
    rows = down.w.shape[-2]
    assert torch.equal(down.w[1], codes[rows:2 * rows]) and torch.equal(down.scale[1], scale)
    wo = local["blocks"]["attn"]["wo"]
    if attn:
        assert (wo.kind, lcfg.n_heads, lcfg.n_kv_heads) == ("row", cfg.n_heads // tp,
                                                            cfg.n_kv_heads // tp)
    else:
        assert torch.is_tensor(wo) and lcfg is cfg
    whole = T.init_caches(cfg, 2, 16, device="cpu")
    mine = T.init_caches(lcfg, 2, 16, device="cpu")
    for leaf, spec, part in zip(T.cache_leaves(whole),
                                shd.cache_specs(whole, mesh, 2, cfg),
                                T.cache_leaves(mine)):
        split = spec[3] == "model"
        want = leaf.shape[:3] + (leaf.shape[3] // tp if split else leaf.shape[3],) \
            + leaf.shape[4:]
        assert part.shape == want


def test_guards_raise_before_any_collective():
    cfg = get_config("smollm-135m", smoke=True)
    params = T.init_params(cfg, seed=0, device="cpu")
    mesh = _view(2)
    x, w = torch.from_numpy(X), torch.from_numpy(W)
    with pytest.raises(ValueError, match="packed"):
        execute_tp(CiMExecSpec("blocked", "torch", "bitplane_u8"), x, w, mesh)
    with pytest.raises(ValueError, match="error"):
        execute_tp(CiMExecSpec("blocked", "torch", error_prob=0.1), x, w, mesh)
    with pytest.raises(ValueError, match="'model'"):
        execute_tp(CiMExecSpec("blocked", "torch"), x, w, _view(2, axes=("x",)))
    spec = CiMExecSpec("blocked", "torch", "bitplane_u8")
    planes = prepare_for_spec({"wq": torch.from_numpy(PLANES_W)}, spec)[1]["wq"]
    xp = torch.zeros((1, planes.k))
    with pytest.raises(ValueError, match="does not divide"):
        execute_packed_tp(spec, xp, planes, _view(3))
    with pytest.raises(ValueError, match="split 2 ways"):
        execute_packed_tp(spec, xp, planes.column_shard(0, 2), _view(4))
    with pytest.raises(ValueError, match="execute_packed_tp"):
        execute_packed(spec, xp, planes.column_shard(0, 2))
    with pytest.raises(ValueError, match="model"):
        ContinuousBatcher(params, cfg, n_slots=2, s_max=16, device="cpu",
                          mesh=_view(2, axes=("x",)))
    with pytest.raises(ValueError, match="mesh"):
        ContinuousBatcher(params, cfg, n_slots=2, s_max=16, device="cpu",
                          compress_tp=True)
    off = cfg.replace(quant=QuantConfig(mode="off"))
    with pytest.raises(ValueError, match="quantized"):
        ContinuousBatcher(params, off, n_slots=2, s_max=16, device="cpu", mesh=mesh,
                          compress_tp=True)
    with pytest.raises(ValueError, match="prepare_weights"):
        with pytest.warns(UserWarning):
            ContinuousBatcher(params, cfg, n_slots=2, s_max=16, device="cpu",
                              mesh=mesh, compress_tp=True, exec_spec=spec)
    with pytest.raises(ValueError, match="tp_reduce"):
        QuantConfig(mode="off", tp_reduce="int8")
    with pytest.raises(ValueError, match="tp_reduce"):
        QuantConfig(mode="cim", tp_reduce="int4")
    mlp = shd.shard_params(params, cfg, mesh)["blocks"]["mlp"]
    shard = mlp["w_up"][0]
    with pytest.raises(ValueError, match="col-parallel"):
        dense(torch.zeros((1, cfg.d_model)), shard, cfg.quant, tp="row")
    # a noisy spec raises on either kind of shard, not only in execute_tp
    noisy = dataclasses.replace(cfg.quant, exec_spec=CiMExecSpec(
        "blocked", "torch", error_prob=0.1))
    with pytest.raises(ValueError, match="sensing-error"):
        dense(torch.ones((1, cfg.d_model)), shard, noisy, tp="col")
    with pytest.raises(ValueError, match="sensing-error"):
        dense(torch.ones((1, cfg.d_ff)), mlp["w_down"][0], noisy, tp="row")
    # mode "off" splits the float weights (no codes, no scale)
    up = shd.shard_params(params, off, mesh)["blocks"]["mlp"]["w_up"]
    assert up.scale is None and torch.equal(
        up.w, params["blocks"]["mlp"]["w_up"][..., :cfg.d_ff // 2])
    # every family splits (encdec and vlm serve their decoders); a family
    # the model does not know raises before any collective
    for arch in ("whisper-large-v3", "llava-next-34b"):
        other = get_config(arch, smoke=True)
        b = ContinuousBatcher(T.init_params(other, seed=0, device="cpu"), other,
                              n_slots=2, s_max=16, device="cpu", mesh=mesh)
        assert (b.cfg.n_heads, b.cfg.n_kv_heads) == (other.n_heads // 2,
                                                     other.n_kv_heads // 2)
    with pytest.raises(ValueError, match="unknown family"):
        ContinuousBatcher(params, cfg.replace(family="bogus"), n_slots=2, s_max=16,
                          device="cpu", mesh=mesh)


def test_launcher_tp_and_its_checks(capsys, monkeypatch):
    """--compress-tp without --tp is refused; --tp 2 --compress-tp serves;
    --tp 2 --serve-http (the front door over a TP rank group per replica)
    runs its selftest with --compress-tp passed through to every rank."""
    monkeypatch.setattr(launcher, "TP_TIMEOUT_S", 120.0)
    with pytest.raises(SystemExit):
        launcher.main(["--smoke", "--device", "cpu", "--compress-tp"])
    assert launcher.main(["--smoke", "--device", "cpu", "--tp", "2", "--compress-tp",
                          "--requests", "2"]) == 0
    out = capsys.readouterr().out
    assert "tp=2 int8-compressed rank 0" in out and "request 1:" in out
    assert launcher.main(["--smoke", "--device", "cpu", "--tp", "2", "--serve-http",
                          "--selftest", "--replicas", "1", "--compress-tp"]) == 0
    out = capsys.readouterr().out
    assert "1 replica x tp 2 on cpu" in out and "selftest ok" in out
