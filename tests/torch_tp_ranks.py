"""Rank functions of the port's tensor-parallel tests
(``test_torch_tp.py``, ``test_torch_tp_families.py``,
``test_torch_collectives.py``, ``test_torch_frontdoor_tp.py``).

``launch.mesh.spawn_tp`` pickles a rank function by its import path and
runs it in fresh processes; this module imports neither JAX nor the JAX
package, so the ranks start with torch only. Each function runs many
checks in one spawned group and returns plain data for the test process
to compare.
"""
import dataclasses
import time

import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.core.execution import CiMExecSpec, execute_packed_tp, execute_tp
from repro_torch.dist import collectives as C
from repro_torch.launch.mesh import make_replica_meshes
from repro_torch.models.registry import get_config
from repro_torch.quant.prepare import prepare_for_spec
from repro_torch.serve.engine import ContinuousBatcher, Request

PROMPTS = [[3, 1, 4], [9, 8], [2, 7, 1, 8, 2], [6]]
MAX_NEWS = [4, 5, 3, 4]

# the unpacked specs of the port's registry (the cuda backends take their
# plain versions on CPU tensors)
TP_SPECS = tuple(f"{f}/{b}" for f in ("exact", "blocked", "corrected",
                                      "bitplane", "fused") for b in ("torch",)) + (
    "blocked/cuda", "exact/cuda")
PACKED_SPECS = ("blocked/cuda", "exact/cuda", "blocked/torch", "blocked/cuda_stream")
PACKED_M = (1, 4, 8, 128)
# fresh rounding streams of the compressed sum's unbiasedness check
INT_TRIALS = 256
PREPARED_SPEC = CiMExecSpec(formulation="blocked", backend="torch", packing="bitplane_u8")


def smoke_cfg(dtype, **quant):
    cfg = get_config("smollm-135m", smoke=True).replace(dtype=dtype)
    if quant:
        cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, **quant))
    return cfg


def serve(params, cfg, mesh=None, n_slots=2, **kw):
    """PROMPTS through a batcher; (tokens per request, stats)."""
    b = ContinuousBatcher(params, cfg, n_slots=n_slots, s_max=32, device="cpu",
                          mesh=mesh, **kw)
    reqs = [Request(i, p, max_new=m) for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEWS))]
    for r in reqs:
        b.submit(r)
    b.run()
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs], b.stats()


def decode_step_collectives(params, cfg, mesh, n_slots, **kw):
    """Collectives of one decode step (no fill in it) of a TP batcher."""
    b = ContinuousBatcher(params, cfg, n_slots=n_slots, s_max=32, device="cpu",
                          mesh=mesh, **kw)
    for i in range(n_slots):
        b.submit(Request(i, [1 + i, 2], max_new=4))
    b.step()                     # the fill and the first decode step
    C.reset_counts()
    b.step()                     # a decode step alone
    return dict(C.COUNTS)


def compressed_row_layers(params, cfg, mesh):
    """The fill and first decode step of a ``compress_tp`` batcher, every
    row-parallel MAC (``layers.execute_row_shard``) also run exact on the
    same operands: per call, whether it went compressed, max |compressed
    - exact|, the shared scale's amax (of the f32 partials the int8 sum
    took), and bit-equality; and the batcher's stats."""
    from repro_torch.models import layers

    real_row, real_psum = layers.execute_row_shard, C.compressed_psum_int8
    amax, calls = [], []

    def psum(x, group, generator):
        amax.append(float(C.all_reduce(x.abs().amax().reshape(1), group, op="max")))
        return real_psum(x, group, generator)

    def row(spec, x_t, w_rows, mesh, *, compressed=False, generator=None):
        got = real_row(spec, x_t, w_rows, mesh, compressed=compressed,
                       generator=generator)
        exact = real_row(spec, x_t, w_rows, mesh)
        calls.append({"compressed": compressed,
                      "err": float((got - exact).abs().max()),
                      "amax": amax.pop() if compressed else None,
                      "equal": torch.equal(got, exact)})
        return got

    b = ContinuousBatcher(params, cfg, n_slots=2, s_max=32, device="cpu", mesh=mesh,
                          compress_tp=True)
    for i, p in enumerate(PROMPTS[:2]):
        b.submit(Request(i, p, max_new=4))
    layers.execute_row_shard, C.compressed_psum_int8 = row, psum
    try:
        b.step()
    finally:
        layers.execute_row_shard, C.compressed_psum_int8 = real_row, real_psum
    return calls, b.stats()


def _spec(name, packing="none"):
    form, backend = name.split("/")
    return CiMExecSpec(formulation=form, backend=backend, packing=packing)


def tp_suite(mesh, trees, x, w, planes_w, serve_checks):
    """The checks of one spawned group: serving (cim, f32 and bf16, on
    the bridged ``trees``), and where ``serve_checks`` is "all" also bf16
    under per-row activation scales, the compressed path (served, its
    row-parallel layers against the exact sum, its decode step's
    collectives), the collectives of a decode step at 2 and 4 slots,
    ``execute_tp`` on every unpacked spec (exact and compressed) and
    ``execute_packed_tp`` on the prepared planes of ``planes_w``."""
    out = {}
    for dtype, tree in trees.items():
        cfg = smoke_cfg(dtype)
        params = params_from_numpy(tree, cfg, device="cpu")
        out[f"serve_{dtype}"] = serve(params, cfg, mesh)
        if serve_checks == "all" and dtype == "float32":
            out["compressed"] = serve(params, cfg, mesh, compress_tp=True)
            out["step_collectives"] = {
                n: decode_step_collectives(params, cfg, mesh, n) for n in (2, 4)}
            out["step_collectives_compressed"] = decode_step_collectives(
                params, cfg, mesh, 2, compress_tp=True)
            out["compressed_layers"] = compressed_row_layers(params, cfg, mesh)
        if serve_checks == "all" and dtype == "bfloat16":
            out["serve_per_row"] = serve(params, smoke_cfg(dtype, act_scale="per_row"),
                                         mesh)
            b = ContinuousBatcher(params, cfg, n_slots=2, s_max=32, device="cpu",
                                  mesh=mesh, exec_spec=PREPARED_SPEC,
                                  prepare_weights=True)
            out["prepared_planes"] = {path: (tuple(p.pos.shape), p.shards)
                                      for path, p in b.packed.items()}
            out["prepared"] = serve(params, cfg, mesh, exec_spec=PREPARED_SPEC,
                                    prepare_weights=True)
    if serve_checks != "all":
        return out
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    out["execute_tp"] = {name: execute_tp(_spec(name), xt, wt, mesh)
                         for name in TP_SPECS}
    g = torch.Generator().manual_seed(100 + mesh.rank)
    out["execute_tp_compressed"] = execute_tp(_spec("blocked/torch"), xt, wt, mesh,
                                              compressed=True, generator=g)
    out["execute_tp_compressed_default"] = [
        execute_tp(_spec("blocked/torch"), xt, wt, mesh, compressed=True)
        for _ in range(2)]
    weight = {"wq": torch.from_numpy(planes_w)}
    packed = {}
    for name in PACKED_SPECS:
        spec = _spec(name, "bitplane_u8")
        shard = prepare_for_spec(weight, spec, mesh=mesh)[1]["wq"]
        whole = prepare_for_spec(weight, spec)[1]["wq"]
        out[f"shard_shape_{name}"] = (tuple(shard.pos.shape), shard.shards)
        g = torch.Generator().manual_seed(7)
        for m in PACKED_M:
            xm = torch.randint(-1, 2, (m, whole.k), generator=g).to(torch.float32)
            packed[(name, m)] = (xm, execute_packed_tp(spec, xm, shard, mesh),
                                 execute_packed_tp(spec, xm, whole, mesh))
    out["packed"] = packed
    return out


# the reference's TP family sweep (tests/test_tp_serve.py): one smoke arch
# per family, deepseek-v2 at a capacity factor that drops nothing
FAMILY_ARCHS = {"dense": "smollm-135m", "ssm": "mamba2-780m",
                "hybrid": "zamba2-2.7b", "moe": "deepseek-v2-236b",
                "encdec": "whisper-large-v3", "vlm": "llava-next-34b"}


def family_cfg(family, mode, dtype=None):
    """The family's smoke config (bf16, the registry default, unless
    ``dtype``) in ``mode`` ("off", or "cim", the registry's own)."""
    from repro_torch.models.layers import QuantConfig

    cfg = get_config(FAMILY_ARCHS[family], smoke=True)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    if family == "moe":
        cfg = cfg.replace(moe_capacity_factor=8.0)
    if mode == "off":
        cfg = cfg.replace(quant=QuantConfig(mode="off"))
    return cfg


def prefill_logits(params, cfg, mesh=None):
    """PROMPTS left-padded into one batch, prefilled through
    ``decode_step`` on a batcher's params and caches (the rank's shard
    under ``mesh``): the logits (B, S, V) as float32."""
    from repro_torch.models import transformer as T

    b = ContinuousBatcher(params, cfg, n_slots=len(PROMPTS), s_max=32, device="cpu",
                          mesh=mesh)
    s_pad = max(map(len, PROMPTS))
    tokens = torch.zeros((len(PROMPTS), s_pad), dtype=torch.int64)
    start = torch.tensor([s_pad - len(p) for p in PROMPTS])
    for i, p in enumerate(PROMPTS):
        tokens[i, s_pad - len(p):] = torch.tensor(p)
    with torch.no_grad():
        logits, _ = T.decode_step(b.params, tokens, b.caches, 0, b.cfg, start=start)
    return logits.to(torch.float32)


def forward_logits(params, cfg, mesh=None):
    """encdec and vlm: ``transformer.forward`` of PROMPTS[2] with seeded
    frames or image patches (the leaves the batcher never reads: the
    encoder, cross attention, the projector), on the rank's shards under
    ``mesh``; the logits as float32."""
    from repro_torch.dist.sharding import local_config, shard_params
    from repro_torch.models import transformer as T

    g = torch.Generator().manual_seed(3)
    if cfg.family == "encdec":
        kw = {"frames": torch.randn((1, cfg.encoder_seq, cfg.d_model), generator=g)}
    else:
        kw = {"patches": torch.randn((1, cfg.n_image_tokens, cfg.d_vision), generator=g)}
    if mesh is not None:
        params, cfg = shard_params(params, cfg, mesh), local_config(cfg, mesh)
    with torch.no_grad():
        return T.forward(params, torch.tensor([PROMPTS[2]]), cfg, **kw).to(torch.float32)


def tp_family_suite(mesh, trees, modes, f32=()):
    """Every family of ``trees`` (the bridged reference trees, by family)
    on one spawned group: per mode of ``modes``, PROMPTS served (tokens,
    stats) and, in mode "off", the prefill logits of :func:`prefill_logits`
    and, for encdec and vlm, :func:`forward_logits`; the families of
    ``f32`` also served in mode "off" at float32 (key ``(family,
    "float32")``)."""
    out = {}
    for family in f32:
        cfg = family_cfg(family, "off", "float32")
        out[(family, "float32")] = serve(params_from_numpy(trees[family], cfg,
                                                           device="cpu"), cfg, mesh)
    for family, tree in trees.items():
        for mode in modes:
            if mode == "cim" and family == "dense":
                continue                 # test_torch_tp.py serves it
            cfg = family_cfg(family, mode)
            params = params_from_numpy(tree, cfg, device="cpu")
            out[(family, mode)] = serve(params, cfg, mesh)
            if mode == "off":
                out[(family, "logits")] = prefill_logits(params, cfg, mesh)
                if family in ("encdec", "vlm"):
                    out[(family, "forward")] = forward_logits(params, cfg, mesh)
    return out


def collectives_suite(mesh, sweep, unbiased_trials):
    """The collectives on one spawned group: the compressed sum over a
    seeded sweep (each rank's own draw of each case, and its result), the
    mean of many compressed sums of one case under fresh generators, the
    exact sum, max and gather, a raise without a generator, and
    ``mean_grads_int8``."""
    out = {"sweep": [], "mesh": (mesh.rank, mesh.ranks, mesh.shape)}
    rows = make_replica_meshes(2, mesh.size // 2)
    mine = [m for m in rows if m.group is not None]
    out["replicas"] = ([(m.rank, m.ranks) for m in rows],
                       C.all_reduce(torch.tensor([float(mesh.rank)]), mine[0].group))
    for seed, scale, shape in sweep:
        g = torch.Generator().manual_seed(seed * 131 + mesh.rank)
        x = torch.randn(shape, generator=g) * scale
        got = C.compressed_psum_int8(x, mesh.group,
                                     torch.Generator().manual_seed(seed + 1000 * mesh.rank))
        out["sweep"].append((C.all_gather(x[None], mesh.group, dim=0), got))
    g = torch.Generator().manual_seed(5 + mesh.rank)
    x = torch.randn((64,), generator=g)
    acc = torch.zeros(64, dtype=torch.float64)
    for t in range(unbiased_trials):
        gen = torch.Generator().manual_seed(10_000 + 97 * t + mesh.rank)
        acc += C.tp_allreduce(x, mesh.group, generator=gen, compressed=True).double()
    out["unbiased"] = (C.all_gather(x[None], mesh.group, dim=0), acc / unbiased_trials)
    # fixed integer partials (event counts), 256 fresh rounding streams
    ints = ((torch.arange(96) * (mesh.rank + 3)) % 81 - 40).to(torch.float32)
    acc = torch.zeros(96, dtype=torch.float64)
    for t in range(INT_TRIALS):
        gen = torch.Generator().manual_seed(50_000 + 31 * t + mesh.rank)
        acc += C.compressed_psum_int8(ints, mesh.group, gen).double()
    out["unbiased_int"] = (C.all_gather(ints[None], mesh.group, dim=0), acc / INT_TRIALS)
    # the default stream of a compressed execute_tp call, on every rank
    from repro_torch.core.execution import _tp_stream

    draw = torch.rand(32, generator=_tp_stream(200, 48, mesh.rank, "cpu"))
    out["default_streams"] = C.all_gather(draw[None], mesh.group, dim=0)
    counts = torch.randint(-40, 41, (8, 24), generator=g).to(torch.float32)
    C.reset_counts()
    out["exact"] = (C.all_gather(counts[None], mesh.group, dim=0),
                    C.tp_allreduce(counts, mesh.group))
    out["counted"] = dict(C.COUNTS)
    out["max"] = C.all_reduce(torch.tensor([float(mesh.rank)]), mesh.group, op="max")
    bf = (torch.arange(6, dtype=torch.float32) + 0.1 * mesh.rank).to(torch.bfloat16)
    out["gather_bf16"] = C.all_gather(bf[None], mesh.group, dim=-1).to(torch.float32)
    try:
        C.tp_allreduce(x, mesh.group, compressed=True)
        out["no_generator"] = None
    except ValueError as e:
        out["no_generator"] = str(e)
    grad = torch.randn((32,), generator=g)
    out["mean_grads"] = (C.all_gather(grad[None], mesh.group, dim=0),
                         C.mean_grads_int8(grad, mesh.group,
                                           torch.Generator().manual_seed(mesh.rank)))
    return out


def raise_on_rank_1(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    C.all_reduce(torch.ones(1), mesh.group)      # waits for rank 1 forever
    return "unreachable"


def hang(mesh, seconds):
    time.sleep(seconds)
    return "late"


def build_with(build_dir, nvcc):
    """``_build.build_all`` into ``build_dir`` with the compiler ``nvcc``
    (a process of the build-lock test)."""
    import os
    from pathlib import Path

    from repro_torch.kernels import _build

    os.environ["NVCC"] = nvcc
    _build.build_dir = lambda: Path(build_dir)
    return sorted(_build.build_all())


# ---------------------------------------------------------------------------
# On the card (test_torch_cuda.py): every rank on cuda:0
# ---------------------------------------------------------------------------

CUDA_ROW_SHAPES = ((576, 576), (1536, 576))
CUDA_PLANE_SHAPES = ((576, 1536), (1536, 576))
CUDA_M = (1, 4, 8, 128)


def cuda_tp_functions(mesh):
    """``execute_tp`` (#1, #5) and ``execute_packed_tp`` (#2/#4, #3/#4)
    at smollm-135m's widths on cuda:0 against ``execute`` /
    ``execute_packed`` on the same operands: {check: bit-equal}, and the
    launches of the TP calls."""
    from repro_torch.core.execution import execute, execute_packed
    from repro_torch.kernels import packed_mac as pm
    from repro_torch.kernels import ternary_mac as tm

    dev = torch.device("cuda", 0)
    wrappers = (tm.ternary_cim_matmul, tm.ternary_exact_matmul,
                pm.packed_cim_matmul_decode, pm.packed_cim_matmul,
                pm.packed_cim_matmul_decode_stream)
    g = torch.Generator(device=dev).manual_seed(3)
    rand = lambda *shape: torch.randint(-1, 2, shape, generator=g, device=dev)
    out, launched = {}, dict.fromkeys((w.__name__ for w in wrappers), 0)

    def tp_call(fn):
        before = [w.launches for w in wrappers]
        got = fn()
        for w, n in zip(wrappers, before):
            launched[w.__name__] += w.launches - n
        return got

    for k, n in CUDA_ROW_SHAPES:
        w = rand(k, n).to(torch.bfloat16)
        for m in CUDA_M:
            x = rand(m, k).to(torch.float32)
            for name in ("blocked/cuda", "exact/cuda"):
                got = tp_call(lambda: execute_tp(_spec(name), x, w, mesh))
                out[f"execute_tp {name} ({k}, {n}) M={m}"] = torch.equal(
                    got, execute(_spec(name), x, w))
    for k, n in CUDA_PLANE_SHAPES:
        weight = {"wq": rand(k, n).to(torch.bfloat16)}
        for name in ("blocked/cuda", "blocked/cuda_stream"):
            spec = _spec(name, "bitplane_u8")
            shard = prepare_for_spec(weight, spec, mesh=mesh)[1]["wq"]
            whole = prepare_for_spec(weight, spec)[1]["wq"]
            for m in CUDA_M:
                x = rand(m, k).to(torch.float32)
                got = tp_call(lambda: execute_packed_tp(spec, x, shard, mesh))
                out[f"execute_packed_tp {name} ({k}, {n}) M={m}"] = torch.equal(
                    got, execute_packed(spec, x, whole))
    torch.cuda.synchronize()
    return out, launched


def cuda_tp_serve(mesh, requests):
    """Full-size smollm-135m served on this rank's shard on cuda:0;
    (tokens, stats, #1 launches)."""
    from repro_torch.kernels import ternary_mac as tm
    from repro_torch.models import transformer as T

    cfg = get_config("smollm-135m")
    params = T.init_params(cfg, seed=0, device="cuda")
    b = ContinuousBatcher(params, cfg, n_slots=4, s_max=64, device="cuda", mesh=mesh)
    reqs = [Request(i, p, max_new=m) for i, (p, m) in enumerate(requests)]
    for r in reqs:
        b.submit(r)
    before = tm.ternary_cim_matmul.launches
    b.run()
    return ([r.generated for r in reqs], b.stats(),
            tm.ternary_cim_matmul.launches - before)


# ---------------------------------------------------------------------------
# The front door over TP rank groups (test_torch_frontdoor_tp.py)
# ---------------------------------------------------------------------------


def door_cfg(mode):
    """smollm-135m smoke at f32: mode "off", or "cim" under per-row
    activation scales (fused serving == generate() under per_row)."""
    from repro_torch.models.layers import QuantConfig

    cfg = get_config("smollm-135m", smoke=True).replace(dtype="float32")
    if mode == "off":
        return cfg.replace(quant=QuantConfig(mode="off"))
    return cfg.replace(quant=dataclasses.replace(cfg.quant, act_scale="per_row"))


def door_batcher(mesh, device, mode):
    """A ``TPReplicaGroup`` rank's batcher: the seed-0 params of
    :func:`door_cfg`, this rank's shard on ``mesh``."""
    from repro_torch.models import transformer as T

    cfg = door_cfg(mode)
    return ContinuousBatcher(T.init_params(cfg, seed=0, device=device), cfg,
                             n_slots=2, s_max=32, device=device, mesh=mesh)
