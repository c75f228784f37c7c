"""Declarative CiM execution API (PyTorch counterpart of
``repro/core/execution.py``): the single dispatch point for every
signed-ternary MAC of the port.

    spec = CiMExecSpec(formulation="blocked", backend="auto")
    out  = execute(spec, x_t, w_t)

``CiMExecSpec`` names what to compute (formulation, ADC clamp, flavor,
sensing-error channel) and how (backend, weight packing). A registry
maps ``(formulation, backend, packing)`` keys to kernel functions. The
shim owns leading-dim flattening, the K pad to whole blocks (zero rows
are inert under the a/b event counts), the sensing-error channel and
the output dtype.

Backends: ``torch`` is the plain formulation on any device (the
counterpart of JAX's ``jnp``); ``cuda`` is the hand-written kernel of
``repro_torch/csrc`` (for a CPU tensor its wrapper runs the kernel's
plain version), the counterpart of ``pallas``; ``cuda_stream`` (JAX's
``pallas_stream``) serves stored planes in layout 1 through the
streaming decode kernel at decode M and the prefill packed kernel
above; ``auto`` resolves from the operands' device: ``cuda`` for CUDA
tensors, ``torch`` otherwise. As JAX's ``auto`` always takes the kernel
on the accelerator, a formulation without a CUDA kernel raises on CUDA
operands rather than running its plain version there.

The tile tables of the JAX package are kept for
:func:`tiles_for` and the canonical stored-plane layout
(:func:`canonical_plane_layout`), so prepared planes are byte-identical
to the JAX ones, and a tile sweep never moves them. What the port tunes
is the CUDA kernels' launch grid (``kernels/plan.py``): :func:`autotune`
times the grids the compiled instances accept (:func:`tile_candidates`:
``(rows, cluster)``, and ``(rows, cluster, nbuf)`` for ``cuda_stream``)
and caches a winner per (registry key, block, shape class), which every
later eager call of that spec and class launches with
(:func:`kernel_plan`); with no winner cached every kernel launches on
``launch_plan``'s grid. :func:`set_shape_class_override` chooses the class
whose winner or default grid applies, never which kernel runs.

The hardware model's bridge (:func:`spec_design`,
:func:`spec_array_cost`, :func:`spec_cost_summary`) binds a spec to a
``repro_torch.hw.ArraySpec``.

With a profiler installed (``profile.set_profiler``), every eager
``execute``/``execute_packed`` call is timed into it, with the
reference's meta (m, k, n, macs, weight_bytes); calls inside a batcher
or serve step (:func:`no_kernel_events`, the counterpart of the
reference's jitted steps, where no call records) and calls while the
current stream captures a graph record nothing. Inside
:func:`graph_kernel_events` a call on the card is timed as a captured
step runs it: device time of a CUDA-graph replay, no host dispatch.

Tensor parallelism: :func:`execute_tp` (row-parallel, K split in whole
blocks, an exact sum of integer-count partials) and
:func:`execute_packed_tp` (column-parallel over N-sharded stored planes,
a gather) run on every rank of a ``launch.mesh.TPMesh``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import math
import threading
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import ternary as tern
from repro_torch.dist import collectives
from repro_torch.kernels import DECODE_M_MAX, ref
from repro_torch.kernels import plan as kplan
from repro_torch.kernels.packed_mac import (
    STREAM_ALIGN,
    STREAM_NBUF,
    packed_cim_matmul,
    packed_cim_matmul_decode,
    packed_cim_matmul_decode_stream,
)
from repro_torch.kernels.ternary_mac import ternary_cim_matmul, ternary_exact_matmul

FORMULATIONS = ("exact", "blocked", "corrected", "bitplane", "fused")
BACKENDS = ("auto", "cuda", "cuda_stream", "torch")
PACKINGS = ("none", "bitplane_u8")
FLAVORS = ("I", "II")


def _device_type(device) -> str:
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


@dataclasses.dataclass(frozen=True)
class CiMExecSpec:
    """Declarative description of one ternary-MAC execution.

    formulation: exact | blocked | corrected | bitplane | fused.
    backend:     auto | cuda | cuda_stream | torch.
    packing:     none | bitplane_u8 (2-bit differential weight storage).
    flavor:      "I" | "II" — identical MAC math.
    block:       rows asserted per array cycle (paper N_A = 16).
    adc_max:     ADC clamp bound for the a/b event counts.
    error_prob:  per-block sensing-error probability; needs a
      ``torch.Generator`` at :func:`execute` time when > 0.
    """

    formulation: str = "blocked"
    backend: str = "auto"
    packing: str = "none"
    flavor: str = "I"
    block: int = 16
    adc_max: int = 8
    error_prob: float = 0.0

    def __post_init__(self):
        if not self.formulation or not isinstance(self.formulation, str):
            raise ValueError(f"bad formulation {self.formulation!r}")
        formulations = set(FORMULATIONS) | {k[0] for k in _REGISTRY}
        if self.formulation not in formulations:
            raise ValueError(
                f"unknown formulation {self.formulation!r} "
                f"(use one of {sorted(formulations)})")
        backends = set(BACKENDS) | {k[1] for k in _REGISTRY}
        if self.backend not in backends:
            raise ValueError(
                f"unknown backend {self.backend!r} (use one of {sorted(backends)})")
        packings = set(PACKINGS) | {k[2] for k in _REGISTRY}
        if self.packing not in packings:
            raise ValueError(
                f"unknown packing {self.packing!r} (use one of {sorted(packings)})")
        if self.flavor not in FLAVORS:
            raise ValueError(f"unknown SiTe CiM flavor {self.flavor!r}")
        if self.block <= 0:
            raise ValueError(f"block must be positive, got {self.block}")
        if self.adc_max <= 0:
            raise ValueError(f"adc_max must be positive, got {self.adc_max}")

    def resolve(self, device=None) -> "CiMExecSpec":
        """Fix "auto" to a concrete backend for ``device`` (the operands'
        device; None = ``cuda`` when available): ``cuda`` on a CUDA
        device, whether or not that key is registered, else ``torch``."""
        if self.backend != "auto":
            return self
        backend = "cuda" if _device_type(device) == "cuda" else "torch"
        return dataclasses.replace(self, backend=backend)

    @property
    def clamps(self) -> bool:
        entry = _REGISTRY.get(self.resolve().registry_key)
        if entry is not None:
            return entry.clamps
        return self.formulation in ("blocked", "corrected", "bitplane")

    @property
    def registry_key(self) -> Tuple[str, str, str]:
        return (self.formulation, self.backend, self.packing)

    @property
    def name(self) -> str:
        return "/".join(self.registry_key)


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BackendEntry:
    """One registered MAC kernel: ``fn(x2d, w, spec)``, whether the
    formulation clamps, and the (m, k, n) -> (bm, bk, bn) tile table of
    kernel backends (read by :func:`tiles_for` and
    :func:`canonical_plane_layout`; the kernels pick their own tiles)."""

    fn: Callable
    clamps: bool
    tiles: Optional[Callable[[int, int, int], Tuple[int, ...]]] = None


_REGISTRY: Dict[Tuple[str, str, str], BackendEntry] = {}


def _parse_key(name) -> Tuple[str, str, str]:
    key = name if isinstance(name, tuple) else tuple(str(name).split("/"))
    if len(key) != 3:
        raise ValueError(
            f"backend key must be 'formulation/backend/packing', got {name!r}")
    return key  # type: ignore[return-value]


def register_backend(name, fn: Callable, *, clamps: bool = True,
                     tiles: Optional[Callable] = None) -> None:
    """Register a MAC kernel under ``"formulation/backend/packing"``.
    ``fn(x2d, w_t, spec)`` receives (M, K) inputs with K padded to the
    block / packing granularity and returns the (M, N) product."""
    key = _parse_key(name)
    if key[1] == "auto":
        raise ValueError("register concrete backends, not 'auto'")
    _REGISTRY[key] = BackendEntry(fn, bool(clamps), tiles)


def get_backend(spec: CiMExecSpec, device=None) -> BackendEntry:
    """The entry registered for ``spec`` resolved on ``device``; raises
    KeyError listing the known keys."""
    key = spec.resolve(device).registry_key
    entry = _REGISTRY.get(key)
    if entry is None:
        known = ", ".join("/".join(k) for k in sorted(_REGISTRY))
        raise KeyError(f"no backend registered for {'/'.join(key)} (known: {known})")
    return entry


def registered_specs() -> Iterator[CiMExecSpec]:
    """One CiMExecSpec per registered (formulation, backend, packing)."""
    for f, b, p in sorted(_REGISTRY):
        yield CiMExecSpec(formulation=f, backend=b, packing=p)


# ---------------------------------------------------------------------------
# Shape classes and tile tables
# ---------------------------------------------------------------------------

SHAPE_CLASSES = ("decode", "prefill")

# tile-sweep winners: {(registry_key, block, shape_class): (rows, cluster)
# or (rows, cluster, nbuf)}, the launch grids of kernels/plan.py
_TILE_CACHE: Dict[Tuple, Tuple[int, ...]] = {}

# benchmark/test lever: force every call into one shape class (None = off)
_CLASS_OVERRIDE: Optional[str] = None

# Guards _TILE_CACHE and _CLASS_OVERRIDE: the front door drives several
# batchers from threads of their own, and the override's read-compose-
# lookup and its context manager's restore are not atomic without it
_DISPATCH_LOCK = threading.Lock()


def shape_class(m: int) -> str:
    """"decode" for M <= DECODE_M_MAX, else "prefill"."""
    return "decode" if m <= DECODE_M_MAX else "prefill"


class _ShapeClassOverride:
    """Handle returned by :func:`set_shape_class_override`. The override
    is installed at construction; used as a context manager, the handle
    restores the previous value on exit, so ``with
    set_shape_class_override("prefill"): ...`` is exception-safe, while
    the imperative call (later ``set_shape_class_override(None)``) works
    too."""

    def __init__(self, prev: Optional[str]):
        self._prev = prev

    def __enter__(self) -> "_ShapeClassOverride":
        return self

    def __exit__(self, *exc) -> bool:
        set_shape_class_override(self._prev)
        return False


def set_shape_class_override(cls: Optional[str]) -> _ShapeClassOverride:
    """Force the shape class of every call regardless of M (None restores
    the M-derived class), as the reference's does: the class whose tile
    table entry :func:`tiles_for` answers with, whose sweep winner or
    default grid the kernels launch on (:func:`kernel_plan`), and that
    kernel events record. It never changes which kernel runs: #2 and #4
    (and #3's prefill delegate) are still chosen by M, where the
    reference's override also reroutes its packed kernels through their M
    tile. Affects eager calls and new captures only. Returns a context
    manager restoring the previous override on exit. Thread-safe."""
    global _CLASS_OVERRIDE
    if cls is not None and cls not in SHAPE_CLASSES:
        raise ValueError(f"unknown shape class {cls!r} (use {SHAPE_CLASSES})")
    with _DISPATCH_LOCK:
        prev = _CLASS_OVERRIDE
        _CLASS_OVERRIDE = cls
    return _ShapeClassOverride(prev)


def clear_tile_cache() -> None:
    """Drop every tile-sweep winner (tests, re-tuning): every kernel
    launches on ``launch_plan``'s grid again. Thread-safe."""
    with _DISPATCH_LOCK:
        _TILE_CACHE.clear()


def tiles_for(spec: CiMExecSpec, m: int, k: int, n: int,
              device=None) -> Optional[Tuple[int, ...]]:
    """The (bm, bk, bn) tiles of the registry entry's table for an
    (M, K) x (K, N) call — (bm, bk, bn, nbuf) for ``cuda_stream``; None
    for untiled (torch) backends. Under :func:`set_shape_class_override`
    the table answers for the forced class (a representative M of it).
    The tile sweep's winners are launch grids, not these tiles: see
    :func:`kernel_plan`."""
    entry = _REGISTRY.get(spec.resolve(device).registry_key)
    if entry is None or entry.tiles is None:
        return None
    with _DISPATCH_LOCK:
        cls = _CLASS_OVERRIDE or shape_class(m)
    if cls != shape_class(m):
        m = DECODE_M_MAX if cls == "decode" else 128
    return entry.tiles(m, k, n)


def _grid_choice(spec: CiMExecSpec, m: int
                 ) -> Tuple[Optional[Tuple[int, ...]], Optional[str]]:
    """(cached winner, forced class) for a call of ``m`` rows: the winner
    of the forced class when there is one, else of M's class."""
    with _DISPATCH_LOCK:
        cls = _CLASS_OVERRIDE or shape_class(m)
        return _TILE_CACHE.get((spec.registry_key, spec.block, cls)), _CLASS_OVERRIDE


def kernel_plan(spec: CiMExecSpec, m: int, k: int, n: int,
                sms: int = kplan.H100_SMS, *,
                rows: Optional[int] = None) -> kplan.LaunchPlan:
    """The grid a kernel of ``spec`` launches on for an (M, K) x (K, N)
    call on a card of ``sms`` SMs: the cached winner of the call's shape
    class, else that class's ``launch_plan`` rule (``plan.tuned_plan``);
    ``rows`` is the kernel's own M tile where it has one (#2, #3: 8).
    With no winner cached and no override it is ``launch_plan(m, k, n,
    sms)``."""
    winner, forced = _grid_choice(spec.resolve(), m)
    return kplan.tuned_plan(m, k, n, sms, winner=winner, cls=forced, rows=rows)


def canonical_plane_layout(spec: CiMExecSpec, device=None) -> Tuple[int, int]:
    """(K multiple, N multiple) of the canonical stored-plane layout for
    ``spec``: the granularity ``quant.prepare.prepare_for_spec`` pads
    packed planes to, so that the default tiles of both shape classes
    divide it. Untiled backends use the block/byte lcm."""
    entry = _REGISTRY.get(spec.resolve(device).registry_key)
    base = math.lcm(spec.block, 8)
    if entry is None or entry.tiles is None:
        return base, 1
    k_mult, n_mult = base, 1
    big = 1 << 20
    for m in (1, 128):
        t = entry.tiles(m, big, big)
        k_mult = math.lcm(k_mult, max(int(t[1]), 1))
        n_mult = math.lcm(n_mult, max(int(t[2]), 1))
    return k_mult, n_mult


# ---------------------------------------------------------------------------
# Profiler sink (repro_torch.profile.trace)
# ---------------------------------------------------------------------------

#: installed by repro_torch.profile.trace.set_profiler; None = profiling
#: off, which costs one None comparison per call
_PROFILE_SINK: Optional[Callable] = None
#: ``.off`` is set inside a batcher or serve step, per thread: the front
#: door's replicas step in threads of their own
_STEP = threading.local()


def set_profile_sink(sink: Optional[Callable]) -> None:
    """Install (or, with None, remove) the kernel-event sink that eager
    ``execute``/``execute_packed`` calls report their wall times to.
    Wired by :func:`repro_torch.profile.trace.set_profiler`: use that."""
    global _PROFILE_SINK
    _PROFILE_SINK = sink


@contextlib.contextmanager
def no_kernel_events():
    """No ``execute`` call in this thread records while inside: a
    batcher or serve step, the counterpart of the reference's jitted
    steps, under whose trace no call is timed."""
    prev = getattr(_STEP, "off", False)
    _STEP.off = True
    try:
        yield
    finally:
        _STEP.off = prev


@contextlib.contextmanager
def graph_kernel_events(copies: int = 4):
    """Inside, a recorded ``execute`` call on the card is timed as a
    captured serve step runs it: after the eager call that gives the
    result, the call is captured ``copies`` times back to back in one
    CUDA graph, and the event's ``wall_us`` is one replay's device time
    (CUDA events) over ``copies``, with no host dispatch in it (meta
    ``"timing": "graph"``). Eager timing charges each call the host's
    dispatch and sync, which a replayed step does not pay. CPU calls are
    timed eagerly as outside."""
    prev = getattr(_STEP, "graph_copies", 0)
    _STEP.graph_copies = int(copies)
    try:
        yield
    finally:
        _STEP.graph_copies = prev


def _graph_us(thunk: Callable, copies: int) -> float:
    """Device microseconds a call of ``thunk`` takes, replayed from one
    CUDA graph that holds ``copies`` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        thunk()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(copies):
            thunk()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    # analysis: host-sync ok -- profiler timing after the eager call, outside any step
    end.synchronize()
    del graph
    return start.elapsed_time(end) * 1e3 / copies


def _profiled_call(entry: str, spec: CiMExecSpec, x: torch.Tensor, m: int,
                   k: int, n: int, weight_bytes: int, thunk: Callable):
    """Run ``thunk()``; with a sink installed, outside a step and outside
    a capture (a sync there would invalidate it), time it to the device's
    completion, or as a graph replay inside :func:`graph_kernel_events`,
    and emit one kernel event."""
    sink = _PROFILE_SINK
    cuda = x.device.type == "cuda"
    if (sink is None or getattr(_STEP, "off", False)
            or (cuda and torch.cuda.is_current_stream_capturing())):
        return thunk()
    meta = {"m": int(m), "k": int(k), "n": int(n),
            "macs": int(m) * int(k) * int(n), "weight_bytes": int(weight_bytes)}
    copies = getattr(_STEP, "graph_copies", 0)
    t0 = time.perf_counter()
    out = thunk()
    t1 = time.perf_counter()
    if cuda:
        # analysis: host-sync ok -- profiler timing after the eager call, outside any step
        torch.cuda.synchronize(x.device)
    t2 = time.perf_counter()
    wall_us = (t2 - t0) * 1e6
    if cuda and copies:
        wall_us = _graph_us(thunk, copies)
        meta["timing"] = "graph"
    sink(entry_point=entry, exec_spec=spec.name,
         shape_class=_CLASS_OVERRIDE or shape_class(m),
         mesh=None, wall_us=wall_us, dispatch_us=(t1 - t0) * 1e6, meta=meta)
    return out


# ---------------------------------------------------------------------------
# The shared execution shim
# ---------------------------------------------------------------------------


def _forward(spec: CiMExecSpec, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    entry = get_backend(spec, x.device)
    lead, k, n = tuple(x.shape[:-1]), x.shape[-1], w.shape[-1]
    x2 = x.reshape(-1, k)
    mult = spec.block if spec.packing == "none" else math.lcm(spec.block, 8)
    xp, wp = ref.pad_axis(x2, mult, 1), ref.pad_axis(w, mult, 0)
    return entry.fn(xp, wp, spec).reshape(lead + (n,)).to(x.dtype)


class _SteExecute(torch.autograd.Function):
    """:func:`_forward` under every backend, with the reference's
    straight-through backward past the clamp: the exact-matmul gradients
    ``dx = g w^T`` and ``dw = x^T g`` (summed over x's leading dims),
    accumulated in f32 for clamping formulations and in the operand dtype
    otherwise, each rounded to its operand's dtype. Plain products: the
    reference computes them outside any kernel, so no backward kernel
    exists. The forward's kernel backends cast the codes to int8 inside
    (one byte per weight into the kernel)."""

    @staticmethod
    def forward(ctx, spec: CiMExecSpec, x: torch.Tensor, w: torch.Tensor
                ) -> torch.Tensor:
        ctx.spec = spec
        ctx.save_for_backward(x, w)
        return _forward(spec, x, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        acc = torch.float32 if ctx.spec.clamps else x.dtype
        gf = g.to(acc)
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dx = (gf @ w.to(acc).T).to(x.dtype)
        if ctx.needs_input_grad[2]:
            k, n = x.shape[-1], g.shape[-1]
            dw = (x.reshape(-1, k).to(acc).T @ gf.reshape(-1, n)).to(w.dtype)
        return None, dx, dw


def _apply_sense_channel(spec: CiMExecSpec, out: torch.Tensor, k_dim: int,
                         generator: Optional[torch.Generator]) -> torch.Tensor:
    """Shared post-MAC sensing-error application (validation + noise)."""
    if spec.error_prob <= 0.0:
        return out
    if not spec.clamps:
        raise ValueError(
            f"the sensing-error channel models the ADC readout; the "
            f"{spec.formulation!r} formulation has no ADC (use a clamping "
            f"formulation or error_prob=0)")
    if generator is None:
        raise ValueError("spec.error_prob > 0 requires a torch.Generator")
    kb = -(-k_dim // spec.block)
    return out + _sense_noise(generator, tuple(out.shape), kb,
                              spec.error_prob, out.dtype, out.device)


def _sense_noise(generator: torch.Generator, shape, kb: int, prob: float,
                 dtype, device) -> torch.Tensor:
    """Additive equivalent of the per-block ±1 ADC-level error channel:
    each of the ``kb`` block partials behind an output flips one level
    with probability ``prob``."""
    full = shape + (kb,)
    flip = torch.rand(full, generator=generator, device=device) < prob
    sign = torch.randint(0, 2, full, generator=generator, device=device) * 2 - 1
    base = dtype if dtype.is_floating_point else torch.int32
    return (flip.to(base) * sign.to(base)).sum(dim=-1).to(dtype)


def execute(spec: CiMExecSpec, x_t: torch.Tensor, w_t: torch.Tensor, *,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Run one ternary MAC under ``spec``.

    x_t: (..., K) ternary values (any numeric dtype); w_t: (K, N) ternary
    values on the same device. Returns (..., N) in the dtype of ``x_t``,
    with gradients defined straight through (the exact-matmul backward of
    :class:`_SteExecute`) when grad is on and an operand requires it;
    otherwise the MAC is called directly, so serving and captured steps
    run no autograd. ``generator`` feeds the sensing-error channel
    (required iff ``spec.error_prob > 0``), which stays outside the
    gradient. With ``packing="bitplane_u8"`` the weight is packed on the
    fly; serving packs once (``quant.prepare``) and calls
    :func:`execute_packed`.
    """
    spec = spec.resolve(x_t.device)
    clean = dataclasses.replace(spec, error_prob=0.0)
    ste = torch.is_grad_enabled() and (x_t.requires_grad or w_t.requires_grad)
    k, n = x_t.shape[-1], w_t.shape[-1]
    out = _profiled_call("execution.execute", clean, x_t, math.prod(x_t.shape[:-1]),
                         k, n, k * n * w_t.element_size(),
                         lambda: (_SteExecute.apply if ste else _forward)(clean, x_t, w_t))
    return _apply_sense_channel(spec, out, x_t.shape[-1], generator)


def _packed_forward(spec: CiMExecSpec, x: torch.Tensor, planes,
                    n_out: int) -> torch.Tensor:
    """``planes`` is the (K/4, N) interleaved array for ``cuda_stream``,
    else the (pos, neg) pair."""
    lead, k = tuple(x.shape[:-1]), x.shape[-1]
    x2 = x.reshape(-1, k)
    if spec.backend == "cuda_stream":
        out = _packed_stream_mac(x2, planes, spec, spec.clamps, n_out)
    else:
        out = _packed_planes_mac(x2, *planes, spec, spec.clamps, n_out)
    return out.reshape(lead + (n_out,)).to(x.dtype)


def execute_packed(spec: CiMExecSpec, x_t: torch.Tensor, w_pos,
                   w_neg: Optional[torch.Tensor] = None, *,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Packed-weight path: a ternary MAC from pre-packed (M1, M2) planes
    without materializing the dense weight.

    The weight side is either ``w_pos``/``w_neg`` (K/8, N) uint8 planes
    (``pack_ternary`` layout along K), or one
    :class:`~repro_torch.core.ternary.PackedPlanes` (canonical padded
    layout, either layout version; pass it as ``w_pos``). A
    ``cuda_stream`` spec reads the planes interleaved (free on layout-1
    storage), every other spec as two planes (free on layout 0; strided
    views of layout 1). Results slice back to the logical N. ``x_t`` must
    hold exact ternary values.
    """
    spec = spec.resolve(x_t.device)
    if spec.packing != "bitplane_u8":
        raise ValueError("execute_packed requires packing='bitplane_u8'")
    if spec.formulation not in ("exact", "blocked"):
        raise ValueError(
            f"packed kernels implement exact|blocked, not {spec.formulation!r}")
    stream = spec.backend == "cuda_stream"
    if isinstance(w_pos, tern.PackedPlanes):
        planes = w_pos
        if w_neg is not None:
            raise ValueError("pass PackedPlanes alone (it carries both planes)")
        if planes.pos.dim() != 2:
            raise ValueError(
                f"stacked planes {tuple(planes.pos.shape)}: slice one layer "
                f"first (PackedPlanes.layer(i))")
        if x_t.shape[-1] != planes.k:
            raise ValueError(
                f"plane/input shape mismatch: x K={x_t.shape[-1]}, logical "
                f"plane K={planes.k}")
        if planes.shards != 1:
            raise ValueError(
                f"a column shard (1 of {planes.shards}) of stored planes: run "
                f"it through execute_packed_tp on its mesh")
        n_out = planes.n
        w = planes.interleaved() if stream else planes.planes()
    else:
        if w_neg is None:
            raise ValueError("raw planes need both w_pos and w_neg")
        if x_t.shape[-1] != w_pos.shape[0] * 8 or w_pos.shape != w_neg.shape:
            raise ValueError(
                f"plane/input shape mismatch: x K={x_t.shape[-1]}, planes "
                f"{tuple(w_pos.shape)} / {tuple(w_neg.shape)}")
        n_out = w_pos.shape[-1]
        w = tern.interleave_planes(w_pos, w_neg) if stream else (w_pos, w_neg)
    clean = dataclasses.replace(spec, error_prob=0.0)
    if stream:
        k_dim, weight_bytes = w.shape[-2] * 4, w.numel()
    else:
        k_dim, weight_bytes = w[0].shape[0] * 8, w[0].numel() + w[1].numel()
    out = _profiled_call("execution.execute_packed", clean, x_t,
                         math.prod(x_t.shape[:-1]), k_dim, n_out, weight_bytes,
                         lambda: _packed_forward(clean, x_t, w, n_out))
    return _apply_sense_channel(spec, out, x_t.shape[-1], generator)


# ---------------------------------------------------------------------------
# Tensor-parallel execution (explicit collectives over a gloo group)
# ---------------------------------------------------------------------------


def _check_axis(mesh, axis_name: str) -> int:
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no {axis_name!r} axis")
    return int(mesh.shape[axis_name])


def _tp_stream(k: int, n: int, rank: int, device) -> torch.Generator:
    """The idempotent default rounding stream of a compressed
    :func:`execute_tp`: a pure function of the operand shape and the
    rank (the reference folds the shape into key 0 and splits it per
    shard)."""
    salt = (k * 1000003 + n * 8191) % (1 << 30)
    return torch.Generator(device=device).manual_seed(salt * 4096 + rank)


def execute_tp(spec: CiMExecSpec, x_t: torch.Tensor, w_t: torch.Tensor, mesh, *,
               axis_name: str = "model", compressed: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Row-parallel ternary MAC over ``mesh``'s ranks (one process each,
    ``launch.mesh``): called on every rank with the whole ``x_t`` (...,
    K) and the whole ``w_t`` (K, N).

    K is zero-padded to ``spec.block * tp`` so every rank holds whole
    blocks: the per-block ADC clamp never straddles two ranks, each
    rank's partial (the registered backend on its K slice: #1 on the
    card under ``blocked/cuda``) is integer event counts, and
    ``dist.collectives.tp_allreduce`` sums them exactly: bit-identical
    to :func:`execute` for every built-in formulation.

    ``compressed=True`` sums through the int8-compressed collective;
    ``generator`` is this rank's rounding stream, and without one the
    stream is a pure function of the operand shape and the rank, so
    identical calls round identically (the reference's idempotent
    default; pass a fresh generator per call for unbiased noise).
    Inference only: no gradient is defined."""
    if spec.resolve(x_t.device).packing != "none":
        raise ValueError(
            "execute_tp splits the contraction dim; packed (K-major 2-bit) "
            "planes shard over N instead: use execute_packed_tp")
    tp = _check_axis(mesh, axis_name)
    return execute_row_shard(spec, x_t, row_split(w_t, spec.block, tp, mesh.rank),
                             mesh, compressed=compressed, generator=generator)


def row_split(t: torch.Tensor, block: int, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s rows of dim -2 of ``t``, K zero-padded to whole
    blocks on every rank (``block * tp``)."""
    k = t.shape[-2]
    pad = -(-k // (block * tp)) * block * tp - k
    if pad:
        t = F.pad(t, (0, 0, 0, pad))
    rows = t.shape[-2] // tp
    return t[..., rank * rows:(rank + 1) * rows, :].clone()


def row_shard_input(x: torch.Tensor, k_local: int, mesh) -> torch.Tensor:
    """Rank's slice of a whole row-parallel input (..., K): K zero-padded
    to ``k_local * size``, then the rank's ``k_local`` columns."""
    kp = k_local * mesh.size
    if kp != x.shape[-1]:
        x = F.pad(x, (0, kp - x.shape[-1]))
    return x[..., mesh.rank * k_local:(mesh.rank + 1) * k_local]


def check_tp_spec(spec: CiMExecSpec) -> None:
    """TP runs serve with no sensing-error channel: its draws would
    depend on the split (``execute``/``execute_packed`` drive it)."""
    if spec.error_prob > 0.0:
        raise ValueError(
            "tensor-parallel execution is the serving path; drive the "
            "sensing-error channel through execute/execute_packed "
            "(error_prob=0 here)")


def execute_row_shard(spec: CiMExecSpec, x_t: torch.Tensor, w_rows: torch.Tensor,
                      mesh, *, compressed: bool = False,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """This rank's half of :func:`execute_tp`: ``w_rows`` is already its
    rows of the weight, K padded to ``spec.block * tp`` and split in whole
    blocks (:func:`row_split`, a ``dist.sharding.WeightShard``'s)."""
    check_tp_spec(spec)
    spec = spec.resolve(x_t.device)
    entry = get_backend(spec, x_t.device)
    lead, k, n = tuple(x_t.shape[:-1]), x_t.shape[-1], w_rows.shape[-1]
    x_loc = row_shard_input(x_t.reshape(-1, k), w_rows.shape[-2], mesh)
    part = entry.fn(x_loc, w_rows, spec)
    if compressed and generator is None:
        generator = _tp_stream(k, n, mesh.rank, x_t.device)
    out = collectives.tp_allreduce(part.to(torch.float32), mesh.group,
                                   generator=generator, compressed=compressed)
    return out.reshape(lead + (n,)).to(x_t.dtype)


def execute_packed_tp(spec: CiMExecSpec, x_t: torch.Tensor, planes, mesh, *,
                      axis_name: str = "model") -> torch.Tensor:
    """Column-parallel packed MAC over N-sharded stored planes: the TP
    twin of :func:`execute_packed`. ``planes`` is one layer's 2-D
    :class:`~repro_torch.core.ternary.PackedPlanes`, whole (its padded N
    must divide the axis) or this rank's column shard
    (``quant.prepare.prepare_for_spec(mesh=)`` stores those). Each rank
    runs the packed kernel on its columns (#2 at decode M, #4 above; #3
    under ``cuda_stream`` at decode M) and the shards are gathered over
    the ranks (a copy). The contraction never splits, so the result is
    bit-identical to :func:`execute_packed`."""
    spec = spec.resolve(x_t.device)
    if spec.packing != "bitplane_u8":
        raise ValueError("execute_packed_tp requires packing='bitplane_u8'")
    check_tp_spec(spec)
    if spec.formulation not in ("exact", "blocked"):
        raise ValueError(
            f"packed kernels implement exact|blocked, not {spec.formulation!r}")
    if not isinstance(planes, tern.PackedPlanes):
        raise ValueError("execute_packed_tp consumes stored PackedPlanes")
    if planes.pos.dim() != 2:
        raise ValueError(
            f"stacked planes {tuple(planes.pos.shape)}: slice one layer first "
            f"(PackedPlanes.layer(i))")
    if x_t.shape[-1] != planes.k:
        raise ValueError(
            f"plane/input shape mismatch: x K={x_t.shape[-1]}, logical plane "
            f"K={planes.k}")
    tp = _check_axis(mesh, axis_name)
    if planes.shards == 1:
        n_pad = int(planes.pos.shape[-1])
        if n_pad % tp != 0:
            raise ValueError(
                f"padded plane N={n_pad} does not divide the {axis_name!r} "
                f"axis ({tp} ranks): re-prepare with the mesh "
                f"(quant.prepare.prepare_for_spec(mesh=...))")
        planes = planes.column_shard(mesh.rank, tp)
    elif planes.shards != tp:
        raise ValueError(f"planes split {planes.shards} ways on a {tp}-rank axis")
    w = planes.interleaved() if spec.backend == "cuda_stream" else planes.planes()
    lead, k = tuple(x_t.shape[:-1]), x_t.shape[-1]
    local = _packed_forward(spec, x_t.reshape(-1, k), w, planes.pos.shape[-1])
    out = collectives.all_gather(local, mesh.group, dim=-1)[:, :planes.n]
    return out.reshape(lead + (planes.n,)).to(x_t.dtype)


# ---------------------------------------------------------------------------
# Built-in backends
# ---------------------------------------------------------------------------

# ---- torch (plain formulations) -------------------------------------------


def _exact_torch(x2, w, spec):
    # operand-dtype dot, as the reference's exact/jnp
    return x2 @ w.to(x2.dtype)


def _blocked_torch(x2, w, spec):
    return ref.ref_cim_matmul(x2.to(torch.float32), w.to(torch.float32),
                              block=spec.block, adc_max=spec.adc_max)


def _blocks(t: torch.Tensor, block: int, lhs: bool) -> torch.Tensor:
    if lhs:
        return t.reshape(t.shape[0], t.shape[1] // block, block)
    return t.reshape(t.shape[0] // block, block, t.shape[1])


def _corrected_torch(x2, w, spec):
    """exact + sum_blk(relu(b-adc) - relu(a-adc)): one full-depth dot plus
    the rare saturation correction."""
    xf, wf = x2.to(torch.float32), w.to(torch.float32)
    exact = xf @ wf
    xb, wb = _blocks(xf, spec.block, True), _blocks(wf, spec.block, False)
    p = torch.einsum("mki,kin->mkn", xb, wb)
    m = torch.einsum("mki,kin->mkn", xb.abs(), wb.abs())
    a, b = (m + p) * 0.5, (m - p) * 0.5
    adc = float(spec.adc_max)
    corr = torch.clamp(b - adc, min=0.0) - torch.clamp(a - adc, min=0.0)
    return exact + corr.sum(dim=1)


def _bitplane_torch(x2, w, spec):
    """Event counting over (M1, M2) bitplanes, as the circuit does:
    a = #(RWL1&M1) + #(RWL2&M2), b = #(RWL1&M2) + #(RWL2&M1). The 0/1
    contractions run in f32 (exact for counts), which every device
    supports."""
    f = torch.float32
    m1, m2 = _blocks((w > 0).to(f), spec.block, False), _blocks((w < 0).to(f), spec.block, False)
    r1, r2 = _blocks((x2 > 0).to(f), spec.block, True), _blocks((x2 < 0).to(f), spec.block, True)
    a = torch.einsum("mki,kin->mkn", r1, m1) + torch.einsum("mki,kin->mkn", r2, m2)
    b = torch.einsum("mki,kin->mkn", r1, m2) + torch.einsum("mki,kin->mkn", r2, m1)
    adc = float(spec.adc_max)
    return (torch.clamp(a, max=adc) - torch.clamp(b, max=adc)).sum(dim=1)


def _fused_torch(x2, w, spec):
    """Signed + magnitude full-depth dots, elementwise combine (== exact)."""
    wd = w.to(x2.dtype)
    pf = (x2 @ wd).to(torch.float32)
    mf = (x2.abs() @ wd.abs()).to(torch.float32)
    big = 2.0 ** 14
    return torch.clamp((mf + pf) * 0.5, max=big) - torch.clamp((mf - pf) * 0.5, max=big)


# ---- cuda (hand-written kernels) ------------------------------------------

# the JAX package's tile tables: decode class (M <= DECODE_M_MAX) and
# prefill class; they fix the canonical plane layout


def _blocked_tiles(m, k, n):
    return (8, 128, 128) if m <= DECODE_M_MAX else (128, 128, 128)


def _exact_tiles(m, k, n):
    return (8, 512, 128) if m <= DECODE_M_MAX else (128, 512, 128)


def _packed_tiles(m, k, n):
    return (8, 256, 128) if m <= DECODE_M_MAX else (128, 256, 128)


def _packed_stream_tiles(m, k, n):
    # 4th element: the stream kernel's ring depth (nbuf); prefill-class
    # M delegates to the prefill packed kernel, which ignores it
    return (8, 256, 128, 2) if m <= DECODE_M_MAX else (128, 256, 128, 2)


def _codes(t: torch.Tensor) -> torch.Tensor:
    """Exact ternary values -> contiguous int8 codes (free for int8)."""
    return t.to(torch.int8).contiguous()


def _grid(spec, x2, n: int, winner=None, rows: Optional[int] = None):
    """(plan, winner) of a kernel call on CUDA ``x2`` against ``n``
    columns: on ``winner`` (autotune's timed candidate), else as
    :func:`kernel_plan` says for this card (``launch_plan``'s grid when
    nothing is cached or forced). (None, None) for CPU operands, which
    take the plain versions."""
    if x2.device.type != "cuda":
        return None, None
    m, k = x2.shape
    forced = None
    if winner is None:
        winner, forced = _grid_choice(spec, m)
    plan = kplan.tuned_plan(m, k, n, kplan.device_sms(x2.device),
                            winner=winner, cls=forced, rows=rows)
    return plan, winner


def _blocked_cuda(x2, w, spec, winner=None):
    plan, _ = _grid(spec, x2, w.shape[1], winner)
    return ternary_cim_matmul(_codes(x2), _codes(w), block=spec.block,
                              adc_max=spec.adc_max, plan=plan)


def _exact_cuda(x2, w, spec, winner=None):
    plan, _ = _grid(spec, x2, w.shape[1], winner)
    return ternary_exact_matmul(_codes(x2), _codes(w), plan=plan)


def _packed_planes_mac(x2, w_pos, w_neg, spec, cim: bool, n_out: int,
                       winner=None):
    """The MAC from (rows, N) planes. torch backends pad x and the planes
    to whole blocks and run the oracle; kernel backends hand the logical
    extents to the decode kernel (M tile <= DECODE_M_MAX, int32) or the
    prefill kernel (f32), which zero-extend K themselves, chosen by M
    whatever the shape-class override says, on ``spec``'s grid."""
    m = x2.shape[0]
    if spec.backend == "torch":
        mult = math.lcm(spec.block, 8)
        k_target = max(w_pos.shape[-2] * 8, -(-x2.shape[1] // mult) * mult)
        out = ref.ref_packed_matmul(
            ref.pad_axis(x2.to(torch.float32), k_target, 1),
            ref.pad_axis(w_pos, k_target // 8, 0),
            ref.pad_axis(w_neg, k_target // 8, 0),
            block=spec.block, adc_max=spec.adc_max, cim=cim)
        return out[:, :n_out]
    kw = dict(n_out=n_out, block=spec.block, adc_max=spec.adc_max, cim=cim)
    if shape_class(m) == "decode":
        plan, _ = _grid(spec, x2, n_out, winner, rows=DECODE_M_MAX)
        return packed_cim_matmul_decode(_codes(x2), w_pos, w_neg, plan=plan,
                                        **kw).to(torch.float32)
    plan, _ = _grid(spec, x2, n_out, winner)
    return packed_cim_matmul(_codes(x2), w_pos, w_neg, plan=plan, **kw)


def _packed_stream_mac(x2, w_int, spec, cim: bool, n_out: int, winner=None):
    """The MAC from ONE (K/4, N) plane-interleaved array (layout 1).
    Decode-class M takes the streaming kernel (columns padded to its
    16-byte copies, a no-op on canonical planes), with the ring depth of
    the winner or the tile table; prefill-class M de-interleaves (strided
    views, no pad) and takes the prefill packed kernel, as the reference
    does, on this spec's grid."""
    m = x2.shape[0]
    if shape_class(m) == "prefill":
        return _packed_planes_mac(x2, *tern.deinterleave_planes(w_int), spec,
                                  cim, n_out, winner)
    plan, winner = _grid(spec, x2, n_out, winner, rows=DECODE_M_MAX)
    nbuf = (winner[2] if winner is not None
            else _packed_stream_tiles(m, x2.shape[1], w_int.shape[1])[3])
    out = packed_cim_matmul_decode_stream(
        _codes(x2), ref.pad_axis(w_int, STREAM_ALIGN, 1), n_out=n_out,
        block=spec.block, adc_max=spec.adc_max, cim=cim, nbuf=nbuf, plan=plan)
    return out.to(torch.float32)


def _packed(x2, w, spec, *, cim: bool):
    """Functional packed path (dense ternary w in hand): pack once at the
    logical K extent, then run the planes MAC."""
    w_pos, w_neg = tern.pack_ternary(w.to(torch.int8), axis=0)
    return _packed_planes_mac(x2, w_pos, w_neg, spec, cim, w.shape[1])


def _packed_stream(x2, w, spec, *, cim: bool):
    """Functional stream path: pack once, interleave (layout 1), stream."""
    w_pos, w_neg = tern.pack_ternary(w.to(torch.int8), axis=0)
    return _packed_stream_mac(x2, tern.interleave_planes(w_pos, w_neg), spec,
                              cim, w.shape[1])


register_backend("exact/torch/none", _exact_torch, clamps=False)
register_backend("blocked/torch/none", _blocked_torch, clamps=True)
register_backend("corrected/torch/none", _corrected_torch, clamps=True)
register_backend("bitplane/torch/none", _bitplane_torch, clamps=True)
register_backend("fused/torch/none", _fused_torch, clamps=False)
register_backend("exact/torch/bitplane_u8",
                 functools.partial(_packed, cim=False), clamps=False)
register_backend("blocked/torch/bitplane_u8",
                 functools.partial(_packed, cim=True), clamps=True)
register_backend("blocked/cuda/none", _blocked_cuda, clamps=True,
                 tiles=_blocked_tiles)
register_backend("exact/cuda/none", _exact_cuda, clamps=False,
                 tiles=_exact_tiles)
register_backend("exact/cuda/bitplane_u8",
                 functools.partial(_packed, cim=False), clamps=False,
                 tiles=_packed_tiles)
register_backend("blocked/cuda/bitplane_u8",
                 functools.partial(_packed, cim=True), clamps=True,
                 tiles=_packed_tiles)
register_backend("exact/cuda_stream/bitplane_u8",
                 functools.partial(_packed_stream, cim=False), clamps=False,
                 tiles=_packed_stream_tiles)
register_backend("blocked/cuda_stream/bitplane_u8",
                 functools.partial(_packed_stream, cim=True), clamps=True,
                 tiles=_packed_stream_tiles)


# ---------------------------------------------------------------------------
# The tile sweep: launch grids of the CUDA kernels
# ---------------------------------------------------------------------------


def tile_candidates(spec: CiMExecSpec, cls: str,
                    k: Optional[int] = None) -> Tuple[Tuple[int, ...], ...]:
    """The launch grids :func:`autotune` sweeps for ``spec``'s kernel in
    shape class ``cls``: what the compiled instances of ``tile_kernel``
    accept. ``(rows, cluster)`` with rows in {8, 32} and cluster in {1, 2,
    4, 8}; the decode kernels #2 and #3 (packed specs at decode) have only
    the 8-row tile; ``cuda_stream`` adds the ring depth, ``(rows, cluster,
    nbuf)`` with nbuf in {2, 3} at decode (#3) and 2 at prefill, where #4
    has no ring to set. With ``k``, clusters are bounded as
    ``launch_plan`` bounds them (no rank without a 16-row block). Raises
    for untiled (torch) backends."""
    spec = spec.resolve()
    if get_backend(spec).tiles is None:
        raise ValueError(f"{spec.name} has no launch grid to tune")
    if cls not in SHAPE_CLASSES:
        raise ValueError(f"unknown shape class {cls!r} (use {SHAPE_CLASSES})")
    decode = cls == "decode"
    rows = ((DECODE_M_MAX,) if spec.packing == "bitplane_u8" and decode
            else kplan.TILE_ROWS)
    clusters = tuple(c for c in kplan.CLUSTERS
                     if k is None or kplan.bounded_cluster(c, k) == c)
    if spec.backend == "cuda_stream":
        nbufs = STREAM_NBUF if decode else (2,)
        return tuple((r, c, b) for r in rows for c in clusters for b in nbufs)
    return tuple((r, c) for r in rows for c in clusters)


def _grid_key(tiles: Tuple[int, ...]) -> str:
    return "x".join(map(str, tiles))


def _sweep_inputs(spec: CiMExecSpec, m: int, k: int, n: int, device):
    """Seeded ternary x (M, K) int8 and the backend call of ``spec`` on a
    (K, N) weight for one grid, as ``execute`` / ``execute_packed`` make
    it: stored planes for packed specs (layout 1 for ``cuda_stream``)."""
    gen = torch.Generator(device=device).manual_seed(m * 1000003 + k * 1009 + n)
    x = torch.randint(-1, 2, (m, k), generator=gen, device=device).to(torch.int8)
    w = torch.randint(-1, 2, (k, n), generator=gen, device=device).to(torch.int8)
    if spec.packing == "bitplane_u8":
        w_pos, w_neg = tern.pack_ternary(w, axis=0)
        if spec.backend == "cuda_stream":
            w_int = tern.interleave_planes(w_pos, w_neg)
            return lambda winner: _packed_stream_mac(x, w_int, spec, spec.clamps,
                                                     n, winner)
        return lambda winner: _packed_planes_mac(x, w_pos, w_neg, spec,
                                                 spec.clamps, n, winner)
    fn = get_backend(spec).fn
    return lambda winner: fn(x, w, spec, winner=winner)


def _time_us(run: Callable, tiles: Tuple[int, ...], repeats: int, device,
             calls: int = 20) -> float:
    """Device microseconds of one ``run(tiles)``: a warm-up call outside
    the clock, then ``calls`` calls captured in one CUDA graph, replayed
    ``repeats`` times between two CUDA events after a synchronize; the
    minimum over the replays, per call. A graph times the launches back to
    back, without the host's dispatch between them. The collector is off
    during the capture, as ``serve.graph.CapturedStep`` keeps it."""
    run(tiles)
    # analysis: host-sync ok -- the tile sweep times calls, outside any step
    torch.cuda.synchronize(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, stream=side):
            for _ in range(calls):
                run(tiles)
    finally:
        if enabled:
            gc.enable()
    graph.replay()
    best = math.inf
    for _ in range(max(1, repeats)):
        # analysis: host-sync ok -- the tile sweep times calls, outside any step
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()  # analysis: host-sync ok -- the tile sweep times calls, outside any step
        best = min(best, start.elapsed_time(end) * 1e3 / calls)
    return best


def _install(spec: CiMExecSpec, cls: str, tiles: Tuple[int, ...]) -> None:
    with _DISPATCH_LOCK:
        _TILE_CACHE[(spec.registry_key, spec.block, cls)] = tiles


def autotune(
    spec: CiMExecSpec,
    shapes: Tuple[Tuple[int, int, int], ...] = ((4, 1024, 512), (256, 1024, 512)),
    *,
    candidates: Optional[Dict[str, Tuple[Tuple[int, ...], ...]]] = None,
    repeats: int = 3,
    calibration=None,
) -> Dict[str, Dict]:
    """Time the launch grids of ``spec``'s kernel (:func:`tile_candidates`,
    or ``candidates[cls]``) on one (M, K, N) per shape class and cache the
    winners: every later eager ``execute`` / ``execute_packed`` of that
    spec and class launches on them (:func:`kernel_plan`). A winner
    installed after a ``CapturedStep`` was captured does not change that
    graph: it affects eager calls and new captures only. The output never
    depends on the grid (every partial is an integer).

    Timing runs on CUDA on seeded ternary operands (stored planes for
    packed specs), per candidate: one warm-up call outside the clock, then
    20 calls captured in one CUDA graph and replayed ``repeats`` times
    between two CUDA events after a synchronize; the minimum per call
    counts (:func:`_time_us`; the weight stays in the L2 cache). Run it
    before serving: the capture needs the device to itself. Candidates
    outside the kernel's grid are skipped, as the reference skips invalid
    tiles.

    With ``calibration=`` (a ``repro_torch.profile.CalibrationTable``, or
    any object with a ``tile_winners`` mapping) nothing is timed: the
    table's winners for ``spec`` are validated against the port's grid
    and installed; a Pallas tile triple, a shape class it does not know,
    or a table without winners for ``spec`` raises ``ValueError``.

    Returns ``{shape_class: {"tiles": winner, "us": best_us, "candidates":
    {"RxC[xB]": us}, "default": launch_plan's grid, "default_us": its
    time}}``. Raises for untiled (torch) backends, as the reference's
    ``jnp`` ones do."""
    spec = spec.resolve()
    entry = get_backend(spec)
    if entry.tiles is None:
        raise ValueError(
            f"{spec.name} has no launch grid to autotune (torch backends run "
            f"plain PyTorch; only the cuda kernels tune)")
    if calibration is not None:
        winners = dict(getattr(calibration, "tile_winners", {}) or {})
        per_spec = winners.get(spec.name)
        if not per_spec:
            raise ValueError(
                f"calibration table has no tile winners for {spec.name} "
                f"(known: {sorted(winners)})")
        report = {}
        for cls, tiles in sorted(per_spec.items()):
            if cls not in SHAPE_CLASSES:
                raise ValueError(f"unknown shape class {cls!r} in calibration")
            tiles = tuple(int(t) for t in tiles)
            if tiles not in tile_candidates(spec, cls):
                raise ValueError(
                    f"calibrated grid {tiles} invalid for {spec.name}/{cls} "
                    f"(the port's grids: {tile_candidates(spec, cls)})")
            _install(spec, cls, tiles)
            report[cls] = {"tiles": tiles, "us": None, "candidates": {},
                           "source": "calibration"}
        return report
    if not torch.cuda.is_available():
        raise RuntimeError("autotune times the kernels on the card: CUDA is "
                           "not available")
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = kplan.device_sms(dev)
    report: Dict[str, Dict] = {}
    for m, k, n in shapes:
        cls = shape_class(m)
        run = _sweep_inputs(spec, m, k, n, dev)
        grid = tile_candidates(spec, cls, k)
        cands = (candidates or {}).get(cls, grid)
        timings: Dict[str, float] = {}
        best = None
        for tiles in cands:
            tiles = tuple(int(t) for t in tiles)
            if tiles not in grid:
                continue
            timings[_grid_key(tiles)] = round(_time_us(run, tiles, repeats, dev), 2)
            if best is None or timings[_grid_key(tiles)] < timings[_grid_key(best)]:
                best = tiles
        if best is None:
            raise ValueError(f"no valid launch grid for {spec.name}/{cls}")
        _install(spec, cls, best)
        default = kplan.launch_plan(m, k, n, sms)
        default = (default.rows, default.cluster) + (
            (entry.tiles(m, k, n)[3],) if spec.backend == "cuda_stream" else ())
        report[cls] = {"tiles": best, "us": timings[_grid_key(best)],
                       "candidates": timings, "default": default,
                       "default_us": timings.get(_grid_key(default))}
    return report


# ---------------------------------------------------------------------------
# Spec -> hardware-model mapping (paper Section V / repro_torch.hw)
# ---------------------------------------------------------------------------


def spec_design(spec: CiMExecSpec) -> str:
    """Map an execution spec onto the registered array designs. "exact"
    is the near-memory baseline; every CiM formulation — including
    "fused", the kernel's cost stand-in, which the port registers as
    non-clamping — executes on a SiTe array, flavor choosing the design
    through the ``repro_torch.hw`` design registry. Unknown (plugged-in)
    formulations fall back on whether they clamp."""
    if spec.formulation == "exact":
        return "NM"
    if spec.formulation in FORMULATIONS or spec.clamps:
        from repro_torch.hw import design_for_flavor

        return design_for_flavor(spec.flavor)
    return "NM"


def _bind_array(spec: CiMExecSpec, tech, array):
    """Bind an execution spec to a concrete ArraySpec: the ArraySpec
    supplies technology and geometry, the *execution* spec decides the
    design (an "exact" spec costs as the NM baseline of that array no
    matter how the ArraySpec was labelled). Without an array, a
    default-geometry array on ``tech`` (default 8T-SRAM). ``tech`` and
    ``array`` are mutually exclusive."""
    from repro_torch import hw

    design = spec_design(spec)
    if array is None:
        return hw.ArraySpec(technology=tech or "8T-SRAM", design=design)
    if tech is not None:
        raise ValueError(
            f"pass either tech= or array=, not both (array already "
            f"names technology {array.technology!r}, got tech={tech!r})")
    return array.with_design(design)


def spec_array_cost(spec: CiMExecSpec, tech=None, array=None):
    """Absolute array-level cost (latency/energy/area) of executing this
    spec on the bound array (:func:`_bind_array`): the bridge from the
    execution API to the hardware model (``repro_torch.hw``)."""
    from repro_torch import hw

    return hw.array_cost(_bind_array(spec, tech, array))


def spec_cost_summary(spec: CiMExecSpec, tech=None, array=None) -> Dict[str, object]:
    """JSON-ready per-MAC-pass cost summary of ``spec`` on the bound
    array (the binding of :func:`spec_array_cost`): technology / design
    names plus the pass latency, energy, and relative area."""
    from repro_torch import hw

    bound = _bind_array(spec, tech, array)
    cost = hw.array_cost(bound)
    return {
        "tech": cost.tech,
        "design": cost.design,
        "array": bound.name,
        "mac_pass_ns": cost.mac_pass_ns,
        "mac_pass_pj": cost.mac_pass_pj,
        "macro_area_vs_nm": cost.macro_area,
    }


# ---------------------------------------------------------------------------
# Tracing contracts (repro_torch.analysis)
#
# The execution-shim invariants, declared where the shim lives. These
# drive the op auditor, the tests and the `python -m repro_torch.analysis`
# ratchet from one table, under the reference's names: the suffixes
# ``jnp``, ``pallas`` and ``stream`` run the port's ``torch``, ``cuda``
# and ``cuda_stream`` backends. A ``cuda`` or ``cuda_stream`` point runs
# on the card (its kernels launch, and its SASS pins apply) and is a
# skip without one.
# ---------------------------------------------------------------------------

from repro_torch.analysis.contracts import (  # noqa: E402
    OpRule,
    SkipTrace,
    TraceContract,
    forbid_convert,
    rank_mesh,
    register_trace_contract,
    sass_async_copies,
    sass_int_accum,
)


def _audit_device(backend: str) -> torch.device:
    if backend == "torch":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SkipTrace(f"the {backend} backend runs its kernels on the card")
    return torch.device("cuda")


def _audit_planes(spec: CiMExecSpec, device, k: int = 512, n: int = 256
                  ) -> tern.PackedPlanes:
    """Deterministic canonical PackedPlanes for audit runs: the
    prepare-time layout without initializing a model. K/N are chosen so
    no plane dim collides with the 128-row M tile (the decode-M rule
    keys on a literal 128 leading dim)."""
    g = torch.Generator().manual_seed(7)
    w = torch.randint(-1, 2, (k, n), generator=g, dtype=torch.int8)
    p1, p2 = tern.pack_ternary(w, axis=0)
    k_mult, n_mult = canonical_plane_layout(spec, device)
    p1 = ref.pad_axis(ref.pad_axis(p1, k_mult // 8, 0), n_mult, 1).to(device)
    p2 = ref.pad_axis(ref.pad_axis(p2, k_mult // 8, 0), n_mult, 1).to(device)
    scale = torch.ones((n,), dtype=torch.float32, device=device)
    if spec.backend == "cuda_stream":
        # the canonical layout prepare_for_spec emits for stream specs:
        # plane-interleaved version 1
        wi = tern.interleave_planes(p1, p2)
        return tern.PackedPlanes(pos=wi, neg=wi[:0], scale=scale, k=k, n=n,
                                 layout_version=tern.PLANE_LAYOUT_STREAM)
    return tern.PackedPlanes(pos=p1, neg=p2, scale=scale, k=k, n=n)


def no_decode_m128_rule() -> OpRule:
    """No decode-class call pads an operand's M to the 128-row prefill
    tile: the decode path takes M as it is (its kernels' M tile is 8).
    Fires on a pad or cat that makes a 2-D non-uint8 tensor of 128 rows
    from fewer (uint8 operands are the stored planes, whose leading dim
    is K/8 or K/4, not M)."""

    def _m128(rec) -> bool:
        if rec.name not in ("constant_pad_nd", "pad", "cat") or not rec.outputs:
            return False
        out = rec.outputs[0]
        return (len(out.shape) == 2 and out.shape[0] == 128 and out.dtype != "uint8"
                and any(len(t.shape) == 2 and t.shape[0] < 128 for t in rec.inputs))

    return OpRule(
        rule="decode-m-pad-128", when=_m128,
        reason="decode shapes take M as it is (an 8-row tile), never 128",
    )


def _packed_decode_point(backend: str):
    """execute_packed over canonical stored planes at a decode shape
    (M=3): the serving weight path."""

    def build():
        dev = _audit_device(backend)
        spec = CiMExecSpec(formulation="blocked", backend=backend,
                           packing="bitplane_u8")
        planes = _audit_planes(spec, dev)
        g = torch.Generator().manual_seed(3)
        x = torch.randint(-1, 2, (3, planes.k), generator=g).to(torch.float32).to(dev)

        def f(xv, pos, neg):
            lay = tern.PackedPlanes(pos=pos, neg=neg, scale=planes.scale,
                                    k=planes.k, n=planes.n,
                                    layout_version=planes.layout_version)
            return execute_packed(spec, xv, lay)

        return f, (x, planes.pos, planes.neg)

    return build


_PACKED_DECODE_RULES = dict(
    max_host_syncs=0,
    no_pad_on_dtypes=("uint8",),
)

register_trace_contract(
    "execution.execute_packed.decode.jnp",
    _packed_decode_point("torch"),
    TraceContract(**_PACKED_DECODE_RULES),
)

register_trace_contract(
    "execution.execute_packed.decode.pallas",
    _packed_decode_point("cuda"),
    TraceContract(
        **_PACKED_DECODE_RULES,
        accum_dtype="int32",
        forbid_ops=(
            no_decode_m128_rule(),
            forbid_convert(
                from_kinds=("int",), to=("float32", "float64", "bfloat16"),
                within="kernel",
                reason="decode-class event counts stay integer end-to-end",
            ),
        ),
        sass_pins=(sass_int_accum("packed_decode_mac"),),
    ),
)

# The streaming decode path inherits every cuda decode rule (int32
# accumulation, no uint8 pad: canonical version-1 planes enter the kernel
# untouched, no int->float convert, M never padded to 128) and adds the
# ring's pins: asynchronous global->shared copies and a wait on them in
# every instance of #3 (the Pallas kernel's 2 dma_start / 1 dma_wait).
register_trace_contract(
    "execution.execute_packed.decode.stream",
    _packed_decode_point("cuda_stream"),
    TraceContract(
        **_PACKED_DECODE_RULES,
        accum_dtype="int32",
        forbid_ops=(
            no_decode_m128_rule(),
            forbid_convert(
                from_kinds=("int",), to=("float32", "float64", "bfloat16"),
                within="kernel",
                reason="the streaming decode path keeps the int8/int32 "
                       "event-count datapath",
            ),
        ),
        sass_pins=(sass_int_accum("packed_stream_mac"),)
        + sass_async_copies("packed_stream_mac"),
    ),
)


def _ste_backward_point(formulation: str = "exact"):
    """The gradients of ``formulation`` on bf16 operands: the exact STE
    backward's products keep the operand dtype, so TP all-reduce payloads
    stay at activation width (no f32[4,32] dx anywhere). The blocked
    formulation accumulates its STE backward in f32 by design: the tests
    use it as the rule's positive control."""

    def build():
        spec = CiMExecSpec(formulation=formulation, backend="torch")
        x = torch.ones((4, 32), dtype=torch.bfloat16, requires_grad=True)
        w = torch.ones((32, 3), dtype=torch.bfloat16, requires_grad=True)

        def f(a, b):
            loss = execute(spec, a, b).to(torch.float32).sum()
            return torch.autograd.grad(loss, (a, b))

        return f, (x, w)

    return build


register_trace_contract(
    "execution.ste_backward.exact",
    _ste_backward_point(),
    TraceContract(forbid_dtype_shapes=(("float32", (4, 32)),)),
)


def _execute_tp_point():
    """The row-parallel TP route with the compressed int8 collective, in
    a rank of a spawned group: the rank's program must not grow with
    tp."""

    def build(tp: int = 2):
        mesh = rank_mesh(tp)
        spec = CiMExecSpec(formulation="blocked", backend="torch")
        x = torch.ones((4, 64), dtype=torch.float32)
        w = torch.ones((64, 32), dtype=torch.float32)

        def f(a, b):
            return execute_tp(spec, a, b, mesh, compressed=True)

        return f, (x, w)

    return build


register_trace_contract(
    "execution.execute_tp.compressed",
    _execute_tp_point(),
    TraceContract(max_host_syncs=0),
    axes={"tp": (2, 4)},
)
