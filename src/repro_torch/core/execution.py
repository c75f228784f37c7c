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
to the JAX ones. The CUDA kernels keep their K loop inside one block and
choose their own M tile by :func:`shape_class`.

With a profiler installed (``profile.set_profiler``), every eager
``execute``/``execute_packed`` call is timed into it, with the
reference's meta (m, k, n, macs, weight_bytes); calls inside a batcher
or serve step (:func:`no_kernel_events`, the counterpart of the
reference's jitted steps, where no call records) and calls while the
current stream captures a graph record nothing.

Not ported yet: ``execute_tp`` /
``execute_packed_tp`` and autotune (``nbuf`` of the stream tiles stays
the table's 2).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.core import ternary as tern
from repro_torch.kernels import DECODE_M_MAX, ref
from repro_torch.kernels.packed_mac import (
    STREAM_ALIGN,
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


def shape_class(m: int) -> str:
    """"decode" for M <= DECODE_M_MAX, else "prefill"."""
    return "decode" if m <= DECODE_M_MAX else "prefill"


def tiles_for(spec: CiMExecSpec, m: int, k: int, n: int,
              device=None) -> Optional[Tuple[int, ...]]:
    """The (bm, bk, bn) tiles of the registry entry's table for an
    (M, K) x (K, N) call — (bm, bk, bn, nbuf) for ``cuda_stream``; None
    for untiled (torch) backends."""
    entry = _REGISTRY.get(spec.resolve(device).registry_key)
    if entry is None or entry.tiles is None:
        return None
    return entry.tiles(m, k, n)


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


def _profiled_call(entry: str, spec: CiMExecSpec, x: torch.Tensor, m: int,
                   k: int, n: int, weight_bytes: int, thunk: Callable):
    """Run ``thunk()``; with a sink installed, outside a step and outside
    a capture (a sync there would invalidate it), time it to the device's
    completion and emit one kernel event."""
    sink = _PROFILE_SINK
    cuda = x.device.type == "cuda"
    if (sink is None or getattr(_STEP, "off", False)
            or (cuda and torch.cuda.is_current_stream_capturing())):
        return thunk()
    t0 = time.perf_counter()
    out = thunk()
    t1 = time.perf_counter()
    if cuda:
        torch.cuda.synchronize(x.device)
    t2 = time.perf_counter()
    sink(entry_point=entry, exec_spec=spec.name, shape_class=shape_class(m),
         mesh=None, wall_us=(t2 - t0) * 1e6, dispatch_us=(t1 - t0) * 1e6,
         meta={"m": int(m), "k": int(k), "n": int(n),
               "macs": int(m) * int(k) * int(n),
               "weight_bytes": int(weight_bytes)})
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


def _blocked_cuda(x2, w, spec):
    return ternary_cim_matmul(_codes(x2), _codes(w), block=spec.block,
                              adc_max=spec.adc_max)


def _exact_cuda(x2, w, spec):
    return ternary_exact_matmul(_codes(x2), _codes(w))


def _packed_planes_mac(x2, w_pos, w_neg, spec, cim: bool, n_out: int):
    """The MAC from (rows, N) planes. torch backends pad x and the planes
    to whole blocks and run the oracle; kernel backends hand the logical
    extents to the decode kernel (M tile <= DECODE_M_MAX, int32) or the
    prefill kernel (f32), which zero-extend K themselves."""
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
        return packed_cim_matmul_decode(_codes(x2), w_pos, w_neg, **kw).to(torch.float32)
    return packed_cim_matmul(_codes(x2), w_pos, w_neg, **kw)


def _packed_stream_mac(x2, w_int, spec, cim: bool, n_out: int):
    """The MAC from ONE (K/4, N) plane-interleaved array (layout 1).
    Decode-class M takes the streaming kernel (columns padded to its
    16-byte copies, a no-op on canonical planes), with the ring depth of
    the tile table; prefill-class M de-interleaves (strided views, no
    pad) and takes the prefill packed kernel, as the reference does."""
    m = x2.shape[0]
    if shape_class(m) == "prefill":
        return _packed_planes_mac(x2, *tern.deinterleave_planes(w_int), spec,
                                  cim, n_out)
    nbuf = _packed_stream_tiles(m, x2.shape[1], w_int.shape[1])[3]
    out = packed_cim_matmul_decode_stream(
        _codes(x2), ref.pad_axis(w_int, STREAM_ALIGN, 1), n_out=n_out,
        block=spec.block, adc_max=spec.adc_max, cim=cim, nbuf=nbuf)
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
