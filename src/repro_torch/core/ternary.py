"""Ternary quantization primitives (PyTorch counterpart of
``repro/core/ternary.py``).

  * threshold ternarization (TWN, factor 0.7) with a per-tensor or
    per-axis scale,
  * the straight-through estimators of training: :func:`ste_ternarize`
    (scaled) and :func:`ste_unit_ternarize` (codes only), whose backward
    is the clipped STE ``g * (|x| <= 1)``,
  * the differential (M1, M2) bitplane encoding of the SiTe CiM cell
    (W=+1 -> M1=1,M2=0; W=-1 -> M1=0,M2=1; W=0 -> M1=M2=0),
  * 8-way bit packing of each plane into uint8 along K (bit j of byte r
    is row 8r+j), the two plane layouts and :class:`PackedPlanes`,
  * the sparsity statistics :func:`ternary_sparsity` and
    :func:`block_overflow_rate`.
"""
from __future__ import annotations

import dataclasses
import functools
import struct
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

TWN_THRESHOLD_FACTOR = 0.7

Axis = Union[None, int, Sequence[int]]


def _axes(x: torch.Tensor, axis: Axis) -> Optional[Tuple[int, ...]]:
    if axis is None:
        return None
    if isinstance(axis, int):
        axis = (axis,)
    return tuple(a % x.ndim for a in axis)


def ternary_threshold(x: torch.Tensor, axis: Axis = None,
                      factor: float = TWN_THRESHOLD_FACTOR) -> torch.Tensor:
    """delta = factor * mean(|x|) (optionally per-channel along ``axis``).
    The factor is rounded to x's dtype first, as the reference's weakly
    typed scalar is (this matters in bf16)."""
    absx = x.abs()
    axes = _axes(x, axis)
    # a host scalar, not a device tensor: no host-to-device copy per call
    # (a captured CUDA graph cannot hold one)
    factor = _rounded(factor, x.dtype)
    if axes is None:
        return factor * absx.mean()
    return factor * absx.mean(dim=axes, keepdim=True)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (round to nearest even), as a
    Python float, in pure Python: no tensor, so a step that calls it
    dispatches no op for it, on its first call either."""
    if dtype == torch.float64:
        return float(value)
    if dtype == torch.float16:
        return struct.unpack("<e", struct.pack("<e", value))[0]
    bits = struct.unpack("<I", struct.pack("<f", value))[0]
    if dtype == torch.bfloat16:
        bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def ternarize(x: torch.Tensor, axis: Axis = None,
              factor: float = TWN_THRESHOLD_FACTOR,
              reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``x`` to {-1, 0, +1} * scale. Returns ``(t, scale)`` with
    ``t`` in the dtype of x and ``scale = E[|x| : |x| > delta]``.

    ``reduce`` (per-tensor only) makes ``x`` one rank's part of a tensor
    split over ranks: it sums a float64 vector over them (an all-reduce),
    and the statistics are the whole tensor's, from :func:`_split_stats`."""
    if reduce is not None:
        if axis is not None:
            raise ValueError("a split statistic is per tensor (axis=None)")
        return _split_stats(x, factor, reduce)
    delta = ternary_threshold(x, axis=axis, factor=factor)
    mask = (x.abs() > delta).to(x.dtype)
    t = torch.sign(x) * mask
    axes = _axes(x, axis)
    if axes is None:
        num = (x.abs() * mask).sum()
        den = torch.clamp(mask.sum(), min=1.0)
    else:
        num = (x.abs() * mask).sum(dim=axes, keepdim=True)
        den = torch.clamp(mask.sum(dim=axes, keepdim=True), min=1.0)
    return t, (num / den).to(x.dtype)


def _split_stats(x: torch.Tensor, factor: float,
                 reduce: Callable[[torch.Tensor], torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor ternarization of the tensor whose part on this rank is
    ``x``: the sum of |x| and the count, then the sum of |x| over the
    kept codes and their count, each pair summed over the ranks by
    ``reduce`` in float64 (two collectives, in this order on every rank)
    and rounded to x's dtype where one device's ``mean`` and ``sum``
    round. Equal to :func:`ternarize` of the whole tensor up to the order
    of the float sums: a threshold one ulp away moves the codes at a
    near-tie."""
    absx = x.abs()
    f64 = torch.float64
    count = torch.full((), float(x.numel()), dtype=f64, device=x.device)
    mean = reduce(torch.stack([absx.sum(dtype=f64), count]))
    delta = _rounded(factor, x.dtype) * (mean[0] / mean[1]).to(x.dtype)
    mask = (absx > delta).to(x.dtype)
    t = torch.sign(x) * mask
    kept = reduce(torch.stack([(absx * mask).sum(dtype=f64), mask.sum(dtype=f64)]))
    num = kept[0].to(x.dtype)
    den = torch.clamp(kept[1].to(x.dtype), min=1.0)
    return t, (num / den).to(x.dtype)


def ternarize_fixed(x: torch.Tensor, delta) -> torch.Tensor:
    """Quantize with an externally supplied threshold (calibration path)."""
    return torch.sign(x) * (x.abs() > delta).to(x.dtype)


class _SteTernarize(torch.autograd.Function):
    """Per-tensor ternarization, scaled (``t * scale``) or not (``t``),
    with the clipped straight-through gradient ``g * (|x| <= 1)``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scaled: bool) -> torch.Tensor:
        t, scale = ternarize(x)
        ctx.save_for_backward(x)
        return t * scale if scaled else t

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype), None


def ste_ternarize(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled ternarization with the clipped STE gradient."""
    return _SteTernarize.apply(x, True)


def ste_unit_ternarize(x: torch.Tensor) -> torch.Tensor:
    """Unscaled ternarization (exactly {-1, 0, 1}) with the clipped STE
    gradient: activations feeding a SiTe CiM array, whose scale folds
    into the layer output."""
    return _SteTernarize.apply(x, False)


def to_bitplanes(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ternary {-1,0,1} -> (M1, M2) uint8 bitplanes."""
    return (t > 0).to(torch.uint8), (t < 0).to(torch.uint8)


def from_bitplanes(m1: torch.Tensor, m2: torch.Tensor,
                   dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """(M1, M2) -> ternary; the illegal (1,1) state decodes as 0."""
    return (m1.to(torch.int32) - m2.to(torch.int32)).to(dtype)


def validate_bitplanes(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """True (a 0-dim bool tensor) iff no cell stores the illegal (1,1)
    combination."""
    return torch.logical_not(torch.any((m1 == 1) & (m2 == 1)))


def _pack_plane(plane: torch.Tensor, axis: int) -> torch.Tensor:
    k = plane.shape[axis]
    moved = plane.movedim(axis, 0).to(torch.int32)
    grouped = moved.reshape((k // 8, 8) + tuple(moved.shape[1:]))
    shift = torch.arange(8, dtype=torch.int32, device=plane.device)
    shift = shift.reshape((1, 8) + (1,) * (grouped.ndim - 2))
    packed = (grouped << shift).sum(dim=1).to(torch.uint8)
    return packed.movedim(0, axis).contiguous()


def pack_ternary(t: torch.Tensor, axis: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack ternary values along ``axis`` (length divisible by 8) into two
    uint8 bitplane arrays of 1/8 the length."""
    axis = axis % t.ndim
    k = t.shape[axis]
    if k % 8 != 0:
        raise ValueError(f"pack axis length {k} not divisible by 8")
    m1, m2 = to_bitplanes(t)
    return _pack_plane(m1, axis), _pack_plane(m2, axis)


def _unpack_plane(packed: torch.Tensor, axis: int) -> torch.Tensor:
    moved = packed.movedim(axis, 0).to(torch.int32)
    shift = torch.arange(8, dtype=torch.int32, device=packed.device)
    shift = shift.reshape((1, 8) + (1,) * (moved.ndim - 1))
    bits = (moved[:, None] >> shift) & 1
    flat = bits.reshape((moved.shape[0] * 8,) + tuple(moved.shape[1:]))
    return flat.movedim(0, axis)


def unpack_ternary(p1: torch.Tensor, p2: torch.Tensor, axis: int = 0,
                   dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Inverse of :func:`pack_ternary`."""
    axis = axis % p1.ndim
    return from_bitplanes(_unpack_plane(p1, axis), _unpack_plane(p2, axis),
                          dtype=dtype)


# Plane storage layouts (PackedPlanes.layout_version):
#   0 — legacy: pos/neg are two separate (..., K/8, N) byte planes.
#   1 — K-major plane-interleaved: ``pos`` holds one (..., K/4, N) array
#       whose byte-rows alternate pos/neg; ``neg`` is an empty
#       (..., 0, N) placeholder.
PLANE_LAYOUT_LEGACY = 0
PLANE_LAYOUT_STREAM = 1


def interleave_planes(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """(..., K/8, N) pos/neg byte planes -> one (..., K/4, N) array with
    alternating pos/neg byte-rows (layout version 1)."""
    if pos.shape != neg.shape:
        raise ValueError(f"plane shape mismatch: {tuple(pos.shape)} vs "
                         f"{tuple(neg.shape)}")
    stacked = torch.stack([pos, neg], dim=-2)  # (..., K/8, 2, N)
    return stacked.reshape(tuple(pos.shape[:-2])
                           + (2 * pos.shape[-2], pos.shape[-1]))


def deinterleave_planes(w_int: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`interleave_planes`: (..., K/4, N) -> two
    (..., K/8, N) byte planes (strided views)."""
    rows = w_int.shape[-2]
    if rows % 2 != 0:
        raise ValueError(f"interleaved plane rows {rows} not even")
    split = w_int.reshape(tuple(w_int.shape[:-2])
                          + (rows // 2, 2, w_int.shape[-1]))
    return split[..., 0, :], split[..., 1, :]


@dataclasses.dataclass(frozen=True)
class PackedPlanes:
    """Stored 2-bit bitplanes in the canonical kernel layout.

    ``pos``/``neg`` are the packed (M1, M2) uint8 planes, padded along
    their last two dims to the packed kernels' tile granularity;
    ``scale`` is the per-output-channel weight scale over the logical
    channels; ``k``/``n`` are the logical contraction/output dims.
    ``layout_version`` selects the storage ordering (``PLANE_LAYOUT_*``).
    Iterating yields ``(pos, neg, scale)`` in the legacy view. Stacked
    (L, K/8, N) planes are sliced per layer with :meth:`layer`.
    ``shards`` > 1 marks one rank's column shard under a TP mesh
    (:meth:`column_shard`): the planes hold 1/``shards`` of the padded
    columns, while ``k``, ``n`` and ``scale`` stay the whole weight's.
    """

    pos: torch.Tensor
    neg: torch.Tensor
    scale: torch.Tensor
    k: int
    n: int
    layout_version: int = PLANE_LAYOUT_LEGACY
    shards: int = 1

    def __iter__(self):
        return iter(self.planes() + (self.scale,))

    def planes(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The two separate (..., K/8, N) byte planes (legacy view)."""
        if self.layout_version == PLANE_LAYOUT_STREAM:
            return deinterleave_planes(self.pos)
        return self.pos, self.neg

    def interleaved(self) -> torch.Tensor:
        """The (..., K/4, N) plane-interleaved array (layout version 1)."""
        if self.layout_version == PLANE_LAYOUT_STREAM:
            return self.pos
        return interleave_planes(self.pos, self.neg)

    def layer(self, i: int) -> "PackedPlanes":
        """One layer's (K/8, N) planes from a stacked (L, K/8, N) entry."""
        if self.pos.ndim < 3:
            raise ValueError(
                f"layer() needs stacked (L, K/8, N) planes, got "
                f"{tuple(self.pos.shape)}")
        return PackedPlanes(
            pos=self.pos[i], neg=self.neg[i], scale=self.scale[i],
            k=self.k, n=self.n, layout_version=self.layout_version,
            shards=self.shards,
        )

    def column_shard(self, rank: int, size: int) -> "PackedPlanes":
        """Rank ``rank``'s of ``size`` equal column shards of whole planes
        (contiguous copies; the padded N must divide ``size``)."""
        if self.shards != 1:
            raise ValueError(f"already a column shard (of {self.shards})")
        n_pad = self.pos.shape[-1]
        if n_pad % size:
            raise ValueError(f"padded plane N={n_pad} does not split {size} ways")
        cols = slice(rank * n_pad // size, (rank + 1) * n_pad // size)
        return PackedPlanes(
            pos=self.pos[..., cols].contiguous(), neg=self.neg[..., cols].contiguous(),
            scale=self.scale, k=self.k, n=self.n,
            layout_version=self.layout_version, shards=size)


# ---------------------------------------------------------------------------
# Sparsity statistics (the paper leans on DNN sparsity for sense margin)
# ---------------------------------------------------------------------------


def ternary_sparsity(t: torch.Tensor) -> torch.Tensor:
    """Fraction of zeros (an f32 0-dim tensor): the quantity the paper's
    sense-margin analysis relies on."""
    return (t == 0).to(torch.float32).mean()


def block_overflow_rate(x_t: torch.Tensor, w_t: torch.Tensor,
                        block: int = 16) -> torch.Tensor:
    """Fraction (an f32 0-dim tensor) of (``block``-row block, output
    column) partial MACs whose event count a or b exceeds 8, i.e. how
    often the 3-bit ADC clamp binds (paper: rare, due to sparsity).
    x_t (..., K) and w_t (K, N) ternary values, K a multiple of
    ``block``; the counts are exact in f32."""
    k = x_t.shape[-1]
    kb = k // block
    xb = x_t.to(torch.float32).reshape(tuple(x_t.shape[:-1]) + (kb, block))
    wb = w_t.to(torch.float32).reshape((kb, block) + tuple(w_t.shape[1:]))
    p = torch.einsum("...ki,kin->...kn", xb, wb)
    m = torch.einsum("...ki,kin->...kn", xb.abs(), wb.abs())
    a, b = (m + p) / 2, (m - p) / 2
    return ((a > 8) | (b > 8)).to(torch.float32).mean()
