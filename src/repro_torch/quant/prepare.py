"""Offline model surgery for ternary serving (port of
``repro/quant/prepare.py``).

``ternarize_params`` folds ternarization into the stored weights (scale
* {-1,0,1}), so serving with ``QuantConfig(pre_quantized=True)`` skips
the per-step threshold quantizer. ``pack_params`` additionally emits the
2-bit differential (M1, M2) planes of each such weight, and
``prepare_for_spec`` does whichever surgery a serving spec's packing
needs, padding planes to the canonical kernel layout.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core import ternary as tern
from repro_torch.core.execution import CiMExecSpec, canonical_plane_layout
from repro_torch.kernels.ref import pad_axis

PyTree = Any

# weights the ternary dense path quantizes (as the reference names them)
_QUANT_RE = re.compile(
    r"(^|/)(wq|wk|wv|wo|w_dkv|w_uk|w_uv|w_in|w_out|w_gate|w_up|w_down|projector)$"
)
_NO_QUANT_RE = re.compile(r"(^|/)(embed|unembed|router|conv_w|conv_b)($|/)")


def tree_paths(tree: PyTree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """Flatten nested dicts to ("path/like/this", leaf) pairs, keys
    sorted (the JAX package's leaf order)."""
    out = []
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        val = tree[key]
        if isinstance(val, dict):
            out.extend(tree_paths(val, path))
        else:
            out.append((path, val))
    return out


def _map_tree(tree: PyTree, fn, prefix: str = "") -> PyTree:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        out[key] = _map_tree(val, fn, path) if isinstance(val, dict) else fn(path, val)
    return out


def _is_quantized_weight(path: str, leaf: torch.Tensor) -> bool:
    return (bool(_QUANT_RE.search(path)) and leaf.dim() >= 2
            and not _NO_QUANT_RE.search(path))


def _ternarize_leaf(leaf: torch.Tensor, factor: float):
    # over the contraction dim only: stacked (L, K, N) leaves get
    # per-(layer, out-channel) thresholds and scales
    return tern.ternarize(leaf, axis=(leaf.dim() - 2,), factor=factor)


def ternarize_params(params: PyTree,
                     factor: float = tern.TWN_THRESHOLD_FACTOR) -> PyTree:
    """Fold ternarization into the stored weights (scale * {-1,0,1})."""
    def fold(path, leaf):
        if not _is_quantized_weight(path, leaf):
            return leaf
        t, scale = _ternarize_leaf(leaf, factor)
        return (t * scale).to(leaf.dtype)

    return _map_tree(params, fold)


def pack_params(params: PyTree, factor: float = tern.TWN_THRESHOLD_FACTOR
                ) -> Tuple[PyTree, Dict[str, Tuple]]:
    """Ternarize and 2-bit-pack the quantizable weights. Returns
    (params_with_scales, packed) with ``packed[path] = (pos, neg, scale)``
    packed along the contraction (second-to-last) dim."""
    packed: Dict[str, Tuple] = {}

    def fold(path, leaf):
        k_axis = leaf.dim() - 2
        if not (_is_quantized_weight(path, leaf) and leaf.shape[k_axis] % 8 == 0):
            return leaf
        t, scale = _ternarize_leaf(leaf, factor)
        p1, p2 = tern.pack_ternary(t.to(torch.int8), axis=k_axis)
        packed[path] = (p1, p2, scale)
        return (t * scale).to(leaf.dtype)

    return _map_tree(params, fold), packed


def _canonicalize_packed(packed: Dict[str, Tuple], spec: CiMExecSpec,
                         device=None, tp: int = 1) -> Dict[str, tern.PackedPlanes]:
    """Pad each (p1, p2, scale) entry to the canonical kernel layout for
    ``spec``: plane rows to the tile K granularity, columns to the tile N
    granularity. Pad cells are (0, 0) pairs — weight 0, inert — and the
    logical (K, N) ride on the :class:`PackedPlanes`. Specs resolving to
    ``cuda_stream`` store the planes interleaved (layout 1: one
    (..., K/4, N) array, the ordering the stream kernel copies a K tile
    from in one run), as the reference does under ``pallas_stream``. For a ``tp``-rank mesh
    the columns pad to ``tp`` times the tile N granularity, so each
    rank's column shard is whole tiles."""
    k_mult, n_mult = canonical_plane_layout(spec, device)
    n_mult *= tp
    stream = spec.resolve(device).backend == "cuda_stream"
    rows = k_mult // 8
    out: Dict[str, tern.PackedPlanes] = {}
    for path, (p1, p2, scale) in packed.items():
        k, n = p1.shape[-2] * 8, p1.shape[-1]
        p1 = pad_axis(pad_axis(p1, rows, -2), n_mult, -1).contiguous()
        p2 = pad_axis(pad_axis(p2, rows, -2), n_mult, -1).contiguous()
        if stream:
            wi = tern.interleave_planes(p1, p2)
            out[path] = tern.PackedPlanes(
                pos=wi, neg=wi[..., :0, :], scale=scale, k=k, n=n,
                layout_version=tern.PLANE_LAYOUT_STREAM)
        else:
            out[path] = tern.PackedPlanes(pos=p1, neg=p2, scale=scale, k=k, n=n)
    return out


def prepare_for_spec(params: PyTree, spec: CiMExecSpec,
                     factor: float = tern.TWN_THRESHOLD_FACTOR, mesh=None):
    """Offline surgery matched to the serving execution spec.

    packing="none"        -> ternarize + fold scales; returns params.
    packing="bitplane_u8" -> also emit packed planes; returns
                             ``(params, packed)`` with each
                             ``packed[path]`` a canonical
                             :class:`PackedPlanes` (layout 1 for
                             ``cuda_stream`` specs, else layout 0).
    The canonical layout is resolved on the params' device.

    ``mesh`` (a ``launch.mesh.TPMesh``): each rank keeps only its column
    shard of every plane (``PackedPlanes.column_shard``, the
    ``dist.sharding.packed_specs`` split over N; the padded N is a
    multiple of ``tp`` tiles, which the guard of
    ``execution.execute_packed_tp`` needs). The surgery itself runs on
    the whole weights (per-channel thresholds need the full K column),
    and the folded params come back whole: ``dist.sharding.shard_params``
    places them, as it needs the config's heads.
    """
    tp = 1 if mesh is None else int(mesh.shape.get("model", 1))
    if spec.packing == "bitplane_u8":
        prepared, packed = pack_params(params, factor=factor)
        device = tree_paths(params)[0][1].device
        packed = _canonicalize_packed(packed, spec, device, tp)
        if tp > 1:
            packed = {path: p.column_shard(mesh.rank, tp)
                      for path, p in packed.items()}
        return prepared, packed
    return ternarize_params(params, factor=factor)
