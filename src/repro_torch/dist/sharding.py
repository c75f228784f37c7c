"""Which leaf splits over the "model" axis, and each rank's shard of it
(port of ``repro/dist/sharding.py``).

``param_specs`` / ``_leaf_spec`` are the reference's rule: attention
projections and MLP weights split column-parallel (``_COL_TP``: the
output dim) or row-parallel (``_ROW_TP``: the contraction dim), the
embedding over its vocabulary, norms and small leaves stay replicated,
and a dim splits only where the axis size divides it. A spec is a tuple
of axis names or None per dim, the counterpart of a ``PartitionSpec``.

The reference hands its specs to GSPMD, which inserts the collectives.
The port runs one process per rank (``launch.mesh``), so
:func:`shard_params` cuts each rank's shard out of the whole (bridged or
seeded) parameters, and the model calls the collectives itself
(``dist.collectives``) where a shard meets them: a row-parallel
:func:`~repro_torch.models.layers.dense` gathers its input and sums its
partials, the embedding sums its masked lookups, and the logits are
gathered over the vocabulary. Two rules differ from GSPMD's:

  * **q/k/v/o split on whole heads and whole GQA groups.** Where
    ``n_heads`` or ``n_kv_heads`` does not divide by the mesh size,
    attention stays replicated on every rank while the MLP and the
    vocabulary still split, so every degree is correct, as in the
    reference. Each rank then runs the model at its own widths
    (:func:`local_config`: its heads).
  * **The KV cache splits by the kv heads a rank owns**
    (:func:`cache_specs`), not over the sequence dim as the reference's
    ``cache_specs`` chooses: attention stays head-local, and each rank
    makes only its own cache.

A quantized shard holds the ternary codes and per-output-channel scales
of the whole weight, computed once at placement by the very function the
single-device step calls (``layers._weight_codes``) on the same layer
view, then sliced (:class:`WeightShard`): a statistic over the split
dim (the row-parallel weights' K) is the single-device one bit for bit.

The other families' rules, where the port differs from GSPMD's:

  * **mamba layers split on whole SSM heads** (:func:`mamba_splits`).
    The fused ``w_in`` has the columns ``[z (di) | x (di) | B (g·n) | C
    (g·n) | dt (h)]``, which a contiguous column split would cut across;
    a rank takes, by an index set of the whole weight's columns
    (:func:`mamba_columns`), its heads' z, x and dt columns and the B
    and C columns of its groups (all of them when there is one group,
    as in every config), the matching channels of ``conv_w``/``conv_b``
    (depthwise: the slice is exact) and its heads of ``A_log``, ``D``
    and ``dt_bias``. The scan runs head-local; the gated norm is a
    statistic over the whole ``d_inner``, so the block gathers its input
    first (a copy) and runs it whole, and ``w_out`` is row-parallel. The
    rank's SSM widths come from its config: :func:`local_config` returns
    a ``configs.base.RankConfig``, whose explicit ``ssm_tp`` field divides
    ``ssm_d_inner`` (and so ``ssm_n_heads``); the conv and state caches
    it makes are the rank's channels and heads.
  * **MLA splits ``wq``, ``w_uk``, ``w_uv`` and ``wo`` on whole heads;
    ``w_dkv`` stays replicated** (the reference's ``_COL_TP`` splits
    it): its output feeds ``kv_norm``, a statistic over the latent, and
    the latent cache is whole on every rank (every head reads it).
    ``w_uk``/``w_uv`` are plain contractions outside ``dense``, so their
    shards are plain column slices.
  * **A rank owns ``n_experts / tp`` whole experts** (the reference's
    ``_EXPERT_TP`` rule, :class:`ExpertShard`): each expert's
    ternarization statistic is its whole weight's. Routing, capacity and
    drops are computed from the replicated activations on every rank;
    a rank runs its experts' rows of the capacity buffer, the outputs
    are gathered over the expert dim (a copy), and every rank combines
    them in the single-device order. The shared experts split as the
    dense MLP. The reference's grouped dispatch (one routing group per
    data shard) runs inside each group (:func:`routing_groups`).

encdec and vlm split as the dense family does, in serving and in
training. whisper's cross attention (``blocks/cross``: q/k/v
column-parallel, o row-parallel; multi-head, so on whole heads exactly
where the self-attention splits) and its encoder (``enc_blocks``:
attention and MLP as a decoder layer's; ``blocks/ln_x``, ``enc_norm``
and ``enc_pos`` replicated), and llava's ``projector`` column-parallel
(``transformer.embed_inputs`` gathers its output over the ranks). Where
the heads do not divide, the encoder's and the cross attention stay
replicated with the decoder's while the MLPs and the vocabulary split.
The batcher serves their decoders (it takes no encoder output and no
image patches); ``forward(frames=)`` and ``forward(patches=)`` run on a
rank's serving shards, and a train step's forward on its training
shards: the replicated encoder output enters every decoder layer's k/v
through one ``collectives.copy`` and an encoder layer's normed input one
copy for its q, k and v, and the projector's columns are gathered by
``collectives.gather``.

Mode "off" splits the same weights as float slices (no codes): a column
shard is ``x @ w``, a row shard computes its partial in float32, sums
the partials in float32 and rounds once.

The model axis of a train step splits by the same rule, kept once in
:func:`train_layout` (a :class:`LeafSplit` per split leaf, which
:func:`shard_params` cuts serving shards by too): a rank holds float
slices that take gradients (:func:`shard_state`; the model reads them
through :func:`train_views` as :class:`TrainShard`, ``ExpertShard`` and
``VocabShard`` views), the model-axis collectives are
``dist.collectives``' autograd functions, and mamba's B and C, held
whole by every rank of one group, sum their partial gradients over the
ranks. :func:`gather_state` joins the shards back, bit for bit.

The data axis (data-parallel training) splits the batch, not the
weights: every rank holds the whole replicated state and runs its rows
of the global batch (:func:`batch_shard`, the rule of the reference's
``dryrun.batch_shardings``). The reference's activation-sharding switch
is ported as state (:func:`enable_activation_sharding`): its divisor
sets MoE's routing groups in one process, as the reference's does,
while ``shard_act`` is the identity, since no partitioner reads a
constraint here. Inside a data-parallel rank (:func:`data_parallel`)
the rank's rows are one routing group, and every per-tensor activation
statistic that the reference's partitioner takes over the whole batch
is summed over the data group (:func:`data_group`, read by
``layers.dense``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.dist import collectives
from repro_torch.quant.prepare import _map_tree

PyTree = Any
Spec = Tuple[Optional[str], ...]

# column-parallel (shard the output-channel / last dim over "model")
_COL_TP = {
    "wq", "wk", "wv", "w_uk", "w_uv", "w_dkv", "w_in",
    "w_gate", "w_up", "unembed", "projector",
}
# row-parallel (shard the contraction dim over "model")
_ROW_TP = {"wo", "w_out", "w_down"}
# MoE expert weights: shard the expert dim over "model"
_EXPERT_TP = {"w_gate", "w_up", "w_down"}
_ATTN = {"wq", "wk", "wv", "wo"}

# leaves below this size are never FSDP-sharded (gather overhead > savings)
FSDP_MIN_SIZE = 1 << 20

#: the families whose params shard_params splits: every family
TP_FAMILIES = ("dense", "ssm", "hybrid", "moe", "encdec", "vlm")
# the mamba leaves a rank takes its heads' (or channels') part of
_MAMBA_HEADS = {"A_log", "D", "dt_bias"}
_MAMBA_CHANNELS = {"conv_w", "conv_b"}


def _axis_size(axis, axis_sizes: Optional[Dict[str, int]]) -> int:
    if axis_sizes is None:
        return 1
    size = 1
    for a in axis if isinstance(axis, tuple) else (axis,):
        size *= int(axis_sizes.get(a, 1))
    return size


def _divides(dim: int, axis, axis_sizes: Optional[Dict[str, int]]) -> bool:
    """True when sharding ``dim`` over ``axis`` is legal (with no
    ``axis_sizes`` the mesh is unknown: the logical axis is emitted)."""
    if axis_sizes is None:
        return True
    size = _axis_size(axis, axis_sizes)
    return size >= 1 and dim % size == 0


def _is_stacked(segs: List[str]) -> bool:
    """Stacked-layer leaves carry the layer dim first."""
    return segs[0] in ("blocks", "enc_blocks") and not (
        len(segs) > 1 and segs[1].isdigit())


def _leaf_spec(path: str, leaf, axis_sizes: Optional[Dict[str, int]]) -> List:
    segs = path.split("/")
    name = segs[-1]
    parent = segs[-2] if len(segs) > 1 else ""
    ndim = len(leaf.shape)
    spec: List = [None] * ndim

    # norms / biases / vectors: replicated
    if ndim < 2 or name.startswith("ln") or name in (
        "final_norm", "enc_norm", "router", "conv_w", "conv_b", "dt_bias",
        "enc_pos",
    ):
        return spec

    if parent == "moe" and name in _EXPERT_TP and ndim >= 3:
        e_dim = ndim - 3
        if _divides(leaf.shape[e_dim], "model", axis_sizes):
            spec[e_dim] = "model"
        return spec

    if name == "embed":
        if _divides(leaf.shape[0], "model", axis_sizes):
            spec[0] = "model"
        return spec

    if name in _COL_TP:
        if _divides(leaf.shape[-1], "model", axis_sizes):
            spec[-1] = "model"
        return spec

    if name in _ROW_TP:
        if _divides(leaf.shape[-2], "model", axis_sizes):
            spec[-2] = "model"
        return spec

    return spec


def param_specs(params: PyTree, fsdp: bool = False,
                axis_sizes: Optional[Dict[str, int]] = None) -> PyTree:
    """Spec tree matching ``params`` (one entry per dim of each leaf).
    ``fsdp=True`` additionally spreads large weights over the "data" axis
    wherever a free dim divides (the reference's FSDP rule; no step of the
    port shards over the data axis)."""

    def f(path, leaf):
        spec = _leaf_spec(path, leaf, axis_sizes)
        if fsdp and axis_sizes and math.prod(leaf.shape) >= FSDP_MIN_SIZE:
            if "data" not in spec:
                start = 1 if _is_stacked(path.split("/")) else 0
                for i in range(start, len(spec)):
                    if spec[i] is None and _divides(leaf.shape[i], "data", axis_sizes):
                        spec[i] = "data"
                        break
        return tuple(spec)

    return _map_tree(params, f)


def model_axis_size(mesh=None) -> int:
    """The size of ``mesh``'s "model" axis; without a mesh, the "model"
    size of the enabled activation sharding (the reference's
    ``model_axis_size()``), 1 when it is off."""
    if mesh is None:
        return int(_ACT_AXES.get("model_size", 1)) if _ACT_AXES else 1
    return int(mesh.shape.get("model", 1))


def _tp(mesh) -> int:
    """The model-axis size a rank's shard is cut for (1 without a mesh)."""
    return 1 if mesh is None else model_axis_size(mesh)


def attention_splits(cfg, tp: int) -> bool:
    """q/k/v/o split over ``tp`` ranks only on whole heads and whole GQA
    groups: both head counts must divide."""
    return cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0


def mamba_splits(cfg, tp: int) -> bool:
    """A mamba layer splits over ``tp`` ranks on whole SSM heads, its B
    and C on whole groups (or whole on every rank where there is one
    group); else it stays replicated."""
    g = cfg.ssm_n_groups
    return (cfg.family in ("ssm", "hybrid") and cfg.ssm_n_heads % tp == 0
            and (g == 1 or g % tp == 0))


def mamba_columns(cfg, tp: int, rank: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s index sets into a whole mamba layer (``cfg`` the
    whole config): ``"w_in"``, its columns of the fused in-projection
    ``[z (di) | x (di) | B (g·n) | C (g·n) | dt (h)]``; ``"conv"``, its
    channels of ``[x (di) | B (g·n) | C (g·n)]``; ``"heads"``, its heads.
    Each in the rank-local layout the block splits (z, x, B, C, dt)."""
    di, h, n, g = cfg.ssm_d_inner, cfg.ssm_n_heads, cfg.ssm_state, cfg.ssm_n_groups
    hl = h // tp
    dil = hl * cfg.ssm_head_dim
    gl = g // tp if g % tp == 0 else g
    g0 = rank * gl if g % tp == 0 else 0
    r = lambda start, size: torch.arange(start, start + size)
    x_ch = r(rank * dil, dil)
    b_ch, c_ch = r(g0 * n, gl * n), r(g * n + g0 * n, gl * n)
    heads = r(rank * hl, hl)
    return {"w_in": torch.cat([x_ch, di + x_ch, 2 * di + b_ch, 2 * di + c_ch,
                               2 * di + 2 * g * n + heads]),
            "conv": torch.cat([x_ch, di + b_ch, di + c_ch]),
            "heads": heads}


def local_config(cfg, mesh):
    """``cfg`` at one rank's widths: its heads (and kv heads) where
    attention splits, its SSM heads (a ``configs.base.RankConfig``
    with ``ssm_tp``, and its groups where they split) where mamba splits,
    else ``cfg`` itself. The vocabulary, d_model, the experts and MLA's
    latent stay whole (the residual stream, the logits, the routing and
    the latent cache are whole on every rank)."""
    tp = _tp(mesh)
    if tp == 1:
        return cfg
    if attention_splits(cfg, tp) and cfg.family != "ssm":
        cfg = cfg.replace(n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
                          head_dim=cfg.resolved_head_dim)
    if mamba_splits(cfg, tp):
        from repro_torch.configs.base import ArchConfig, RankConfig

        g = cfg.ssm_n_groups
        fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ArchConfig)}
        cfg = RankConfig(**dict(fields, ssm_n_groups=g // tp if g % tp == 0 else g),
                         ssm_tp=tp)
    return cfg


def _cache_leaf_specs(node, batch: int, heads: bool, mamba: bool) -> List[Spec]:
    from repro_torch.models import attention as A
    from repro_torch.models.ssm import SSMCache

    def spec(leaf, split_dim=None):
        out: List = [None] * leaf.dim()
        if leaf.dim() >= 2 and leaf.shape[1] == batch:
            out[1] = "data"
        if split_dim is not None:
            out[split_dim] = "model"
        return tuple(out)

    if isinstance(node, SSMCache):
        return [spec(node.conv, 3 if mamba else None),
                spec(node.state, 2 if mamba else None)]
    if isinstance(node, (A.KVCache, A.QuantKVCache)):
        return [spec(leaf, 3 if heads and leaf.dim() == 5 else None) for leaf in node]
    if isinstance(node, (A.MLACache, A.QuantMLACache)):
        return [spec(leaf) for leaf in node]
    return [s for part in node for s in _cache_leaf_specs(part, batch, heads, mamba)]


def cache_specs(caches, mesh, batch: int, cfg) -> List[Spec]:
    """Specs of the decode caches of a TP batcher, one per leaf in
    ``transformer.cache_leaves`` order (the port's rule), for the whole
    config ``cfg``'s caches (``init_caches(cfg, ...)``); a rank makes
    only its shard (``init_caches(local_config(cfg, mesh), ...)``).
    Batch goes over "data" (size 1 here). Over "model": a KV leaf (L, B,
    S, H_kv, Dh) splits its kv heads (dim 3) where attention splits
    (scale leaves (L, B, S) of a quantized cache stay whole over heads);
    an SSM conv window (L, B, W-1, C) its channels (dim 3: the rank's x
    channels, with the B and C channels of its groups, all of them for
    one group) and an SSM state (L, B, H, P, N) its heads (dim 2) where
    mamba splits; an MLA latent cache stays whole on every rank (every
    head reads the latent)."""
    tp = _tp(mesh)
    return _cache_leaf_specs(caches, batch, tp > 1 and attention_splits(cfg, tp),
                             tp > 1 and mamba_splits(cfg, tp))


def packed_specs(packed: Dict[str, Any],
                 axis_sizes: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """Specs for a ``quant.prepare`` packed dict: every plane shards its
    output-channel dim N over "model" (planes are packed 2-bit along K,
    so a K split would tear bytes apart) where N divides; scales stay
    whole. Entries are ``{"pos": spec, "neg": spec, "scale": spec}``."""

    def leaf_spec(t):
        spec: List = [None] * t.dim()
        if t.dim() >= 2 and _divides(t.shape[-1], "model", axis_sizes):
            spec[-1] = "model"
        return tuple(spec)

    return {path: {"pos": leaf_spec(p.pos), "neg": leaf_spec(p.neg),
                   "scale": tuple([None] * p.scale.dim())}
            for path, p in packed.items()}


def replica_device_groups(replicas: int, tp: int,
                          devices: Optional[List[torch.device]] = None
                          ) -> List[List[torch.device]]:
    """Partition ``devices`` (default: every visible CUDA device) into
    ``replicas`` disjoint groups of ``tp``: the rows of a ``(replicas,
    tp)`` grid, replication on the grid's "data" rows, each replica's TP
    on its "model" columns. Groups are disjoint, so replicas never
    contend for a device."""
    if replicas < 1 or tp < 1:
        raise ValueError(f"need replicas >= 1 and tp >= 1, got "
                         f"replicas={replicas} tp={tp}")
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    need = replicas * tp
    if len(devices) < need:
        raise ValueError(f"{replicas} replicas x tp={tp} needs {need} devices "
                         f"but only {len(devices)} are visible")
    return [list(devices[r * tp:(r + 1) * tp]) for r in range(replicas)]


# ---------------------------------------------------------------------------
# A rank's shards
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WeightShard:
    """One rank's part of a split dense weight, stacked (L, ..) or one
    layer's. ``kind`` "col": ``w`` holds this rank's output columns (a
    contiguous slice, or a mamba ``w_in``'s index set); "row": its
    contraction rows (``k`` is the whole K). In a quantized mode ``w``
    holds the whole weight's ternary codes (in the weight's dtype) and
    ``scale`` its per-output-channel scale, for this rank's columns
    (row-parallel: every column), and a row shard's K is padded to
    ``block * size`` and split in whole blocks. In mode "off" ``w`` is
    the float weight's slice (a row shard's K split evenly) and
    ``scale`` is None."""

    w: torch.Tensor
    scale: Optional[torch.Tensor]
    kind: str
    k: int
    mesh: Any

    def __getitem__(self, i) -> "WeightShard":
        """Layer ``i``'s shard of a stacked one (``layer_params``)."""
        return dataclasses.replace(
            self, w=self.w[i], scale=None if self.scale is None else self.scale[i])


@dataclasses.dataclass(frozen=True)
class ExpertShard:
    """One rank's whole experts of a MoE expert stack (``w_gate``,
    ``w_up`` or ``w_down``, (L, E_local, K, N) or one layer's): experts
    ``[first, first + E_local)`` as float weights; ``moe._tern3``
    ternarizes each expert from its own whole weight, as on one device.
    ``train``: a training view (:func:`train_views`), whose collectives
    are ``dist.collectives``' autograd functions."""

    w: torch.Tensor
    first: int
    mesh: Any
    train: bool = False

    def __getitem__(self, i) -> "ExpertShard":
        return dataclasses.replace(self, w=self.w[i])


@dataclasses.dataclass(frozen=True)
class VocabShard:
    """One rank's rows of the embedding (``vocab_dim`` 0, (V, D)) or
    columns of the unembedding (``vocab_dim`` 1, (D, V)): token ids
    ``[offset, offset + n)``. ``train``: a training view
    (:func:`train_views`): the lookup's sum is ``collectives.reduce``,
    and the logits' input enters through ``collectives.copy`` and their
    gather is ``collectives.gather``, so the table (tied: both uses) and
    the activations take their gradients."""

    table: torch.Tensor
    offset: int
    vocab_dim: int
    mesh: Any
    train: bool = False

    def lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """Embedding rows of ``tokens``: the rank's rows, zero elsewhere
        (exact zeros, not a product), summed over the ranks: each element
        has one nonzero contributor, so the sum is exact."""
        n = self.table.shape[0]
        local = tokens - self.offset
        inside = (local >= 0) & (local < n)
        rows = self.table[local.clamp(0, n - 1)]
        rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
        if self.train:
            return collectives.reduce(rows, self.mesh.group)
        return collectives.all_reduce(rows, self.mesh.group)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The plain unembedding of ``x`` (B, S, D): the rank's vocabulary
        columns accumulated in float64 and rounded to x's dtype, as the
        single-device ``_logits``, then gathered over the vocabulary in
        that dtype (a copy), so a greedy argmax breaks ties on the same
        index."""
        table = self.table.T if self.vocab_dim == 0 else self.table
        if self.train:
            x = collectives.copy(x, self.mesh.group)
        local = (x.to(torch.float64) @ table.to(torch.float64)).to(x.dtype)
        if self.train:
            return collectives.gather(local, self.mesh.group, dim=-1)
        return collectives.all_gather(local, self.mesh.group, dim=-1)


def _codes(w: torch.Tensor, qc, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole weight's (codes, scale), layer by layer for a stack: the
    single-device step's ``_weight_codes`` call on the same layer view,
    on ``device`` (one layer moved there at a time; default: w's own)."""
    from repro_torch.models.layers import _weight_codes

    if w.dim() == 2:
        return _weight_codes(w.to(device), qc)
    parts = [_weight_codes(w[i].to(device), qc) for i in range(w.shape[0])]
    return (torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]))


def shard_params(params: PyTree, cfg, mesh, device=None) -> PyTree:
    """This rank's parameters from the whole ones (seeded, or bridged
    from the JAX package), by the rules of the module docstring: split
    dense leaves become :class:`WeightShard`s (attention only on whole
    heads, :func:`attention_splits`; mamba on whole SSM heads by index
    sets, :func:`mamba_splits`), the expert stacks :class:`ExpertShard`s,
    MLA's ``w_uk``/``w_uv`` and mamba's conv and head vectors plain
    slices, the embedding and unembedding :class:`VocabShard`s where the
    vocabulary divides; everything else (MLA's ``w_dkv``, norms, the
    router) stays as it is (replicated). ``cfg`` is the serving config:
    in a quantized mode its ``quant`` makes the codes, in mode "off" the
    shards are float slices. ``device`` (default: where the params are)
    is where the shards go: a whole tree on the host is cut there and
    only this rank's shard moves, each weight's codes computed on
    ``device`` from its whole layer (one layer moved at a time), as the
    step there computes them."""
    layout = train_layout(cfg, mesh)
    if layout is None:
        return params
    qc = cfg.quant
    to = (lambda t: t) if device is None else (lambda t: t.to(device))

    def place(leaf, sp):
        if sp is None:
            return to(leaf)
        first = int(sp.index[mesh.rank][0])
        if sp.view == "expert":
            return ExpertShard(to(sp.cut(leaf)), first, mesh)
        if sp.view == "vocab":
            return VocabShard(to(sp.cut(leaf)), first, sp.dim, mesh)
        if sp.view == "plain":
            return to(sp.cut(leaf))
        # a dense weight: the whole weight's codes and scale (mode "off": the
        # float weight), cut as a float shard is (row: in whole blocks)
        w, scale = (leaf, None) if qc.mode == "off" else _codes(leaf, qc, device)
        if scale is not None and sp.view == "col":
            scale = sp.cut(scale)
        return WeightShard(to(sp.cut(w)).contiguous(),
                           None if scale is None else scale.contiguous(), sp.view,
                           leaf.shape[-2], mesh)

    with torch.no_grad():
        return _zip_map(place, params, layout)


# ---------------------------------------------------------------------------
# Training shards: the model axis of a train step
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainShard:
    """One rank's training view of a split dense weight, stacked (L, ..)
    or one layer's: ``w`` is the rank's float slice, which takes the
    gradient (a :class:`WeightShard` holds codes fixed at placement and
    serves only). ``kind`` "col": ``w`` holds the rank's output columns
    (a contiguous slice, or a mamba ``w_in``'s index set); "row": its
    contraction rows, K (``k`` is the whole K) zero-padded to ``block *
    size`` and split in whole blocks (evenly in mode "off"), as
    :func:`~repro_torch.core.execution.row_split` cuts. ``layers.dense``
    takes the codes from it at every call (see there)."""

    w: torch.Tensor
    kind: str
    k: int
    mesh: Any

    def __getitem__(self, i) -> "TrainShard":
        return dataclasses.replace(self, w=self.w[i])


@dataclasses.dataclass(frozen=True, eq=False)
class LeafSplit:
    """How one leaf of a training state splits over the model axis, the
    same rule for the params, the Adam moments and the residual. The
    whole leaf (``shape``) is zero-padded along ``dim`` to ``padded``
    (row splits on whole blocks; else ``padded`` is the extent) and rank
    ``r`` holds its positions ``index[r]`` along it: a contiguous block,
    or a mamba layer's index set. ``shared``: the positions of the
    rank's shard that every rank holds (mamba's B and C of one group),
    or None. ``view`` is what the model reads (:meth:`view_of`)."""

    view: str            # "col" | "row" | "expert" | "vocab" | "plain"
    dim: int
    shape: Tuple[int, ...]
    padded: int
    index: Tuple[torch.Tensor, ...]
    shared: Optional[torch.Tensor]
    mesh: Any

    def cut(self, whole: torch.Tensor, rank: Optional[int] = None) -> torch.Tensor:
        """Rank ``rank``'s shard (default: this process's) of the whole
        leaf: an exact copy of its positions."""
        rank = self.mesh.rank if rank is None else rank
        pad = self.padded - whole.shape[self.dim]
        if pad:
            widths = [0, 0] * (whole.dim() - 1 - self.dim) + [0, pad]
            whole = torch.nn.functional.pad(whole, widths)
        return whole.index_select(self.dim, self.index[rank].to(whole.device))

    def join(self, parts) -> torch.Tensor:
        """The whole leaf from every rank's shard, in rank order (exact
        copies; a shared position is written by every rank alike)."""
        first = parts[0]
        shape = list(self.shape)
        shape[self.dim] = self.padded
        whole = torch.zeros(shape, dtype=first.dtype, device=first.device)
        for idx, part in zip(self.index, parts):
            whole.index_copy_(self.dim, idx.to(first.device), part)
        return whole.narrow(self.dim, 0, self.shape[self.dim])

    def squares(self, g: torch.Tensor) -> torch.Tensor:
        """This rank's part of the leaf's sum of squares over the whole
        (f32): its shard, a shared position counted on rank 0 alone."""
        out = torch.sum(torch.square(g.to(torch.float32)))
        if self.shared is not None and self.mesh.rank != 0:
            dup = g.index_select(self.dim, self.shared.to(g.device))
            out = out - torch.sum(torch.square(dup.to(torch.float32)))
        return out

    def view_of(self, w: torch.Tensor):
        """The model's view of the rank's shard ``w`` (a leaf that takes
        gradients): a :class:`TrainShard`, :class:`ExpertShard` or
        :class:`VocabShard` for a training step, else the tensor. Shared
        positions pass through ``collectives.copy``, so their gradient,
        a partial one on every rank, is summed over the model group."""
        want = list(self.shape)
        want[self.dim] = len(self.index[self.mesh.rank])
        if list(w.shape) != want:
            raise ValueError(f"a training shard of shape {tuple(w.shape)} where this "
                             f"rank's split wants {tuple(want)} (a whole state under "
                             f"a model axis? shard it: shard_state)")
        if self.shared is not None:
            idx = self.shared.to(w.device)
            part = collectives.copy(w.index_select(self.dim, idx), self.mesh.group)
            w = w.index_copy(self.dim, idx, part)
        first = int(self.index[self.mesh.rank][0])
        if self.view in ("col", "row"):
            return TrainShard(w, self.view, self.shape[-2], self.mesh)
        if self.view == "expert":
            return ExpertShard(w, first, self.mesh, train=True)
        if self.view == "vocab":
            return VocabShard(w, first, self.dim, self.mesh, train=True)
        return w


def _blocks(padded: int, tp: int) -> Tuple[torch.Tensor, ...]:
    """Every rank's contiguous block of ``padded`` positions."""
    n = padded // tp
    return tuple(torch.arange(r * n, (r + 1) * n) for r in range(tp))


def _leaf_split(path: str, leaf, cfg, mesh, attn: bool, cols) -> Optional[LeafSplit]:
    """The split of one whole leaf over the model axis (None:
    replicated): its view, dim, padding and every rank's positions."""
    tp = mesh.size
    segs = path.split("/")
    name = segs[-1]
    shape = tuple(leaf.shape)
    nd = len(shape)

    def split(view, dim, index, padded=None):
        dim = dim % nd
        padded = shape[dim] if padded is None else padded
        held = torch.cat(index)
        shared = None
        if held.numel() > padded:       # a position on more than one rank
            counts = torch.bincount(held, minlength=padded)
            mine = index[mesh.rank]
            found = torch.nonzero(counts[mine] == tp).reshape(-1)
            shared = found if found.numel() else None
        return LeafSplit(view, dim, shape, padded, tuple(index), shared, mesh)

    def blocks(view, dim):
        return split(view, dim, _blocks(shape[dim % nd], tp))

    def row():
        block = 1 if cfg.quant.mode == "off" else cfg.quant.block
        k = shape[-2]
        padded = -(-k // (block * tp)) * block * tp
        return split("row", -2, _blocks(padded, tp), padded)

    if "mamba" in segs:
        if cols is None:
            return None
        if name in _MAMBA_HEADS:
            return split("plain", -1, [c["heads"] for c in cols])
        if name in _MAMBA_CHANNELS:
            return split("plain", -1, [c["conv"] for c in cols])
        if name == "w_in":
            return split("col", -1, [c["w_in"] for c in cols])
        return row() if name == "w_out" else None
    spec = _leaf_spec(path, leaf, {"data": 1, "model": tp})
    if "model" not in spec or (name in _ATTN and not attn) or name == "w_dkv":
        return None
    if name == "embed":
        return blocks("vocab", 0)
    if name == "unembed":
        return blocks("vocab", -1)
    if name in ("w_uk", "w_uv"):
        return blocks("plain", -1) if attn else None
    if len(segs) > 1 and segs[-2] == "moe" and name in _EXPERT_TP:
        return blocks("expert", nd - 3)
    return blocks("col", -1) if spec[-1] == "model" else row()


def train_layout(cfg, mesh) -> Optional[PyTree]:
    """The training split of every leaf of ``cfg``'s params for this
    rank of ``mesh``'s model axis: a tree of :class:`LeafSplit` (None
    for a replicated leaf) in the params' structure, or None without a
    model axis. The one rule of the module docstring, which
    :func:`shard_params` places serving shards by too: q/k/v/o only on
    whole heads, mamba on whole SSM heads by index sets (B and C whole on
    every rank for one group: shared), the experts, the vocabulary;
    MLA's ``w_dkv``, the norms and the router replicated. Read from the
    params' shapes (``transformer.init_params`` on the meta device: a
    few ms a call)."""
    tp = _tp(mesh)
    if tp == 1:
        return None
    from repro_torch.models import transformer as T

    whole = T.init_params(cfg, device="meta")
    attn = attention_splits(cfg, tp)
    cols = [mamba_columns(cfg, tp, r) for r in range(tp)] if mamba_splits(cfg, tp) else None
    return _map_tree(whole, lambda path, leaf: _leaf_split(path, leaf, cfg, mesh, attn, cols))


def _zip_map(fn, tree, layout):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], layout[k]) for k in tree}
    return fn(tree, layout)


def train_views(params: PyTree, layout: Optional[PyTree]) -> PyTree:
    """The model's view of a rank's training params (its shards, leaves
    that take gradients) under ``layout`` (:func:`train_layout`):
    :class:`TrainShard`, :class:`ExpertShard` and :class:`VocabShard`
    where the leaf splits (``LeafSplit.view_of``), the tensor where it is
    replicated. ``params`` itself without a layout."""
    if layout is None:
        return params
    return _zip_map(lambda p, sp: p if sp is None else sp.view_of(p), params, layout)


def shard_tree(tree: PyTree, layout: Optional[PyTree]) -> PyTree:
    """This rank's shards of a whole tree in the params' structure
    (params, an Adam moment, a residual or gradients): exact copies."""
    if layout is None:
        return tree
    return _zip_map(lambda t, sp: t if sp is None else sp.cut(t).contiguous(),
                    tree, layout)


def gather_tree(tree: PyTree, layout: Optional[PyTree]) -> PyTree:
    """The whole tree from every rank's shards of it (every rank of the
    model group calls it: one all-gather a split leaf); replicated leaves
    as they are. Exact copies: ``gather_tree(shard_tree(t)) == t``."""
    if layout is None:
        return tree

    def whole(t, sp):
        if sp is None:
            return t
        parts = collectives.all_gather(t.contiguous()[None], sp.mesh.group, dim=0)
        return sp.join(parts.unbind(0))

    return _zip_map(whole, tree, layout)


def shard_state(state, cfg, mesh):
    """A rank's train state from the whole one (a ``train_step.
    TrainState``): its shards of the params, the Adam moments and the
    residual (:func:`shard_tree` under :func:`train_layout`); the step
    and the compression generator are replicated. The state itself
    without a model axis."""
    layout = train_layout(cfg, mesh)
    if layout is None:
        return state
    cut = lambda t: shard_tree(t, layout)
    return state._replace(
        params=cut(state.params),
        opt=state.opt._replace(mu=cut(state.opt.mu), nu=cut(state.opt.nu)),
        residual=None if state.residual is None else cut(state.residual))


def gather_state(state, cfg, mesh):
    """The whole train state from the model group's shards: the inverse
    of :func:`shard_state`, bit for bit (a collective of the model
    group)."""
    layout = train_layout(cfg, mesh)
    if layout is None:
        return state
    join = lambda t: gather_tree(t, layout)
    return state._replace(
        params=join(state.params),
        opt=state.opt._replace(mu=join(state.opt.mu), nu=join(state.opt.nu)),
        residual=None if state.residual is None else join(state.residual))


# ---------------------------------------------------------------------------
# Activation sharding and the data axis
# ---------------------------------------------------------------------------

# None = off. When on: {"multi_pod", "divisor", "model_size", "data"}, the
# reference's record; models/moe.py reads "divisor" for its routing groups
_ACT_AXES: Optional[Dict[str, Any]] = None
# the data group of the data-parallel step running in this process (None:
# none), process-wide so that remat's recompute in autograd's device
# thread reads it too
_DATA_GROUP: Any = None


def enable_activation_sharding(*, multi_pod: bool = False, batch_divisor: int = 1,
                               model_size: int = 1) -> None:
    """The reference's switch: a batch that divides ``batch_divisor``
    is treated as split over the data-like axes (MoE routes in that many
    groups), the model axis has ``model_size`` ranks."""
    global _ACT_AXES
    _ACT_AXES = {
        "multi_pod": bool(multi_pod),
        "divisor": int(batch_divisor),
        "model_size": int(model_size),
        "data": ("pod", "data") if multi_pod else ("data",),
    }


def disable_activation_sharding() -> None:
    global _ACT_AXES
    _ACT_AXES = None


def batch_axes() -> Tuple[str, ...]:
    """The data-like mesh axes batch dims shard over (() when off)."""
    return _ACT_AXES["data"] if _ACT_AXES else ()


def shard_act(x: torch.Tensor, name: str) -> torch.Tensor:
    """The reference's named activation constraint: the identity, as the
    reference's is with no mesh context, for any batch (a batch that
    does not divide the divisor is not an error there either). Every
    split of the port is explicit, so no constraint has a reader."""
    return x


def routing_groups(batch: int) -> int:
    """MoE's routing groups for a batch of ``batch`` rows, the
    reference's rule: the enabled divisor where it is above 1 and
    divides ``batch``, else 1; always 1 inside a data-parallel rank,
    whose rows are one group (a second split would route them in
    groups of groups)."""
    if _DATA_GROUP is not None or _ACT_AXES is None:
        return 1
    div = int(_ACT_AXES.get("divisor", 1))
    return div if div > 1 and batch % div == 0 else 1


def mesh_batch_divisor(mesh) -> int:
    """Product of the data-like axis sizes ("pod", "data") of ``mesh``:
    a batch splits over the data axis only where it divides this (else
    it is replicated: :func:`batch_shard`)."""
    d = 1
    for ax in ("pod", "data"):
        if ax in mesh.axis_names:
            d *= int(mesh.shape[ax])
    return d


def batch_is_split(batch: int, mesh) -> bool:
    """Whether a global batch of ``batch`` rows splits over ``mesh``'s
    data axis: the divisor is above 1 and divides it (else every rank
    runs the whole batch, replicated)."""
    div = 1 if mesh is None else mesh_batch_divisor(mesh)
    return div > 1 and batch % div == 0


def batch_shard(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's rows of the global ``batch`` (a dict of arrays or
    tensors, batch dim first): a contiguous block of ``B / D`` rows,
    block ``data_rank``, where the batch divides ``D =
    mesh_batch_divisor(mesh)``; else the whole batch (replicated). The
    reference's ``dryrun.batch_shardings`` rule. Views, not copies."""
    rows = {len(v) for v in batch.values()}
    if len(rows) != 1:
        raise ValueError(f"a batch's entries disagree on the batch dim: {sorted(rows)}")
    b = rows.pop()
    if not batch_is_split(b, mesh):
        return dict(batch)
    n = b // mesh_batch_divisor(mesh)
    r = mesh.data_rank
    return {k: v[r * n:(r + 1) * n] for k, v in batch.items()}


def data_group():
    """The data group of the data-parallel step running in this process,
    or None: where ``layers.dense``, its only reader, sums its per-tensor
    activation statistics."""
    return _DATA_GROUP


@contextlib.contextmanager
def data_parallel(mesh) -> Iterator[None]:
    """Run the body as one data-parallel rank of ``mesh`` on its rows of
    a split batch: per-tensor activation statistics are summed over the
    data group and MoE routes the rank's rows as one group. Restores
    the previous state after."""
    global _DATA_GROUP
    prev = _DATA_GROUP
    _DATA_GROUP = mesh.data_group
    try:
        yield
    finally:
        _DATA_GROUP = prev
