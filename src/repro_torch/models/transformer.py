"""Model assembly for the dense, SSM (mamba2), hybrid (zamba2), MoE
(deepseek-v2 with MLA, grok-1), enc-dec (whisper) and VLM (llava)
families (port of ``repro/models/transformer.py``).

Entry points:
  * init_params(cfg, seed=, device=)   — params, stacked-layer layout
  * forward(params, tokens, cfg, frames=, patches=) — teacher-forced
                                         logits (encdec runs the encoder
                                         over ``frames``; vlm puts the
                                         projected ``patches`` first)
  * run_encoder(params, frames, cfg)   — whisper's encoder output
  * init_caches(cfg, batch, s_max)     — stacked decode caches: KV or MLA
                                         (bf16 or quantized,
                                         cfg.quant.cache_dtype), SSM (f32),
                                         or hybrid's pair
  * decode_step(params, tokens, caches, index, cfg, start=, enc=) — cached
                                         step (encdec's cross attention
                                         reads ``enc`` where it is given)

Params are nested dicts with the JAX package's stacked layout (e.g.
``blocks/attn/wq`` of shape (L, K, N)); a Python loop over layers takes
the place of ``lax.scan``. A cache tree is a cache NamedTuple or the
hybrid pair of them; :func:`map_caches` and :func:`cache_leaves` walk
it.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, dtype_of, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import collectives
from repro_torch.dist.sharding import TrainShard, VocabShard, WeightShard
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models import ssm

UNEMBED_OFF = L.QuantConfig(mode="off")


FAMILIES = ("dense", "ssm", "hybrid", "moe", "encdec", "vlm")
# the families whose layers are decoder blocks (attention, then an MLP or
# a MoE block) over KV or MLA caches
DECODER_FAMILIES = ("dense", "moe", "encdec", "vlm")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} (one of {FAMILIES})")


# ---------------------------------------------------------------------------
# Cache trees
# ---------------------------------------------------------------------------


def map_caches(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a cache tree (a cache NamedTuple, or
    a plain tuple of them: hybrid's (SSM, KV) pair), keeping the
    structure: the port's ``jax.tree.map`` over caches."""
    if torch.is_tensor(tree):
        return fn(tree)
    parts = [map_caches(fn, part) for part in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


def cache_leaves(tree) -> Iterator[torch.Tensor]:
    """The leaves of a cache tree, in :func:`map_caches`' order."""
    if torch.is_tensor(tree):
        yield tree
    else:
        for part in tree:
            yield from cache_leaves(part)


# ---------------------------------------------------------------------------
# Params and blocks
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: DeviceLike = None) -> Dict:
    """Seeded random params on ``device`` (default ``cuda``; raises
    without CUDA unless ``device="cpu"``): ``blocks/{ln1, ln2, attn,
    mlp}`` for dense and vlm, ``blocks/{ln1, ln2, attn, moe}`` for moe
    (``attn`` MLA's weights where ``cfg.mla``), ``blocks/{ln1, mamba}``
    for ssm and hybrid, and hybrid's one ``shared_attn/{ln1, ln2, attn,
    mlp}``. encdec adds ``blocks/{ln_x, cross}``, the encoder's
    ``enc_blocks/{ln1, ln2, attn, mlp}`` stacked over
    ``n_encoder_layers``, ``enc_norm`` and ``enc_pos`` (encoder_seq, D);
    vlm the ``projector`` (d_vision, D). ``device="meta"`` makes the
    tree's shapes and dtypes alone (``dist.sharding.train_layout`` reads
    them)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    # the meta device gives the shapes and dtypes alone: no draws
    g = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    embed = torch.randn((cfg.vocab, d), generator=g, device=dev) * 0.02
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=dev)
    params = {"embed": embed.to(dtype), "final_norm": ones(d),
              "blocks": _init_blocks(g, cfg, dtype, dev, cfg.n_layers)}
    if cfg.family == "hybrid":
        params["shared_attn"] = {"ln1": ones(d), "ln2": ones(d),
                                 "attn": attn.init_gqa(g, cfg, dtype, dev),
                                 "mlp": L.init_mlp(g, d, cfg.d_ff, dtype, dev)}
    if cfg.family == "encdec":
        ne = cfg.n_encoder_layers
        params["enc_blocks"] = {"ln1": ones(ne, d), "ln2": ones(ne, d),
                                "attn": attn.init_cross(g, cfg, dtype, dev, ne),
                                "mlp": L.init_mlp(g, d, cfg.d_ff, dtype, dev, (ne,))}
        params["enc_norm"] = ones(d)
        enc_pos = torch.randn((cfg.encoder_seq, d), generator=g, device=dev) * 0.02
        params["enc_pos"] = enc_pos.to(dtype)
    if cfg.family == "vlm":
        params["projector"] = L.init_dense_weight(g, (cfg.d_vision, d), dtype, dev)
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_dense_weight(g, (d, cfg.vocab), dtype, dev)
    return params


def _init_blocks(g: Optional[torch.Generator], cfg: ArchConfig, dtype, dev,
                 n: int) -> Dict:
    """``n`` stacked layers by family: ``{ln1, ln2, attn, mlp | moe}``
    (encdec adds ``ln_x`` and ``cross``) or ``{ln1, mamba}``."""
    d = cfg.d_model
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=dev)
    if cfg.family not in DECODER_FAMILIES:
        return {"ln1": ones(n, d), "mamba": ssm.init_mamba2(g, cfg, dtype, dev, n)}
    blocks = {"ln1": ones(n, d), "ln2": ones(n, d),
              "attn": (attn.init_mla if cfg.mla else attn.init_gqa)(g, cfg, dtype, dev, n)}
    if cfg.n_experts:
        blocks["moe"] = moe.init_moe(g, cfg, dtype, dev, n)
    else:
        blocks["mlp"] = L.init_mlp(g, d, cfg.d_ff, dtype, dev, (n,))
    if cfg.family == "encdec":
        blocks["ln_x"] = ones(n, d)
        blocks["cross"] = attn.init_cross(g, cfg, dtype, dev, n)
    return blocks


def init_block(generator: torch.Generator, cfg: ArchConfig, dtype,
               device: DeviceLike = None) -> Dict:
    """One decoder (or mamba) layer's params by family, the reference's
    ``init_block``: layer 0 of a one-layer stack of :func:`init_params`'s
    blocks, drawn from ``generator``."""
    _check_family(cfg)
    one = _init_blocks(generator, cfg, dtype, resolve_device(device), 1)
    return layer_params(one, 0)


def layer_params(blocks: Dict, i: int) -> Dict:
    """Layer ``i``'s params (views) from the stacked ``blocks`` dict."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def apply_block(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, cache,
                cache_index, start: Optional[torch.Tensor] = None,
                enc: Optional[torch.Tensor] = None):
    """One decoder or mamba layer; returns (x, cache). A mamba layer
    given a cache and ``start`` treats the columns of negative position
    (the left pad) as inert. A decoder layer attends with MLA where
    ``cfg.mla``, else GQA; given ``enc`` and cross-attention weights
    (encdec) it then attends to ``enc``; last it runs the MoE block where
    it has one, else the MLP."""
    h = L.rms_norm(x, p["ln1"])
    if "mamba" in p:
        valid = positions >= 0 if cache is not None and start is not None else None
        out, cache = ssm.mamba2_block(p["mamba"], h, cfg, cache, valid=valid)
        return x + out, cache
    attend = attn.mla_attention if cfg.mla else attn.gqa_attention
    a, cache = attend(p["attn"], h, cfg, positions, cache, cache_index, start)
    x = x + a
    if enc is not None and "cross" in p:
        h = L.rms_norm(x, p["ln_x"])
        x = x + attn.cross_attention(p["cross"], h, enc, cfg)
    h = L.rms_norm(x, p["ln2"])
    if "moe" in p:
        return x + moe.moe_block(p["moe"], h, cfg), cache
    return x + L.mlp(p["mlp"], h, cfg.quant), cache


def _encoder_block_apply(p: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """One encoder layer: unmasked self-attention (cross attention of x
    to itself: in a train step its one input enters q, k and v through
    one copy), then the MLP."""
    h = L.rms_norm(x, p["ln1"])
    x = x + attn.cross_attention(p["attn"], h, h, cfg)
    h = L.rms_norm(x, p["ln2"])
    return x + L.mlp(p["mlp"], h, cfg.quant)


def run_encoder(params, frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """frames: (B, S_enc, D) precomputed frame embeddings (the reference
    stubs the conv frontend), plus ``enc_pos``; returns the normed
    encoder output (B, S_enc, D)."""
    x = frames + params["enc_pos"][None, :frames.shape[1], :].to(frames.dtype)
    for i in range(cfg.n_encoder_layers):
        x = _encoder_block_apply(layer_params(params["enc_blocks"], i), x, cfg)
    return L.rms_norm(x, params["enc_norm"])


def _enc_entry(params, enc: torch.Tensor) -> torch.Tensor:
    """The encoder output as it enters the decoder's cross attention:
    through one ``collectives.copy`` for every layer's k/v where they
    are a train step's column shards (``layers.tp_input``), else
    itself."""
    return L.tp_input(enc, params["blocks"]["cross"]["wk"])


def _run_stack(params, x, cfg, positions, caches, index, start, enc=None):
    """The layer stack (decoder blocks, given ``enc`` with encdec's cross
    attention, or mamba layers), or hybrid's segments: every
    ``hybrid_attn_every`` mamba layers, the weight-shared attention and
    MLP block, with its own KV cache per application. Caches (None in
    ``forward``) are written in place: hybrid's KV writes land in the
    application's view of the stack, so nothing is restacked. Under
    ``cfg.remat``, without caches and with grad on, each layer runs under
    activation checkpointing."""
    layer_cache = lambda stack, i: (None if stack is None
                                    else map_caches(lambda a: a[i], stack))
    block = apply_block
    if cfg.remat and caches is None and torch.is_grad_enabled():
        # the reference's jax.checkpoint of the scanned block: each layer
        # keeps only its input, and the backward recomputes it (MACs
        # included) through the same STE functions. The forward draws no
        # random numbers, so there is no RNG state to save (saving it
        # would read the generator inside a captured train step)
        block = functools.partial(checkpoint, apply_block, use_reentrant=False,
                                  preserve_rng_state=False)
    if cfg.family != "hybrid":
        for i in range(cfg.n_layers):
            x, _ = block(layer_params(params["blocks"], i), x, cfg, positions,
                         layer_cache(caches, i), index, start, enc)
        return x
    k = cfg.hybrid_attn_every
    sp = params["shared_attn"]
    ssm_caches, kv_caches = (None, None) if caches is None else caches
    for seg in range(cfg.n_layers // k):
        for i in range(seg * k, (seg + 1) * k):
            x, _ = block(layer_params(params["blocks"], i), x, cfg, positions,
                         layer_cache(ssm_caches, i), index, start)
        h = L.rms_norm(x, sp["ln1"])
        a, _ = attn.gqa_attention(sp["attn"], h, cfg, positions,
                                  layer_cache(kv_caches, seg), index, start)
        x = x + a
        h = L.rms_norm(x, sp["ln2"])
        x = x + L.mlp(sp["mlp"], h, cfg.quant)
    return x


def _logits(params, x: torch.Tensor, cfg: ArchConfig,
            qc: L.QuantConfig) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"])
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    if isinstance(table, VocabShard):
        if qc.mode == "off":
            return table.logits(x)
        if not table.train:
            raise NotImplementedError(
                "a quantized unembedding over a serving vocabulary shard is not "
                "ported (the decode step's unembedding is plain)")
        # a train step's quantized unembedding: a column-parallel dense over
        # the rank's vocabulary (per-column codes: the single device's
        # slice), gathered over the ranks
        w = table.table.T if table.vocab_dim == 0 else table.table
        shard = TrainShard(w, "col", w.shape[-2], table.mesh)
        local = L.dense(L.tp_input(x, shard), shard, qc, tp="col")
        return collectives.gather(local, table.mesh.group, dim=-1)
    table = table.T if cfg.tie_embeddings else table
    if qc.mode != "off":
        return L.dense(x, table, qc)
    # the plain unembedding accumulates in float64, rounded once to the
    # activation dtype: a row's logits (and so greedy tokens) do not depend
    # on the batch it rides in (see attention.py)
    return (x.to(torch.float64) @ table.to(torch.float64)).to(x.dtype)


def embed_inputs(params, tokens: torch.Tensor, cfg: ArchConfig,
                 patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings (B, S, D); for vlm the projected ``patches`` (B,
    n_img, d_vision), a dense layer, go in front: (B, n_img + S, D). On a
    rank of a TP mesh the projector is column-parallel and its output is
    gathered over the ranks (a copy); in a train step through
    ``collectives.gather``, whose backward is the rank's columns of the
    whole (replicated) gradient. The patches take no gradient, so they
    enter the projector without a copy."""
    x = L.embed(tokens, params["embed"])
    if cfg.family == "vlm":
        if patches is None:
            raise ValueError("the vlm family's forward needs patches")
        proj = params["projector"]
        img = L.dense(patches.to(x.dtype), proj, cfg.quant, tp="col")
        if isinstance(proj, TrainShard):
            img = collectives.gather(img, proj.mesh.group, dim=-1)
        elif isinstance(proj, WeightShard):
            img = collectives.all_gather(img, proj.mesh.group, dim=-1)
        x = torch.cat([img, x], dim=1)
    return x


def forward(params, tokens: torch.Tensor, cfg: ArchConfig, *,
            frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced logits (B, S_total, V) for tokens (B, S). encdec
    needs ``frames`` (B, S_enc, D) and runs the encoder first; vlm needs
    ``patches`` (B, n_img, d_vision), whose rows lead the sequence
    (S_total = n_img + S). In a train step over a model axis the encoder
    output, replicated, enters every decoder layer's rank-partial k/v
    through one ``collectives.copy`` (one sum of its gradient, not one a
    layer; remat's recompute reads the copy as the block's input)."""
    _check_family(cfg)
    x = embed_inputs(params, tokens, cfg, patches).to(dtype_of(cfg.dtype))
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    enc = None
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError("the encdec family's forward needs frames")
        enc = _enc_entry(params, run_encoder(params, frames.to(x.dtype), cfg))
    x = _run_stack(params, x, cfg, positions, None, None, None, enc)
    return _logits(params, x, cfg, cfg.quant if cfg.quantize_unembed else UNEMBED_OFF)


def _kv_caches(cfg: ArchConfig, batch: int, s_max: int, dtype, dev, layers: int):
    cd = cfg.quant.cache_dtype
    if cfg.mla:
        if cd == "bf16":
            return attn.MLACache.zeros(batch, s_max, cfg.kv_lora_rank,
                                       cfg.qk_rope_head_dim, dtype=dtype,
                                       device=dev, layers=layers)
        return attn.QuantMLACache.zeros(batch, s_max, cfg.kv_lora_rank,
                                        cfg.qk_rope_head_dim, cd, device=dev,
                                        layers=layers)
    if cd == "bf16":
        return attn.KVCache.zeros(batch, s_max, cfg.n_kv_heads,
                                  cfg.resolved_head_dim, dtype=dtype,
                                  device=dev, layers=layers)
    return attn.QuantKVCache.zeros(batch, s_max, cfg.n_kv_heads,
                                   cfg.resolved_head_dim, cd, device=dev,
                                   layers=layers)


def init_caches(cfg: ArchConfig, batch: int, s_max: int,
                dtype=torch.bfloat16, device: DeviceLike = None):
    """Stacked decode caches, every leaf (L, B, ...), slots on axis 1.

    dense, encdec and vlm: KV caches in the layout of
    ``cfg.quant.cache_dtype``: "bf16"
    gives a :class:`~repro_torch.models.attention.KVCache` of ``dtype``
    k/v (L, B, S_max, H_kv, Dh); "int8" and "ternary" give a
    :class:`~repro_torch.models.attention.QuantKVCache` of codes (int8,
    or uint8 with Dh halved) and (L, B, S_max) f32 scales, made as zero
    codes (ternary: bytes 0x11) with scales 1.0. An offset past the cache
    is clamped to its last slots.
    moe: the same KV caches (grok-1), or under ``cfg.mla`` (deepseek-v2)
    an :class:`~repro_torch.models.attention.MLACache` of the latent
    (L, B, S_max, kv_lora) and the rope key (L, B, S_max, Dr), or its
    :class:`~repro_torch.models.attention.QuantMLACache` with (L, B,
    S_max) scales, by ``cache_dtype`` as above.
    ssm: a :class:`~repro_torch.models.ssm.SSMCache` (conv window and
    state), f32 under any ``cache_dtype`` (small, rewritten every step,
    and recurrent: quantization error would compound).
    hybrid: the pair (SSMCache over the mamba layers, KV caches over the
    ``n_layers // hybrid_attn_every`` applications of the shared block).
    Decode writes them in place."""
    _check_family(cfg)
    dev = resolve_device(device)
    if cfg.family in DECODER_FAMILIES:
        return _kv_caches(cfg, batch, s_max, dtype, dev, cfg.n_layers)
    ssm_caches = ssm.SSMCache.zeros(batch, cfg, device=dev, layers=cfg.n_layers)
    if cfg.family == "ssm":
        return ssm_caches
    return (ssm_caches, _kv_caches(cfg, batch, s_max, dtype, dev,
                                   cfg.n_layers // cfg.hybrid_attn_every))


def decode_step(params, tokens: torch.Tensor, caches, index,
                cfg: ArchConfig, start: Optional[torch.Tensor] = None,
                enc: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, tuple]:
    """One cached step. tokens: (B, S_step); ``index`` is the cache write
    offset — a Python int (every row at the same position) or a (B,)
    tensor (ragged decode). ``start`` (B,) marks each row's left-padding
    dead zone; RoPE positions are logical, ``index - start``, and mamba
    layers hold the pad columns inert. ``enc`` (B, S_enc, D), encdec's
    encoder output, is attended by every layer's cross attention, its K
    and V projected anew on every step (without it the decoder runs
    without cross attention). vlm decodes tokens only. The caches are
    updated in place and returned with the logits (B, S_step, V)."""
    _check_family(cfg)
    x = L.embed(tokens, params["embed"]).to(dtype_of(cfg.dtype))
    b, s = x.shape[:2]
    dev = x.device
    if torch.is_tensor(index):
        base = index.to(torch.int64)
    else:
        base = torch.full((b,), int(index), dtype=torch.int64, device=dev)
    if start is not None:
        base = base - start.to(torch.int64)
    positions = base.expand(b)[:, None] + torch.arange(s, device=dev)[None, :]
    x = _run_stack(params, x, cfg, positions, caches, index, start, enc)
    # the decode unembedding is always the plain matmul, as in the reference
    return _logits(params, x, cfg, UNEMBED_OFF), caches
