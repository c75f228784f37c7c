"""GQA, MLA and cross attention, with bf16 or quantized caches (port of
``repro/models/attention.py``).

Weight projections route through ``layers.dense`` so the ternary/CiM
modes apply; the score/value contractions are activation-activation
products and stay plain PyTorch. They accumulate in float64 (the JAX
package: float32): products of bf16 values are exact there, so a row's
scores, softmax and output do not depend on the reduction order — not
on its batchmates, nor on where left-padding put its tokens in the
cache. That keeps fused serving token-identical to ``generate()`` on
the GPU, whose reduction order changes with shapes.

The port writes caches in place: a stacked cache is one tensor per leaf
that every layer and step updates at its own token slots (the JAX
package returns new arrays instead). A write whose offset would run past
the cache is clamped to its last slots, as ``dynamic_update_slice``
clamps it in the reference: a slot freed at capacity rides the batched
step as a dead lane and rewrites the last slot of its own row.

MLA (deepseek-v2) caches the compressed latent ``ckv`` and the
decoupled rope key instead of k/v (:class:`MLACache`) and attends in the
absorbed-weight form: ``W_uk`` folds into the query and ``W_uv`` is
applied after the values are attended in latent space.

Quantized caches (:class:`QuantKVCache`, :class:`QuantMLACache`, the
reference's DESIGN.md §13) store int8 codes, or ternary codes
nibble-packed two per byte, with one f32 scale per (row, position). Dequantization stays in the attention
contractions: the codes enter the score and value einsums and the
scales multiply the (B, ..., Sk) score and probability matrices; no
dequantized copy of the cache is made.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import ternary as tern
from repro_torch.dist import collectives
from repro_torch.dist.sharding import TrainShard
from repro_torch.models import layers as L

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, H_kv, Dh), or stacked (L, B, S_max, H_kv, Dh)
    v: torch.Tensor

    @staticmethod
    def zeros(batch: int, s_max: int, n_kv: int, head_dim: int,
              dtype=torch.bfloat16, device=None, layers: Optional[int] = None):
        lead = () if layers is None else (layers,)
        shape = lead + (batch, s_max, n_kv, head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Quantized KV caches
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor, cache_dtype: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``x`` (B, S, ...) per (row, position) over every trailing
    axis. Returns ``(codes, scale)`` with scale (B, S) f32:

      * ``"int8"``:    ``round(x/scale)`` (half to even) in [-127, 127],
                       ``scale = amax/127`` (1.0 where the slice is all
                       zero: dead pad rows stay exactly zero);
      * ``"ternary"``: TWN codes in {-1,0,1} (``core.ternary.ternarize``)
                       nibble-packed two per byte along the last axis
                       (uint8, last dim halved).
    """
    red = tuple(range(2, x.ndim))
    xf = x.to(torch.float32)
    if cache_dtype == "int8":
        amax = xf.abs().amax(dim=red)
        scale = torch.where(amax > 0, amax / 127.0, 1.0)
        q = torch.round(xf / scale[(...,) + (None,) * len(red)])
        return torch.clamp(q, -127, 127).to(torch.int8), scale
    if cache_dtype == "ternary":
        t, scale = tern.ternarize(xf, axis=red)
        return pack_ternary_kv(t.to(torch.int8)), scale.reshape(x.shape[:2])
    raise ValueError(f"quantize_kv: unknown cache_dtype {cache_dtype!r}")


def pack_ternary_kv(t: torch.Tensor) -> torch.Tensor:
    """Pack ternary codes {-1,0,1} (int8) two per byte along the last
    axis, high nibble first: stored nibbles are ``t+1`` in {0,1,2}.
    Needs an even last dim (checked when the cache is made)."""
    c = (t + 1).to(torch.uint8)
    return (c[..., 0::2] << 4) | c[..., 1::2]


def unpack_ternary_kv(p: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`pack_ternary_kv`: uint8 (..., D/2) -> codes
    (..., D) in {-1,0,1} as ``dtype``."""
    hi = ((p >> 4) & 0xF).to(torch.int8) - 1
    lo = (p & 0xF).to(torch.int8) - 1
    codes = torch.stack([hi, lo], dim=-1).reshape(p.shape[:-1] + (2 * p.shape[-1],))
    return codes.to(dtype)


def _kv_codes(buf: torch.Tensor, dtype) -> torch.Tensor:
    """Stored cache codes -> codes in ``dtype`` (int8: a cast; uint8: the
    nibble unpack)."""
    if buf.dtype == torch.uint8:
        return unpack_ternary_kv(buf, dtype)
    return buf.to(dtype)


def _quant_zeros(shape: Tuple[int, ...], cache_dtype: str,
                 device=None) -> torch.Tensor:
    if cache_dtype == "ternary":
        if shape[-1] % 2:
            raise ValueError(
                f"ternary cache_dtype packs 2 codes/byte along the last "
                f"axis; got odd trailing dim {shape[-1]} (shape {shape})")
        # all-zero codes pack to nibble value 1 on both halves
        return torch.full(shape[:-1] + (shape[-1] // 2,), 0x11,
                          dtype=torch.uint8, device=device)
    if cache_dtype == "int8":
        return torch.zeros(shape, dtype=torch.int8, device=device)
    raise ValueError(f"unknown quantized cache_dtype {cache_dtype!r}")


class QuantKVCache(NamedTuple):
    """Quantized GQA cache: codes + per-(row, position) f32 scales.

    ``k``/``v`` are int8 (B, S_max, H_kv, Dh) or ternary-packed uint8
    (B, S_max, H_kv, Dh/2), the storage mode carried by the leaf dtype;
    ``k_scale``/``v_scale`` are (B, S_max) f32. Stacked for the layer
    stack, every leaf gains a leading (L,) axis."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor

    @staticmethod
    def zeros(batch: int, s_max: int, n_kv: int, head_dim: int,
              cache_dtype: str = "int8", device=None,
              layers: Optional[int] = None):
        lead = () if layers is None else (layers,)
        shape = lead + (batch, s_max, n_kv, head_dim)
        # four leaves of their own storage: the port writes them in place
        return QuantKVCache(
            _quant_zeros(shape, cache_dtype, device),
            _quant_zeros(shape, cache_dtype, device),
            torch.ones(lead + (batch, s_max), dtype=torch.float32, device=device),
            torch.ones(lead + (batch, s_max), dtype=torch.float32, device=device))


class MLACache(NamedTuple):
    """Compressed MLA cache: latent ``ckv`` (B, S_max, kv_lora) and rope
    key ``k_rope`` (B, S_max, Dr); stacked, every leaf gains (L,)."""
    ckv: torch.Tensor
    k_rope: torch.Tensor

    @staticmethod
    def zeros(batch: int, s_max: int, kv_lora: int, rope_dim: int,
              dtype=torch.bfloat16, device=None, layers: Optional[int] = None):
        lead = () if layers is None else (layers,)
        return MLACache(
            torch.zeros(lead + (batch, s_max, kv_lora), dtype=dtype, device=device),
            torch.zeros(lead + (batch, s_max, rope_dim), dtype=dtype, device=device))


class QuantMLACache(NamedTuple):
    """Quantized MLA cache: latent and rope-key codes (int8, or ternary
    nibble-packed uint8 with the last dim halved) with (B, S_max) f32
    scales, the storage mode carried by the leaf dtype, as
    :class:`QuantKVCache`."""
    ckv: torch.Tensor
    k_rope: torch.Tensor
    ckv_scale: torch.Tensor
    krope_scale: torch.Tensor

    @staticmethod
    def zeros(batch: int, s_max: int, kv_lora: int, rope_dim: int,
              cache_dtype: str = "int8", device=None,
              layers: Optional[int] = None):
        lead = () if layers is None else (layers,)
        scale = lambda: torch.ones(lead + (batch, s_max), dtype=torch.float32,
                                   device=device)
        return QuantMLACache(
            _quant_zeros(lead + (batch, s_max, kv_lora), cache_dtype, device),
            _quant_zeros(lead + (batch, s_max, rope_dim), cache_dtype, device),
            scale(), scale())


# ---------------------------------------------------------------------------
# Cache writes
# ---------------------------------------------------------------------------


def _index_vector(index, b: int, device) -> torch.Tensor:
    """Normalize a scalar-or-(B,) cache index to a (B,) int64 vector (a
    Python int fills on the device: no host-to-device copy)."""
    if torch.is_tensor(index):
        return index.to(torch.int64).expand(b)
    return torch.full((b,), int(index), dtype=torch.int64, device=device)


def write_cache_rows(buf: torch.Tensor, new: torch.Tensor, index) -> torch.Tensor:
    """Write ``new`` (B, s, ...) into ``buf`` (B, S_max, ...) at sequence
    offset ``index`` in place, and return ``buf``. A scalar ``index``
    writes every row at the same offset; a (B,) vector writes each row at
    its own offset (ragged decode). Each offset is clamped to
    [0, S_max - s], as ``dynamic_update_slice`` clamps it in the
    reference (a tensor clamp: no host branch in a captured step)."""
    new = new.to(buf.dtype)
    s = new.shape[1]
    last = buf.shape[1] - s
    if not torch.is_tensor(index) or index.dim() == 0:
        i = min(max(int(index), 0), last)
        buf[:, i:i + s] = new
        return buf
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    cols = (index.to(torch.int64).clamp(0, last)[:, None]
            + torch.arange(s, device=buf.device)[None, :])
    buf[rows, cols] = new
    return buf


def init_gqa(generator: torch.Generator, cfg: ArchConfig, dtype, device,
             layers: Optional[int] = None):
    """q/k/v/o weights, stacked (layers, K, N) for a layer stack or (K, N)
    for one block (``layers=None``: zamba2's shared block)."""
    d, h, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    lead = () if layers is None else (layers,)
    shapes = {"wq": (d, h * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (h * hd, d)}
    return {name: L.init_dense_weight(generator, lead + shape, dtype, device)
            for name, shape in shapes.items()}


def _sdpa(q, k, v, causal_offset, length=None, start=None,
          k_scale=None, v_scale=None):
    """q: (B, Sq, H, Dh); k, v: (B, Sk, Hkv, Dh). GQA via head grouping.

    causal_offset: position of q[0] relative to k[0] (None = no mask);
      scalar, or (B,) for ragged decode.
    length: (B,) valid KV length (mask at and beyond).
    start: (B,) first valid KV slot (mask below) — the left-padding dead
      zone of a batched prefill.
    k_scale/v_scale: (B, Sk) f32 scales of a quantized cache, whose k/v
      then hold int8 or ternary-packed uint8 codes. The codes enter the
      contractions; k_scale multiplies the scores and v_scale the
      probabilities (each is constant along Dh, so it factors out of the
      contraction), and the probabilities round to q's dtype after it,
      as in the reference.
    """
    quant = k_scale is not None
    acc = torch.float64
    if quant:
        k, v = _kv_codes(k, acc), _kv_codes(v, acc)
    out_dtype = q.dtype if quant else v.dtype
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(acc), k.to(acc))
    if quant:
        scores = scores * k_scale.to(acc)[:, None, None, None, :]
    scores = scores / math.sqrt(dh)
    dev = q.device
    kpos = torch.arange(sk, device=dev)
    if causal_offset is not None:
        if torch.is_tensor(causal_offset):                      # (B,) or scalar
            off = causal_offset.to(torch.int64).reshape(-1)
        else:
            off = torch.full((1,), int(causal_offset), dtype=torch.int64, device=dev)
        qpos = off[:, None, None] + torch.arange(sq, device=dev)[None, :, None]
        mask = kpos[None, None, :] <= qpos                      # (1|B, sq, sk)
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
    if length is not None:
        valid = kpos[None, :] < length[:, None]
        scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    if start is not None:
        live = kpos[None, :] >= start[:, None]
        scores = torch.where(live[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if quant:
        probs = probs * v_scale.to(acc)[:, None, None, None, :]
    probs = probs.to(out_dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(acc), v.to(acc))
    return out.to(out_dtype).reshape(b, sq, h, dh)


def _sdpa_chunked(q, k, v, chunk: int, k_scale=None, v_scale=None):
    """Causal attention from position 0 as an online softmax over KV
    chunks of ``chunk`` slots (the reference's flash-style scan; used by
    ``forward`` under ``cfg.attn_chunk``): no (B, H, Sq, Sk) score matrix
    is made. Accumulates in float64, as :func:`_sdpa`. Optional
    k_scale/v_scale (B, Sk): quantized-cache codes in k/v, with
    :func:`_sdpa`'s scale contract applied per chunk."""
    quant = k_scale is not None
    acc = torch.float64
    if quant:
        k, v = _kv_codes(k, q.dtype), _kv_codes(v, q.dtype)
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if sk % chunk:
        raise ValueError(f"KV length {sk} is not a multiple of chunk {chunk}")
    g = h // hkv
    dev = q.device
    qg = q.reshape(b, sq, hkv, g, dh).to(acc)
    qpos = torch.arange(sq, device=dev)
    m = torch.full((b, hkv, g, sq), -math.inf, dtype=acc, device=dev)
    denom = torch.zeros((b, hkv, g, sq), dtype=acc, device=dev)
    out = torch.zeros((b, hkv, g, sq, dh), dtype=acc, device=dev)
    for c0 in range(0, sk, chunk):
        cols = slice(c0, c0 + chunk)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k[:, cols].to(acc))
        if quant:
            s = s * k_scale[:, cols].to(acc)[:, None, None, None, :]
        s = s / math.sqrt(dh)
        kpos = c0 + torch.arange(chunk, device=dev)
        s = torch.where((kpos[None, :] <= qpos[:, None])[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        denom = denom * alpha + p.sum(dim=-1)
        if quant:
            p = p * v_scale[:, cols].to(acc)[:, None, None, None, :]
        out = out * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(v.dtype).to(acc), v[:, cols].to(acc))
        m = m_new
    out = out / torch.clamp(denom, min=1e-30)[..., None]
    return out.movedim(-2, 1).reshape(b, sq, h, dh).to(q.dtype)


def gqa_attention(params, x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor, cache=None,
                  cache_index=None, start: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[tuple]]:
    """x: (B, S, D). With a cache (one layer's :class:`KVCache` or
    :class:`QuantKVCache`): the new KV is written at ``cache_index``
    (scalar or (B,)) in place — quantized on write for a
    :class:`QuantKVCache` — and attention runs against the whole cache;
    ``start`` marks each row's first valid slot. Without a cache,
    attention is causal over x, chunked under ``cfg.attn_chunk`` when it
    divides S. Returns (out, cache). On a rank of a TP mesh ``cfg`` gives
    the rank's heads (``dist.sharding.local_config``) and the weights
    are its shards: q/k/v column-parallel, o row-parallel, attention
    head-local over the kv heads (and cache) the rank owns. In a train
    step (``dist.sharding.TrainShard`` weights) ``x`` enters q/k/v
    through ``collectives.copy`` once (``layers.tp_input``), and remat's
    recompute runs the same collectives again."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    qc = cfg.quant
    x = L.tp_input(x, params["wq"])
    q = L.dense(x, params["wq"], qc, tp="col").reshape(b, s, h, hd)
    k = L.dense(x, params["wk"], qc, tp="col").reshape(b, s, hkv, hd)
    v = L.dense(x, params["wv"], qc, tp="col").reshape(b, s, hkv, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if cache is None:
        if cfg.attn_chunk and s % cfg.attn_chunk == 0 and s > cfg.attn_chunk:
            out = _sdpa_chunked(q, k, v, cfg.attn_chunk)
        else:
            out = _sdpa(q, k, v, causal_offset=0)
    else:
        length = _index_vector(cache_index, b, x.device) + s
        if isinstance(cache, QuantKVCache):
            cd = "ternary" if cache.k.dtype == torch.uint8 else "int8"
            for buf, scale_buf, new in ((cache.k, cache.k_scale, k),
                                        (cache.v, cache.v_scale, v)):
                codes, scale = quantize_kv(new, cd)
                write_cache_rows(buf, codes, cache_index)
                write_cache_rows(scale_buf, scale, cache_index)
            out = _sdpa(q, cache.k, cache.v, causal_offset=cache_index,
                        length=length, start=start, k_scale=cache.k_scale,
                        v_scale=cache.v_scale)
        else:
            write_cache_rows(cache.k, k, cache_index)
            write_cache_rows(cache.v, v, cache_index)
            out = _sdpa(q, cache.k, cache.v, causal_offset=cache_index,
                        length=length, start=start)
    out = out.reshape(b, s, h * hd)
    return L.dense(out, params["wo"], qc, tp="row"), cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v2): low-rank joint KV compression + decoupled rope key
# ---------------------------------------------------------------------------


def init_mla(generator: torch.Generator, cfg: ArchConfig, dtype, device,
             layers: int):
    """Stacked (layers, K, N) MLA weights: full-rank queries ``wq`` (no q
    LoRA, as the reference), the joint KV down-projection with the rope
    key ``w_dkv``, the up-projections ``w_uk``/``w_uv`` from the latent,
    ``wo``, and the latent's norm ``kv_norm``."""
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    shapes = {"wq": (d, h * (dn + dr)), "w_dkv": (d, r + dr), "w_uk": (r, h * dn),
              "w_uv": (r, h * dv), "wo": (h * dv, d)}
    p = {name: L.init_dense_weight(generator, (layers,) + shape, dtype, device)
         for name, shape in shapes.items()}
    p["kv_norm"] = torch.ones((layers, r), dtype=dtype, device=device)
    return p


def mla_attention(params, x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor, cache=None, cache_index=None,
                  start: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[tuple]]:
    """x: (B, S, D). With a cache (one layer's :class:`MLACache` or
    :class:`QuantMLACache`) the new latent and rope key are written at
    ``cache_index`` in place (quantized on write for a quantized cache)
    and attention runs against the whole cache, ``start`` masking each
    row's left pad; without one it is causal over x.

    The absorbed-weight form: q_lat = q_nope·W_uk, scores = q_lat·ckv +
    q_rope·k_rope (each term times its own cache scale before the sum),
    probabilities attend the latent, then W_uv. ``wq``, ``w_dkv`` and
    ``wo`` are dense layers (the ternary/CiM modes apply: kernel #1 on
    the card); ``w_uk`` and ``w_uv`` are plain contractions, as in the
    reference. The contractions accumulate in float64 and round to x's
    dtype where the reference rounds (``layers.accum_einsum``).

    On a rank of a TP mesh ``cfg`` gives the rank's heads
    (``dist.sharding.local_config``): ``wq`` is its column shard,
    ``w_uk``/``w_uv`` its heads' columns, ``wo`` row-parallel; ``w_dkv``,
    ``kv_norm`` and the latent cache are whole on every rank. In a train
    step ``x`` enters ``wq`` through ``collectives.copy`` (``w_dkv``
    reads it whole: its gradient is whole on every rank), and so do the
    normed latent and the rope key, where they meet the rank's heads."""
    b, s, _ = x.shape
    h, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    qc, dt = cfg.quant, x.dtype
    q = L.dense(L.tp_input(x, params["wq"]), params["wq"], qc,
                tp="col").reshape(b, s, h, dn + dr)
    q_nope = q[..., :dn]
    q_rope = L.apply_rope(q[..., dn:], positions, cfg.rope_theta)
    dkv = L.dense(x, params["w_dkv"], qc)
    ckv = L.rms_norm(dkv[..., :r], params["kv_norm"])
    k_rope = L.apply_rope(dkv[:, :, None, r:], positions, cfg.rope_theta)[:, :, 0]
    if isinstance(params["wq"], TrainShard):
        # the latent and the rope key, replicated (w_dkv and kv_norm are
        # whole on every rank), feed the rank's heads: one copy for both
        both = collectives.copy(torch.cat([ckv, k_rope], dim=-1), params["wq"].mesh.group)
        ckv, k_rope = both[..., :r], both[..., r:]

    ckv_scale = krope_scale = length = None
    if cache is None:
        ckv_all, krope_all, offset, start = ckv, k_rope, 0, None
    else:
        if isinstance(cache, QuantMLACache):
            cd = "ternary" if cache.ckv.dtype == torch.uint8 else "int8"
            for buf, scale_buf, new in ((cache.ckv, cache.ckv_scale, ckv),
                                        (cache.k_rope, cache.krope_scale, k_rope)):
                codes, scale = quantize_kv(new, cd)
                write_cache_rows(buf, codes, cache_index)
                write_cache_rows(scale_buf, scale, cache_index)
            ckv_scale, krope_scale = cache.ckv_scale, cache.krope_scale
        else:
            write_cache_rows(cache.ckv, ckv, cache_index)
            write_cache_rows(cache.k_rope, k_rope, cache_index)
        ckv_all, krope_all, offset = cache.ckv, cache.k_rope, cache_index
        length = _index_vector(cache_index, b, x.device) + s
    sk = ckv_all.shape[1]
    ckv_c, krope_c = _kv_codes(ckv_all, dt), _kv_codes(krope_all, dt)

    w_uk = params["w_uk"].reshape(r, h, dn).to(dt)
    q_lat = L.accum_einsum("bqhd,rhd->bqhr", q_nope, w_uk).to(dt)
    nope = L.accum_einsum("bqhr,bkr->bhqk", q_lat, ckv_c)
    rope = L.accum_einsum("bqhd,bkd->bhqk", q_rope, krope_c)
    if ckv_scale is not None:
        # the two terms carry independent scales: applied before the sum
        nope = nope * ckv_scale.to(torch.float64)[:, None, None, :]
        rope = rope * krope_scale.to(torch.float64)[:, None, None, :]
    scores = (nope + rope) / math.sqrt(dn + dr)
    dev = x.device
    if torch.is_tensor(offset):
        off = offset.to(torch.int64).reshape(-1)
    else:
        off = torch.full((1,), int(offset), dtype=torch.int64, device=dev)
    qpos = off[:, None] + torch.arange(s, device=dev)[None, :]      # (1|B, s)
    kpos = torch.arange(sk, device=dev)
    scores = torch.where((kpos[None, None, :] <= qpos[:, :, None])[:, None],
                         scores, NEG_INF)
    if length is not None:
        valid = kpos[None, :] < length[:, None]
        scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    if start is not None:
        live = kpos[None, :] >= start[:, None]
        scores = torch.where(live[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if ckv_scale is not None:
        probs = probs * ckv_scale.to(torch.float64)[:, None, None, :]
    lat = L.accum_einsum("bhqk,bkr->bqhr", probs.to(dt), ckv_c).to(dt)
    w_uv = params["w_uv"].reshape(r, h, dv).to(dt)
    out = L.accum_einsum("bqhr,rhd->bqhd", lat, w_uv).to(dt)
    return L.dense(out.reshape(b, s, h * dv), params["wo"], qc, tp="row"), cache


# ---------------------------------------------------------------------------
# Cross attention (whisper's decoder; its encoder's self-attention)
# ---------------------------------------------------------------------------


def init_cross(generator: torch.Generator, cfg: ArchConfig, dtype, device,
               layers: Optional[int] = None):
    """:func:`init_gqa`'s q/k/v/o weights with ``n_heads`` for k and v too
    (full multi-head attention), stacked (layers, K, N) for a stack."""
    return init_gqa(generator, cfg.replace(n_kv_heads=cfg.n_heads), dtype, device,
                    layers)


def cross_attention(params, x: torch.Tensor, enc: torch.Tensor,
                    cfg: ArchConfig) -> torch.Tensor:
    """Queries from x (B, S, D), keys and values from ``enc`` (B, S_enc,
    D), unmasked, no RoPE. K and V are projected from ``enc`` on every
    call, as in the reference: there is no cross-KV cache. Every
    projection is a dense layer (kernel #1 on the card under mode cim);
    the contractions are :func:`_sdpa`'s, in float64. On a rank of a TP
    mesh, as :func:`gqa_attention`: the rank's heads, q/k/v
    column-parallel, o row-parallel. In a train step (``dist.sharding.
    TrainShard`` weights) ``x`` enters ``wq`` through ``collectives.copy``
    (``layers.tp_input``); ``enc`` has entered already (``transformer.
    forward`` copies the encoder output once for every decoder layer's
    k/v), and where ``enc is x`` (the encoder's self-attention) the one
    copy of ``x`` feeds q, k and v."""
    b, s, _ = x.shape
    se = enc.shape[1]
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    qc = cfg.quant
    same = enc is x
    x = L.tp_input(x, params["wq"])
    if same:
        enc = x
    q = L.dense(x, params["wq"], qc, tp="col").reshape(b, s, h, hd)
    k = L.dense(enc, params["wk"], qc, tp="col").reshape(b, se, h, hd)
    v = L.dense(enc, params["wv"], qc, tp="col").reshape(b, se, h, hd)
    out = _sdpa(q, k, v, causal_offset=None)
    return L.dense(out.reshape(b, s, h * hd), params["wo"], qc, tp="row")
