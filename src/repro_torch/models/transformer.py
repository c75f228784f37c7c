"""Model assembly for the dense decoder family (port of
``repro/models/transformer.py``).

Entry points:
  * init_params(cfg, seed=, device=)   — params, stacked-layer layout
  * forward(params, tokens, cfg)       — teacher-forced logits
  * init_caches(cfg, batch, s_max)     — stacked decode caches, bf16 or
                                         quantized (cfg.quant.cache_dtype)
  * decode_step(params, tokens, caches, index, cfg, start=) — cached step

Params are nested dicts with the JAX package's stacked layout (e.g.
``blocks/attn/wq`` of shape (L, K, N)); a Python loop over layers takes
the place of ``lax.scan``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, dtype_of, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L

UNEMBED_OFF = L.QuantConfig(mode="off")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"the {cfg.family} family is not ported yet")


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: DeviceLike = None) -> Dict:
    """Seeded random params on ``device`` (default ``cuda``; raises
    without CUDA unless ``device="cpu"``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    g = torch.Generator(device=dev).manual_seed(seed)
    n, d = cfg.n_layers, cfg.d_model
    embed = torch.randn((cfg.vocab, d), generator=g, device=dev) * 0.02
    params = {
        "embed": embed.to(dtype),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
        "blocks": {
            "ln1": torch.ones((n, d), dtype=dtype, device=dev),
            "ln2": torch.ones((n, d), dtype=dtype, device=dev),
            "attn": attn.init_gqa(g, cfg, dtype, dev, n),
            "mlp": {
                name: L.init_dense_weight(g, (n,) + shape, dtype, dev)
                for name, shape in (("w_gate", (d, cfg.d_ff)),
                                    ("w_up", (d, cfg.d_ff)),
                                    ("w_down", (cfg.d_ff, d)))
            },
        },
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_dense_weight(g, (d, cfg.vocab), dtype, dev)
    return params


def layer_params(blocks: Dict, i: int) -> Dict:
    """Layer ``i``'s params (views) from the stacked ``blocks`` dict."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def apply_block(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, cache,
                cache_index, start: Optional[torch.Tensor] = None):
    """One decoder layer; returns (x, cache)."""
    h = L.rms_norm(x, p["ln1"])
    a, cache = attn.gqa_attention(p["attn"], h, cfg, positions, cache,
                                  cache_index, start)
    x = x + a
    h = L.rms_norm(x, p["ln2"])
    return x + L.mlp(p["mlp"], h, cfg.quant), cache


def _logits(params, x: torch.Tensor, cfg: ArchConfig,
            qc: L.QuantConfig) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"])
    table = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    if qc.mode != "off":
        return L.dense(x, table, qc)
    # the plain unembedding accumulates in float64, rounded once to the
    # activation dtype: a row's logits (and so greedy tokens) do not depend
    # on the batch it rides in (see attention.py)
    return (x.to(torch.float64) @ table.to(torch.float64)).to(x.dtype)


def forward(params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Teacher-forced logits (B, S, V) for tokens (B, S)."""
    _check_family(cfg)
    x = L.embed(tokens, params["embed"]).to(dtype_of(cfg.dtype))
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for i in range(cfg.n_layers):
        x, _ = apply_block(layer_params(params["blocks"], i), x, cfg,
                           positions, None, None)
    return _logits(params, x, cfg, cfg.quant if cfg.quantize_unembed else UNEMBED_OFF)


def init_caches(cfg: ArchConfig, batch: int, s_max: int,
                dtype=torch.bfloat16, device: DeviceLike = None):
    """Stacked KV caches for the layer stack, every leaf (L, B, S_max,
    ...), in the layout of ``cfg.quant.cache_dtype``: "bf16" gives a
    :class:`~repro_torch.models.attention.KVCache` of ``dtype`` k/v
    (L, B, S_max, H_kv, Dh); "int8" and "ternary" give a
    :class:`~repro_torch.models.attention.QuantKVCache` of codes (int8,
    or uint8 with Dh halved) and (L, B, S_max) f32 scales, made as zero
    codes (ternary: bytes 0x11) with scales 1.0. Decode writes them in
    place; an offset past the cache is clamped to its last slots."""
    _check_family(cfg)
    dev = resolve_device(device)
    cd = cfg.quant.cache_dtype
    if cd == "bf16":
        return attn.KVCache.zeros(batch, s_max, cfg.n_kv_heads,
                                  cfg.resolved_head_dim, dtype=dtype,
                                  device=dev, layers=cfg.n_layers)
    return attn.QuantKVCache.zeros(batch, s_max, cfg.n_kv_heads,
                                   cfg.resolved_head_dim, cd, device=dev,
                                   layers=cfg.n_layers)


def decode_step(params, tokens: torch.Tensor, caches, index,
                cfg: ArchConfig, start: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, tuple]:
    """One cached step. tokens: (B, S_step); ``index`` is the cache write
    offset — a Python int (every row at the same position) or a (B,)
    tensor (ragged decode). ``start`` (B,) marks each row's left-padding
    dead zone; RoPE positions are logical, ``index - start``. The caches
    are updated in place and returned with the logits (B, S_step, V)."""
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
    for i in range(cfg.n_layers):
        layer_cache = type(caches)(*(leaf[i] for leaf in caches))
        x, _ = apply_block(layer_params(params["blocks"], i), x, cfg,
                           positions, layer_cache, index, start)
    # the decode unembedding is always the plain matmul, as in the reference
    return _logits(params, x, cfg, UNEMBED_OFF), caches
