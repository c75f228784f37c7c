"""GQA attention with a bf16 KV cache (port of the GQA part of
``repro/models/attention.py``).

Weight projections route through ``layers.dense`` so the ternary/CiM
modes apply; the score/value contractions are activation-activation
products and stay plain PyTorch. They accumulate in float64 (the JAX
package: float32): products of bf16 values are exact there, so a row's
scores, softmax and output do not depend on the reduction order — not
on its batchmates, nor on where left-padding put its tokens in the
cache. That keeps fused serving token-identical to ``generate()`` on
the GPU, whose reduction order changes with shapes.

The port writes caches in place: a stacked cache is one tensor per k/v
that every layer and step updates at its own token slots (the JAX
package returns new arrays instead).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
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
    its own offset (ragged decode)."""
    new = new.to(buf.dtype)
    s = new.shape[1]
    if not torch.is_tensor(index) or index.dim() == 0:
        i = int(index)
        buf[:, i:i + s] = new
        return buf
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    cols = index.to(torch.int64)[:, None] + torch.arange(s, device=buf.device)[None, :]
    buf[rows, cols] = new
    return buf


def init_gqa(generator: torch.Generator, cfg: ArchConfig, dtype, device,
             layers: int):
    d, h, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    shapes = {"wq": (d, h * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (h * hd, d)}
    return {name: L.init_dense_weight(generator, (layers,) + shape, dtype, device)
            for name, shape in shapes.items()}


def _sdpa(q, k, v, causal_offset, length=None, start=None):
    """q: (B, Sq, H, Dh); k, v: (B, Sk, Hkv, Dh). GQA via head grouping.

    causal_offset: position of q[0] relative to k[0] (None = no mask);
      scalar, or (B,) for ragged decode.
    length: (B,) valid KV length (mask at and beyond).
    start: (B,) first valid KV slot (mask below) — the left-padding dead
      zone of a batched prefill.
    """
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    acc = torch.float64
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(acc), k.to(acc))
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
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(acc), v.to(acc))
    return out.to(v.dtype).reshape(b, sq, h, dh)


def gqa_attention(params, x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor, cache: Optional[KVCache] = None,
                  cache_index=None, start: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """x: (B, S, D). With a cache (one layer's (B, S_max, Hkv, Dh) k/v):
    the new KV is written at ``cache_index`` (scalar or (B,)) in place and
    attention runs against the whole cache; ``start`` marks each row's
    first valid slot. Returns (out, cache)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    qc = cfg.quant
    q = L.dense(x, params["wq"], qc).reshape(b, s, h, hd)
    k = L.dense(x, params["wk"], qc).reshape(b, s, hkv, hd)
    v = L.dense(x, params["wv"], qc).reshape(b, s, hkv, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if cache is None:
        out = _sdpa(q, k, v, causal_offset=0)
    else:
        write_cache_rows(cache.k, k, cache_index)
        write_cache_rows(cache.v, v, cache_index)
        length = _index_vector(cache_index, b, x.device) + s
        out = _sdpa(q, cache.k, cache.v, causal_offset=cache_index,
                    length=length, start=start)
    out = out.reshape(b, s, h * hd)
    return L.dense(out, params["wo"], qc), cache
