"""Architecture configuration schema (port of ``repro/configs/base.py``).

The port keeps its own copy of the fields the ported model families
read; families not ported yet keep only their name in ``family``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.layers import QuantConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense (the family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None        # defaults to d_model // n_heads
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    quant: QuantConfig = QuantConfig(mode="off")
    quantize_unembed: bool = False
    # 0 = full attention (materialized scores); > 0 = online-softmax
    # attention over KV chunks of this size in ``forward`` (cache-free)
    attn_chunk: int = 0
    dtype: str = "bfloat16"
    # the reference's training flag, kept so the configs read as its own;
    # the port does not train
    remat: bool = True

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def param_count(self) -> int:
        """Parameter count of the dense family."""
        d, f, v, hd = self.d_model, self.d_ff, self.vocab, self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        return int(emb + self.n_layers * (attn + 3 * d * f))
