"""Architecture configuration schema (port of ``repro/configs/base.py``).

The port keeps its own copy of the fields the ported model families
(dense, ssm, hybrid) read; families not ported yet keep only their name
in ``family``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.layers import QuantConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | ssm | hybrid (the families ported)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None        # defaults to d_model // n_heads
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # --- hybrid (zamba2): shared attention block every k mamba layers ---
    hybrid_attn_every: int = 6
    quant: QuantConfig = QuantConfig(mode="off")
    quantize_unembed: bool = False
    # 0 = full attention (materialized scores); > 0 = online-softmax
    # attention over KV chunks of this size in ``forward`` (cache-free)
    attn_chunk: int = 0
    dtype: str = "bfloat16"
    # the reference's training flag, kept so the configs read as its own;
    # the port does not train
    remat: bool = True
    # long-context marker of the reference: archs with sub-quadratic decode
    subquadratic: bool = False

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Parameter count of the ported families, as the reference counts
        it: projections and embeddings only (no norms, conv or SSM
        vectors); hybrid adds its one shared attention block and MLP."""
        d, f, v, hd = self.d_model, self.d_ff, self.vocab, self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.family == "dense":
            return int(emb + self.n_layers * (attn + 3 * d * f))
        di = self.ssm_d_inner
        mamba = (d * (2 * di + 2 * self.ssm_n_groups * self.ssm_state
                      + self.ssm_n_heads) + di * d)
        shared = attn + 3 * d * f if self.family == "hybrid" else 0
        return int(emb + self.n_layers * mamba + shared)
