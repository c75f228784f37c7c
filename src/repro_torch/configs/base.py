"""Architecture configuration schema (port of ``repro/configs/base.py``).

The port keeps its own copy of the reference's fields, for every family
of its registry: dense, ssm, hybrid, moe, encdec (whisper) and vlm
(llava). ``norm`` is kept as the reference keeps it: no block reads it
(every block uses ``rms_norm``, whisper's included).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.layers import QuantConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | ssm | hybrid | moe | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None        # defaults to d_model // n_heads
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"                 # rmsnorm | layernorm (read by no block)
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0                  # per-expert FFN width (moe)
    moe_capacity_factor: float = 1.25
    # --- MLA (deepseek-v2) ---
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # --- hybrid (zamba2): shared attention block every k mamba layers ---
    hybrid_attn_every: int = 6
    # --- encdec (whisper) ---
    n_encoder_layers: int = 0
    encoder_seq: int = 1500               # precomputed frame embeddings
    # --- vlm (llava-next) ---
    n_image_tokens: int = 0
    d_vision: int = 1024                  # patch-embedding width (stub)
    quant: QuantConfig = QuantConfig(mode="off")
    quantize_unembed: bool = False
    # 0 = full attention (materialized scores); > 0 = online-softmax
    # attention over KV chunks of this size in ``forward`` (cache-free)
    attn_chunk: int = 0
    dtype: str = "bfloat16"
    # activation checkpointing of each layer in training (``forward`` with
    # grad on); serving never reads it
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

    def _attn_params(self) -> int:
        d, h, hd = self.d_model, self.n_heads, self.resolved_head_dim
        if not self.mla:
            return d * hd * (h + 2 * self.n_kv_heads) + h * hd * d
        r, dn, dr, dv = (self.kv_lora_rank, self.qk_nope_head_dim,
                         self.qk_rope_head_dim, self.v_head_dim)
        kv = d * (r + dr) + r * h * (dn + dv) + h * dv * d
        if self.q_lora_rank:
            return (d * self.q_lora_rank + kv
                    + self.q_lora_rank * h * (dn + dr))
        return d * h * (dn + dr) + kv

    def param_count(self) -> int:
        """Parameter count, as the reference counts it: projections and
        embeddings only (no norms, conv or SSM vectors, nor whisper's
        ``enc_pos``); hybrid adds its one shared attention block and MLP,
        moe counts every expert, the shared experts and the router,
        encdec its encoder blocks and every decoder layer's cross
        attention, vlm its projector."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = self._attn_params()
        if self.family in ("dense", "moe", "encdec", "vlm"):
            if self.n_experts:
                ffn = (3 * d * self.expert_d_ff
                       * (self.n_experts + self.n_shared_experts)
                       + d * self.n_experts)
            else:
                ffn = 3 * d * f
            total = emb + self.n_layers * (attn + ffn)
            if self.family == "encdec":
                total += self.n_encoder_layers * (4 * d * d + 3 * d * f)
                total += self.n_layers * 4 * d * d       # cross attention
            if self.family == "vlm":
                total += self.d_vision * d               # projector
            return int(total)
        di = self.ssm_d_inner
        mamba = (d * (2 * di + 2 * self.ssm_n_groups * self.ssm_state
                      + self.ssm_n_heads) + di * d)
        shared = attn + 3 * d * f if self.family == "hybrid" else 0
        return int(emb + self.n_layers * mamba + shared)

    def active_param_count(self) -> int:
        """Parameters a token uses: a moe model counts only its top-k
        routed experts (and the shared ones); other families all."""
        full = self.param_count()
        if not self.n_experts:
            return full
        per_expert = 3 * self.d_model * self.expert_d_ff * self.n_layers
        return int(full - per_expert * (self.n_experts - self.top_k))


@dataclasses.dataclass(frozen=True)
class RankConfig(ArchConfig):
    """One tensor-parallel rank's view of a config
    (``dist.sharding.local_config``): every field of the whole config at
    the rank's widths, plus the explicit ``ssm_tp``, the number of ranks
    that share each mamba layer. It divides ``ssm_d_inner`` and so
    ``ssm_n_heads``, which a registry config derives from ``d_model``
    (whole on every rank): the rank's mamba blocks and SSM caches take
    their widths from it."""

    ssm_tp: int = 1

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model // self.ssm_tp
