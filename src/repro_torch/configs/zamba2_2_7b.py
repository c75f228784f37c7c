"""Zamba2-2.7B [arXiv:2411.15242] — Mamba2 backbone + shared attention."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import QuantConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    head_dim=80,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_n_groups=1,
    ssm_chunk=256,
    hybrid_attn_every=6,
    subquadratic=True,
    quant=QuantConfig(mode="cim"),
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
    hybrid_attn_every=2, remat=False,
)
