"""Grok-1-314B [hf:xai-org/grok-1] — 8-expert top-2 MoE."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import QuantConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    head_dim=128,
    n_experts=8,
    n_shared_experts=0,
    top_k=2,
    expert_d_ff=32768,
    quant=QuantConfig(mode="cim"),
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    n_experts=4, top_k=2, expert_d_ff=96, d_ff=96, vocab=256, remat=False,
)
