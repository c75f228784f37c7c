"""DeepSeek-V2-236B [arXiv:2405.04434] — MLA (kv_lora=512) + 160-expert
top-6 MoE with 2 shared experts."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import QuantConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,     # MLA: per-head keys from the shared latent
    d_ff=1536,
    vocab=102400,
    mla=True,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    expert_d_ff=1536,
    quant=QuantConfig(mode="cim"),
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16,
    n_experts=8, n_shared_experts=1, top_k=2, expert_d_ff=64, d_ff=64,
    vocab=256, remat=False,
)
