"""StarCoder2-15B [arXiv:2402.19173] — GQA + RoPE dense code LM."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import QuantConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    rope_theta=1e6,
    quant=QuantConfig(mode="cim"),
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab=256, remat=False,
)
