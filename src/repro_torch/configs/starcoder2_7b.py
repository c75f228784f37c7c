"""StarCoder2-7B [arXiv:2402.19173] — GQA + RoPE dense code LM."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import QuantConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    head_dim=128,
    rope_theta=1e6,
    quant=QuantConfig(mode="cim"),
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=72, n_heads=6, n_kv_heads=2, head_dim=12,
    d_ff=160, vocab=256, remat=False,
)
