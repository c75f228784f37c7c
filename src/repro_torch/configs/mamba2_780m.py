"""Mamba2-780M [arXiv:2405.21060] — attention-free SSD state-space LM."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import QuantConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,           # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_n_groups=1,
    ssm_chunk=256,
    subquadratic=True,
    quant=QuantConfig(mode="cim"),
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, vocab=256, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=8, remat=False,
)
