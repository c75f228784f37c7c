"""Whisper-large-v3 [arXiv:2212.04356] — enc-dec transformer backbone.

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, 1500, 1280)."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import QuantConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,           # decoder layers
    n_encoder_layers=32,
    encoder_seq=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    head_dim=64,
    quant=QuantConfig(mode="cim"),
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, n_encoder_layers=2, encoder_seq=32, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=256, remat=False,
)
