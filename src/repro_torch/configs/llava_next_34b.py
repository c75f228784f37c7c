"""LLaVA-NeXT-34B [hf:llava-hf/llava-v1.6] — Yi-34B backbone VLM.

The vision tower and anyres tiling are a stub, as in the reference: the
model takes precomputed patch embeddings (B, n_img, d_vision), and the
projector maps them into the LM stream."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import QuantConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    head_dim=128,
    rope_theta=5e6,
    n_image_tokens=2880,   # anyres: base 576 + 4 tiles x 576
    d_vision=1024,
    quant=QuantConfig(mode="cim"),
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=176, vocab=256, n_image_tokens=8, d_vision=32, remat=False,
)
