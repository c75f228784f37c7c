"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small dense LM."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import QuantConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
    head_dim=64,
    tie_embeddings=True,
    quant=QuantConfig(mode="cim"),
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, remat=False,
)
