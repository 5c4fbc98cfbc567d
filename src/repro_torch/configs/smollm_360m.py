"""smollm-360m — llama-arch small model [hf:HuggingFaceTB/SmolLM].

32L, d_model 960, 15 q heads / 5 kv heads (GQA), d_ff 2560, vocab 49152.
The odd head counts (15/5) deliberately exercise the divisibility-fallback
sharding policy on the 16-wide model axis.
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49_152,
    unit=(LayerSpec("attn", "mlp"),),
    n_units=32,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.scaled(
        n_units=2, d_model=60, n_heads=3, n_kv_heads=1, head_dim=20,
        d_ff=96, vocab_size=128, remat=False,
    )
