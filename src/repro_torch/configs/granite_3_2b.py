"""granite-3-2b — IBM Granite 3.0 2B dense GQA [hf:ibm-granite/granite-3.0-2b-base].

40L, d_model 2048, 32 q heads / 8 kv heads, d_ff 8192, vocab 49155.
The vocab (49155 = 3·5·29·113) is indivisible by any power of two — it
exercises the embed-axis fallback (vocab replicates, d_model shards).
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49_155,
    unit=(LayerSpec("attn", "mlp"),),
    n_units=40,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.scaled(
        n_units=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=131, remat=False,
    )
