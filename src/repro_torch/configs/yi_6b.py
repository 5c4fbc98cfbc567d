"""yi-6b — llama-arch GQA transformer [arXiv:2403.04652].

32L, d_model 4096, 32 q heads / 4 kv heads (GQA), d_ff 11008, vocab 64000.
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64_000,
    unit=(LayerSpec("attn", "mlp"),),
    n_units=32,
)


def reduced() -> ModelConfig:
    return CONFIG.scaled(
        n_units=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=112, vocab_size=256, remat=False,
    )
