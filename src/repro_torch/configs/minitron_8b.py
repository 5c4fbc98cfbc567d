"""minitron-8b — pruned Nemotron dense GQA transformer [arXiv:2407.14679].

32L, d_model 4096, 32 q heads / 8 kv heads (GQA), d_ff 16384, vocab 256000.
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256_000,
    unit=(LayerSpec("attn", "mlp"),),
    n_units=32,
)


def reduced() -> ModelConfig:
    return CONFIG.scaled(
        n_units=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, remat=False,
    )
