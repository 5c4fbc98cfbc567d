"""pixtral-12b — Pixtral-ViT + Mistral-NeMo decoder [hf:mistralai/Pixtral-12B-2409].

Backbone only per the assignment: 40L, d_model 5120, 32 q heads / 8 kv
heads, d_ff 14336, vocab 131072, head_dim 128.  The vision tower is a
stub — ``input_specs()`` provides precomputed patch embeddings (already
projected to d_model) prepended to the token stream.
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    unit=(LayerSpec("attn", "mlp"),),
    n_units=40,
    frontend="vision",
    frontend_len=1024,            # 1024 patch embeddings (stub)
)


def reduced() -> ModelConfig:
    return CONFIG.scaled(
        n_units=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, frontend_len=8, remat=False,
    )
