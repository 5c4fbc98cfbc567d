"""musicgen-large — decoder-only LM over EnCodec tokens [arXiv:2306.05284].

48L, d_model 2048, 32 heads MHA (kv=32), d_ff 8192, vocab 2048 (EnCodec
codebook).  Backbone only per the assignment: the EnCodec/conditioning
frontend is a stub — ``input_specs()`` provides precomputed frame
embeddings prepended to the token stream.  MusicGen uses sinusoidal
positions (no RoPE).
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    unit=(LayerSpec("attn", "mlp"),),
    n_units=48,
    frontend="audio",
    frontend_len=256,             # conditioning frames (stub embeddings)
    pos_embed="sinusoidal",
)


def reduced() -> ModelConfig:
    return CONFIG.scaled(
        n_units=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=128, frontend_len=4, remat=False,
    )
