"""mamba2-370m — pure SSD (state-space duality) model [arXiv:2405.21060].

48L, d_model 1024 (attention-free, d_ff 0 — no FFN; the Mamba2 block IS
the layer), ssm_state 128, vocab 50280.  d_inner = 2·d_model = 2048,
head_dim 64 → 32 SSD heads.
"""
from .base import LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    d_model=1024,
    n_heads=1,                    # attention-free; SSD heads from ssm cfg
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50_280,
    unit=(LayerSpec("mamba", "none"),),
    n_units=48,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk=256),
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.scaled(
        n_units=2, d_model=64, vocab_size=256, remat=False,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk=8),
    )
