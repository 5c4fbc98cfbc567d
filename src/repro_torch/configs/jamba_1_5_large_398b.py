"""jamba-1.5-large-398b — hybrid Mamba/attention + MoE [arXiv:2403.19887].

72L, d_model 8192, 64 q heads / 8 kv heads, expert d_ff 24576, vocab
65536.  Structure: 9 blocks of 8 layers; layer 0 of each block is
attention, layers 1-7 are Mamba; every other layer's FFN is a 16-expert
top-2 MoE (odd indices), the rest are dense MLPs.

Adaptation note, as in the reference: Jamba's Mamba-1 (selective-scan)
layers are realized as Mamba-2/SSD blocks — the state-space-duality
reformulation by the same authors that maps the recurrence onto matrix
products; the recurrence semantics are equivalent up to the
per-channel→per-head parameter tying.

398B total / ~94B active parameters (verified by
``count_params_analytic``), bf16 params + factored optimizer state.
"""
from .base import LayerSpec, ModelConfig, MoEConfig, SSMConfig

_UNIT = tuple(
    LayerSpec(
        mixer="attn" if i == 0 else "mamba",
        ffn="moe" if i % 2 == 1 else "mlp",
    )
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=65_536,
    unit=_UNIT,
    n_units=9,
    moe=MoEConfig(
        n_routed=16, n_shared=0, top_k=2, d_expert=24_576, impl="alltoall"
    ),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=128,
                  n_groups=1, chunk=256),
    param_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    return CONFIG.scaled(
        n_units=1, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, remat=False, param_dtype="float32",
        moe=MoEConfig(n_routed=4, n_shared=0, top_k=2, d_expert=64,
                      impl="dense"),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk=8),
    )
