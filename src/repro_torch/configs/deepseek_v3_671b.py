"""deepseek-v3-671b — MLA + 256-expert MoE + MTP [arXiv:2412.19437].

61L, d_model 7168, 128 heads, MLA (q_lora 1536, kv_lora 512), first 3
layers dense (d_ff 18432), 58 MoE layers with 1 shared + 256 routed
top-8 experts (expert d_ff 2048), vocab 129280, multi-token prediction.

bf16 params + factored optimizer state (train/optimizer.py picks
Adafactor for ≥100B) so a large mesh holds params+grads+state.
"""
from .base import LayerSpec, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,                 # nope 128 + rope 64
    d_ff=18_432,                  # dense (first 3) layers; experts use 2048
    vocab_size=129_280,
    prefix=(LayerSpec("mla", "mlp"),) * 3,
    unit=(LayerSpec("mla", "moe"),),
    n_units=58,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_routed=256, n_shared=1, top_k=8, d_expert=2048, impl="alltoall"
    ),
    mtp=True,
    param_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    return CONFIG.scaled(
        prefix=(LayerSpec("mla", "mlp"),),
        n_units=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
        d_ff=160, vocab_size=256, remat=False, param_dtype="float32",
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                      rope_head_dim=8, nope_head_dim=16, v_head_dim=16),
        moe=MoEConfig(n_routed=8, n_shared=1, top_k=2, d_expert=32,
                      impl="dense"),
    )
