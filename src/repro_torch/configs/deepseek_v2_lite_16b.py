"""deepseek-v2-lite-16b — MLA + fine-grained MoE [arXiv:2405.04434].

27L, d_model 2048, 16 heads, MLA kv_lora 512 (no q compression in Lite),
MoE: 64 routed experts top-6 + 2 shared, expert d_ff 1408; first layer is
dense (d_ff 10944); vocab 102400.

NOTE: the assignment line reads "MoE 64e top-6 ... 2 shared+160 routed";
160 routed is the *full* V2 (236B).  V2-Lite (16B) has 64 routed experts
(model card), which also matches the leading "MoE 64e top-6" — we follow
the 64-expert reading and record the discrepancy here.
"""
from .base import LayerSpec, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,                 # nope 128 + rope 64
    d_ff=10_944,                  # dense (first) layer FFN
    vocab_size=102_400,
    prefix=(LayerSpec("mla", "mlp"),),
    unit=(LayerSpec("mla", "moe"),),
    n_units=26,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=None,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_routed=64, n_shared=2, top_k=6, d_expert=1408, impl="alltoall"
    ),
)


def reduced() -> ModelConfig:
    return CONFIG.scaled(
        n_units=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
        d_ff=160, vocab_size=256, remat=False,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=None,
                      rope_head_dim=8, nope_head_dim=16, v_head_dim=16),
        moe=MoEConfig(n_routed=4, n_shared=1, top_k=2, d_expert=32,
                      impl="dense"),
    )
