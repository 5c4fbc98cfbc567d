"""Model configuration system.

One ``ModelConfig`` describes any architecture in the assigned pool:
dense GQA transformers, MLA+MoE (DeepSeek), audio/vlm backbones with stub
frontends, Mamba2 (SSD), and hybrid attn/SSM interleaves (Jamba).

Layer stacking is expressed as ``prefix + unit × n_units + suffix`` where
``unit`` is a list of per-layer ``LayerSpec``s.  The units' parameters and
caches are stacked on a leading ``n_units`` axis; prefix and suffix layers
stand alone (e.g. DeepSeek-V3's first-3 dense layers).  A copy of
``repro.configs.base``: ``remat``, ``remat_policy`` and ``unroll_scans``
only shape the reference's compiled program, and the port's forward
ignores them.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    n_shared: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    impl: str = "dense"            # "dense" (exact, small E) | "alltoall" (EP)


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"            # "attn" | "mla" | "mamba"
    ffn: str = "mlp"               # "mlp" | "moe" | "none"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # layer stack: prefix (unrolled) + unit × n_units (scanned) + suffix
    unit: Tuple[LayerSpec, ...]
    n_units: int
    prefix: Tuple[LayerSpec, ...] = ()
    suffix: Tuple[LayerSpec, ...] = ()
    head_dim: Optional[int] = None         # default d_model // n_heads
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: str = "none"                 # "none" | "audio" | "vision"
    frontend_len: int = 0                  # stub prefix length (dry-run)
    mtp: bool = False                      # DeepSeek-V3 multi-token predict
    pos_embed: str = "rope"                # "rope" | "sinusoidal"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    param_dtype: str = "float32"           # "bfloat16" for ≥100B params
    compute_dtype: str = "bfloat16"
    remat: bool = True                     # checkpoint each scanned unit
    logit_softcap: float = 0.0
    sliding_window: int = 0                # 0 = full causal
    # The reference's cost-measurement mode (python loops in place of
    # its scans); the port's forward is one Python loop either way.
    unroll_scans: bool = False
    # ---- §Perf hillclimb knobs (default off = paper-faithful baseline) --
    # Skip fully-masked kv blocks in chunked causal attention: query chunk
    # i only visits kv ≤ (i+1)·q_chunk (one pass over the static list of
    # lower-triangle block pairs) — ~halves train attention flops.
    causal_skip: bool = False
    # Reduce MoE EP psum payload to bf16 (halves the dominant collective).
    moe_psum_bf16: bool = False
    # Remat policy for the unit scan: "nothing" (recompute all) or "dots"
    # (save matmul outputs — fewer recompute flops, more memory).
    remat_policy: str = "nothing"
    # Serving layout: params not FSDP-sharded (kills the per-step ZeRO-3
    # weight all-gather that dominates decode collectives); MoE expert FFN
    # dims TP over "data" with the serve_tp shard_map impl.
    serving: bool = False
    # Within the serving layout: True = expert-FFN TP over data + global
    # token all-gather (decode: tokens are tiny).  False = experts
    # replicated over data, tokens stay local (prefill: tokens are huge,
    # weights fit for ≤30B-class models).
    serve_expert_ff_tp: bool = True

    # ------------------------------------------------------------------
    @property
    def n_layers(self) -> int:
        return (
            len(self.prefix)
            + len(self.unit) * self.n_units
            + len(self.suffix)
        )

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    def layer_specs(self) -> List[LayerSpec]:
        return (
            list(self.prefix)
            + list(self.unit) * self.n_units
            + list(self.suffix)
        )

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D model-FLOPs)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)

    def scaled(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
