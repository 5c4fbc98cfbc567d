"""The decoder LM of the port: ``repro.models`` whole (attention, MLA and
Mamba2 mixers, SwiGLU MLPs and MoE FFNs, stub frontends, DeepSeek-V3's
``mtp`` head, the training loss ``loss_fn``), with ``DecoderLM``, a
module that owns a parameter tree, and ``convert``, which carries the
reference's parameters, caches and optimizer states across as numpy
trees."""
from .convert import (
    cache_from_numpy,
    opt_state_from_numpy,
    params_from_numpy,
)
from .layers import PV, split_pv
from .model import (
    DecoderLM,
    abstract_params,
    cache_axes,
    cache_position,
    count_params_analytic,
    decode_step,
    forward,
    init_cache,
    init_model,
    loss_fn,
    materialize_params,
)

__all__ = [
    "abstract_params",
    "cache_axes",
    "cache_position",
    "count_params_analytic",
    "decode_step",
    "forward",
    "init_cache",
    "init_model",
    "loss_fn",
    "materialize_params",
    "DecoderLM",
    "PV",
    "split_pv",
    "cache_from_numpy",
    "opt_state_from_numpy",
    "params_from_numpy",
]
