"""The decoder LM of the port: the dense half of ``repro.models`` (attention
mixers, SwiGLU MLPs, stub frontends), with ``DecoderLM``, a module that
owns a parameter tree, and ``convert``, which carries the reference's
parameters and caches across as numpy trees."""
from .convert import cache_from_numpy, params_from_numpy
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
    "materialize_params",
    "DecoderLM",
    "PV",
    "split_pv",
    "cache_from_numpy",
    "params_from_numpy",
]
