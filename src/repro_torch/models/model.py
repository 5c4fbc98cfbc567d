"""Decoder LM over the assigned architecture pool: the dense half.

PyTorch port of ``repro.models.model``.  Structure: embed (+ optional
stub frontend) → prefix layers → a Python loop over identical units
(params and caches stacked on a leading ``n_units`` axis, as the
reference stacks them for its scan) → suffix layers → final norm → LM
head.  The functional core keeps the reference's signatures, so the
serving steps read line for line like the reference's; ``DecoderLM`` is a
thin ``nn.Module`` that owns a parameter tree and calls the core.

Entry points:
  init_model(cfg, key, device)          → PV param tree (value + axes)
  abstract_params(cfg)                  → meta-tensor tree + axes tree
  forward(cfg, params, batch)           → logits (+extras) for prefill
  init_cache(cfg, batch, max_seq)       → decode cache tree
  decode_step(cfg, params, cache, tokens) → (logits, new cache)

Only attention mixers with MLP (or no) FFNs are ported: an ``mla``,
``mamba`` or ``moe`` layer, and the ``mtp`` head, raise
``NotImplementedError`` naming the ROADMAP.md item that ports them;
nothing falls back to another mixer.  ``loss_fn`` waits for the training
slice.  A decode step writes its keys and values into the cache's
buffers in place (the cache is consumed, as the reference's jitted decode
donates it) and returns a cache with new position counters.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.array_trie import resolve_device
from repro_torch.distributed.sharding import constrain
from repro_torch.pytree import tree_leaves, tree_leaves_with_path, tree_map
from .layers import (
    PV,
    attention,
    attention_cache_axes,
    init_attention,
    init_attention_cache,
    init_mlp,
    init_rmsnorm,
    mlp,
    pv,
    rmsnorm,
    sinusoidal_pos,
    split_pv,
    torch_dtype,
)

# layer kinds of the reference that the port does not run yet, and the
# ROADMAP.md item that ports each
NOT_PORTED = {
    "mla": "ROADMAP.md Queue 1 item 1 (models/mla.py with models/moe.py)",
    "moe": "ROADMAP.md Queue 1 item 1 (models/mla.py with models/moe.py)",
    "mamba": "ROADMAP.md Queue 1 item 2 (models/mamba.py)",
    "mtp": "ROADMAP.md Queue 1 item 1 (DeepSeek-V3's mtp head)",
}


def _require_ported(spec: LayerSpec):
    for kind in (spec.mixer, spec.ffn):
        if kind in NOT_PORTED:
            raise NotImplementedError(
                f"layer {spec} is not ported yet: {NOT_PORTED[kind]}")
    if spec.mixer != "attn":
        raise ValueError(spec.mixer)
    if spec.ffn not in ("mlp", "none"):
        raise ValueError(spec.ffn)


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def _init_layer(key, cfg: ModelConfig, spec: LayerSpec, lead=()):
    p: Dict[str, Any] = {
        "ln_mix": init_rmsnorm(key, cfg.d_model, None, lead=lead),
        "mixer": init_attention(key, cfg, lead=lead),
    }
    if spec.ffn == "mlp":
        p["ln_ffn"] = init_rmsnorm(key, cfg.d_model, None, lead=lead)
        p["ffn"] = init_mlp(key, cfg, lead=lead)
    return p


def _prepend_layers_axis(tree):
    return tree_map(lambda p: PV(p.value, ("layers",) + tuple(p.axes)), tree)


def init_model(cfg: ModelConfig, key, device=None) -> Dict[str, Any]:
    """PV tree drawn from the generator ``key`` (on its device, in a
    fixed order) and placed on ``device`` (CUDA unless named); ``key=None``
    builds meta tensors on the ``meta`` device."""
    dev = torch.device("meta") if key is None else resolve_device(device)
    for spec in cfg.layer_specs():
        _require_ported(spec)
    if cfg.mtp:
        raise NotImplementedError(
            f"the mtp head is not ported yet: {NOT_PORTED['mtp']}")
    dt = torch_dtype(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": pv(
            key, "embed", (cfg.vocab_size, cfg.d_model),
            ("vocab", "fsdp"), dt, fan_in=cfg.d_model,
        ),
        "final_norm": init_rmsnorm(key, cfg.d_model, dt),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = pv(
            key, "lm_head", (cfg.d_model, cfg.vocab_size),
            ("fsdp", "vocab"), dt,
        )
    if cfg.frontend != "none":
        params["frontend_proj"] = pv(
            key, "frontend_proj", (cfg.d_model, cfg.d_model),
            ("fsdp", None), dt,
        )
    params["prefix"] = [_init_layer(key, cfg, spec) for spec in cfg.prefix]
    params["suffix"] = [_init_layer(key, cfg, spec) for spec in cfg.suffix]
    params["units"] = _prepend_layers_axis({
        str(i): _init_layer(key, cfg, spec, lead=(cfg.n_units,))
        for i, spec in enumerate(cfg.unit)
    })
    if key is None or key.device == dev:
        return params
    return tree_map(lambda p: PV(p.value.to(dev), p.axes), params)


def abstract_params(cfg: ModelConfig):
    """(meta-tensor param tree, logical-axes tree) — no allocation."""
    return split_pv(init_model(cfg, None))


def materialize_params(cfg: ModelConfig, key, device=None):
    params, axes = split_pv(init_model(cfg, key, device))
    return params, axes


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------
def _apply_layer(cfg, spec: LayerSpec, p, h, positions, segment_ids, cache):
    """One residual block; returns (h, new_cache).  (The reference's
    third output, the MoE aux loss, is zero on every ported layer.)"""
    _require_ported(spec)
    mix_in = rmsnorm(h, p["ln_mix"], cfg.norm_eps)
    mix_out, new_cache = attention(
        cfg, p["mixer"], mix_in, positions, segment_ids, cache
    )
    h = h + mix_out
    if spec.ffn != "none":
        f_in = rmsnorm(h, p["ln_ffn"], cfg.norm_eps)
        h = h + mlp(cfg, p["ffn"], f_in)
    return h, new_cache


def _apply_unit(cfg, p_unit, h, positions, segment_ids, cache_unit):
    """Apply every layer of one unit; cache_unit is a dict keyed like
    p_unit (or None)."""
    new_caches = {}
    for i, spec in enumerate(cfg.unit):
        ci = cache_unit[str(i)] if cache_unit is not None else None
        h, nc = _apply_layer(
            cfg, spec, p_unit[str(i)], h, positions, segment_ids, ci
        )
        if nc is not None:
            new_caches[str(i)] = nc
    return h, (new_caches if cache_unit is not None else None)


def _restack(stacked, *per_unit):
    """One leaf of the units' new caches: the stacked buffer itself where
    every unit wrote into its own slice in place, else a new stack."""
    if all(t.data_ptr() == stacked[u].data_ptr()
           for u, t in enumerate(per_unit)):
        return stacked
    return torch.stack(per_unit)


def _embed_tokens(cfg, params, tokens):
    cdt = torch_dtype(cfg.compute_dtype)
    return F.embedding(tokens, params["embed"]).to(cdt)


def forward(
    cfg: ModelConfig,
    params,
    batch: Dict[str, torch.Tensor],
    cache=None,
    logits_mode: str = "all",        # "all" | "last"
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """Returns (logits [b, s, vocab] float32, extras, new_cache)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = batch.get("positions")
    segment_ids = batch.get("segment_ids")
    h = _embed_tokens(cfg, params, tokens)

    front_len = 0
    if cfg.frontend != "none" and "frontend_embeds" in batch:
        fe = batch["frontend_embeds"].to(h.dtype)
        fe = fe @ params["frontend_proj"].to(h.dtype)
        h = torch.cat((fe, h), dim=1)
        front_len = fe.shape[1]
    if positions is None:
        start = cache_position(cache) if cache is not None else 0
        positions = start + torch.arange(h.shape[1], dtype=torch.int32,
                                         device=h.device)[None]
        positions = positions.expand(b, h.shape[1])
    if cfg.pos_embed == "sinusoidal":
        h = h + sinusoidal_pos(positions, cfg.d_model).to(h.dtype)
    h = constrain(h, ("batch", "seq", "embed"))

    new_cache = {"prefix": [], "units": None, "suffix": []} \
        if cache is not None else None

    for i, spec in enumerate(cfg.prefix):
        ci = cache["prefix"][i] if cache is not None else None
        h, nc = _apply_layer(
            cfg, spec, params["prefix"][i], h, positions, segment_ids, ci
        )
        if cache is not None:
            new_cache["prefix"].append(nc)

    # the stacked units, one after another
    cache_units = cache["units"] if cache is not None else None
    new_units = []
    for u in range(cfg.n_units):
        p_u = tree_map(lambda x: x[u], params["units"])
        c_u = (tree_map(lambda x: x[u], cache_units)
               if cache_units is not None else None)
        h, nc_u = _apply_unit(cfg, p_u, h, positions, segment_ids, c_u)
        new_units.append(nc_u)
    if cache is not None:
        new_cache["units"] = tree_map(_restack, cache_units, *new_units)

    for i, spec in enumerate(cfg.suffix):
        ci = cache["suffix"][i] if cache is not None else None
        h, nc = _apply_layer(
            cfg, spec, params["suffix"][i], h, positions, segment_ids, ci
        )
        if cache is not None:
            new_cache["suffix"].append(nc)

    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    if front_len:
        h = h[:, front_len:, :]
    if logits_mode == "last":
        logits = unembed(cfg, params, h[:, -1:, :])
    else:
        logits = unembed(cfg, params, h)
    extras = {"aux_loss": torch.zeros((), dtype=torch.float32,
                                      device=h.device), "hidden": h}
    return logits, extras, new_cache


def unembed(cfg, params, h):
    """float32 logits: the operands are cast to the compute dtype, then
    multiplied in float32, as the reference's
    ``preferred_element_type=float32``."""
    cdt = torch_dtype(cfg.compute_dtype)
    w = (
        params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    ).to(cdt)
    logits = h.to(cdt).float() @ w.float()
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return constrain(logits, ("batch", "seq", "vocab"))


# ----------------------------------------------------------------------
# decode cache
# ----------------------------------------------------------------------
def _layer_cache(cfg, spec: LayerSpec, batch, max_seq, dtype, device,
                 lead=()):
    _require_ported(spec)
    return init_attention_cache(cfg, batch, max_seq, dtype, device, lead)


def _layer_cache_axes(spec: LayerSpec):
    _require_ported(spec)
    return attention_cache_axes()


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    """Zeroed caches on ``device`` (CUDA unless named); the units' caches
    stacked on a leading ``n_units`` axis, their ``pos`` an int32
    [n_units] vector."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    return {
        "prefix": [
            _layer_cache(cfg, spec, batch, max_seq, dtype, dev)
            for spec in cfg.prefix
        ],
        "units": {
            str(i): _layer_cache(cfg, spec, batch, max_seq, dtype, dev,
                                 lead=(cfg.n_units,))
            for i, spec in enumerate(cfg.unit)
        },
        "suffix": [
            _layer_cache(cfg, spec, batch, max_seq, dtype, dev)
            for spec in cfg.suffix
        ],
    }


def cache_axes(cfg: ModelConfig):
    def with_layers(tree):
        return tree_map(lambda axes: ("layers",) + tuple(axes), tree)

    return {
        "prefix": [_layer_cache_axes(s) for s in cfg.prefix],
        "units": with_layers(
            {str(i): _layer_cache_axes(s) for i, s in enumerate(cfg.unit)}
        ),
        "suffix": [_layer_cache_axes(s) for s in cfg.suffix],
    }


def integer_leaf(x) -> bool:
    """An integer tensor: a position counter in a cache."""
    return isinstance(x, torch.Tensor) and x.dtype in (
        torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


def cache_position(cache) -> torch.Tensor:
    """Current sequence position from any attention-family cache entry.

    ``pos`` counters are int32 scalars in the prefix and suffix layers and
    [n_units] vectors inside the stacked unit cache (every unit holds the
    same value); the first in the reference's leaf order answers."""
    for v in tree_leaves(cache):
        if integer_leaf(v):
            if v.ndim == 0:
                return v
            if v.ndim == 1:
                return v[0]
    return torch.zeros((), dtype=torch.int32)


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One serving step: tokens [b, k] appended at the cache position."""
    logits, _extras, new_cache = forward(
        cfg, params, {"tokens": tokens}, cache=cache
    )
    return logits, new_cache


# ----------------------------------------------------------------------
# parameter counting
# ----------------------------------------------------------------------
def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    params, _ = abstract_params(cfg)
    total = 0
    moe_routed = 0
    for path, leaf in tree_leaves_with_path(params):
        n = int(math.prod(leaf.shape))
        total += n
        # routed expert weights are the only ≥3-D ffn leaves
        # ([E, d, f] or stacked [layers, E, d, f])
        if "ffn" in path and any(k in ("wi", "wg", "wo") for k in path) \
                and leaf.ndim >= 3:
            moe_routed += n
    if active_only and cfg.moe is not None and cfg.moe.n_routed > 0:
        frac = cfg.moe.top_k / cfg.moe.n_routed
        total = total - moe_routed + int(moe_routed * frac)
    return total


# ----------------------------------------------------------------------
# the module
# ----------------------------------------------------------------------
class DecoderLM(torch.nn.Module):
    """Owns a parameter tree (each leaf a frozen ``nn.Parameter``, named
    by its path) and calls the functional core on it."""

    def __init__(self, cfg: ModelConfig, params):
        super().__init__()
        self.cfg = cfg
        self.params = self._own(params)

    def _own(self, tree, path=()):
        if isinstance(tree, dict):
            return {k: self._own(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [self._own(v, path + (i,)) for i, v in enumerate(tree)]
        p = torch.nn.Parameter(tree, requires_grad=False)
        self.register_parameter("__".join(map(str, path)), p)
        return p

    @classmethod
    def init(cls, cfg: ModelConfig, key, device=None) -> "DecoderLM":
        return cls(cfg, materialize_params(cfg, key, device)[0])

    def forward(self, batch, cache=None, logits_mode: str = "all"):
        return forward(self.cfg, self.params, batch, cache, logits_mode)

    def decode_step(self, cache, tokens):
        return decode_step(self.cfg, self.params, cache, tokens)

    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16):
        return init_cache(self.cfg, batch, max_seq, dtype,
                          self.params["embed"].device)

