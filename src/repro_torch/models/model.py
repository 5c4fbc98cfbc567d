"""Decoder LM over the assigned architecture pool.

PyTorch port of ``repro.models.model``.  Structure: embed (+ optional
stub frontend) → prefix layers → a Python loop over identical units
(params and caches stacked on a leading ``n_units`` axis, as the
reference stacks them for its scan) → suffix layers → final norm → LM
head (+ DeepSeek-V3's ``mtp`` params).  The functional core keeps the
reference's signatures, so the serving steps read line for line like the
reference's; ``DecoderLM`` is a thin ``nn.Module`` that owns a parameter
tree and calls the core.

Entry points:
  init_model(cfg, key, device)          → PV param tree (value + axes)
  abstract_params(cfg)                  → meta-tensor tree + axes tree
  forward(cfg, params, batch)           → logits (+extras) for train/prefill
  loss_fn(cfg, params, batch)           → scalar LM loss (+ MoE aux, MTP)
  init_cache(cfg, batch, max_seq)       → decode cache tree
  decode_step(cfg, params, cache, tokens) → (logits, new cache)

Mixers: GQA attention (``layers``), MLA (``mla``) and the Mamba2 SSD
block (``mamba``); FFNs: the SwiGLU MLP and the MoE (``moe``), whose aux
loss ``forward`` sums into ``extras["aux_loss"]``.  An unknown mixer or
FFN raises ``ValueError``.  ``loss_fn`` is the reference's training loss:
cross-entropy, 1e-3 x the MoE aux, and 0.3 x DeepSeek-V3's depth-1 MTP
loss; with ``cfg.remat`` and autograd on, each unit of ``forward`` runs
under ``torch.utils.checkpoint`` (memory only, never values).  A decode
step writes its keys and values
(MLA: its latents; Mamba: its conv windows and SSM state) into the
cache's buffers in place (the cache is consumed, as the reference's
jitted decode donates it) and returns a cache with new position
counters.  A pure-SSM cache has no position counter: its position reads
0, as the reference's.

On a process mesh (params placed as DTensors by
``train.elastic.remesh_state`` on a ``launch.mesh.ProcessMesh``) the
same functions run the reference's program one rank at a time, as a
shard map would: each rank takes its rows of the batch (a DTensor's own
block, or the block ``logical_to_spec(("batch", "seq"))`` gives a plain
batch), each layer's placed weights whole (``Rows.weight``: the
redistribution to ``Replicate()`` around the ops, the ZeRO-3 gather;
the ops themselves are the one-device code, so none needs a sharding
rule), the MoE's expert slices through its process-group path, and a
placed cache's rows whole for the step (its blocks over the other axes
gathered, the step's writes then copied into the rank's own block in
place: Mamba's conv windows and SSM state as attention's keys and
values).  Logits, ``hidden`` and the new cache come back placed; the
loss, DeepSeek-V3's MTP loss and the dense MoE's aux loss sum over every
rank's rows.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.array_trie import resolve_device
from repro_torch.distributed.sharding import (
    Rows,
    entry_axes,
    constrain,
    get_mesh,
    is_placed,
    local_block,
    logical_to_spec,
    place_block,
    placements_of,
    use_mesh,
)
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
from .mamba import init_mamba, init_mamba_cache, mamba_block, mamba_cache_axes
from .mla import init_mla, init_mla_cache, mla_attention, mla_cache_axes
from .moe import init_moe, moe

# each mixer's parameter init and cache axes
MIXER_INIT = {"attn": init_attention, "mla": init_mla, "mamba": init_mamba}
MIXER_CACHE_AXES = {"attn": attention_cache_axes, "mla": mla_cache_axes,
                    "mamba": mamba_cache_axes}


def _check_spec(spec: LayerSpec):
    if spec.mixer not in MIXER_INIT:
        raise ValueError(spec.mixer)
    if spec.ffn not in ("mlp", "moe", "none"):
        raise ValueError(spec.ffn)


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def _init_layer(key, cfg: ModelConfig, spec: LayerSpec, lead=()):
    """Draws the mixer's leaves, then the FFN's."""
    _check_spec(spec)
    p: Dict[str, Any] = {
        "ln_mix": init_rmsnorm(key, cfg.d_model, None, lead=lead),
        "mixer": MIXER_INIT[spec.mixer](key, cfg, lead=lead),
    }
    if spec.ffn != "none":
        p["ln_ffn"] = init_rmsnorm(key, cfg.d_model, None, lead=lead)
        p["ffn"] = (init_mlp if spec.ffn == "mlp" else init_moe)(
            key, cfg, lead=lead)
    return p


def _prepend_layers_axis(tree):
    return tree_map(lambda p: PV(p.value, ("layers",) + tuple(p.axes)), tree)


def init_model(cfg: ModelConfig, key, device=None) -> Dict[str, Any]:
    """PV tree drawn from the generator ``key`` (on its device) and
    placed on ``device`` (CUDA unless named); ``key=None`` builds meta
    tensors on the ``meta`` device.  The draws come in this order:
    ``embed``, ``lm_head``, ``frontend_proj``, the prefix layers, the
    suffix layers, the units (each unit layer's leaves for all units at
    once, layer by layer), then the ``mtp`` head's ``proj`` and ``block``
    (an ``("mla", "mlp")`` layer when ``cfg.mla`` is set, else
    ``("attn", "mlp")``); within a layer, the mixer's leaves, then the
    FFN's, each in its module's stated order.  Norm scales are ones."""
    dev = torch.device("meta") if key is None else resolve_device(device)
    for spec in cfg.layer_specs():
        _check_spec(spec)
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
    if cfg.mtp:
        params["mtp"] = {
            "proj": pv(key, "mtp_proj", (2 * cfg.d_model, cfg.d_model),
                       ("fsdp", None), dt),
            "norm_h": init_rmsnorm(key, cfg.d_model, dt),
            "norm_e": init_rmsnorm(key, cfg.d_model, dt),
            "block": _init_layer(key, cfg, LayerSpec(
                "attn" if cfg.mla is None else "mla", "mlp")),
        }
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
def _layer_weights(spec: LayerSpec, p, rows):
    """A layer's placed leaves whole on this rank (the MoE's stay placed:
    its paths take the blocks they compute with)."""
    if rows is None:
        return p
    return {k: v if k == "ffn" and spec.ffn == "moe" else rows.tree(v)
            for k, v in p.items()}


def _apply_layer(cfg, spec: LayerSpec, p, h, positions, segment_ids, cache,
                 rows=None):
    """One residual block; returns (h, new_cache, aux): ``aux`` is the
    MoE's aux loss, or ``None`` for a layer without one (the reference's
    zero, which adds nothing to a sum).  ``rows``: a placed model's step
    on a process mesh."""
    _check_spec(spec)
    p = _layer_weights(spec, p, rows)
    aux = None
    mix_in = rmsnorm(h, p["ln_mix"], cfg.norm_eps)
    if spec.mixer == "mamba":
        mix_out, new_cache = mamba_block(cfg, p["mixer"], mix_in, cache)
    else:
        mix_out, new_cache = (attention if spec.mixer == "attn"
                              else mla_attention)(
            cfg, p["mixer"], mix_in, positions, segment_ids, cache
        )
    h = h + mix_out
    if spec.ffn != "none":
        f_in = rmsnorm(h, p["ln_ffn"], cfg.norm_eps)
        if spec.ffn == "moe":
            f_out, aux = moe(cfg, p["ffn"], f_in, rows)
        else:
            f_out = mlp(cfg, p["ffn"], f_in)
        h = h + f_out
    return h, new_cache, aux


def _add_aux(total, aux):
    """The sum of two aux losses, either of which may be ``None``."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def _apply_unit(cfg, p_unit, h, positions, segment_ids, cache_unit,
                rows=None):
    """Apply every layer of one unit; cache_unit is a dict keyed like
    p_unit (or None).  Returns (h, new caches, the unit's aux or None)."""
    new_caches = {}
    aux_total = None
    for i, spec in enumerate(cfg.unit):
        ci = cache_unit[str(i)] if cache_unit is not None else None
        h, nc, aux = _apply_layer(
            cfg, spec, p_unit[str(i)], h, positions, segment_ids, ci, rows
        )
        aux_total = _add_aux(aux_total, aux)
        if nc is not None:
            new_caches[str(i)] = nc
    return h, (new_caches if cache_unit is not None else None), aux_total


# the products ``remat_policy="dots"`` keeps (jax's ``dots_saveable``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _apply_unit_in(mesh, *args):
    with use_mesh(mesh):
        return _apply_unit(*args)


def _remat_unit(cfg, p_u, h, positions, segment_ids, rows=None):
    """``_apply_unit`` without a cache under ``torch.utils.checkpoint``:
    policy ``"nothing"`` keeps only the unit's inputs and recomputes the
    rest in the backward pass; ``"dots"`` also keeps the matmul outputs
    (selective checkpointing).  Placed weights are gathered inside, so
    the backward pass gathers them again (as FSDP does).  The recompute
    runs under the forward's ambient mesh: autograd runs a CUDA backward
    on a thread of its own, where the context variable of ``use_mesh``
    is unset, and the MoE would take another path there."""
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                   _save_dots)
    mesh = get_mesh()
    fn = _apply_unit if mesh is None else partial(_apply_unit_in, mesh)
    h, _, aux = checkpoint(fn, cfg, p_u, h, positions, segment_ids, None,
                           rows, use_reentrant=False, **kw)
    return h, None, aux


def _restack(stacked, *per_unit):
    """One leaf of the units' new caches: the stacked buffer itself where
    every unit wrote into its own slice in place (its storage, at its
    slice's offset: meta tensors too, which have no data pointers), else
    a new stack."""
    st = stacked.untyped_storage()
    if all(t.untyped_storage() is st
           and t.storage_offset() == stacked[u].storage_offset()
           for u, t in enumerate(per_unit)):
        return stacked
    return torch.stack(per_unit)


def _unit_views(x, rows):
    """A stacked leaf's per-unit views.  A placed leaf whose rank's block
    is the whole leaf (no mesh axis of extent above 1 splits it) is
    unwrapped once (``Rows.weight``) into plain views; another gives
    placed views of its local block (the unit axis is never split), each
    gathered when its layer runs."""
    if not is_placed(x):
        return x.unbind(0)
    if all(isinstance(p, Replicate) or n == 1
           for p, n in zip(x.placements, rows.mesh.sizes)):
        return rows.weight(x).unbind(0)
    shape, stride = x.shape[1:], x.stride()[1:]
    places = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                   for p in x.placements)
    return tuple(DTensor.from_local(t, x.device_mesh, places,
                                    run_check=False, shape=shape,
                                    stride=stride)
                 for t in x.to_local().unbind(0))


def _embed_tokens(cfg, params, tokens):
    cdt = torch_dtype(cfg.compute_dtype)
    return F.embedding(tokens, params["embed"]).to(cdt)


# the leaves ``forward`` reads outside the layers
_TOP = ("embed", "lm_head", "frontend_proj", "final_norm")


def forward(
    cfg: ModelConfig,
    params,
    batch: Dict[str, torch.Tensor],
    cache=None,
    logits_mode: str = "all",        # "all" | "last"
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """Returns (logits [b, s, vocab] float32, extras, new_cache).  On
    placed params (DTensors on a process mesh) logits, ``hidden`` and
    the cache come back placed (module docstring)."""
    if not is_placed(params["embed"]):
        return _forward(cfg, params, batch, cache, logits_mode)
    rows, local = _rows_of_batch(params, batch)
    local_cache = None if cache is None else _cache_rows(cfg, cache, rows)
    logits, extras, new_cache = _forward(cfg, params, local, local_cache,
                                         logits_mode, rows)
    extras = dict(extras, hidden=_placed_rows(extras["hidden"], rows))
    if cache is not None:
        new_cache = _cache_back(cfg, cache, new_cache, rows)
    return _placed_rows(logits, rows), extras, new_cache


def _process_mesh_of(params):
    """The process mesh a placed tree lives on: the ambient one (it must
    hold the tree's ``DeviceMesh``), else one over the tree's."""
    dm = params["embed"].device_mesh
    mesh = get_mesh()
    if hasattr(mesh, "device_mesh"):
        if mesh.device_mesh != dm:
            raise ValueError("the params are placed on another mesh than "
                             "the ambient one")
        return mesh
    from repro_torch.launch.mesh import ProcessMesh

    return ProcessMesh(dm)


def _rows_of_batch(params, batch):
    """(``Rows``, this rank's rows of every batch entry): a DTensor's
    own block (its dim 0 split over the mesh axes it is sharded over),
    else the block ``logical_to_spec(("batch", "seq"))`` gives."""
    mesh = _process_mesh_of(params)
    tokens = batch["tokens"]
    if is_placed(tokens):
        rows = Rows.of(tokens, mesh)
    else:
        spec = logical_to_spec(("batch", "seq"), mesh, tuple(tokens.shape))
        rows = Rows(mesh, entry_axes(spec[0]))

    def mine(x):
        if is_placed(x):
            return x.to_local()
        n = x.shape[0] // rows.count
        return x.narrow(0, rows.index() * n, n)

    return rows, {k: mine(v) for k, v in batch.items()}


def _placed_rows(x, rows):
    """This rank's rows of an output as a DTensor split over the row
    axes on dim 0."""
    spec = (tuple(rows.axes) or None,) + (None,) * (x.ndim - 1)
    return place_block(x, rows.mesh, spec,
                       (x.shape[0] * rows.count,) + tuple(x.shape[1:]))


def _row_spec(x, axes, rows):
    """A placed cache leaf's spec with only its batch dim split, and the
    full spec: the leaf's blocks must split the batch over the step's
    row axes."""
    full = logical_to_spec(tuple(axes), rows.mesh, tuple(x.shape))
    want = tuple(e if a == "batch" else None for a, e in zip(axes, full))
    got = tuple(a for e in want for a in entry_axes(e))
    if "batch" in axes and got != tuple(rows.axes):
        raise ValueError(f"a cache leaf splits its batch over {got}, the "
                         f"step's rows over {rows.axes}")
    return want, full


def _cache_rows(cfg, cache, rows):
    """Each placed cache leaf's rows whole: its blocks over the axes
    other than the row axes gathered (none to gather: the rank's own
    block, in place)."""
    def leaf(x, axes):
        if not is_placed(x):
            return x
        return local_block(x, rows.mesh, _row_spec(x, axes, rows)[0])

    return tree_map(leaf, cache, cache_axes(cfg))


def _cache_back(cfg, cache, new_local, rows):
    """The step's cache placed again: a buffer's new rows copied into the
    rank's own block of the old placed leaf in place (nothing to copy
    where the step wrote there), a new position counter placed."""
    coord, shape = rows.mesh.coordinate, rows.mesh.shape

    def leaf(old, new, axes):
        if not is_placed(old):
            return new
        _, full = _row_spec(old, axes, rows)
        if integer_leaf(new):
            return place_block(new, rows.mesh, full, old.shape)
        mine = old.to_local()
        if new.untyped_storage() is mine.untyped_storage():
            return old
        block = new
        for axis, p in zip(rows.mesh.axis_names,
                           placements_of(full, rows.mesh)):
            if isinstance(p, Shard) and axis not in rows.axes and \
                    shape[axis] > 1:
                n = block.shape[p.dim] // shape[axis]
                block = block.narrow(p.dim, coord[axis] * n, n)
        mine.copy_(block)
        return old

    return tree_map(leaf, cache, new_local, cache_axes(cfg))


def _top_weights(params, rows):
    """The leaves ``forward`` reads outside the layers whole on this rank
    (plain leaves come back as they are)."""
    return dict(params, **{k: rows.tree(params[k]) for k in _TOP
                           if k in params})


def _forward(cfg, params, batch, cache, logits_mode, rows=None):
    """``forward`` on this rank's rows (``rows``) or on one device."""
    if rows is not None:
        params = _top_weights(params, rows)
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

    aux_total = None
    new_cache = {"prefix": [], "units": None, "suffix": []} \
        if cache is not None else None

    for i, spec in enumerate(cfg.prefix):
        ci = cache["prefix"][i] if cache is not None else None
        h, nc, aux = _apply_layer(
            cfg, spec, params["prefix"][i], h, positions, segment_ids, ci,
            rows
        )
        aux_total = _add_aux(aux_total, aux)
        if cache is not None:
            new_cache["prefix"].append(nc)

    # the stacked units, one after another; rematerialized where a
    # backward pass will run (the reference's ``jax.checkpoint`` of its
    # scan body changes memory only, and a cache is written in place)
    cache_units = cache["units"] if cache is not None else None
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    # each stacked leaf split once into per-unit views: its backward
    # stacks the units' gradients once, where indexing one unit at a time
    # would sum n_units zero-padded [n_units, ...] copies
    units = tree_map(lambda x: _unit_views(x, rows), params["units"])
    new_units = []
    for u in range(cfg.n_units):
        p_u = tree_map(lambda x: x[u], units)
        if remat:
            h, nc_u, aux = _remat_unit(cfg, p_u, h, positions, segment_ids,
                                       rows)
        else:
            c_u = (tree_map(lambda x: x[u], cache_units)
                   if cache_units is not None else None)
            h, nc_u, aux = _apply_unit(cfg, p_u, h, positions, segment_ids,
                                       c_u, rows)
        aux_total = _add_aux(aux_total, aux)
        new_units.append(nc_u)
    if cache is not None:
        new_cache["units"] = tree_map(_restack, cache_units, *new_units)

    for i, spec in enumerate(cfg.suffix):
        ci = cache["suffix"][i] if cache is not None else None
        h, nc, aux = _apply_layer(
            cfg, spec, params["suffix"][i], h, positions, segment_ids, ci,
            rows
        )
        aux_total = _add_aux(aux_total, aux)
        if cache is not None:
            new_cache["suffix"].append(nc)

    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    if front_len:
        h = h[:, front_len:, :]
    if logits_mode == "last":
        logits = unembed(cfg, params, h[:, -1:, :])
    else:
        logits = unembed(cfg, params, h)
    if aux_total is None:
        aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    extras = {"aux_loss": aux_total, "hidden": h}
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
# loss
# ----------------------------------------------------------------------
def _ce(logits, labels, mask, rows=None):
    """Mean cross-entropy over the positions ``mask`` keeps, in float32:
    logsumexp less the label's logit (a gather, which equals the
    reference's one-hot dot exactly for labels in ``[0, vocab)``), over
    ``max(sum(mask), 1)``; with ``rows`` both sums run over every rank's
    rows."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    mask = mask.float()
    num, den = torch.sum((lse - ll) * mask), torch.sum(mask)
    if rows is not None:
        num, den = rows.sum(num), rows.sum(den)
    return num / torch.clamp(den, min=1.0)


def _loss_mask(batch):
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    return mask


def loss_fn(cfg: ModelConfig, params, batch) -> Tuple[torch.Tensor, Dict]:
    """(total loss, metrics): the LM cross-entropy plus 1e-3 x the MoE aux
    loss, plus 0.3 x the MTP loss when ``cfg.mtp`` is set; metrics
    ``lm_loss``, ``aux_loss`` (and ``mtp_loss``).  ``batch["loss_mask"]``
    defaults to ones.  On placed params each rank computes on its rows
    and the loss is the global batch's, the same on every rank."""
    rows = None
    if is_placed(params["embed"]):
        rows, batch = _rows_of_batch(params, batch)
        # gathered once for the LM head and the MTP head both
        params = _top_weights(params, rows)
    logits, extras, _ = _forward(cfg, params, batch, None, "all", rows)
    mask = _loss_mask(batch)
    loss = _ce(logits, batch["labels"], mask, rows)
    total = loss + 1e-3 * extras["aux_loss"]
    metrics = {"lm_loss": loss, "aux_loss": extras["aux_loss"]}
    if cfg.mtp:
        mtp_loss = _mtp_loss(cfg, params, batch, extras["hidden"], rows)
        total = total + 0.3 * mtp_loss
        metrics["mtp_loss"] = mtp_loss
    return total, metrics


def _mtp_loss(cfg, params, batch, hidden, rows=None):
    """DeepSeek-V3 MTP (depth 1): predict t+2 from (h_t, emb(t+1)).
    With ``rows``: ``hidden``, ``batch`` and the step are this rank's
    rows, the head's leaves gathered whole, the loss the global
    batch's."""
    p = params["mtp"]
    if rows is not None:
        p = {k: v if k == "block" else rows.tree(v) for k, v in p.items()}
    tokens, labels = batch["tokens"], batch["labels"]
    mask = _loss_mask(batch)
    cdt = torch_dtype(cfg.compute_dtype)
    h = rmsnorm(hidden[:, :-1], p["norm_h"], cfg.norm_eps)
    e = F.embedding(tokens[:, 1:], params["embed"]).to(cdt)
    e = rmsnorm(e, p["norm_e"], cfg.norm_eps)
    x = torch.cat((h, e), -1).to(cdt) @ p["proj"].to(cdt)
    b, s1, _ = x.shape
    positions = torch.arange(s1, dtype=torch.int32,
                             device=x.device)[None].expand(b, s1)
    # the reference's block spec: the last unit layer's mixer with an MLP
    spec = LayerSpec(cfg.unit[-1].mixer, "mlp")
    x, _, _ = _apply_layer(cfg, spec, p["block"], x, positions, None, None,
                           rows)
    logits = unembed(cfg, params, x)
    # target at position i is labels[i+1] = t_{i+2}
    return _ce(logits[:, :-1], labels[:, 2:], mask[:, 2:], rows)


# ----------------------------------------------------------------------
# decode cache
# ----------------------------------------------------------------------
def _layer_cache(cfg, spec: LayerSpec, batch, max_seq, dtype, device,
                 lead=()):
    _check_spec(spec)
    if spec.mixer == "mamba":
        return init_mamba_cache(cfg, batch, dtype, device, lead)
    init = init_mla_cache if spec.mixer == "mla" else init_attention_cache
    return init(cfg, batch, max_seq, dtype, device, lead)


def _layer_cache_axes(spec: LayerSpec):
    _check_spec(spec)
    return MIXER_CACHE_AXES[spec.mixer]()


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
    same value); the first in the reference's leaf order answers (Jamba:
    its attention layer's).  A cache with none (pure SSM: Mamba's windows
    and state are floats) answers 0."""
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

