"""Multi-pod dry run: one device's program of every (arch x shape x mesh)
cell, counted on the meta device.

PyTorch port of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell with XLA over 512 placeholder host devices and reads
the compiler's memory and cost analyses.  PyTorch has no HLO, so the port
counts its own program: it lays the cell out with ``launch/specs.py``,
builds ONE device's program of the step on ``meta`` tensors (shapes, no
storage: a 671B model fits) and runs it under counting dispatch modes.
Nothing at import sets an environment variable or touches CUDA.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch deepseek-v3-671b --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

Per cell: the production mesh (16 x 16, or 2 x 16 x 16 with
``--multi-pod``), the full-depth per-device run (memory), the counting
runs (FLOPs and bytes), the collective model, and a JSON record under
``dryrun_out/`` (``--out``) with the reference's keys.

**The per-device program.**  The step of the cell's kind
(``train.train_step.make_train_step`` with ``train.optimizer.
pick_optimizer``, ``serve.engine.make_prefill_step`` or
``make_decode_step``) on one device's tensors, under ``distributed.
use_mesh`` of the mesh:
  - the batch divides over its spec's batch axes where it divides;
  - each parameter holds its compute shape: its local shape with the
    ``fsdp`` dims whole (FSDP shards weights at rest; a forward computes
    with the gathered weight, so FSDP moves memory and collectives, not
    FLOPs) and the MoE router whole (the reference's ``shard_map`` takes
    it as ``P(None, None)``).  Heads, kv heads, FFN, vocab, expert and
    Mamba inner dims are split over ``model`` where ``logical_to_spec``
    splits the leaf's dim; where the fallback replicates, the work is
    replicated (smollm's 15 q / 5 kv heads on a 16-wide axis are computed
    whole on every device).  Mamba's gated norm scale follows its inner
    dim;
  - the attention core: with a cache, over the heads the cache holds
    (its kv heads, each with all its q heads, the q projection's heads
    tiled up: the all-gather of q) and the kv extent the cache holds (its
    ``seq_kv`` axes divide it); without one, over the device's q heads
    and the kv heads they read (``models.layers._device_heads``);
  - the MoE runs the routed path: the router over every expert, then one
    slice of ``e_local = n_routed / model extent`` experts at
    ``_capacity(tokens_local)`` (``models.moe``, meta tensors only; a
    dense-impl MoE on a ``model`` extent above 1 is counted as this
    routed path too: ``moe_dense`` is never counted on a split mesh);
  - train: the gradients come back at compute shape and are cut to each
    leaf's shard at rest (a narrowed copy: the reduce-scatter's output)
    before the optimizer updates the shards; its state is laid out like
    the params (``specs.opt_state_specs`` under the params' rules).

**FLOPs** (``flops_per_device``): ``torch.utils.flop_counter.
FlopCounterMode`` around the per-device step, at the reference's grid:
train and prefill at u in {1, 2} units x c in {2, 3, 4} chunks of
``Q_CHUNK`` = 256 tokens (a prefill's cache keeps the cell's true
length), fitted with ``_poly_extrapolate`` (the c^2 terms for train
only) and evaluated at the cell's ``n_units`` and ``seq_len / 256``;
decode at u in {1, 2}, extended linearly, and so a train or prefill
cell whose prompt does not take the chunked attention (the grid's do:
a train step recomputes each chunk in its backward pass), at its own
length.  The fit is solved in exact
rational arithmetic, so an integer polynomial comes back as the integer.

**Bytes.**  ``bytes_per_device``, the counterpart of XLA's unfused
"bytes accessed": the input plus output bytes of every aten op of the
per-device step but views, from a ``TorchDispatchMode``.
``bytes_boundary_per_device``, the counterpart of the reference's
``boundary_bytes``: the ops whose results materialize in HBM under
fusion, by the classes of its ``_BOUNDARY_OPS`` -- products (``mm``,
``bmm``, ``addmm``, ``baddbmm``: operands and result), reductions,
gathers and scatters, sorts, copies and ``arange`` (result only) -- plus
the program's arguments once and the collective model's payloads.  Both
come from the same grid and fit as the FLOPs.

**Collectives** (``collective_bytes_per_device``): a model derived from
the specs, not a trace; each kind's bytes are a payload's output bytes
times the reference's ring multiplier ``_MULT`` (all-reduce 2, the rest
1).  ``T`` is the tokens a device holds (``b_local x seq``, the frontend
prefix included), ``d`` the model width, ``cb`` the compute dtype's
bytes; a training step's unit layers run their forward twice under
remat (the recompute), and its backward once.
  - FSDP all-gather: every leaf whose ``fsdp`` dims are split (and the
    MoE router's expert dim) gathered to its compute shape, once a
    forward; a unit's leaves again for each remat recompute.
  - Gradients (train): a leaf's gradient is partial over the batch axes
    (and the router's over ``model``): reduce-scatter over the partial
    axes it is gathered over (output: its shard at rest), all-reduce over
    the partial axes it is not sharded on (on the multi-pod mesh: the
    ``pod`` all-reduce of every leaf the fsdp rule left whole over pod).
  - Row-parallel all-reduce over ``model`` of ``T x d x cb`` for every
    block whose contraction dim is split there: the attention and MLA
    out-projection, the MLP down-projection, the shared experts' and
    Mamba's out-projection; a forward each, and in training the
    backward's conjugate all-reduce of the block's input gradient.
    Mamba's gated norm over a split inner dim adds ``T x 4``.
  - The vocab-split embedding: the lookup's all-reduce of ``b x seq x
    d`` in the table's dtype; in training the cross-entropy's max, sum
    and label logit (``3 x b x seq x 4``) and the LM head's input
    gradient (``b x seq x d x cb``), and the same for DeepSeek's MTP
    head (its block counted as a layer).
  - MoE, train layout (``moe_alltoall``): all-to-all 0 -- tokens enter
    model-replicated (``P(batch, None, None)``), so the dispatch packs a
    device's own copies; the combine is the ``psum`` over ``model`` of
    ``T x d`` f32 (bf16 under ``moe_psum_bf16``), a forward each, plus
    in training the input gradient's ``T x d x cb``.  Serving layout
    (``moe_serve_tp``): the dispatch all-gathers the tokens over the
    batch axes (``T x shards x d x cb``) and the combine ``psum``s over
    ``model`` and ``data`` (the ``expert_ff`` split).
  - Decode's ``seq_kv`` combine: where the cache's sequence is split
    (extent above 1), each attention layer all-reduces its partial
    outputs and softmax statistics, ``b x s x h x (hd + 2) x 4``, and
    all-gathers q (``b x s x h x hd x cb``) where its q heads were split.

**Memory** (``memory``): ``argument`` the local bytes of the params at
rest (and the optimizer state for train), the inputs and the cache;
``alias`` what the reference donates (params and optimizer state for
train, the cache for prefill and decode); ``output`` the bytes of what
the full-depth step returns; ``temp`` the peak of live meta storage the
full-depth run allocates beyond its arguments (weakrefs on the storages,
in the same dispatch mode), outputs included.  The gathered weights are
the run's arguments, so ``temp`` leaves them out; on an FSDP mesh it
holds the whole gradient tree at compute shape before the cut to the
shards, where the reference scatters each unit's as it is made.
``generated_code`` is 0.

**Seconds.**  ``lower_seconds``: the layout and the meta build of the
arguments; ``compile_seconds``: the full-depth meta run (memory);
``cost_measure_seconds``: the counting runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import math
import os
import time
import traceback
import weakref
from fractions import Fraction
from typing import Any, Dict, Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_shape
from repro_torch.configs.base import LayerSpec
from repro_torch.distributed.sharding import use_mesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import DRYRUN_DIR
from repro_torch.launch.specs import (
    batch_specs,
    cache_len,
    cache_specs,
    input_specs,
    meta_tree,
    opt_state_specs,
    param_specs,
    rules_for,
    spec_extent,
    tree_nbytes,
)
from repro_torch.models.layers import torch_dtype
from repro_torch.pytree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
    tree_unflatten,
)
from repro_torch.serve.engine import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import pick_optimizer
from repro_torch.train.train_step import make_train_step

OUT_DIR = DRYRUN_DIR
Q_CHUNK = 256

# the reference's ring wire-cost multipliers (x output bytes)
_MULT = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# aten ops whose results materialize in HBM even under fusion, by the
# classes of the reference's ``_BOUNDARY_OPS``: products (operands and
# result), then reductions, gathers and scatters, sorts, copies and iota
# (result only)
_DOT_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv",
                      "dot", "convolution"})
_RESULT_OPS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "argmax", "argmin", "var", "std", "norm", "linalg_vector_norm",
    "cumsum", "cumprod", "any", "all",
    "embedding", "embedding_dense_backward", "index", "index_select",
    "gather", "index_put", "index_put_", "_index_put_impl_", "index_add",
    "index_add_", "index_copy", "index_copy_", "scatter", "scatter_",
    "scatter_add", "scatter_add_", "scatter_reduce", "slice_scatter",
    "select_scatter", "narrow_copy", "sort", "topk", "searchsorted",
    "copy_", "clone", "repeat", "arange",
})


def _bytes_of(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _aliases(out, inputs) -> bool:
    """Whether every tensor ``out`` holds lives in an input's storage (a
    view; ``aten.to`` may return a copy, under inference mode too)."""
    held = {id(t.untyped_storage()) for t in pytree.tree_leaves(inputs)
            if isinstance(t, torch.Tensor)}
    return all(id(t.untyped_storage()) in held
               for t in pytree.tree_leaves(out)
               if isinstance(t, torch.Tensor))


class _OpBytes(TorchDispatchMode):
    """Counts each aten op's input and output bytes but a view's
    (``bytes``), and those of the boundary classes (``boundary``)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.boundary = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view and _aliases(out, (args, kwargs)):
            return out
        outs = _bytes_of(out)
        ins = _bytes_of((args, kwargs))
        self.bytes += ins + outs
        name = func.overloadpacket.__name__
        if name in _DOT_OPS:
            self.boundary += ins + outs
        elif name in _RESULT_OPS:
            self.boundary += outs
        return out


class _LiveStorage(TorchDispatchMode):
    """The storage the ops allocate beyond what ``known`` marks as
    pre-existing, live (``cur``) and at its peak (``peak``): a weakref on
    each new storage takes its bytes back when it is freed."""

    def __init__(self, known):
        super().__init__()
        self.live: Dict[int, Any] = {}
        self.cur = 0
        self.peak = 0
        for t in pytree.tree_leaves(known):
            if isinstance(t, torch.Tensor):
                self._watch(t.untyped_storage(), 0)

    def _watch(self, st, nbytes):
        key = id(st)
        if key in self.live:
            return
        self.live[key] = (weakref.ref(st, lambda _r, k=key: self._free(k)),
                          nbytes)
        self.cur += nbytes
        self.peak = max(self.peak, self.cur)

    def _free(self, key):
        _ref, nbytes = self.live.pop(key)
        self.cur -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self._watch(st, st.nbytes())
        return out


# ----------------------------------------------------------------------
# one device's program
# ----------------------------------------------------------------------
class _DeviceView:
    """The mesh the per-device program runs under: the mesh's extents,
    and how many shards the layout cut the batch into (``models.moe``'s
    serving layout all-gathers its tokens over them)."""

    def __init__(self, mesh, token_shards: int):
        self.shape = dict(mesh.shape)
        self.token_shards = token_shards


def _names(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _gathered_dims(path, axes, spec, mesh):
    """(dim, extent) of each dim a leaf is gathered on for compute: its
    split ``fsdp`` dims, and the MoE router's split expert dim."""
    out = []
    for d, (name, entry) in enumerate(zip(axes, spec.spec)):
        n = spec_extent(mesh, entry)
        if n > 1 and (name == "fsdp" or path[-1] == "router"):
            out.append((d, n))
    return tuple(out)


def _shard(t, dims, copy):
    """``t`` cut to the device's shard on each of ``dims``."""
    for d, n in dims:
        t = t.narrow(d, 0, t.shape[d] // n)
    return t.clone() if copy and dims else t


class _AtRest:
    """The optimizer of a layout with gathered dims: each gradient cut to
    the device's shard (a copy: the reduce-scatter's output) and each
    param to its shard at rest, then the wrapped optimizer's update."""

    def __init__(self, optimizer, dims):
        self.opt = optimizer
        self.dims = dims

    def update(self, grads, state, params, step):
        grads = tree_map(lambda g, dims: _shard(g, dims, True), grads,
                         self.dims)
        params = tree_map(lambda p, dims: _shard(p, dims, False), params,
                          self.dims)
        return self.opt.update(grads, state, params, step)


def _first(tree, key):
    """The first leaf of ``tree`` under a dict key ``key``, with its
    path, or (None, None)."""
    for path, leaf in tree_leaves_with_path(tree):
        if key in path:
            return path, leaf
    return None, None


class Program:
    """One device's program of a cell: ``cfg`` at ``shape`` on ``mesh``,
    its tokens at ``seq`` (the counting grid's; default the cell's)."""

    def __init__(self, cfg, shape, mesh, seq: Optional[int] = None,
                 optimizer=None):
        self.cfg, self.shape, self.mesh = cfg, shape, mesh
        self.kind = shape.kind
        # the tokens a sequence feeds the step
        self.seq = 1 if self.kind == "decode" else (
            shape.seq_len if seq is None else seq)
        self.rules = rules_for(cfg)
        self.pspecs, self.axes = param_specs(cfg, mesh)
        tok = dataclasses.replace(shape, seq_len=self.seq)
        if self.kind == "train":
            self.inputs = input_specs(cfg, tok, mesh)
        elif self.kind == "prefill":
            self.inputs = {
                "batch": batch_specs(cfg, tok, mesh, with_labels=False),
                "cache": cache_specs(cfg, mesh, shape.global_batch,
                                     cache_len(cfg, shape))}
        else:
            self.inputs = input_specs(cfg, shape, mesh)
        tokens = (self.inputs["tokens"] if self.kind == "decode"
                  else self.inputs["batch"]["tokens"])
        self.batch_axes = _names(tokens.spec[0])
        self.b_local = tokens.local_shape[0]
        self.token_shards = spec_extent(mesh, tokens.spec[0])
        self.view = _DeviceView(mesh, self.token_shards)

        leaves = list(tree_leaves_with_path(self.pspecs))
        ax = tree_leaves(self.axes)
        shapes, dims = {}, {}
        for (path, spec), axes in zip(leaves, ax):
            dims[path] = _gathered_dims(path, axes, spec, mesh)
            shape_c = list(spec.local_shape)
            for d, n in dims[path]:
                shape_c[d] *= n
            shapes[path] = tuple(shape_c)
        for path in shapes:   # Mamba's gated norm follows its inner dim
            if path[-3:] == ("mixer", "norm", "scale"):
                inner = shapes[path[:-2] + ("w_x",)][-1]
                shapes[path] = shapes[path][:-1] + (inner,)
        self.compute_shapes = tree_unflatten(
            self.pspecs, [shapes[p] for p, _ in leaves])
        self.gathered = tree_unflatten(self.pspecs,
                                       [dims[p] for p, _ in leaves])
        self.cfg_dev = self._device_config()
        self.optimizer = None
        if self.kind == "train":
            self.optimizer = optimizer or pick_optimizer(cfg)
            self.state_specs = opt_state_specs(
                self.optimizer, self.pspecs, self.axes, mesh, self.rules)

    # -- the layout's consequences for the model code ------------------
    def _device_config(self):
        cfg, kw = self.cfg, {}
        path, wq = _first(self.compute_shapes, "wq")
        if path is not None and "wk" in _parent(self.compute_shapes, path):
            hq = wq[-2]
            kvp = _parent(self.compute_shapes, path)["wk"][-2]
            g = cfg.n_heads // cfg.n_kv_heads
            cache = self.inputs.get("cache")
            _, ck = (None, None) if cache is None else _first(cache, "k")
            if ck is not None:
                kv_c = ck.local_shape[-3]
                if kv_c != kvp:
                    raise ValueError(f"{kvp} kv heads projected, {kv_c} "
                                     "cached")
                kw.update(n_heads=kv_c * g, n_kv_heads=kv_c)
            elif hq % g == 0:
                kw.update(n_heads=hq, n_kv_heads=hq // g)
            elif g % hq == 0:
                kw.update(n_heads=hq, n_kv_heads=1)
            else:
                raise ValueError(f"{hq} q heads a device across groups of "
                                 f"{g}")
        elif cfg.mla is not None:
            _, wq_b = _first(self.compute_shapes, "wq_b")
            if wq_b is None:
                _, wq_b = _first(self.compute_shapes, "wq")
            kw.update(n_heads=wq_b[-2])
        model = self.mesh.shape.get("model", 1)
        if cfg.moe is not None and cfg.moe.impl == "dense" and model > 1:
            kw["moe"] = dataclasses.replace(cfg.moe, impl="alltoall")
        return cfg.scaled(**kw) if kw else cfg

    # -- arguments and the run -----------------------------------------
    def arguments(self) -> Dict[str, Any]:
        params = tree_map(
            lambda s, shp: torch.empty(shp, dtype=s.dtype, device="meta"),
            self.pspecs, self.compute_shapes)
        args = {"params": params}
        for k, v in self.inputs.items():
            args[k] = meta_tree(v)
        if self.kind == "train":
            args["opt_state"] = meta_tree(self.state_specs)
        return args

    def argument_bytes(self) -> int:
        n = tree_nbytes(self.pspecs) + tree_nbytes(self.inputs)
        if self.kind == "train":
            n += tree_nbytes(self.state_specs)
        return n

    def alias_bytes(self) -> int:
        if self.kind == "train":
            return tree_nbytes(self.pspecs) + tree_nbytes(self.state_specs)
        return tree_nbytes(self.inputs["cache"])

    def run(self, args):
        with use_mesh(self.view):
            if self.kind == "train":
                opt = self.optimizer
                if any(tree_leaves(self.gathered)):
                    opt = _AtRest(opt, self.gathered)
                step = make_train_step(self.cfg_dev, opt)
                return step(args["params"], args["opt_state"],
                            args["batch"], 0.0)
            if self.kind == "prefill":
                return make_prefill_step(self.cfg_dev)(
                    args["params"], args["cache"], args["batch"])
            return make_decode_step(self.cfg_dev)(
                args["params"], args["cache"], args["tokens"])


def _parent(tree, path):
    for k in path[:-1]:
        tree = tree[k]
    return tree


# ----------------------------------------------------------------------
# the collective model
# ----------------------------------------------------------------------


def _layers(prog):
    """(layer spec, its param LeafSpecs, its cache LeafSpecs or None,
    count, in the units, tokens) for every layer the step runs."""
    cfg, ps = prog.cfg, prog.pspecs
    cache = prog.inputs.get("cache")
    t = prog.b_local * prog.seq
    if cfg.frontend != "none" and prog.kind != "decode":
        t += prog.b_local * cfg.frontend_len

    def cached(group, key):
        return None if cache is None else cache[group][key]

    out = [(spec, ps["prefix"][i], cached("prefix", i), 1, False, t)
           for i, spec in enumerate(cfg.prefix)]
    out += [(spec, ps["units"][str(i)], cached("units", str(i)),
             cfg.n_units, True, t) for i, spec in enumerate(cfg.unit)]
    out += [(spec, ps["suffix"][i], cached("suffix", i), 1, False, t)
            for i, spec in enumerate(cfg.suffix)]
    if cfg.mtp and prog.kind == "train":
        out.append((LayerSpec(cfg.unit[-1].mixer, "mlp"), ps["mtp"]["block"],
                    None, 1, False, prog.b_local * (prog.seq - 1)))
    return out


def collective_bytes(prog: Program) -> Dict[str, float]:
    """Per-device collective bytes of ``prog`` by kind (output bytes x
    ``_MULT``), from the specs: the rules of the module docstring."""
    cfg, mesh = prog.cfg, prog.mesh
    out = {k: 0.0 for k in _MULT}

    def add(kind, nbytes, times=1):
        out[kind] += _MULT[kind] * nbytes * times

    train = prog.kind == "train"
    remat = train and cfg.remat
    model = mesh.shape.get("model", 1)
    d = cfg.d_model
    cb = torch.empty((), dtype=torch_dtype(cfg.compute_dtype)).element_size()

    def split(names):
        return {a for a in names if mesh.shape[a] > 1}

    def _has(entry, axis) -> bool:
        """Whether a spec entry splits its dim over ``axis``."""
        return axis in split(_names(entry))

    batch = split(prog.batch_axes)

    # FSDP gathers and the gradients' reduction, leaf by leaf
    for (path, spec), dims in zip(tree_leaves_with_path(prog.pspecs),
                                  tree_leaves(prog.gathered)):
        if path[0] == "mtp" and not train:
            continue
        gathered = split(a for dd, _ in dims for a in _names(spec.spec[dd]))
        if gathered:
            compute = spec.local_nbytes * math.prod(n for _, n in dims)
            add("all-gather", compute, 2 if remat and path[0] == "units"
                else 1)
        if train:
            partial = set(batch)
            if path[-1] == "router" and model > 1:
                partial.add("model")
            if gathered & partial:
                add("reduce-scatter", spec.local_nbytes)
            if partial - gathered:
                add("all-reduce", spec.local_nbytes)

    # the layers' all-reduces and gathers over model and the cache
    for spec, p, cache, count, in_units, t in _layers(prog):
        lead = 1 if in_units else 0
        fwd = (2 if remat and in_units else 1) * count
        both = fwd + (count if train else 0)
        rows = 0
        if spec.mixer in ("attn", "mla"):
            rows += _has(p["mixer"]["wo"].spec[lead], "model")
        else:
            if _has(p["mixer"]["w_out"].spec[lead], "model"):
                rows += 1
                add("all-reduce", t * 4, both)       # the gated norm
        if spec.ffn == "mlp":
            rows += _has(p["ffn"]["wo"].spec[lead], "model")
        elif spec.ffn == "moe":
            mo = cfg.moe
            if mo.n_shared:
                rows += _has(p["ffn"]["shared_wo"].spec[lead], "model")
            if model > 1 and _has(p["ffn"]["wi"].spec[lead], "model"):
                psum = 2 if cfg.moe_psum_bf16 else 4
                if (cfg.serving and mo.impl != "dense"
                        and cfg.serve_expert_ff_tp):
                    n = prog.token_shards
                    if n > 1:
                        add("all-gather", t * n * d * cb, fwd)
                    add("all-reduce", t * n * d * psum, fwd)
                else:
                    add("all-reduce", t * d * psum, fwd)
                    if train:
                        add("all-reduce", t * d * cb, count)
        add("all-reduce", rows * t * d * cb, both)
        if spec.mixer == "attn" and cache is not None:
            n_seq = spec_extent(mesh, cache["k"].spec[-2])
            s = prog.seq
            h, hd = prog.cfg_dev.n_heads, cfg.resolved_head_dim
            if n_seq > 1:
                add("all-reduce", prog.b_local * s * h * (hd + 2) * 4, count)
            if h > p["mixer"]["wq"].local_shape[-2]:
                add("all-gather", prog.b_local * s * h * hd * cb, count)

    # the vocab-split embedding and LM head
    emb = prog.pspecs["embed"]
    if model > 1 and _has(emb.spec[0], "model"):
        heads = [prog.b_local * prog.seq]
        if cfg.mtp and train:
            heads.append(prog.b_local * (prog.seq - 1))
        for n in heads:
            add("all-reduce", n * d * emb.itemsize)
            if train:
                add("all-reduce", 3 * n * 4 + n * d * cb)
    out["total"] = sum(out.values())
    return out


# ----------------------------------------------------------------------
# counting
# ----------------------------------------------------------------------
def _costs(prog: Program) -> Dict[str, Any]:
    args = prog.arguments()
    mode = _OpBytes()
    with FlopCounterMode(display=False) as fc, mode:
        prog.run(args)
    coll = collective_bytes(prog)
    payload = sum(v / _MULT[k] for k, v in coll.items() if k != "total")
    return {
        "flops": fc.get_total_flops(),
        "bytes": mode.bytes,
        "bytes_boundary": mode.boundary + prog.argument_bytes() + payload,
        "collectives": coll,
    }


def _memory(prog: Program) -> Dict[str, float]:
    args = prog.arguments()
    mode = _LiveStorage(args)
    with mode:
        out = prog.run(args)
    temp = mode.peak
    return {
        "argument_size_in_bytes": float(prog.argument_bytes()),
        "output_size_in_bytes": float(_bytes_of(out)),
        "temp_size_in_bytes": float(temp),
        "generated_code_size_in_bytes": 0.0,
        "alias_size_in_bytes": float(prog.alias_bytes()),
    }


def _solve(rows, values):
    """Least squares in exact rationals: the normal equations by
    Gauss-Jordan elimination."""
    n = len(rows[0])
    a = [[sum(r[i] * r[j] for r in rows) for j in range(n)]
         + [sum(r[i] * v for r, v in zip(rows, values))] for i in range(n)]
    for c in range(n):
        p = next(i for i in range(c, n) if a[i][c] != 0)
        a[c], a[p] = a[p], a[c]
        a[c] = [x / a[c][c] for x in a[c]]
        for i in range(n):
            if i != c and a[i][c] != 0:
                a[i] = [x - a[i][c] * y for x, y in zip(a[i], a[c])]
    return [a[i][n] for i in range(n)]


def _number(x: Fraction):
    x = max(x, Fraction(0))
    return int(x) if x.denominator == 1 else float(x)


def _poly_extrapolate(meas, n_units: int, true_c: float,
                      quadratic: bool = True) -> Dict[str, Any]:
    """Solve cost(u,c) = a + b·u + d·c + e·uc [+ g·c² + h·uc²] from the
    (u, c) measurements and evaluate at (n_units, true_c), as the
    reference does, in exact rational arithmetic.

    The c² terms exist only for train cells (attention kv extent = token
    count); prefill and decode kv extents are fixed by the cache."""
    keys = sorted(meas)
    if quadratic:
        def basis(u, c):
            return [1, u, c, u * c, c * c, u * c * c]
    else:
        def basis(u, c):
            return [1, u, c, u * c]
    m = [[Fraction(x) for x in basis(u, c)] for (u, c) in keys]
    target = basis(Fraction(n_units), Fraction(true_c))

    def solve(values):
        coef = _solve(m, [Fraction(v) for v in values])
        return _number(sum(t * k for t, k in zip(target, coef)))

    out = {name: solve([meas[k][name] for k in keys])
           for name in ("flops", "bytes", "bytes_boundary")}
    out["collectives"] = {
        ck: solve([meas[k]["collectives"][ck] for k in keys])
        for ck in meas[keys[0]]["collectives"]}
    return out


def _chunked(seq: int) -> bool:
    """Whether a prompt of ``seq`` tokens takes the chunked attention
    (``models.layers.attention``), whose chunks a train step checkpoints
    and recomputes, as the counting grid's prompts of 2-4 chunks do."""
    return seq > Q_CHUNK and seq % Q_CHUNK == 0


def mesh_name(mesh) -> str:
    shape = tuple(mesh.shape.values())
    if shape == (16, 16):
        return "pod16x16"
    if shape == (2, 16, 16):
        return "pod2x16x16"
    return "mesh" + "x".join(str(n) for n in shape)


def run_cell(arch: str, shape_name: str, multi_pod: bool, transform=None,
             *, cfg=None, shape=None, mesh=None) -> Dict[str, Any]:
    """The record of one cell.  ``cfg``, ``shape`` and ``mesh`` override
    the arch's config, the named shape and the production mesh (a config
    cut to size, a shape of one's own, a 1 x 1 mesh)."""
    cfg = get_config(arch) if cfg is None else cfg
    if transform is not None:
        cfg = transform(cfg)
    shape = get_shape(shape_name) if shape is None else shape
    mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None \
        else mesh
    record: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name(mesh),
        "kind": shape.kind,
        "n_devices": math.prod(mesh.shape.values()),
    }
    t0 = time.time()
    prog = Program(cfg, shape, mesh)
    prog.arguments()
    t1 = time.time()
    mem = _memory(prog)
    t2 = time.time()

    opt = prog.optimizer
    if shape.kind in ("train", "prefill") and _chunked(shape.seq_len):
        meas = {}
        for u in (1, 2):
            cfg_u = cfg.scaled(n_units=u)
            for c in (2, 3, 4):
                meas[(u, c)] = _costs(Program(cfg_u, shape, mesh,
                                              seq=c * Q_CHUNK, optimizer=opt))
        costs = _poly_extrapolate(meas, cfg.n_units, shape.seq_len / Q_CHUNK,
                                  quadratic=shape.kind == "train")
        record["raw_measurements"] = {f"u{u}c{c}": meas[(u, c)]
                                      for (u, c) in meas}
    else:
        ca = _costs(Program(cfg.scaled(n_units=1), shape, mesh,
                            optimizer=opt))
        cb = _costs(Program(cfg.scaled(n_units=2), shape, mesh,
                            optimizer=opt))
        n = cfg.n_units

        def line(a, b):
            return a + (n - 1) * (b - a)

        costs = {k: line(ca[k], cb[k])
                 for k in ("flops", "bytes", "bytes_boundary")}
        costs["collectives"] = {k: line(ca["collectives"][k],
                                        cb["collectives"][k])
                                for k in ca["collectives"]}
        record["raw_measurements"] = {"u1": ca, "u2": cb}
    t3 = time.time()
    record.update({
        "lower_seconds": t1 - t0,
        "compile_seconds": t2 - t1,
        "cost_measure_seconds": t3 - t2,
        "memory": mem,
        "flops_per_device": costs["flops"],
        "bytes_per_device": costs["bytes"],
        "bytes_boundary_per_device": costs["bytes_boundary"],
        "collective_bytes_per_device": costs["collectives"],
    })
    return record


def recost(out_dir: str):
    """Update existing cell records with the current cost estimators
    without redoing the full-depth run's memory."""
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        print(f"[recost] {os.path.basename(path)}", flush=True)
        try:
            fresh = run_cell(rec["arch"], rec["shape"],
                             rec["mesh"] == "pod2x16x16")
        except Exception:
            traceback.print_exc()
            continue
        for k in ("flops_per_device", "bytes_per_device",
                  "bytes_boundary_per_device", "collective_bytes_per_device",
                  "raw_measurements", "cost_measure_seconds"):
            rec[k] = fresh[k]
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    print("recost done")


def cell_tag(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}__{shape}__{'mp' if multi_pod else 'sp'}"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--all", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--recost", action="store_true")
    p.add_argument("--out", default=OUT_DIR)
    args = p.parse_args(argv)

    if args.recost:
        recost(args.out)
        return

    os.makedirs(args.out, exist_ok=True)
    cells = []
    if args.all:
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        for arch in ARCH_IDS:
            for shape in SHAPES:
                for mp in meshes:
                    cells.append((arch, shape.name, mp))
    else:
        if args.arch is None or args.shape is None:
            p.error("--arch and --shape, or --all")
        cells.append((args.arch, args.shape, args.multi_pod))

    failures = []
    for arch, shape, mp in cells:
        tag = cell_tag(arch, shape, mp)
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"[skip] {tag} (exists)")
            continue
        print(f"[cell] {tag}", flush=True)
        try:
            rec = run_cell(arch, shape, mp)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"[ok] {tag}: compile={rec['compile_seconds']:.1f}s "
                  f"flops/dev={rec['flops_per_device']:.3e} "
                  f"coll/dev={rec['collective_bytes_per_device']['total']:.3e}",
                  flush=True)
        except Exception:
            failures.append(tag)
            with open(path + ".err", "w") as f:
                traceback.print_exc(file=f)
            traceback.print_exc()
    if failures:
        print("FAILED CELLS:", failures)
        raise SystemExit(1)
    print("all cells ok")


if __name__ == "__main__":
    main()
