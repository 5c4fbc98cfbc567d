"""Shape, dtype and layout stand-ins for every (arch x shape) dry-run cell.

PyTorch port of ``repro.launch.specs``.  One ``LeafSpec`` a leaf takes
the place of the reference's sharded ``ShapeDtypeStruct``: the global
shape, the dtype, the spec tuple of
``distributed.sharding.logical_to_spec`` (entry for entry the reference's
``PartitionSpec``) and the local shape, each dim divided by the product of
its spec's mesh extents.  ``logical_to_spec`` shards only dims that
divide, so the division is exact.  ``input_specs`` gives the three step
kinds' inputs:

  train    {tokens, labels [B, S]} (+ frontend_embeds stub)
  prefill  {tokens [B, S]} + an empty decode cache (prefill fills it)
  decode   {tokens [B, 1]} + a full-length decode cache

Nothing here allocates: parameters and caches are built on the ``meta``
device, and a mesh is anything with a ``.shape`` mapping
(``launch.mesh.make_production_mesh``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (
    LOGICAL_RULES,
    SERVING_RULES,
    logical_to_spec,
)
from repro_torch.models import abstract_params, cache_axes, init_cache
from repro_torch.models.layers import torch_dtype
from repro_torch.pytree import tree_leaves, tree_map


def spec_extent(mesh, entry) -> int:
    """The number of shards a spec entry (None, an axis name or a tuple
    of names) cuts its dim into."""
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    return math.prod(mesh.shape[a] for a in names)


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One leaf of a cell's inputs: global shape, dtype, spec and the
    shape one device holds."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Tuple[Any, ...]
    local_shape: Tuple[int, ...]

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    @property
    def local_nbytes(self) -> int:
        return math.prod(self.local_shape) * self.itemsize


def leaf_spec(shape, dtype, mesh, axes, rules=None) -> LeafSpec:
    shape = tuple(int(n) for n in shape)
    spec = logical_to_spec(tuple(axes), mesh, shape, rules=rules)
    local = tuple(n // spec_extent(mesh, e) for n, e in zip(shape, spec))
    return LeafSpec(shape, dtype, spec, local)


def shard_tree(tree, axes_tree, mesh, rules=None):
    """A tree of tensors (or anything with ``.shape`` and ``.dtype``) and
    its twin tree of logical axes → a tree of ``LeafSpec``s."""
    return tree_map(
        lambda t, axes: leaf_spec(t.shape, t.dtype, mesh, axes, rules),
        tree, axes_tree)


def meta_tree(specs, local: bool = True):
    """Meta tensors at each ``LeafSpec``'s local (or global) shape."""
    return tree_map(
        lambda s: torch.empty(s.local_shape if local else s.shape,
                              dtype=s.dtype, device="meta"), specs)


def tree_nbytes(specs) -> int:
    """The bytes one device holds of a tree of ``LeafSpec``s."""
    return sum(s.local_nbytes for s in tree_leaves(specs))


def rules_for(cfg: ModelConfig) -> Dict:
    """The layout rules of ``cfg``: ``SERVING_RULES`` when it serves
    (expert FFN slices replicated unless ``serve_expert_ff_tp``), else
    ``LOGICAL_RULES``."""
    if cfg.serving:
        rules = dict(SERVING_RULES)
        if not cfg.serve_expert_ff_tp:
            rules["expert_ff"] = None   # replicate expert slices instead
        return rules
    return LOGICAL_RULES


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                with_labels: bool) -> Dict[str, LeafSpec]:
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": leaf_spec((b, s), torch.int32, mesh, ("batch", "seq"))}
    if with_labels:
        out["labels"] = leaf_spec((b, s), torch.int32, mesh,
                                  ("batch", "seq"))
    if cfg.frontend != "none" and shape.kind != "decode":
        out["frontend_embeds"] = leaf_spec(
            (b, cfg.frontend_len, cfg.d_model),
            torch_dtype(cfg.compute_dtype), mesh, ("batch", "seq", "embed"))
    return out


def param_specs(cfg: ModelConfig, mesh):
    """(tree of ``LeafSpec``s, logical-axes tree) of ``cfg``'s params."""
    params, axes = abstract_params(cfg)
    return shard_tree(params, axes, mesh, rules=rules_for(cfg)), axes


def cache_specs(cfg: ModelConfig, mesh, batch: int, max_seq: int):
    """The decode cache's ``LeafSpec``s (bf16 buffers); the scalar and
    [n_units] ``pos`` counters take ``None`` for their missing axes."""
    cache = init_cache(cfg, batch, max_seq, torch.bfloat16, device="meta")

    def fix(t, ax):
        ax = tuple(ax)
        if len(ax) < t.ndim:
            ax = ax + (None,) * (t.ndim - len(ax))
        return leaf_spec(t.shape, t.dtype, mesh, ax)

    return tree_map(fix, cache, cache_axes(cfg))


def cache_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """The cache length of a cell: its sequence, plus the frontend's
    prefix for a prefill."""
    if shape.kind == "prefill" and cfg.frontend != "none":
        return shape.seq_len + cfg.frontend_len
    return shape.seq_len


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh
                ) -> Dict[str, Any]:
    """All the inputs of one dry-run cell but the params and optimizer
    state."""
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, shape, mesh, with_labels=True)}
    if shape.kind == "prefill":
        return {
            "batch": batch_specs(cfg, shape, mesh, with_labels=False),
            "cache": cache_specs(cfg, mesh, shape.global_batch,
                                 cache_len(cfg, shape)),
        }
    if shape.kind == "decode":
        return {
            "tokens": leaf_spec((shape.global_batch, 1), torch.int32, mesh,
                                ("batch", "seq")),
            "cache": cache_specs(cfg, mesh, shape.global_batch,
                                 shape.seq_len),
        }
    raise ValueError(shape.kind)


def opt_state_specs(optimizer, pspecs, axes, mesh, rules=None):
    """The optimizer state's ``LeafSpec``s: the state of the global
    params, laid out by ``optimizer.state_axes`` (the reference's
    ``shard_tree(opt_sds, opt.state_axes(axes), mesh)``)."""
    state = optimizer.init(meta_tree(pspecs, local=False))
    return shard_tree(state, optimizer.state_axes(axes), mesh, rules)


__all__ = [
    "LeafSpec",
    "batch_specs",
    "cache_len",
    "cache_specs",
    "input_specs",
    "leaf_spec",
    "meta_tree",
    "opt_state_specs",
    "param_specs",
    "rules_for",
    "shard_tree",
    "spec_extent",
    "tree_nbytes",
]
