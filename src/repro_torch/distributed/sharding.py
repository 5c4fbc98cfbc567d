"""Logical-axis sharding rules (MaxText-style) with divisibility fallback.

A copy of the rule table and the spec mapping of
``repro.distributed.sharding``.  Every parameter/activation dimension
carries a logical name; a rules table maps logical names to mesh axes.  A
dimension that is not evenly divisible by its mesh-axis extent silently
falls back to replication — the policy that makes odd head counts
(smollm: 15 q / 5 kv heads) and odd vocabs (granite: 49 155) shard
safely on a 16-wide model axis.

A mesh here is anything with a ``.shape`` mapping from axis name to
extent, and a spec is a tuple with one entry per dimension: ``None``, a
mesh axis name, or a tuple of names — entry for entry the reference's
``PartitionSpec``.  The port serves the LM on one device, where
``constrain`` returns its input unchanged, as the reference's does off a
mesh; placing tensors by these specs across GPUs (the reference's
``named_sharding``) waits for the multi-GPU LM slice (ROADMAP.md).

The ambient mesh: ``with use_mesh(mesh):`` makes ``mesh`` the one
``get_mesh()`` returns (``None`` outside), as the reference's
``jax.set_mesh`` does for ``jax.sharding.get_abstract_mesh()``; the MoE's
expert-parallel paths read it.

Key logical axes:
  batch      data-parallel batch            → ("pod", "data")
  embed      residual/d_model               → None (replicated activations)
  heads      attention q heads              → "model"   (TP)
  kv_heads   attention kv heads             → "model"   (TP)
  mlp        FFN hidden                     → "model"   (TP)
  vocab      embedding/unembedding vocab    → "model"   (TP)
  expert     MoE expert id                  → "model"   (EP)
  fsdp       weight shard dim for FSDP      → ("pod", "data")  (ZeRO-3 style)
  seq        sequence (SP, long-context)    → None by default
  layers     stacked unit axis              → None
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Optional, Sequence, Tuple

from repro_torch.pytree import tree_map

Axes = Tuple[Optional[str], ...]
Spec = Tuple[object, ...]

# what every path that would span several GPUs names when it raises
MULTI_GPU = ("ROADMAP.md Queue 1 item 4 (named_sharding, the multi-GPU LM "
             "slice)")

# logical axis -> mesh axis (or tuple of mesh axes)
LOGICAL_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "expert_ff": None,           # per-expert FFN hidden (serving: "data")
    "d_state": None,
    "embed": None,
    "kv_lora": None,
    "seq": None,
    # decode KV-cache sequence axis: soaks up whatever mesh axes the batch
    # dim left unclaimed (heads-poor GQA and batch=1 long-context cells)
    "seq_kv": ("model", "data", "pod"),
    "layers": None,
    "conv": None,
    "head_dim": None,
    "qk_dim": None,
    "capacity": None,
    None: None,
}

# Serving layout: parameters are NOT FSDP-sharded (the per-step weight
# all-gather would dominate decode collectives under the train layout);
# MoE expert FFN dims are TP-sharded over ``data`` instead.
SERVING_RULES: Dict[str, Optional[Tuple[str, ...]]] = dict(
    LOGICAL_RULES,
    **{
        "fsdp": None,
        "expert_ff": ("data",),
    },
)


def _mesh_axes_for(logical: Optional[str], mesh, rules=None
                   ) -> Tuple[str, ...]:
    rule = (rules or LOGICAL_RULES).get(logical)
    if rule is None:
        return ()
    return tuple(a for a in rule if a in mesh.shape)


def logical_to_spec(
    axes: Axes, mesh, shape: Optional[Sequence[int]] = None, rules=None,
) -> Spec:
    """Map per-dim logical names to a spec tuple.

    If ``shape`` is given, any dim not divisible by the product of its mesh
    axes takes the longest prefix of those axes that divides it, or is
    replicated.  Mesh axes may be used at most once across the whole spec;
    later claims lose.
    """
    used = set()
    parts = []
    for d, name in enumerate(axes):
        mesh_axes = _mesh_axes_for(name, mesh, rules)
        mesh_axes = tuple(a for a in mesh_axes if a not in used)
        if not mesh_axes:
            parts.append(None)
            continue
        if shape is not None:
            extent = 1
            for a in mesh_axes:
                extent *= mesh.shape[a]
            if shape[d] % extent != 0:
                picked = ()
                for k in range(len(mesh_axes), 0, -1):
                    ext = 1
                    for a in mesh_axes[:k]:
                        ext *= mesh.shape[a]
                    if shape[d] % ext == 0:
                        picked = mesh_axes[:k]
                        break
                mesh_axes = picked
                if not mesh_axes:
                    parts.append(None)
                    continue
        used.update(mesh_axes)
        parts.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
    return tuple(parts)


def shard_params_specs(axes_tree, mesh, shapes_tree=None, rules=None):
    """Tree of logical-axes tuples → tree of spec tuples.  A leaf of
    ``shapes_tree`` is a shape or anything with a ``.shape``."""
    if shapes_tree is None:
        return tree_map(
            lambda axes: logical_to_spec(axes, mesh, rules=rules), axes_tree
        )
    return tree_map(
        lambda axes, shp: logical_to_spec(
            axes, mesh, tuple(getattr(shp, "shape", shp)), rules=rules),
        axes_tree, shapes_tree,
    )


def constrain(x, axes: Axes):
    """Activation sharding constraint by logical axes: the identity on
    one device (the reference's behaviour off a mesh)."""
    return x


_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[object]:
    """Make ``mesh`` (anything with a ``.shape`` mapping from axis name to
    extent) the ambient mesh inside the block; the previous one after."""
    if not hasattr(mesh, "shape"):
        raise TypeError(f"a mesh needs a .shape mapping, got {mesh!r}")
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def get_mesh():
    """The ambient mesh of ``use_mesh``, or ``None``."""
    return _MESH.get()
