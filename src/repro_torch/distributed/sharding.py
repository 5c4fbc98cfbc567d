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
``PartitionSpec``.

Placement over a ``torch.distributed`` world: on a
``launch.mesh.ProcessMesh`` (one process a device, a ``DeviceMesh`` with
named dims) ``named_sharding`` gives the reference's ``NamedSharding``:
the spec and its DTensor ``placements``, one ``Shard(d)`` or
``Replicate()`` per mesh dim.  One layout differs from the reference's:
a dim split over several mesh axes (a tuple entry) is chunked
mesh-dim-major by DTensor (the first mesh dim outermost), where the
reference chunks it in the tuple's order.  The two agree whenever the
tuple lists the axes in the mesh's order (``batch`` and ``fsdp``:
``("pod", "data")``); ``seq_kv``'s ``("model", "data", "pod")`` holds the
same values in every shard's shape, but a rank's chunk is another
rank's chunk in the reference.  ``constrain`` redistributes a DTensor to
its logical placements under an ambient process mesh (the identity off
one and on plain tensors).  ``local_block`` is the shard-map view of a
placed tensor: the block a rank computes with, its gradient declared
partial over the axes whose ranks saw other rows; ``Rows`` carries the
batch axes a step's rows are split over and the collectives over them.

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
import dataclasses
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.pytree import tree_map

Axes = Tuple[Optional[str], ...]
Spec = Tuple[object, ...]

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


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (``None``, a name, or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_of(spec: Spec, mesh) -> tuple:
    """One DTensor placement per mesh dim (``mesh.axis_names`` order):
    ``Shard(d)`` where the spec splits dim ``d`` over that axis, else
    ``Replicate()``."""
    out = []
    for axis in mesh.axis_names:
        dims = [d for d, e in enumerate(spec) if axis in entry_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The reference's ``NamedSharding``: a mesh and a spec, with the
    DTensor placements the spec gives on a process mesh."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements_of(self.spec, self.mesh)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """A shard's shape: each dim over the product of its axes'
        extents (which must divide it, as in the reference)."""
        out = []
        for n, entry in zip(shape, tuple(self.spec) + (None,) * len(shape)):
            ext = 1
            for a in entry_axes(entry):
                ext *= self.mesh.shape[a]
            if n % ext:
                raise ValueError(f"dim {n} does not divide over {entry}")
            out.append(n // ext)
        return tuple(out)


def named_sharding(axes: Axes, mesh, shape=None) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(axes, mesh, shape))


def _same_layout(have, want, mesh) -> bool:
    """Whether two placements lay out the same blocks: equal on every
    mesh dim of extent above 1."""
    return all(h == w or n == 1 for h, w, n in zip(have, want, mesh.sizes))


def local_block(x, mesh, spec: Optional[Spec] = None, partial=()):
    """The block of ``x`` a rank computes with under ``spec`` (``None``:
    the whole tensor), as a plain tensor: ``x`` redistributed to
    ``spec``'s placements where its own lay out other blocks, then its
    local tensor.  Its gradient is declared partial over the mesh axes in
    ``partial`` that ``spec`` replicates (their ranks computed on other
    rows, so their gradients sum), and laid out like the block
    elsewhere.  A plain tensor comes back as it is."""
    if not isinstance(x, DTensor):
        return x
    want = placements_of(tuple(spec) if spec is not None
                         else (None,) * x.ndim, mesh)
    if _same_layout(x.placements, want, mesh):
        want = x.placements
    else:
        x = x.redistribute(mesh.device_mesh, want)
    grads = [Partial() if a in partial and isinstance(p, Replicate) else p
             for a, p in zip(mesh.axis_names, want)]
    return x.to_local(grad_placements=grads)


def place_block(local, mesh, spec: Spec, shape=None):
    """``local`` (this rank's block under ``spec``) as a DTensor on
    ``mesh`` (no copy and no collective: every rank passes its own)."""
    shape = tuple(local.shape) if shape is None else tuple(shape)
    return DTensor.from_local(local, mesh.device_mesh,
                              placements_of(spec, mesh), run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


def _contiguous_strides(shape) -> Tuple[int, ...]:
    strides, n = [], 1
    for d in reversed(shape):
        strides.append(n)
        n *= d
    return tuple(reversed(strides))


class _AllReduce(torch.autograd.Function):
    """A sum over process groups, divided by ``div``; its gradient is the
    output's over ``div`` (what flows into each rank's term when every
    rank computes the same thing downstream)."""

    @staticmethod
    def forward(ctx, x, groups, div):
        y = x.clone()
        for g in groups:
            dist.all_reduce(y, group=g)
        ctx.div = div
        return y / div if div != 1 else y

    @staticmethod
    def backward(ctx, g):
        return (g / ctx.div if ctx.div != 1 else g), None, None


class _SumGrads(torch.autograd.Function):
    """The identity whose gradient is summed over process groups: the
    entry of a region whose ranks each add a part of the gradient."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g, None


class _AllGather(torch.autograd.Function):
    """Concatenate the ranks' ``x`` along dim 0 over a group, in rank
    order; the gradient of a rank's block is the sum over the group of
    the gradient at its rows."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.group, ctx.n, ctx.rank = group, n, dist.get_rank(group)
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(ctx.n, 0)[ctx.rank], None


def psum(x, mesh, axes):
    """``lax.psum`` over the mesh ``axes`` (gradient: the identity)."""
    groups = [mesh.group(a) for a in axes if mesh.shape[a] > 1]
    return _AllReduce.apply(x, groups, 1) if groups else x


def pmean(x, mesh, axes):
    """``lax.pmean`` over the mesh ``axes``: the sum over their ranks,
    then over their count (gradient: the output's over the count)."""
    groups = [mesh.group(a) for a in axes if mesh.shape[a] > 1]
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return _AllReduce.apply(x, groups, n) if groups else x


def sum_grads(x, mesh, axes):
    """``x`` unchanged, its gradient summed over the mesh ``axes``."""
    groups = [mesh.group(a) for a in axes if mesh.shape[a] > 1]
    return _SumGrads.apply(x, groups) if groups else x


def all_gather_rows(x, mesh, axes):
    """``lax.all_gather(..., tiled=True)`` along dim 0 over each of
    ``axes`` in turn: the first axis's blocks end innermost."""
    for a in axes:
        if mesh.shape[a] > 1:
            x = _AllGather.apply(x, mesh.group(a))
    return x


def is_placed(x) -> bool:
    return isinstance(x, DTensor)


@dataclasses.dataclass(frozen=True)
class Rows:
    """A step's rows on a process mesh: ``axes`` are the mesh axes its
    batch dim is split over (``logical_to_spec(("batch", ...))``); each
    rank computes on its own rows with whole weights."""

    mesh: Any
    axes: Tuple[str, ...]

    def weight(self, x, spec: Optional[Spec] = None, partial=()):
        """``local_block`` of a placed weight; its gradient is partial
        over the row axes (and ``partial``)."""
        return local_block(x, self.mesh, spec, tuple(self.axes) + tuple(
            partial))

    def tree(self, tree):
        return tree_map(self.weight, tree)

    def sum(self, x):
        """The sum of ``x`` over the ranks' rows (gradient: identity)."""
        return psum(x, self.mesh, self.axes)

    @classmethod
    def of(cls, x, mesh) -> "Rows":
        """The rows of a placed ``x``: its dim 0's mesh axes."""
        return cls(mesh, tuple(a for a, p in zip(mesh.axis_names,
                                                 x.placements)
                               if isinstance(p, Shard) and p.dim == 0))

    def index(self) -> int:
        """This rank's block of rows, counted over ``axes`` in order."""
        i, coord = 0, self.mesh.coordinate
        for a in self.axes:
            i = i * self.mesh.shape[a] + coord[a]
        return i

    @property
    def count(self) -> int:
        n = 1
        for a in self.axes:
            n *= self.mesh.shape[a]
        return n


def constrain(x, axes: Axes):
    """Activation sharding constraint by logical axes: a DTensor under an
    ambient process mesh is redistributed to the placements
    ``logical_to_spec`` gives its shape; off a process mesh, and on a
    plain tensor, the identity (the reference's behaviour off a
    mesh)."""
    mesh = get_mesh()
    if not isinstance(x, DTensor) or not hasattr(mesh, "device_mesh"):
        return x
    spec = logical_to_spec(tuple(axes), mesh, tuple(x.shape))
    return x.redistribute(mesh.device_mesh, placements_of(spec, mesh))


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
