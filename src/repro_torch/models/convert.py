"""Carry the reference's parameters, caches and optimizer states into
the port.

The reference's random init cannot be re-derived from a seed in another
process (it folds ``hash(name)`` into its keys), so the port is held to
the reference on the reference's own weights: take its tree with numpy
leaves (``jax.tree.map(np.asarray, params)``) and rebuild it here as
torch tensors.  The two trees have one structure, leaf for leaf.  bf16
leaves (numpy's ``bfloat16`` from ``ml_dtypes``) keep their bits, and
every leaf keeps its dtype: Mamba's float32 ``a_log``, ``dt_bias`` and
``d_skip`` beside bf16 params, its bf16 conv windows beside its float32
``ssm`` state in a cache.  Optimizer states (AdamW's ``m`` / ``v``,
Adafactor's ``vr`` / ``vc`` / ``v``) cross the same way, against the
port optimizer's own ``init`` of the config's shapes.  With ``mesh=`` (a
``launch.mesh.ProcessMesh``) each tree comes back placed by
``named_sharding`` of its logical axes (``train.elastic.remesh_state``),
each rank holding its blocks on its own device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.array_trie import resolve_device
from repro_torch.pytree import tree_map
from .model import abstract_params, cache_axes


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tree_from_numpy(like, tree, device=None):
    """``tree`` (numpy leaves, ``like``'s structure) as tensors on
    ``device`` (CUDA unless named).  Raises if a leaf's shape or dtype
    differs from ``like``'s (meta tensors will do)."""
    dev = resolve_device(device)

    def leaf(want, got):
        t = _tensor(got, dev)
        if tuple(t.shape) != tuple(want.shape) or t.dtype != want.dtype:
            raise ValueError(
                f"leaf {tuple(t.shape)} {t.dtype} where the config has "
                f"{tuple(want.shape)} {want.dtype}")
        return t

    return tree_map(leaf, like, tree)


def _placed(tree, axes, mesh):
    if mesh is None:
        return tree
    from repro_torch.train.elastic import remesh_state

    return remesh_state(tree, axes, mesh)


def _device(device, mesh):
    return mesh.device if device is None and mesh is not None else device


def params_from_numpy(cfg, tree, device=None, mesh=None):
    """The reference's parameter tree (numpy leaves) as the port's, on
    ``device`` (CUDA unless named; a process mesh's rank's device),
    checked against ``abstract_params(cfg)``, placed on ``mesh`` when
    given."""
    like, axes = abstract_params(cfg)
    return _placed(tree_from_numpy(like, tree, _device(device, mesh)), axes,
                   mesh)


def opt_state_from_numpy(cfg, optimizer, tree, device=None, mesh=None):
    """The reference's optimizer state for ``cfg`` (numpy leaves) as the
    port's ``optimizer`` (``train.AdamW`` or ``train.Adafactor``) keeps
    it, checked against ``optimizer.init`` of the config's shapes, placed
    on ``mesh`` (by ``optimizer.state_axes``) when given."""
    like, axes = abstract_params(cfg)
    state = tree_from_numpy(optimizer.init(like), tree, _device(device, mesh))
    return _placed(state, optimizer.state_axes(axes), mesh)


def cache_from_numpy(cfg, tree, device=None, mesh=None):
    """A reference decode cache (numpy leaves) as the port's, on
    ``device``; each leaf's rank must match ``cache_axes(cfg)``; placed
    on ``mesh`` when given."""
    dev = resolve_device(_device(device, mesh))

    def leaf(axes, got):
        t = _tensor(got, dev)
        if t.ndim != len(axes):
            raise ValueError(f"cache leaf of rank {t.ndim} where the "
                             f"config has axes {axes}")
        return t

    return _placed(tree_map(leaf, cache_axes(cfg), tree), cache_axes(cfg),
                   mesh)
