"""Carry the reference's parameters and caches into the port.

The reference's random init cannot be re-derived from a seed in another
process (it folds ``hash(name)`` into its keys), so the port is held to
the reference on the reference's own weights: take its tree with numpy
leaves (``jax.tree.map(np.asarray, params)``) and rebuild it here as
torch tensors.  The two trees have one structure, leaf for leaf.  bf16
leaves (numpy's ``bfloat16`` from ``ml_dtypes``) keep their bits.
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


def params_from_numpy(cfg, tree, device=None):
    """The reference's parameter tree (numpy leaves) as the port's, on
    ``device`` (CUDA unless named).  Raises if a leaf's shape or dtype
    differs from ``abstract_params(cfg)``."""
    dev = resolve_device(device)

    def leaf(want, got):
        t = _tensor(got, dev)
        if tuple(t.shape) != tuple(want.shape) or t.dtype != want.dtype:
            raise ValueError(
                f"leaf {tuple(t.shape)} {t.dtype} where the config has "
                f"{tuple(want.shape)} {want.dtype}")
        return t

    return tree_map(leaf, abstract_params(cfg)[0], tree)


def cache_from_numpy(cfg, tree, device=None):
    """A reference decode cache (numpy leaves) as the port's, on
    ``device``; each leaf's rank must match ``cache_axes(cfg)``."""
    dev = resolve_device(device)

    def leaf(axes, got):
        t = _tensor(got, dev)
        if t.ndim != len(axes):
            raise ValueError(f"cache leaf of rank {t.ndim} where the "
                             f"config has axes {axes}")
        return t

    return tree_map(leaf, cache_axes(cfg), tree)
