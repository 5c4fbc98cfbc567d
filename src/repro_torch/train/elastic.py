"""Straggler detection and elastic re-meshing.

PyTorch port of ``repro.train.elastic``.  ``StragglerDetector`` lives in
``distributed.health`` (the serve loop's ``ShardHealth`` runs the same
detector) and is re-exported here.  ``remesh_state`` places a (params,
opt_state) tree onto a mesh by the leaves' logical axes: the recovery
path is checkpoint → remesh → resume.
"""
from __future__ import annotations

import numpy as np
from torch.distributed.tensor import Shard

from repro_torch.distributed.health import StragglerDetector
from repro_torch.distributed.sharding import (
    is_placed,
    logical_to_spec,
    named_sharding,
    place_block,
)
from repro_torch.pytree import tree_map

__all__ = ["StragglerDetector", "remesh_state"]


def _block(full, mesh, placements):
    """This rank's block of ``full`` under ``placements``: each mesh dim
    in order cuts its tensor dim into equal chunks and keeps the rank's
    (DTensor's layout: the first mesh dim outermost)."""
    coord = [mesh.coordinate[a] for a in mesh.axis_names]
    t = full
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and mesh.sizes[i] > 1:
            n = t.shape[p.dim] // mesh.sizes[i]
            t = t.narrow(p.dim, coord[i] * n, n)
    return t


def remesh_state(tree, axes_tree, new_mesh):
    """Re-place every leaf onto ``new_mesh`` with its logical sharding.

    On a process mesh (``launch.mesh.ProcessMesh``) each leaf becomes a
    DTensor placed by ``named_sharding`` of its axes and shape: every
    rank keeps its own block of the full tensor (a host tensor every
    rank holds whole, as a restored checkpoint is, or a DTensor on any
    mesh, gathered whole first) on its device, with no copy where the
    block is the whole leaf on that device.  On a one-device mesh (a
    ``HostMesh``: anything with ``.shape`` and ``.devices``) each leaf
    is whole on that device (a DTensor gathered first)."""
    if hasattr(new_mesh, "device_mesh"):
        dev = new_mesh.device

        def place(x, axes):
            full = x.full_tensor() if is_placed(x) else x
            sharding = named_sharding(tuple(axes), new_mesh,
                                      tuple(full.shape))
            local = _block(full, new_mesh, sharding.placements)
            if local.numel() != full.numel():
                local = local.clone()   # let the whole tensor go
            return place_block(local.to(dev), new_mesh, sharding.spec,
                               full.shape)

        return tree_map(place, tree, axes_tree)

    devices = {str(d) for d in np.asarray(new_mesh.devices,
                                           dtype=object).reshape(-1)}
    if len(devices) != 1:
        raise ValueError(
            f"a mesh over the devices {sorted(devices)} in one process: "
            "several devices take a process mesh (launch.mesh.make_mesh)")
    device = np.asarray(new_mesh.devices, dtype=object).reshape(-1)[0]

    def whole(x, axes):
        if is_placed(x):
            x = x.full_tensor()
        logical_to_spec(tuple(axes), new_mesh, tuple(x.shape))
        return x.to(device)

    return tree_map(whole, tree, axes_tree)
