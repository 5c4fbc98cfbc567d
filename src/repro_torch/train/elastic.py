"""Straggler detection and elastic re-meshing.

PyTorch port of ``repro.train.elastic``.  ``StragglerDetector`` lives in
``distributed.health`` (the serve loop's ``ShardHealth`` runs the same
detector) and is re-exported here.  ``remesh_state`` places a (params,
opt_state) tree onto a mesh by the leaves' logical axes: the recovery
path is checkpoint → remesh → resume.  The port runs one device: a mesh
over several devices raises ``NotImplementedError``
(``distributed.sharding.MULTI_GPU``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.distributed.health import StragglerDetector
from repro_torch.distributed.sharding import MULTI_GPU, logical_to_spec
from repro_torch.pytree import tree_map

__all__ = ["StragglerDetector", "remesh_state"]


def remesh_state(tree, axes_tree, new_mesh):
    """Every leaf of ``tree`` on ``new_mesh``'s device, with its logical
    sharding spec computed (``logical_to_spec`` of its axes and shape; on
    a one-device mesh every named mesh axis has extent 1, so each leaf is
    whole).  ``new_mesh`` is a ``launch.mesh.HostMesh`` (anything with
    ``.shape`` and ``.devices``)."""
    devices = {str(d) for d in np.asarray(new_mesh.devices,
                                           dtype=object).reshape(-1)}
    if len(devices) != 1:
        raise NotImplementedError(
            f"remesh onto the devices {sorted(devices)}: the port places "
            f"state on one device: {MULTI_GPU}")
    device = np.asarray(new_mesh.devices, dtype=object).reshape(-1)[0]

    def place(x, axes):
        logical_to_spec(tuple(axes), new_mesh, tuple(x.shape))
        return x.to(device)

    return tree_map(place, tree, axes_tree)
