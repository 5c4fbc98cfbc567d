"""Meshes in one process: the host mesh the trainer runs under, the
trie mesh a sharded trie spreads over, and the production meshes the
dry run lays a model out on.

``make_production_mesh`` is the counterpart of the reference's: the
single-pod mesh is 16 x 16 = 256 devices ``("data", "model")``, the
multi-pod mesh 2 x 16 x 16 = 512 ``("pod", "data", "model")``, with the
reference's shapes and axis names so that dry-run records line up.  Here
it is an ``AbstractMesh``: axis names and extents, no devices and no CUDA
call; ``distributed.use_mesh`` accepts it and
``distributed.sharding.logical_to_spec`` reads it (the dry run,
``launch/dryrun.py``, counts one device's program under it).

``ProcessMesh`` is a mesh over the ranks of a ``torch.distributed``
world, one process a device: a ``DeviceMesh`` with named dims, read as
the reference reads a ``jax.sharding.Mesh`` (``.shape`` from axis name
to extent, ``.axis_names``, ``.devices``), plus this rank's coordinate
and each axis's process group.  ``distributed.sharding.named_sharding``
places tensors on it as DTensors; ``make_mesh`` builds one over the
initialized world.

``make_host_mesh`` is the PyTorch counterpart of the reference's: with a
process group up, the reference's 1 x n ``("data", "model")`` mesh over
the whole world (rank r on ``cuda:r``, or the CPU under gloo); without
one, a ``HostMesh``: the (1, 1) mesh on one device, which
``distributed.use_mesh`` accepts (a mesh is anything with ``.shape``).

``TrieMesh`` is the counterpart of ``make_trie_mesh`` in
``repro.launch.mesh``.  The
reference's mesh is one controller over one host's local devices, with
``shard_map`` under a single ``jit``; here a ``TrieMesh`` is a tuple of
``torch.device``s along one ``"data"`` axis, and the sharded ops
(``distributed.trie_sharding``) loop over it in one process, launching
each shard's kernels on its own device and merging on the first.  There
is no process group: the reference has no multi-process path either.

A ``TrieMesh`` built directly may name a device more than once:
``TrieMesh(["cpu"] * 8)`` is eight shards on the CPU (each running the
kernels' plain versions), ``TrieMesh(["cuda:0"] * 4)`` four shards on one
card.  ``make_trie_mesh`` takes distinct visible CUDA devices.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.array_trie import resolve_device


def _indexed(device) -> torch.device:
    """``device`` with its index filled in for CUDA (the current device
    when unset), so the shards' tensors compare equal to it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class TrieMesh:
    """A 1-D ``("data",)`` mesh: shard ``d`` lives on ``devices[d]``, and
    ``devices[0]`` is the lead device the shards' answers merge on."""

    axis_names = ("data",)

    def __init__(self, devices: Iterable):
        self.devices: Tuple[torch.device, ...] = tuple(
            _indexed(d) for d in devices
        )
        if not self.devices:
            raise ValueError("a TrieMesh needs at least one device")

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices)}

    @property
    def lead(self) -> torch.device:
        """The device the shards' answers merge on."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"TrieMesh({[str(d) for d in self.devices]})"


def make_trie_mesh(n_shards: Optional[int] = None) -> TrieMesh:
    """A mesh over the first ``n_shards`` visible CUDA devices (every one
    by default): the trie partitions into contiguous DFS subtree ranges,
    one per device; queries replicate, the structure shards."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_shards is None else int(n_shards)
    if not 1 <= n <= count:
        raise ValueError(
            f"n_shards={n} outside [1, {count}] visible devices"
        )
    return TrieMesh([torch.device("cuda", i) for i in range(n)])


class HostMesh:
    """A ``("data", "model")`` mesh of shape (1, 1): ``devices`` is a
    [1, 1] object array holding the one ``torch.device``."""

    axis_names = ("data", "model")

    def __init__(self, device):
        self.devices = np.empty((1, 1), dtype=object)
        self.devices[0, 0] = _indexed(device)

    @property
    def shape(self) -> dict:
        return {"data": 1, "model": 1}

    @property
    def device(self) -> torch.device:
        return self.devices[0, 0]

    def __repr__(self) -> str:
        return f"HostMesh({self.device})"


class AbstractMesh:
    """A mesh of named axes and their extents with no devices behind it
    (the reference's production mesh lowered against placeholder
    devices; ``jax.sharding.AbstractMesh`` is its shape alone)."""

    def __init__(self, axis_sizes: Iterable[int], axis_names: Iterable[str]):
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        sizes = tuple(int(n) for n in axis_sizes)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"{sizes} extents for axes {self.axis_names}")
        self._shape = dict(zip(self.axis_names, sizes))

    @property
    def shape(self) -> dict:
        return dict(self._shape)

    @property
    def size(self) -> int:
        """The number of devices the mesh lays out."""
        return int(np.prod(list(self._shape.values()), dtype=np.int64))

    def __repr__(self) -> str:
        return f"AbstractMesh({self._shape})"


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16 x 16 ``("data", "model")``, or 2 x 16 x 16 ``("pod", "data",
    "model")`` with ``multi_pod``: the ``pod`` axis carries inter-pod data
    parallelism, ``model`` stays inside a pod."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


class ProcessMesh:
    """A mesh of named axes over the ranks of the initialized
    ``torch.distributed`` world: ``device_mesh`` (a ``DeviceMesh`` whose
    dims carry the axis names), ``shape`` (axis name → extent, the
    reference's ``Mesh.shape``), ``axis_names``, ``devices`` (an object
    array of the ``torch.device`` at each coordinate: ``cuda:r`` for rank
    r on CUDA, else the device type), ``device`` (this rank's),
    ``coordinate`` (axis name → this rank's index) and ``group(axis)``
    (the process group along one axis)."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        kind = device_mesh.device_type
        ranks = device_mesh.mesh.cpu().numpy()
        # read once: ``DeviceMesh.mesh`` rebuilds its tensor at each read
        self.sizes: Tuple[int, ...] = tuple(int(n) for n in ranks.shape)
        self.devices = np.empty(ranks.shape, dtype=object)
        for idx, r in np.ndenumerate(ranks):
            self.devices[idx] = _rank_device(kind, int(r))
        self._coordinate = tuple(device_mesh.get_coordinate())

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def coordinate(self) -> dict:
        return dict(zip(self.axis_names, self._coordinate))

    @property
    def device(self) -> torch.device:
        return self.devices[self._coordinate]

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"ProcessMesh({self.shape}, {self.device_mesh.device_type})"


def _rank_device(kind: str, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:r`` (one host, a card a rank), or
    the device type alone (the CPU)."""
    if kind == "cuda":
        return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return torch.device(kind)


def make_mesh(shape: Iterable[int], axes: Iterable[str],
              device_type: str = "cuda") -> ProcessMesh:
    """A ``ProcessMesh`` of ``shape`` with axis names ``axes`` over the
    initialized world (its size must be the product of ``shape``), rank
    r at the r-th coordinate in row-major order; on CUDA each rank takes
    ``cuda:r`` as its current device first."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    if device_type == "cuda":
        torch.cuda.set_device(_rank_device("cuda", dist.get_rank()))
    return ProcessMesh(init_device_mesh(device_type, tuple(shape),
                                        mesh_dim_names=tuple(axes)))


def make_host_mesh(device=None):
    """The reference's 1 x n ``("data", "model")`` mesh over the whole
    initialized world (``make_mesh`` on ``device``'s type), or, with no
    process group up, the degenerate 1 x 1 ``HostMesh`` on ``device``;
    CUDA unless named."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        return make_mesh((1, dist.get_world_size()), ("data", "model"),
                         dev.type)
    return HostMesh(dev)
