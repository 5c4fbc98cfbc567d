"""Launch helpers of the port: the host mesh (``mesh.make_host_mesh``)
the trainer runs under, the process meshes over a ``torch.distributed``
world (``mesh.ProcessMesh``, ``mesh.make_mesh``), the trie mesh (``mesh.TrieMesh``,
``mesh.make_trie_mesh``) the sharded trie spreads over, the production
meshes (``mesh.make_production_mesh``, devices-free ``AbstractMesh``es),
the training entry point ``train`` (``python -m
repro_torch.launch.train``), the dry run (``dryrun``: one device's
program of a cell on the meta device, its FLOPs, bytes, collectives and
memory; ``specs`` lays out its inputs; ``perf`` re-runs a cell under
config variants), and the card's peaks with the kernel and model
rooflines (``roofline``).  Nothing here
touches CUDA or the environment at import."""
from .mesh import (
    AbstractMesh,
    HostMesh,
    ProcessMesh,
    TrieMesh,
    make_host_mesh,
    make_mesh,
    make_production_mesh,
    make_trie_mesh,
)

__all__ = ["AbstractMesh", "HostMesh", "ProcessMesh", "TrieMesh",
           "make_host_mesh", "make_mesh", "make_production_mesh",
           "make_trie_mesh"]
