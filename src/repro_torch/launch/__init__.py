"""Launch helpers of the port: the host mesh (``mesh.make_host_mesh``)
the trainer runs under, the trie mesh (``mesh.TrieMesh``,
``mesh.make_trie_mesh``) the sharded trie spreads over, the training
driver ``train`` (``python -m repro_torch.launch.train``) and the card's
peaks with a kernel's roofline (``roofline``)."""
from .mesh import HostMesh, TrieMesh, make_host_mesh, make_trie_mesh

__all__ = ["HostMesh", "TrieMesh", "make_host_mesh", "make_trie_mesh"]
