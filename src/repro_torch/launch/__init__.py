"""Launch helpers of the port: the trie mesh (``mesh.TrieMesh``,
``mesh.make_trie_mesh``) the sharded trie spreads over."""
from .mesh import TrieMesh, make_trie_mesh

__all__ = ["TrieMesh", "make_trie_mesh"]
