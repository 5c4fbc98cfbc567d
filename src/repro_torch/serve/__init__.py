"""Serving: the trie query engine (replicated backend, one device)."""
from .trie_engine import TrieQueryEngine

__all__ = ["TrieQueryEngine"]
