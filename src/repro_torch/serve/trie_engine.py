"""Trie query serving: one front door over a frozen trie on one device.

PyTorch port of ``repro.serve.trie_engine.TrieQueryEngine``, replicated
backend only: the whole trie lives on one device, uploaded once, with the
gathered column dicts memoized, and the batched ops route to
``kernels.ops``.  The sharded backend is ROADMAP slice 6, streaming tries
slice 4, and request tracing slice 5.
"""
from __future__ import annotations

from typing import Dict, Sequence

from repro_torch.core.array_trie import FrozenTrie, resolve_device
from repro_torch.kernels import ops as trie_ops


class TrieQueryEngine:
    """Serving front door for one frozen Trie of Rules."""

    def __init__(self, frozen: FrozenTrie, device=None):
        if not isinstance(frozen, FrozenTrie):
            raise NotImplementedError(
                f"TrieQueryEngine serves a FrozenTrie; "
                f"{type(frozen).__name__} (streaming tries are ROADMAP "
                f"slice 4) is not supported yet"
            )
        self.frozen = frozen
        self.device = resolve_device(device)
        self.dt = frozen.device_arrays(device=self.device)
        self._edges = None
        self._dfs_arrays = None
        self._item_arrays = None

    def rule_search_batch(self, queries, ant_len=None) -> Dict:
        if self._edges is None:
            self._edges = trie_ops.edge_metric_arrays(self.dt)
        # the FrozenTrie keeps ragged-pair canonicalization host-side
        return trie_ops.rule_search_batch(
            self.frozen, queries, ant_len, edges=self._edges
        )

    def top_k_rules_batch(self, prefixes, k: int,
                          metric: str = "confidence",
                          min_depth: int = 1) -> Dict:
        if self._dfs_arrays is None:
            self._dfs_arrays = trie_ops.dfs_rank_arrays(self.dt)
            self._dfs_arrays["_device_trie"] = self.dt
        return trie_ops.top_k_rules_batch(
            self.frozen, prefixes, k, metric=metric, min_depth=min_depth,
            arrays=self._dfs_arrays,
        )

    def rules_with(self, items: Sequence[int], role: str = "any",
                   k: int = 10, metric: str = "confidence",
                   min_depth: int = 1) -> Dict:
        if self._item_arrays is None:
            self._item_arrays = trie_ops.item_rank_arrays(self.dt)
        return trie_ops.rules_with(
            self.frozen, items, role=role, k=k, metric=metric,
            min_depth=min_depth, arrays=self._item_arrays,
        )

    def trie_reduce(self) -> Dict:
        return trie_ops.trie_reduce(self.dt)

