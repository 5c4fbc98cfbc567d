"""The frozen Trie of Rules: host layout (numpy), device view (torch) and
the tensor oracles, plus the synthetic tries the benches and tests use."""
from .array_trie import (
    DeviceTrie,
    FrozenTrie,
    batched_rule_search,
    bucket_edge_lookup,
    canonical_prefix_rows,
    child_lookup,
    csr_offsets_from_edges,
    dfs_layout,
    item_index_arrays,
    item_tables,
    resolve_device,
    sanitize_query_items,
    top_n_nodes,
    traverse_reduce,
)
from .synthetic import (
    frozen_from_arrays,
    mixed_queries,
    random_csr_trie,
    synthetic_csr_trie,
    synthetic_search_queries,
)

__all__ = [
    "DeviceTrie",
    "FrozenTrie",
    "batched_rule_search",
    "bucket_edge_lookup",
    "canonical_prefix_rows",
    "child_lookup",
    "csr_offsets_from_edges",
    "dfs_layout",
    "frozen_from_arrays",
    "item_index_arrays",
    "item_tables",
    "mixed_queries",
    "random_csr_trie",
    "resolve_device",
    "sanitize_query_items",
    "synthetic_csr_trie",
    "synthetic_search_queries",
    "top_n_nodes",
    "traverse_reduce",
]
