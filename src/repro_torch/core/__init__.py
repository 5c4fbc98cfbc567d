"""Core library — the paper's contribution (Trie of Rules) in three forms:

- ``TrieOfRules``   paper-faithful pointer trie (the parity oracle),
- ``FlatRuleTable`` dataframe stand-in comparator (the paper's baseline),
- ``FrozenTrie``    the flat SoA/CSR/DFS encoding: host layout (numpy),
  device view (torch) and the tensor oracles,

the array-native builder and the three-step pipeline over them, plus the
synthetic tries the benches and tests use.
"""
from .metrics import Rule, RuleMetrics, compound_confidence
from .trie import TrieNode, TrieOfRules
from .flat_table import FlatRuleTable
from .array_trie import (
    AUTO_COMPRESS_SPAN_FRACTION,
    CompressedTrie,
    DeviceTrie,
    FrozenTrie,
    batched_rule_search,
    bucket_edge_lookup,
    canonical_prefix_rows,
    chain_spans,
    child_lookup,
    compress_pos_space,
    compressed_descend,
    compressed_step,
    csr_offsets_from_edges,
    dfs_layout,
    item_index_arrays,
    item_tables,
    quantize_metric_columns,
    resolve_device,
    sanitize_query_items,
    top_n_nodes,
    traverse_reduce,
)
from .build_arrays import (
    build_frozen_trie,
    canonicalize_matrix,
    pack_sequences,
    trie_arrays,
)
from .builder import BuildResult, build_flat_table, build_trie_of_rules
from .synthetic import (
    frozen_from_arrays,
    mixed_queries,
    random_csr_trie,
    synthetic_chain_trie,
    synthetic_csr_trie,
    synthetic_search_queries,
)

__all__ = [
    "AUTO_COMPRESS_SPAN_FRACTION",
    "BuildResult",
    "CompressedTrie",
    "DeviceTrie",
    "FlatRuleTable",
    "FrozenTrie",
    "Rule",
    "RuleMetrics",
    "TrieNode",
    "TrieOfRules",
    "batched_rule_search",
    "bucket_edge_lookup",
    "build_flat_table",
    "build_frozen_trie",
    "build_trie_of_rules",
    "canonical_prefix_rows",
    "canonicalize_matrix",
    "chain_spans",
    "child_lookup",
    "compound_confidence",
    "compress_pos_space",
    "compressed_descend",
    "compressed_step",
    "csr_offsets_from_edges",
    "dfs_layout",
    "frozen_from_arrays",
    "item_index_arrays",
    "item_tables",
    "mixed_queries",
    "pack_sequences",
    "quantize_metric_columns",
    "random_csr_trie",
    "resolve_device",
    "sanitize_query_items",
    "synthetic_chain_trie",
    "synthetic_csr_trie",
    "synthetic_search_queries",
    "top_n_nodes",
    "traverse_reduce",
    "trie_arrays",
]
