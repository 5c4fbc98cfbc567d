"""Kernels of the batched query path and of trie construction,
hand-written for Hopper, and the ops over them.

- ``rank.topk_rank_batch``          segmented top-k over DFS ranges (CUDA)
- ``rule_search.rule_search_fused`` CSR descent + Eq. 1-4 lift (CUDA)
- ``rule_search.rule_search_span`` the same on the path-compressed layout
  (CUDA)
- ``rule_search.rule_search_sweep`` the full-sweep search of the seed
  layout, without CSR offsets (CUDA)
- ``item_index.rules_with_member``  item-membership top-k (CUDA)
- ``trie_reduce.trie_reduce_columns`` masked traversal reduction (CUDA)
- ``support_count.support_count_bitmap`` itemset support over the vertical
  transaction bitmaps (CUDA)

Each wrapper runs its kernel on CUDA tensors and its plain PyTorch version
(``ref``) on CPU tensors, and counts its kernel launches in a plain
integer attribute ``launches``.  The rank, membership, span-search and
reduction kernels take quantized metric columns and widen them in-kernel.
"""
from .item_index import ROLES, rules_with_member
from .metrics_inkernel import RANK_METRICS
from .rank import topk_rank_batch
from .rule_search import (
    rule_search_fused, rule_search_span, rule_search_sweep,
)
from .support_count import support_count_bitmap
from .trie_reduce import trie_reduce_columns
from .tuning import launch_pad
from .ops import (
    InvalidQueryError,
    TransientBackendError,
    TrieQueryError,
    annotate_candidates,
    bitmaps_from_dense,
    dedup_query_rows,
    dense_from_bitmaps,
    dfs_rank_arrays,
    edge_metric_arrays,
    is_retryable,
    item_rank_arrays,
    members_from_candidates,
    prefix_ranges,
    rule_search,
    rule_search_batch,
    rules_with,
    support_count,
    top_k_rules,
    top_k_rules_batch,
    trie_reduce,
)

KERNELS = {
    "topk_rank_batch": topk_rank_batch,
    "rule_search_fused": rule_search_fused,
    "rule_search_span": rule_search_span,
    "rule_search_sweep": rule_search_sweep,
    "rules_with_member": rules_with_member,
    "trie_reduce_columns": trie_reduce_columns,
    "support_count_bitmap": support_count_bitmap,
}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "RANK_METRICS",
    "ROLES",
    "InvalidQueryError",
    "TransientBackendError",
    "TrieQueryError",
    "annotate_candidates",
    "bitmaps_from_dense",
    "dedup_query_rows",
    "dense_from_bitmaps",
    "dfs_rank_arrays",
    "edge_metric_arrays",
    "is_retryable",
    "item_rank_arrays",
    "launch_counts",
    "launch_pad",
    "members_from_candidates",
    "prefix_ranges",
    "reset_launch_counts",
    "rule_search",
    "rule_search_batch",
    "rules_with",
    "rules_with_member",
    "rule_search_fused",
    "rule_search_span",
    "rule_search_sweep",
    "support_count",
    "support_count_bitmap",
    "top_k_rules",
    "top_k_rules_batch",
    "topk_rank_batch",
    "trie_reduce",
    "trie_reduce_columns",
]
