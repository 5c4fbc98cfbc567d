"""Kernels of the batched query path, hand-written for Hopper, and the ops
over them.

- ``rank.topk_rank_batch``          segmented top-k over DFS ranges (CUDA)
- ``rule_search.rule_search_fused`` CSR descent + Eq. 1-4 lift (CUDA)
- ``item_index.rules_with_member``  item-membership top-k (CUDA)
- ``trie_reduce.trie_reduce_columns`` masked traversal reduction (Triton)

Each wrapper runs its kernel on CUDA tensors and its plain PyTorch version
(``ref``) on CPU tensors, and counts its kernel launches in a plain
integer attribute ``launches``.
"""
from .item_index import ROLES, rules_with_member
from .metrics_inkernel import RANK_METRICS
from .rank import topk_rank_batch
from .rule_search import rule_search_fused
from .trie_reduce import trie_reduce_columns
from .tuning import KernelConfig, launch_pad
from .ops import (
    InvalidQueryError,
    TransientBackendError,
    TrieQueryError,
    dedup_query_rows,
    dfs_rank_arrays,
    edge_metric_arrays,
    is_retryable,
    item_rank_arrays,
    prefix_ranges,
    rule_search,
    rule_search_batch,
    rules_with,
    top_k_rules,
    top_k_rules_batch,
    trie_reduce,
)

KERNELS = {
    "topk_rank_batch": topk_rank_batch,
    "rule_search_fused": rule_search_fused,
    "rules_with_member": rules_with_member,
    "trie_reduce_columns": trie_reduce_columns,
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
    "KernelConfig",
    "TransientBackendError",
    "TrieQueryError",
    "dedup_query_rows",
    "dfs_rank_arrays",
    "edge_metric_arrays",
    "is_retryable",
    "item_rank_arrays",
    "launch_counts",
    "launch_pad",
    "prefix_ranges",
    "reset_launch_counts",
    "rule_search",
    "rule_search_batch",
    "rules_with",
    "rules_with_member",
    "rule_search_fused",
    "top_k_rules",
    "top_k_rules_batch",
    "topk_rank_batch",
    "trie_reduce",
    "trie_reduce_columns",
]
