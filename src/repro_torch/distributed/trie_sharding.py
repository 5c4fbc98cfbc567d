"""Sharded residency of a frozen trie, and the shard-failure error.

So far this module holds only ``ShardFailure``, the error a failing trie
shard raises and the serve loop's resilience ladder catches
(``serve.resilience``).  The rest of the reference module, the
``ShardPlan`` of contiguous DFS subtree ranges, the sharded ops and
``mask_dead_shards``, is ROADMAP slice 6 (multi-GPU).
"""
from __future__ import annotations

from repro_torch.kernels.ops import TrieQueryError


class ShardFailure(TrieQueryError):
    """A specific trie shard is unhealthy (raised by fault injection or a
    real per-device launch failure).  Deliberately NOT retryable under
    ``kernels.ops.is_retryable``: re-launching on the same sharded
    backend hits the same dead shard; the serve loop's ``ShardHealth``
    handles it by demoting to the replicated backend."""

    def __init__(self, shard: int, message: str = ""):
        self.shard = int(shard)
        super().__init__(
            message or f"shard {self.shard} failed"
        )
