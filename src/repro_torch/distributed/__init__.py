"""Distributed pieces of the port: the sharded trie of ``trie_sharding``
(``shard_device_trie`` cuts a frozen trie into contiguous DFS subtree
ranges over a ``launch.mesh.TrieMesh``; the batched ops answer a
``ShardPlan`` bitwise like one device; ``mask_dead_shards`` answers
around dead shards), the int8 column encoding of ``compression`` (the
compressed layout quantizes its confidence and lift columns with it) and
the serve loop's ``health`` signals, and the LM side's logical-axis
rules of ``sharding`` (``logical_to_spec`` with its divisibility
fallback, ``shard_params_specs``, and ``constrain``, the identity on one
device)."""
from .sharding import (
    LOGICAL_RULES,
    SERVING_RULES,
    constrain,
    logical_to_spec,
    shard_params_specs,
)
from .trie_sharding import (
    ShardedDeviceTrie,
    ShardFailure,
    ShardPlan,
    TrieShard,
    hub_child_buckets,
    mask_dead_shards,
    plan_shard_bounds,
    shard_device_trie,
    shard_dfs_ranges,
)

__all__ = [
    "LOGICAL_RULES",
    "SERVING_RULES",
    "constrain",
    "logical_to_spec",
    "shard_params_specs",
    "ShardFailure",
    "ShardPlan",
    "ShardedDeviceTrie",
    "TrieShard",
    "hub_child_buckets",
    "mask_dead_shards",
    "plan_shard_bounds",
    "shard_device_trie",
    "shard_dfs_ranges",
]
