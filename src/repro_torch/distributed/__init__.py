"""Distributed pieces of the port: the sharded trie of ``trie_sharding``
(``shard_device_trie`` cuts a frozen trie into contiguous DFS subtree
ranges over a ``launch.mesh.TrieMesh``; the batched ops answer a
``ShardPlan`` bitwise like one device; ``mask_dead_shards`` answers
around dead shards), the int8 encoding of ``compression`` (the compressed
layout quantizes its confidence and lift columns with it; the trainer's
error-feedback gradient compressor and ``compressed_psum`` too) and
the serve loop's ``health`` signals, and the LM side's logical-axis
rules of ``sharding`` (``logical_to_spec`` with its divisibility
fallback, ``shard_params_specs``, ``named_sharding`` and ``constrain``,
which place and redistribute DTensors on a process mesh, and the
ambient mesh of ``use_mesh`` / ``get_mesh``)."""
from .sharding import (
    LOGICAL_RULES,
    SERVING_RULES,
    NamedSharding,
    constrain,
    get_mesh,
    logical_to_spec,
    named_sharding,
    shard_params_specs,
    use_mesh,
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
    "NamedSharding",
    "constrain",
    "get_mesh",
    "logical_to_spec",
    "named_sharding",
    "shard_params_specs",
    "use_mesh",
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
