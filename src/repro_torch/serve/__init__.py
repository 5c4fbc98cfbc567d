"""Serving: the LM's prefill/decode steps (``engine``) and trie-backed
speculative decoding (``spec_decode``), the trie query engine (replicated
on one device, or sharded over a ``launch.mesh.TrieMesh``) and the
resilient continuous-batching serve loop (scheduler / resilience /
faults)."""
from .engine import make_decode_step, make_prefill_step
from .faults import FaultInjector, FaultyEngine, zipfian_workload
from .resilience import (
    MonotonicClock,
    ResilientTrieEngine,
    RetryPolicy,
    ShardHealth,
    VirtualClock,
    retry_call,
)
from .scheduler import (
    STAT_KEYS,
    LaunchPredictor,
    QueueFull,
    Request,
    Response,
    TrieScheduler,
)
from .trie_engine import TrieQueryEngine, make_trie_engine

__all__ = [
    "make_decode_step",
    "make_prefill_step",
    "TrieQueryEngine",
    "make_trie_engine",
    "TrieScheduler",
    "QueueFull",
    "Request",
    "Response",
    "LaunchPredictor",
    "STAT_KEYS",
    "ResilientTrieEngine",
    "RetryPolicy",
    "ShardHealth",
    "VirtualClock",
    "MonotonicClock",
    "retry_call",
    "FaultInjector",
    "FaultyEngine",
    "zipfian_workload",
]
