"""Data pipeline of the port (copies of ``repro.data``): tokenization,
packing, deterministic sharded batches, and ARM over a corpus (the
paper's structure as a data feature, and the ``NgramTrie`` proposer of
speculative decoding).
"""
from .tokenizer import ByteTokenizer
from .pipeline import PipelineConfig, TokenPipeline, synthetic_corpus
from .corpus_rules import NgramTrie, mine_corpus_rules

__all__ = [
    "ByteTokenizer",
    "PipelineConfig",
    "TokenPipeline",
    "synthetic_corpus",
    "NgramTrie",
    "mine_corpus_rules",
]
