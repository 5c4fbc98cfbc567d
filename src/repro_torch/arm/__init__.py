"""Association-rule-mining substrate (paper Step 1).

Transaction encoding, frequent-itemset miners (Apriori, FP-growth, FP-max)
and rule generation: a copy of ``repro.arm``.  The support-counting hot
loop runs on the GPU as the hand-written CUDA kernel
``repro_torch.kernels.support_count`` over the bitmap layout defined here.
"""
from .transactions import TransactionDB
from .fpgrowth import fpgrowth, fpmax
from .apriori import apriori
from .rulegen import prefix_split_rules, canonical_sequences

__all__ = [
    "TransactionDB",
    "fpgrowth",
    "fpmax",
    "apriori",
    "prefix_split_rules",
    "canonical_sequences",
]
