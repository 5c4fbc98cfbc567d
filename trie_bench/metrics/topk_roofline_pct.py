"""topk_roofline_pct (kernels, ``kernels/rank.py``, ``csrc/rank.cu``,
``csrc/topk_select.cuh``): over the window's ``top_k_rules_batch`` calls,
the rank kernels' least time (bytes at the HBM bandwidth or operations at
the float32 rate, whichever is larger, counted from the reference's
subtree ranges of each call's distinct prefixes) over their device time in
the trace, in percent.  Moves ``queries_per_s``."""

from trie_bench.readers import roofline_pct, topk_launch_work
from trie_bench.roofline import RANK_KERNELS


def read(ctx):
    return roofline_pct(ctx, "top_k", RANK_KERNELS, topk_launch_work)
