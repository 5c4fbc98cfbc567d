"""member_roofline_pct (kernels, ``kernels/item_index.py``,
``csrc/item_index.cu``): over the window's ``rules_with`` calls, the
membership kernels' least time (the score's columns at each position the
items' member ranges cover, the posting bounds, k results a query; three
operations a member position; from the reference's counts) over their
device time in the trace, in percent.  Moves ``queries_per_s``."""

from trie_bench.readers import member_launch_work, roofline_pct
from trie_bench.roofline import MEMBER_KERNELS


def read(ctx):
    return roofline_pct(ctx, "rules_with", MEMBER_KERNELS,
                        member_launch_work)
