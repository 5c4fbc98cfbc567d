"""The batched-launch row pad.

No tuning table, no autotune.  The reference's TPU knobs ``rank_bn``,
``reduce_bn``, ``search_bf``, ``span_bf`` and ``posting_window_edges`` size
VMEM tiles and have no counterpart here; the CUDA kernels fix their own
tile sizes at compile time and their wrappers size the grids
(``rank.launch_shape``, ``trie_reduce.launch_shape``, ...).
"""
from __future__ import annotations


def launch_pad(n: int) -> int:
    """Batched-launch row padding: the next power of two."""
    return 1 << max(int(n) - 1, 0).bit_length()
