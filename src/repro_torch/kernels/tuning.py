"""Launch knobs of the port's kernels, and the batched-launch row pad.

Defaults only: no tuning table, no autotune.  The reference's TPU knobs
``rank_bn``, ``search_bf``, ``span_bf`` and ``posting_window_edges`` size
VMEM tiles and have no counterpart here; the CUDA kernels fix their own tile sizes at
compile time (``csrc/topk_select.cuh``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    # elements per Triton program in the traversal reduction's first pass
    reduce_block: int = 4096


DEFAULTS = KernelConfig()


def launch_pad(n: int) -> int:
    """Batched-launch row padding: the next power of two."""
    return 1 << max(int(n) - 1, 0).bit_length()
