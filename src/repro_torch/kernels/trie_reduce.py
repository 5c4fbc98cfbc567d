"""Full-ruleset traversal reduction (the paper's visit-every-rule pass).

``trie_reduce_columns`` returns ``(n_rules, Σ support, max confidence,
Σ confidence)`` as f32 scalars over the nodes at ``depth > 0``, and
``trie_reduce_stats`` the same and the mean ``Σ confidence / max(n, 1)``;
the max is 0 when no node is live, and an empty trie reduces to zeros.

On a CUDA tensor they launch the hand-written kernel in
``csrc/trie_reduce.cu`` (replacing the TPU kernel
``repro.kernels.trie_reduce.trie_reduce_pallas``): one launch over a
persistent grid (``launch_shape``) that streams the three columns in
16-byte loads and folds the blocks' partials in a fixed order in its last
block, so that the sums repeat bitwise; ``ref.trie_reduce_split_ref`` is
that order in plain PyTorch.  On a CPU tensor they run the plain version
``ref.trie_reduce_ref``.

Quantized columns (the compressed layout: int32 support counts, bf16 or
int8 confidence) are loaded in their storage types and widened in
registers with ``dequantize_metrics``'s arithmetic (count times the f32
reciprocal of ``n_transactions``; int8 code times its scale).

What bounds it: memory.  It reads at most 12 bytes per node (support,
confidence, depth) once and does three adds and a max per node.  Count
and max are exact in any order (the count is an int until the end); the
sums reassociate and hold to the plain version within 1e-6 relative.

The grid's blocks an SM (``reduce_blocks_per_sm``) and the most tiles one
block folds alone (``reduce_single_block_tiles``) are launch knobs, read
from ``tuning.get_kernel_config()`` at call time.  Count and max are
bitwise at any value; the sums are bitwise ``ref.trie_reduce_split_ref``'s
at the same block count.
"""
from __future__ import annotations

import torch

from . import _build
from .metrics_inkernel import count_reciprocal, storage_codes
from .ref import trie_reduce_ref
from .tuning import get_kernel_config

# mirrors of csrc/trie_reduce.cu's constants
THREADS = 256         # TR_THREADS: threads a block
TILE_NODES = 16       # TR_TILE_NODES: nodes a thread loads per tile
PARTIAL_BYTES = 16    # a block's partial (count, Σ support, max, Σ conf)

# per (device index, stream): the ticket (16 bytes) and the partials of
# the largest grid yet, zeroed when made; each launch leaves the ticket at
# 0, and a larger grid gets a larger buffer
_scratch = {}


def vector_nodes(confidence_dtype: torch.dtype) -> int:
    """Nodes a vector holds: 16 bytes of the confidence column (4 f32,
    8 bf16, 16 int8), the narrowest column of every storage pair."""
    return 16 // torch.empty((), dtype=confidence_dtype).element_size()


def vector_head(support, confidence, depth) -> tuple:
    """``(head, aligned)``: the first node ``h`` below one vector at which
    all three columns are 16-byte aligned, and ``(0, False)`` when their
    offsets allow none (the kernel then reads every node element by
    element, in the same order); ``head`` is at most the node count."""
    cols = (support, confidence, depth)
    for h in range(vector_nodes(confidence.dtype)):
        if all((c.data_ptr() + h * c.element_size()) % 16 == 0
               for c in cols):
            return min(h, support.shape[0]), True
    return 0, False


def launch_shape(n: int, vec: int, head: int, sms: int) -> dict:
    """The launch for ``n`` nodes, ``vec`` a vector, whole vectors from
    ``head``, on ``sms`` SMs: ``nv`` vectors, ``unroll`` vectors a thread
    a tile (``TILE_NODES`` nodes), ``tiles`` of ``THREADS x unroll``
    vectors and ``blocks``, ``reduce_blocks_per_sm`` an SM and no more
    than there are tiles; one block (which writes the outputs without the
    ticket's round trips) for at most ``reduce_single_block_tiles``."""
    cfg = get_kernel_config()
    nv = (int(n) - int(head)) // int(vec)
    unroll = TILE_NODES // int(vec)
    tiles = -(-nv // (THREADS * unroll))
    blocks = min(cfg.reduce_blocks_per_sm * int(sms), tiles)
    if tiles <= cfg.reduce_single_block_tiles:
        blocks = 1
    return {"nv": nv, "tiles": tiles, "blocks": blocks,
            "threads": THREADS, "unroll": unroll}


def _scratch_for(dev, stream: int, blocks: int) -> torch.Tensor:
    """The ticket and room for ``blocks`` partials on ``stream``: the
    cached buffer, or a larger zeroed one when a grid outgrows it."""
    key = (dev.index, stream)
    buf = _scratch.get(key)
    size = PARTIAL_BYTES * (1 + int(blocks)) // 4
    if buf is None or buf.numel() < size:
        buf = _scratch[key] = torch.zeros((size,), dtype=torch.int32,
                                          device=dev)
    return buf


def trie_reduce_stats(support, confidence, depth, n_transactions: int = 0,
                      confidence_scale: float = 1.0):
    """``(n_rules, Σ support, max confidence, Σ confidence, mean
    confidence)``, f32 scalars; ``support`` f32, int32 counts or bf16,
    ``confidence`` f32, bf16 or int8, ``depth`` int32, one length."""
    dev = support.device
    if _build.interpret_mode(dev):
        n, sup_sum, conf_max, conf_sum = trie_reduce_ref(
            support, confidence, depth, n_transactions, confidence_scale)
        return n, sup_sum, conf_max, conf_sum, conf_sum / n.clamp(min=1.0)
    if dev.type != "cuda":
        raise ValueError(f"trie_reduce_columns: unsupported device {dev}")
    n = support.shape[0]
    if confidence.shape[:1] != (n,) or depth.shape[:1] != (n,):
        raise ValueError(
            f"trie_reduce_columns: support, confidence and depth have "
            f"{n}, {confidence.shape[0]} and {depth.shape[0]} nodes")
    if n >= 1 << 31:
        raise ValueError(f"trie_reduce_columns: {n} nodes, at most 2^31 - 1")
    if n == 0:
        z = torch.zeros((5,), dtype=torch.float32, device=dev)
        return z[0], z[1], z[2], z[3], z[4]
    sup_code, col_code = storage_codes("trie_reduce_columns", support,
                                       confidence, confidence)
    _build.check_inputs(
        "trie_reduce_columns", dev,
        support=(support, support.dtype, 1),
        confidence=(confidence, confidence.dtype, 1),
        depth=(depth, torch.int32, 1),
    )
    head, aligned = vector_head(support, confidence, depth)
    shape = launch_shape(n, vector_nodes(confidence.dtype), head,
                         _build.sm_count(dev))
    stream = _build.stream_handle(dev)
    scratch = _scratch_for(dev, stream, shape["blocks"])
    out = torch.empty((5,), dtype=torch.float32, device=dev)
    err = _build.lib("trie_reduce").trie_reduce_launch(
        support.data_ptr(), confidence.data_ptr(), confidence.data_ptr(),
        sup_code, col_code, count_reciprocal(n_transactions),
        float(confidence_scale), float(confidence_scale), depth.data_ptr(),
        n, head, int(aligned), shape["blocks"], scratch.data_ptr(),
        out.data_ptr(), stream,
    )
    if err != 0:
        # a launch that did not run to its end may leave the ticket set
        _scratch.pop((dev.index, stream), None)
    _build.check(err, "trie_reduce_columns")
    trie_reduce_columns.launches += 1
    return out[0], out[1], out[2], out[3], out[4]


def trie_reduce_columns(support, confidence, depth, n_transactions: int = 0,
                        confidence_scale: float = 1.0):
    """``(n_rules, Σ support, max confidence, Σ confidence)``, f32
    scalars: ``trie_reduce_stats`` without the mean."""
    return trie_reduce_stats(support, confidence, depth, n_transactions,
                             confidence_scale)[:4]


trie_reduce_columns.launches = 0
