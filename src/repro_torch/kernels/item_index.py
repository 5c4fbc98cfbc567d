"""Item-scoped top-k over the item-inverted index.

``rules_with_member`` answers Q item queries in one call: the top-k rules
involving each item, by role -- ``"consequent"`` (the node's own item),
``"antecedent"`` (a strict ancestor carries it) or ``"any"``.  The plain
version tests membership per DFS position with the laminar range count
over the item's posting slice,

    |{u : post_lo[u] <= p}| - |{u : post_hi[u] <= p}|,

never a path walk.  Rows follow ``jax.lax.top_k`` order with ``(-inf,
-1)`` empty slots; an absent item is an empty slice ``plos[q] == phis[q]``
plus an item id no node carries.

On a CUDA tensor it launches the hand-written kernel in
``csrc/item_index.cu`` (replacing the TPU kernel
``repro.kernels.item_index.rules_with_pallas``), which reads only each
query's members, in the closed form of ``ref.member_ranges_ref``: the
outermost posting ranges (antecedent, any) or the postings themselves
(consequent).  On a CPU tensor it runs the plain version
``ref.rules_with_ref``.  Quantized metric columns (the compressed layout)
widen in the kernel's score pass, as in ``rank``.  Its selection grid
(``select_work_blocks``) and the fewest tiles a block of its top-k pass
takes (``member_min_tiles``) are launch knobs, read from
``tuning.get_kernel_config()`` at call time (``launch_shape``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .metrics_inkernel import metric_index
from .rank import (
    TILE, metric_column_args, scratch, selection_grid, selection_lists,
)
from .ref import _empty_ranked, rules_with_ref
from .tuning import DEFAULTS, get_kernel_config

ROLES = ("consequent", "antecedent", "any")
POSTING_CHUNK = 2048  # postings per block of the range pass (item_index.cu)
# the default of member_min_tiles (tuning.DEFAULTS): the fewest tiles of
# candidates a block of the top-k pass takes (its grid is
# rank.selection_grid's), since a block's first tile sorts every candidate
# it admits and later ones only those that beat the query's running k-th
# key
MIN_TILES = DEFAULTS.member_min_tiles


def launch_shape(q: int, k: int) -> dict:
    """The top-k pass of ``q`` item queries at ``k``: the selection grid
    (``rank.selection_grid``), the fewest tiles a block takes and the
    int32 words of its plan scratch (a first block, a block count and a
    finished count a query, then a query a block)."""
    work_blocks, grid = selection_grid(q, k)
    return {"work_blocks": work_blocks, "grid": grid,
            "min_tiles": get_kernel_config().member_min_tiles,
            "plan_words": 3 * q + grid}


def rules_with_member(
    support, confidence, lift, depth, node_item, post_lo, post_hi,
    plos, phis, items,
    *, k: int, metric: str = "confidence", min_depth: int = 1,
    role: str = "any", n_transactions: int = 0,
    confidence_scale: float = 1.0, lift_scale: float = 1.0,
):
    """Top-k (scores, DFS positions) of the rules involving each queried
    item: ``(f32[Q, k], int32[Q, k])``."""
    if role not in ROLES:
        raise ValueError(f"role {role!r} not in {ROLES}")
    dev = support.device
    dequant = dict(n_transactions=n_transactions,
                   confidence_scale=confidence_scale, lift_scale=lift_scale)
    if _build.interpret_mode(dev):
        return rules_with_ref(
            support, confidence, lift, depth, node_item, post_lo, post_hi,
            plos, phis, items, k=k, metric=metric, min_depth=min_depth,
            role=role, **dequant,
        )
    if dev.type != "cuda":
        raise ValueError(f"rules_with_member: unsupported device {dev}")
    n, q, k = support.shape[0], plos.shape[0], int(k)
    if n == 0 or k <= 0 or q == 0:
        return _empty_ranked(q, k, dev)
    plos = plos.to(torch.int32).contiguous()
    phis = phis.to(torch.int32).contiguous()
    items = items.to(torch.int32).contiguous()
    _build.check_inputs(
        "rules_with_member", dev,
        support=(support, support.dtype, 1),
        confidence=(confidence, confidence.dtype, 1),
        lift=(lift, lift.dtype, 1), depth=(depth, torch.int32, 1),
        node_item=(node_item, torch.int32, 1),
        post_lo=(post_lo, torch.int32, 1), post_hi=(post_hi, torch.int32, 1),
        plos=(plos, torch.int32, 1), phis=(phis, torch.int32, 1),
        items=(items, torch.int32, 1),
    )
    columns = metric_column_args("rules_with_member", support, confidence,
                                 lift, **dequant)
    # the host lays out the range pass from the slice lengths: each query's
    # range slots, and the posting chunks of every slice
    bounds = torch.stack([plos, phis]).cpu().numpy().astype(np.int64)
    lens = np.maximum(bounds[1] - bounds[0], 0)
    if int(lens.sum()) >= 2**31:
        raise ValueError("rules_with_member: posting slices over 2^31")
    chunks = np.zeros_like(lens) if role == "consequent" else \
        -(-lens // POSTING_CHUNK)
    meta = torch.from_numpy(np.concatenate([
        np.cumsum(lens) - lens, np.cumsum(chunks) - chunks,
        np.repeat(np.arange(q), chunks),
    ]).astype(np.int32)).to(dev)
    shape = launch_shape(q, k)
    # held here until the launch returns: the C side takes raw pointers
    n_chunks, slots = int(chunks.sum()), int(lens.sum())
    bufs = [
        scratch(n_chunks, torch.int32, dev),
        scratch(n_chunks, torch.int64, dev),
        scratch(slots, torch.int32, dev), scratch(slots, torch.int32, dev),
        scratch(2 * q, torch.int32, dev),
        scratch(shape["plan_words"], torch.int32, dev),
        scratch(q, torch.int64, dev),
    ]
    lists = [
        scratch(n, torch.float32, dev),
        scratch(-(-n // TILE), torch.int64, dev),
        *selection_lists(shape["grid"], k, dev),
    ]
    vals = torch.empty((q, k), dtype=torch.float32, device=dev)
    pos = torch.empty((q, k), dtype=torch.int32, device=dev)
    err = _build.lib("item_index").rules_with_launch(
        *columns, depth.data_ptr(), node_item.data_ptr(), n,
        post_lo.data_ptr(), post_hi.data_ptr(),
        plos.data_ptr(), phis.data_ptr(), items.data_ptr(),
        q, k, metric_index(metric), int(min_depth), ROLES.index(role),
        meta.data_ptr(), n_chunks, *[b.data_ptr() for b in bufs],
        shape["min_tiles"], shape["work_blocks"],
        *[b.data_ptr() for b in lists],
        vals.data_ptr(), pos.data_ptr(), _build.stream_handle(dev),
    )
    _build.check(err, "rules_with_member")
    rules_with_member.launches += 1
    return vals, pos


rules_with_member.launches = 0
