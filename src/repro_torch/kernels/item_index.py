"""Item-scoped top-k over the item-inverted index.

``rules_with_member`` answers Q item queries in one call: the top-k rules
involving each item, by role -- ``"consequent"`` (the node's own item),
``"antecedent"`` (a strict ancestor carries it) or ``"any"``.  Ancestor
membership is the laminar range count over the item's posting slice,

    |{u : post_lo[u] <= p}| - |{u : post_hi[u] <= p}|,

two binary searches per DFS position, never a path walk.  Rows follow
``jax.lax.top_k`` order with ``(-inf, -1)`` empty slots; an absent item is
an empty slice ``plos[q] == phis[q]`` plus an item id no node carries.

On a CUDA tensor it launches the hand-written kernel in
``csrc/item_index.cu`` (replacing the TPU kernel
``repro.kernels.item_index.rules_with_pallas``); on a CPU tensor it runs
the plain version ``ref.rules_with_ref``.  Quantized metric columns (the
compressed layout) widen in the kernel's score pass, as in ``rank``.
"""
from __future__ import annotations

import torch

from . import _build
from .metrics_inkernel import metric_index
from .rank import TILE, _scratch, chunking, metric_column_args
from .ref import _empty_ranked, rules_with_ref

ROLES = ("consequent", "antecedent", "any")


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
    if dev.type == "cpu":
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
    n_chunks, per_chunk, kk = chunking(q, -(-n // TILE), k)
    sc, ka, va, kb, vb, cap = _scratch(n, q, n_chunks, kk, k, dev)
    vals = torch.empty((q, k), dtype=torch.float32, device=dev)
    pos = torch.empty((q, k), dtype=torch.int32, device=dev)
    err = _build.lib("item_index").rules_with_launch(
        *columns, depth.data_ptr(), node_item.data_ptr(), n,
        post_lo.data_ptr(), post_hi.data_ptr(),
        plos.data_ptr(), phis.data_ptr(), items.data_ptr(),
        q, k, metric_index(metric), int(min_depth), ROLES.index(role),
        n_chunks, per_chunk, sc.data_ptr(),
        ka.data_ptr(), va.data_ptr(), kb.data_ptr(), vb.data_ptr(), cap,
        vals.data_ptr(), pos.data_ptr(), _build.stream_handle(dev),
    )
    _build.check(err, "rules_with_member")
    rules_with_member.launches += 1
    return vals, pos


rules_with_member.launches = 0
