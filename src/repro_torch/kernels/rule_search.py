"""Batched Trie-of-Rules descent with full paper metrics (the search op).

``rule_search_fused`` walks each canonical query row root-down through
the CSR child buckets (node ``p``'s edges are ``[child_offsets[p],
child_offsets[p+1])``, item-sorted), runs the root-anchored
consequent-only walk in the same pass, and selects the Eq. 1-4 compound
lift.  Metrics ride on the edges (the child node's columns gathered once,
``ops.edge_metric_arrays``).

On a CUDA tensor it launches the hand-written kernel in
``csrc/rule_search.cu`` (replacing the TPU kernel
``repro.kernels.rule_search.rule_search_fused_pallas``); on a CPU tensor it
runs the plain version ``ref.rule_search_fused_ref``.  The seed
full-sweep kernel and the compressed-layout span kernel are later slices.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import _build
from .ref import not_found, rule_search_fused_ref


def rule_search_fused(
    child_offsets, edge_item, edge_child, edge_conf, edge_sup, edge_lift,
    queries, ant_len, max_fanout: int = 0,
) -> Dict[str, torch.Tensor]:
    """found bool, node int32, confidence/support/lift/con_support f32,
    all ``[Q]``, for int32 ``queries[Q, L]`` (-1 padded) and
    ``ant_len[Q]``."""
    dev = queries.device
    if dev.type == "cpu":
        return rule_search_fused_ref(
            child_offsets, edge_item, edge_child, edge_conf, edge_sup,
            edge_lift, queries, ant_len, max_fanout,
        )
    if dev.type != "cuda":
        raise ValueError(f"rule_search_fused: unsupported device {dev}")
    q, width = queries.shape
    if edge_item.shape[0] == 0 or width == 0 or q == 0:
        return not_found(q, dev)
    queries = queries.to(torch.int32).contiguous()
    ant_len = ant_len.to(torch.int32).contiguous()
    _build.check_inputs(
        "rule_search_fused", dev,
        child_offsets=(child_offsets, torch.int32, 1),
        edge_item=(edge_item, torch.int32, 1),
        edge_child=(edge_child, torch.int32, 1),
        edge_conf=(edge_conf, torch.float32, 1),
        edge_sup=(edge_sup, torch.float32, 1),
        edge_lift=(edge_lift, torch.float32, 1),
        queries=(queries, torch.int32, 2), ant_len=(ant_len, torch.int32, 1),
    )
    if ant_len.shape[0] != q:
        raise ValueError("rule_search_fused: ant_len must have Q entries")
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    node, found = torch.empty((q,), **i32), torch.empty((q,), **i32)
    conf, sup = torch.empty((q,), **f32), torch.empty((q,), **f32)
    lift, con_sup = torch.empty((q,), **f32), torch.empty((q,), **f32)
    err = _build.lib("rule_search").rule_search_fused_launch(
        child_offsets.data_ptr(), edge_item.data_ptr(),
        edge_child.data_ptr(), edge_conf.data_ptr(), edge_sup.data_ptr(),
        edge_lift.data_ptr(), queries.data_ptr(), ant_len.data_ptr(),
        q, width, node.data_ptr(), found.data_ptr(), conf.data_ptr(),
        sup.data_ptr(), lift.data_ptr(), con_sup.data_ptr(),
        _build.stream_handle(dev),
    )
    _build.check(err, "rule_search_fused")
    rule_search_fused.launches += 1
    return {
        "found": found != 0,
        "node": node,
        "confidence": conf,
        "support": sup,
        "lift": lift,
        "con_support": con_sup,
    }


rule_search_fused.launches = 0
