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
runs the plain version ``ref.rule_search_fused_ref``.

``rule_search_span`` is the same search on the path-compressed layout:
per walk a ``(pos, rem, ctail)`` state, one item-column gather per step
inside a span and one compressed-bucket binary search at a CSR node, over
position-indexed metric columns that may be quantized (int32 support
counts, bf16 or int8 confidence and lift, widened in the kernel).  It
launches the second kernel of ``csrc/rule_search.cu`` (replacing
``repro.kernels.rule_search.rule_search_span_pallas``), or runs
``ref.rule_search_span_ref`` on CPU tensors.  The TPU knob ``span_bf``
sized that kernel's VMEM bucket lanes; a binary search has no lane width,
so it has no counterpart here (as ``search_bf`` has none for the fused
kernel).  The seed full-sweep kernel is a later slice.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import _build
from .rank import metric_column_args
from .ref import not_found, rule_search_fused_ref, rule_search_span_ref


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


def rule_search_span(
    child_offsets, edge_item, edge_pos, edge_span, edge_tail, node_item,
    support, confidence, lift, queries, ant_len, max_fanout: int = 0,
    n_transactions: int = 0, confidence_scale: float = 1.0,
    lift_scale: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """found bool, pos int32 (a DFS position, -1 when absent),
    confidence/support/lift/con_support f32, all ``[Q]``, on the
    compressed layout."""
    dev = queries.device
    dequant = dict(n_transactions=n_transactions,
                   confidence_scale=confidence_scale, lift_scale=lift_scale)
    if dev.type == "cpu":
        return rule_search_span_ref(
            child_offsets, edge_item, edge_pos, edge_span, edge_tail,
            node_item, support, confidence, lift, queries, ant_len,
            max_fanout, **dequant,
        )
    if dev.type != "cuda":
        raise ValueError(f"rule_search_span: unsupported device {dev}")
    q, width = queries.shape
    if edge_item.shape[0] == 0 or width == 0 or q == 0:
        out = not_found(q, dev)
        out["pos"] = out.pop("node")
        return out
    queries = queries.to(torch.int32).contiguous()
    ant_len = ant_len.to(torch.int32).contiguous()
    i32 = torch.int32
    _build.check_inputs(
        "rule_search_span", dev,
        child_offsets=(child_offsets, i32, 1), edge_item=(edge_item, i32, 1),
        edge_pos=(edge_pos, i32, 1), edge_span=(edge_span, i32, 1),
        edge_tail=(edge_tail, i32, 1), node_item=(node_item, i32, 1),
        support=(support, support.dtype, 1),
        confidence=(confidence, confidence.dtype, 1),
        lift=(lift, lift.dtype, 1),
        queries=(queries, i32, 2), ant_len=(ant_len, i32, 1),
    )
    if ant_len.shape[0] != q:
        raise ValueError("rule_search_span: ant_len must have Q entries")
    columns = metric_column_args("rule_search_span", support, confidence,
                                 lift, **dequant)
    f32 = dict(dtype=torch.float32, device=dev)
    pos = torch.empty((q,), dtype=i32, device=dev)
    found = torch.empty((q,), dtype=i32, device=dev)
    conf, sup = torch.empty((q,), **f32), torch.empty((q,), **f32)
    lift_o, con_sup = torch.empty((q,), **f32), torch.empty((q,), **f32)
    err = _build.lib("rule_search").rule_search_span_launch(
        child_offsets.data_ptr(), edge_item.data_ptr(), edge_pos.data_ptr(),
        edge_span.data_ptr(), edge_tail.data_ptr(), node_item.data_ptr(),
        *columns, queries.data_ptr(), ant_len.data_ptr(), q, width,
        pos.data_ptr(), found.data_ptr(), conf.data_ptr(), sup.data_ptr(),
        lift_o.data_ptr(), con_sup.data_ptr(), _build.stream_handle(dev),
    )
    _build.check(err, "rule_search_span")
    rule_search_span.launches += 1
    return {
        "found": found != 0,
        "pos": pos,
        "confidence": conf,
        "support": sup,
        "lift": lift_o,
        "con_support": con_sup,
    }


rule_search_span.launches = 0
