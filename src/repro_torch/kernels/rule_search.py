"""Batched Trie-of-Rules descent with full paper metrics (the search op).

``rule_search_fused`` walks each canonical query row root-down through
the CSR child buckets (node ``p``'s edges are ``[child_offsets[p],
child_offsets[p+1])``, item-sorted), runs the root-anchored
consequent-only walk beside it, and selects the Eq. 1-4 compound lift.
Metrics ride on the edges (the child node's columns gathered once,
``ops.edge_metric_arrays``).

On a CUDA tensor it launches the hand-written kernel in
``csrc/rule_search.cu`` (replacing the TPU kernel
``repro.kernels.rule_search.rule_search_fused_pallas``); on a CPU tensor it
runs the plain version ``ref.rule_search_fused_ref``.

``rule_search_span`` is the same search on the path-compressed layout:
per walk a ``(pos, rem, ctail)`` state, item-column gathers inside a span
and a compressed-bucket search at a CSR node, over position-indexed
metric columns that may be quantized (int32 support counts, bf16 or int8
confidence and lift, widened in the kernel).  It launches the second
kernel of ``csrc/rule_search.cu`` (replacing
``repro.kernels.rule_search.rule_search_span_pallas``), or runs
``ref.rule_search_span_ref`` on CPU tensors.

Both kernels give each walk a group of ``ref.SEARCH_GROUP`` lanes and run
a row's two walks at once: a bucket is read in rounds of 16-byte loads
(pivot rounds first when it is wider than a round covers), a span run of
up to ``SEARCH_GROUP`` items in one round, and each block stages the
root's bucket (up to ``ref.SEARCH_ROOT_CAP`` edges) in shared memory;
``search_launch_shape`` sizes the grid.  ``ref.rule_search_fused_group_ref``
and ``ref.rule_search_span_group_ref`` run that design in plain PyTorch.
The TPU knobs ``search_bf`` and ``span_bf`` sized VMEM bucket lanes and
have no counterpart here.

``rule_search_sweep`` is the seed layout's search (a ``DeviceTrie``
without CSR offsets): at every step each row is compared with the whole
``(edge_parent, edge_item)`` table, and the max child and the max of each
edge metric over the matches advance it.  It returns node metrics only;
``ops.rule_search`` makes a second, consequent-only call for compound
lift.  It launches the sweep kernels of ``csrc/rule_search.cu``
(replacing ``repro.kernels.rule_search.rule_search_pallas``), or runs
``ref.rule_search_sweep_ref`` on CPU tensors.  Each step sweeps only the
rows active in it, compacted on the device, with the (row tile, edge
chunk) units split evenly over a fixed grid of warps
(``sweep_launch_shape``), 32-bit fingerprints compared first and the
exact pair on a fingerprint hit; ``ref.rule_search_sweep_split_ref`` runs
that design in plain PyTorch.  The match grid's blocks an SM
(``sweep_blocks_per_sm``) is a launch knob, read from
``tuning.get_kernel_config()`` at call time; the kernel's
``__launch_bounds__(SW_THREADS, SW_BLOCKS_PER_SM)`` stays a compile-time
register budget for 4 resident blocks an SM, so a grid of more blocks an
SM than fit at once runs the rest in a later wave (its units split evenly
over every warp of the grid, resident or not), and any grid gives the
same answers.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import _build
from .rank import metric_column_args
from .ref import (
    SEARCH_GROUP, SWEEP_CHUNK, SWEEP_ROWS, not_found, rule_search_fused_ref,
    rule_search_span_ref, rule_search_sweep_ref, sweep_not_found,
)
from .tuning import get_kernel_config

# mirror of csrc/rule_search.cu's sweep constant SW_THREADS (SW_R and
# SW_CHUNK are ref.SWEEP_ROWS and SWEEP_CHUNK)
SWEEP_WARPS_PER_BLOCK = 8
# mirror of the descent searches' block (RS_THREADS; RS_GROUP and
# RS_ROOT_CAP are ref.SEARCH_GROUP and SEARCH_ROOT_CAP)
SEARCH_THREADS = 256


def search_launch_shape(q: int) -> dict:
    """The grid of a fused or span search over ``q`` rows: two walks a
    row, ``SEARCH_GROUP`` lanes a walk, ``rows`` rows in a block of
    ``SEARCH_THREADS`` threads, ``blocks`` blocks."""
    rows = SEARCH_THREADS // (2 * SEARCH_GROUP)
    return {"rows": rows, "blocks": -(-int(q) // rows),
            "threads": SEARCH_THREADS}


def _check_edge_columns(what: str, e: int, **cols) -> None:
    for name, col in cols.items():
        if col.shape[0] != e:
            raise ValueError(f"{what}: {name} must have E entries")


def rule_search_fused(
    child_offsets, edge_item, edge_child, edge_conf, edge_sup, edge_lift,
    queries, ant_len, max_fanout: int = 0,
) -> Dict[str, torch.Tensor]:
    """found bool, node int32, confidence/support/lift/con_support f32,
    all ``[Q]``, for int32 ``queries[Q, L]`` (-1 padded) and
    ``ant_len[Q]``."""
    dev = queries.device
    if _build.interpret_mode(dev):
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
    e = edge_item.shape[0]
    _check_edge_columns("rule_search_fused", e, edge_child=edge_child,
                        edge_conf=edge_conf, edge_sup=edge_sup,
                        edge_lift=edge_lift)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    node, found = torch.empty((q,), **i32), torch.empty((q,), **i32)
    conf, sup = torch.empty((q,), **f32), torch.empty((q,), **f32)
    lift, con_sup = torch.empty((q,), **f32), torch.empty((q,), **f32)
    err = _build.lib("rule_search").rule_search_fused_launch(
        child_offsets.data_ptr(), edge_item.data_ptr(),
        edge_child.data_ptr(), edge_conf.data_ptr(), edge_sup.data_ptr(),
        edge_lift.data_ptr(), queries.data_ptr(), ant_len.data_ptr(),
        q, width, e, search_launch_shape(q)["blocks"], node.data_ptr(),
        found.data_ptr(), conf.data_ptr(), sup.data_ptr(), lift.data_ptr(),
        con_sup.data_ptr(), _build.stream_handle(dev),
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
    if _build.interpret_mode(dev):
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
    e = edge_item.shape[0]
    _check_edge_columns("rule_search_span", e, edge_pos=edge_pos,
                        edge_span=edge_span, edge_tail=edge_tail)
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
        *columns, queries.data_ptr(), ant_len.data_ptr(), q, width, e,
        search_launch_shape(q)["blocks"], pos.data_ptr(), found.data_ptr(),
        conf.data_ptr(), sup.data_ptr(), lift_o.data_ptr(),
        con_sup.data_ptr(), _build.stream_handle(dev),
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


def sweep_launch_shape(q: int, width: int, e: int, sms: int) -> dict:
    """Sizes of one sweep call from its shape alone (no device read):
    ``n_chunks`` chunks of ``SWEEP_CHUNK`` edges (the fingerprint table
    padded to whole chunks), the int32 ``words`` of scratch
    (``rule_search.cu::sweep_scratch``: the table, a count per step
    rounded up to 4, and 9 words a row) and the match grid:
    ``sweep_blocks_per_sm`` blocks an SM, fewer when even Q active rows
    give fewer (tile, chunk) units than warps; ``warps`` is the grid's
    warp count, over which every step's units split evenly."""
    n_chunks = -(-int(e) // SWEEP_CHUNK)
    words = n_chunks * SWEEP_CHUNK + -(-int(width) // 4) * 4 + 9 * int(q)
    units = -(-int(q) // SWEEP_ROWS) * n_chunks
    per_sm = get_kernel_config().sweep_blocks_per_sm
    blocks = max(1, min(per_sm * int(sms),
                        -(-units // SWEEP_WARPS_PER_BLOCK)))
    return {"n_chunks": n_chunks, "words": words, "match_blocks": blocks,
            "warps": blocks * SWEEP_WARPS_PER_BLOCK}


def rule_search_sweep(
    edge_parent, edge_item, edge_child, edge_conf, edge_sup, edge_lift,
    queries, ant_len,
) -> Dict[str, torch.Tensor]:
    """found bool, node int32, confidence/support/node_lift f32, all
    ``[Q]``, for int32 ``queries[Q, L]`` (-1 padded) and ``ant_len[Q]``,
    by the full sweep of the edge table at every step."""
    dev = queries.device
    if _build.interpret_mode(dev):
        return rule_search_sweep_ref(
            edge_parent, edge_item, edge_child, edge_conf, edge_sup,
            edge_lift, queries, ant_len,
        )
    if dev.type != "cuda":
        raise ValueError(f"rule_search_sweep: unsupported device {dev}")
    q, width = queries.shape
    e = edge_parent.shape[0]
    if e == 0 or width == 0 or q == 0:
        return sweep_not_found(q, dev)
    queries = queries.to(torch.int32).contiguous()
    ant_len = ant_len.to(torch.int32).contiguous()
    i32 = torch.int32
    f32 = torch.float32
    _build.check_inputs(
        "rule_search_sweep", dev,
        edge_parent=(edge_parent, i32, 1), edge_item=(edge_item, i32, 1),
        edge_child=(edge_child, i32, 1), edge_conf=(edge_conf, f32, 1),
        edge_sup=(edge_sup, f32, 1), edge_lift=(edge_lift, f32, 1),
        queries=(queries, i32, 2), ant_len=(ant_len, i32, 1),
    )
    if ant_len.shape[0] != q:
        raise ValueError("rule_search_sweep: ant_len must have Q entries")
    _check_edge_columns("rule_search_sweep", e, edge_item=edge_item,
                        edge_child=edge_child, edge_conf=edge_conf,
                        edge_sup=edge_sup, edge_lift=edge_lift)
    shape = sweep_launch_shape(q, width, e, _build.sm_count(dev))
    if shape["n_chunks"] * SWEEP_CHUNK >= 1 << 31:
        raise ValueError(f"rule_search_sweep: {e} edges, at most 2^31 - "
                         f"{SWEEP_CHUNK + 1}")
    node = torch.empty((q,), dtype=i32, device=dev)
    found = torch.empty((q,), dtype=i32, device=dev)
    conf, sup, lift = (torch.empty((q,), dtype=f32, device=dev)
                       for _ in range(3))
    scratch = torch.empty((shape["words"],), dtype=i32, device=dev)
    err = _build.lib("rule_search").rule_search_sweep_launch(
        edge_parent.data_ptr(), edge_item.data_ptr(), edge_child.data_ptr(),
        edge_conf.data_ptr(), edge_sup.data_ptr(), edge_lift.data_ptr(), e,
        queries.data_ptr(), ant_len.data_ptr(), q, width,
        shape["n_chunks"], shape["match_blocks"], scratch.data_ptr(),
        node.data_ptr(), found.data_ptr(), conf.data_ptr(), sup.data_ptr(),
        lift.data_ptr(), _build.stream_handle(dev),
    )
    _build.check(err, "rule_search_sweep")
    rule_search_sweep.launches += 1
    return {
        "found": found != 0,
        "node": node,
        "confidence": conf,
        "support": sup,
        "node_lift": lift,
    }


rule_search_sweep.launches = 0
