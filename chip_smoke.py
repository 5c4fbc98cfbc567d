#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's batched query path, its rule
construction path and its path-compressed, quantized layout on one NVIDIA
GPU.

    python3 chip_smoke.py [--edges N] [--seed S] [--reps R]

1. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, in
   parallel) and the Triton reduction.
2. Builds ``synthetic_csr_trie(--edges)`` (default 2^20 rules) on the host
   and uploads it.
3. Holds every kernel against its plain PyTorch version on the card at
   full size: all rank metrics, k in {10, 100} and a k past small ranges,
   every rules_with role, whole-trie and prefix ranges, and a tie-heavy
   copy of the columns.  Bitwise equal, except the trie_reduce sums
   (1e-6 relative).
4. Drives the main path through ``TrieQueryEngine`` with the launch
   counters at 0, checks every kernel launched and every answer against
   the tensor oracles, and times each op (CUDA events, median of --reps
   runs after warm-up) and each kernel beside its plain version (device
   time from a torch.profiler trace with the L2 flushed before each call,
   mean of --reps calls, and CUDA events around one call).
5. Construction: makes ``online_retail_db()`` on the host, checks that
   apriori on the card finds the itemsets host apriori and fpgrowth find,
   holds the support-count kernel against its plain version on the card
   and the host bitmap sweep at every counting level and at the
   annotation, exactly; then drives ``build_trie_of_rules(db, 0.002,
   miner="apriori", engine="arrays")`` with the counters at 0 (one launch
   per level, one for the annotation), compares its trie with the host
   build (structure bitwise, metrics to rtol 1e-6 / atol 1e-7) and its
   f32 columns with the same annotation on CPU tensors (bitwise), serves
   it through ``TrieQueryEngine`` against the oracles, and times each
   launch, its plain version and the build's mine / build / annotate
   split.
6. Compressed layout: builds ``synthetic_chain_trie(2^20,
   chain_fraction=0.75, seed=3)`` and four device tries from it (plain;
   ``layout="auto"``, which must pick compressed; int32 support + bf16
   and int32 support + int8 columns at ``n_transactions = 100,000``),
   drives every op on each with the launch counters at 0 (4096 search
   rows of width 8, 256 prefixes at k = 10 and 100, 256 items per role,
   trie_reduce), and checks: compressed f32 == plain bitwise (node ids,
   values, tie order), every kernel call == its plain version on the card
   bitwise on every trie (sums to 1e-6), the quantized answers within the
   README's error bounds of plain f32 (found and node exact), and that the
   span search and the quantized rank, membership and reduce variants
   launched.  Then the retail trie of step 5: ``auto`` keeps it plain, and
   served compressed with int32 + bf16 columns at its real
   ``n_transactions`` it finds all its rules.  Prints resident bytes, op
   ms compressed against plain, and the span and quantized kernels' times.
7. Prints the GPU's name and power limit, one ``{"kernels": [...]}`` line,
   and last ``{"ok": true, "device": {...}}``.

Exits non-zero with no result when CUDA is unavailable or any phase fails.
"""
import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
FP32_OPS_PER_S = 67e12       # H100 SXM 32-bit CUDA-core peak
BF16_OPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
MINSUP = 0.002               # the retail operating point (arm/datasets.py)
COMPRESS_N_TX = 100_000      # int32 support denominator of the chain trie
# the compressed tries of step 6: FrozenTrie.device_arrays arguments
QUANT = {
    "compressed": dict(layout="auto"),
    "i32+bf16": dict(layout="compressed", quantize=True,
                     n_transactions=COMPRESS_N_TX),
    "i32+int8": dict(layout="compressed", quantize=True,
                     n_transactions=COMPRESS_N_TX, columns="int8"),
}
L2_FLUSH_BYTES = 128 << 20   # written between timed calls: over 2x the L2
METRICS = ("support", "confidence", "lift", "leverage", "conviction")
ROLES = ("consequent", "antecedent", "any")


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps, warmup=3):
    """Median milliseconds of ``fn`` between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps, flush, kernel=None):
    """Mean device milliseconds per call of ``fn`` with a cold L2: the
    durations of the kernels (and copies) it ran on the card, summed from
    a torch.profiler trace of ``reps`` calls each after ``flush()``, less
    ``flush()``'s own per-call time from a trace of it alone.  With
    ``kernel`` (a name, or a tuple of names), only the device events whose
    name holds one of them count (those kernels alone, without the
    wrapper's other device work) and nothing is subtracted.  None, logged
    with the traces' event counts, when a trace holds no such event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def traced_us(call, name=None, n=reps):
        # a short trace now and then comes back without its device events:
        # take it again, up to three times
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    flush()
                    call()
                torch.cuda.synchronize()
            events = prof.events()
            on_card = [e for e in events if e.device_type == DeviceType.CUDA]
            us = sum(e.time_range.elapsed_us() for e in on_card
                     if name is None or any(k in e.name for k in name))
            if us > 0:
                return us
            log(f"[profiler] no device time in a trace of {len(events)} "
                f"events, {len(on_card)} on the card (kernel {name})")
        return 0

    fn()
    torch.cuda.synchronize()
    if kernel is not None:
        only = traced_us(fn, (kernel,) if isinstance(kernel, str) else kernel)
        return only / reps / 1e3 if only > 0 else None
    # the flush-only trace takes at least 20 calls: shorter ones have come
    # back without their device events
    n_alone = max(reps, 20)
    both, alone = traced_us(fn), traced_us(lambda: None, n=n_alone)
    if both <= 0 or alone <= 0:
        return None
    return (both / reps - alone / n_alone) / 1e3


def bitwise_equal(a, b):
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs_err(a, b):
    import torch

    if not a.dtype.is_floating_point or a.numel() == 0:
        return 0.0 if torch.equal(a, b) else float("inf")
    same = a == b
    diff = torch.where(same, 0.0, (a.double() - b.double()).abs())
    return float(diff.max())


def check_same(what, got, want, errs):
    """Bitwise comparison of two result tuples; records the worst error."""
    for g, w in zip(got, want):
        errs.append(max_abs_err(g, w))
        if not bitwise_equal(g, w):
            raise AssertionError(f"{what}: kernel differs from plain version"
                                 f" (max abs err {errs[-1]})")


def prefixes_for(arrs, n_items, count, rng):
    """Whole-trie, absent and real 1-3 item prefixes, in turn."""
    out = []
    n = arrs["node_item"].shape[0]
    for i in range(count):
        if i % 8 == 0:
            out.append([])
        elif i % 8 == 7:
            out.append([n_items + 5])
        else:
            nid, path = int(rng.randint(1, n)), []
            while nid > 0:
                path.append(int(arrs["node_item"][nid]))
                nid = int(arrs["node_parent"][nid])
            out.append(path[::-1][: 1 + i % 3])
    return out


def walk_steps(dt, queries, ant_len):
    """Bucket lookups the two walks of a rule search perform on this data
    (the data-dependent part of its byte bound)."""
    import torch
    from repro_torch.core.array_trie import child_lookup

    q = queries.shape[0]
    node = torch.zeros((q,), dtype=torch.int32, device=queries.device)
    cnode = node.clone()
    ok = torch.ones((q,), dtype=torch.bool, device=queries.device)
    cok = ok.clone()
    main = cons = 0
    for s in range(queries.shape[1]):
        item = queries[:, s]
        active = (item >= 0) & ok
        c_active = (item >= 0) & (s >= ant_len) & cok
        main += int(active.sum())
        cons += int(c_active.sum())
        child = child_lookup(dt, node, item)
        ok = torch.where(active, child >= 0, ok)
        node = torch.where(active & (child >= 0), child, node)
        cchild = child_lookup(dt, cnode, item)
        cok = torch.where(c_active, cchild >= 0, cok)
        cnode = torch.where(c_active & (cchild >= 0), cchild, cnode)
    return main, cons


def drive_engine(engine, queries, ant_len, pairs, prefixes, items):
    """One pass of every batched op through ``engine``."""
    res = {
        "search": engine.rule_search_batch(queries, ant_len),
        "search_pairs": engine.rule_search_batch(pairs),
        "topk10": engine.top_k_rules_batch(prefixes, 10),
        "topk100": engine.top_k_rules_batch(prefixes, 100),
        "reduce": engine.trie_reduce(),
    }
    for role in ROLES:
        res[role] = engine.rules_with(items, role=role, k=10)
    return res


def check_answers(what, res, engine, queries, ant_len, pairs, prefixes,
                  items):
    """Every answer of ``drive_engine`` against the tensor oracles and the
    plain ops on the same device."""
    import torch
    from repro_torch.core.array_trie import batched_rule_search, traverse_reduce
    from repro_torch.kernels import ops

    dt, frozen, dev = engine.dt, engine.frozen, engine.device
    n = frozen.n_nodes
    dfs = ops.dfs_rank_arrays(dt)
    dfs["_device_trie"] = dt
    ia = ops.item_rank_arrays(dt)
    pq, pal = frozen.canonicalize_queries([p[0] for p in pairs],
                                          [p[1] for p in pairs])
    for key_res, (q, al) in (("search", (queries, ant_len)),
                             ("search_pairs", (pq, pal))):
        oracle = batched_rule_search(dt, torch.as_tensor(q, device=dev),
                                     torch.as_tensor(al, device=dev))
        for key in oracle:
            if not bitwise_equal(res[key_res][key], oracle[key]):
                raise AssertionError(f"{what}: rule_search_batch "
                                     f"{key_res} {key} != oracle")
    for k in (10, 100):
        want = ops.top_k_rules_batch(frozen, prefixes, k, arrays=dfs,
                                     use_kernel=False, device=dev)
        for key in want:
            if not bitwise_equal(res[f"topk{k}"][key], want[key]):
                raise AssertionError(f"{what}: top_k_rules_batch k={k} {key}")
        if res[f"topk{k}"]["values"].shape != (len(prefixes), k):
            raise AssertionError(f"{what}: top_k_rules_batch shape")
    for role in ROLES:
        want = ops.rules_with(frozen, items, role=role, k=10, arrays=ia,
                              use_kernel=False, device=dev)
        for key in want:
            if not bitwise_equal(res[role][key], want[key]):
                raise AssertionError(f"{what}: rules_with {role} {key}")
    want = traverse_reduce(dt)
    if float(res["reduce"]["n_rules"]) != float(want["n_rules"]) or \
            float(res["reduce"]["n_rules"]) != n - 1:
        raise AssertionError(f"{what}: trie_reduce n_rules")
    for key in ("support_sum", "confidence_max", "mean_conf"):
        got, w = float(res["reduce"][key]), float(want[key])
        if not math.isfinite(got) or abs(got - w) > 1e-6 * abs(w):
            raise AssertionError(f"{what}: trie_reduce {key}: {got} vs {w}")


# the kernels a query on the plain layout launches, and on the compressed
PLAIN_QUERY_KERNELS = ("topk_rank_batch", "rule_search_fused",
                       "rules_with_member", "trie_reduce_columns")
SPAN_QUERY_KERNELS = ("topk_rank_batch", "rule_search_span",
                      "rules_with_member", "trie_reduce_columns")


def require_launched(what, launches, names):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{what}: kernel {name} never launched")


def time_ops(engine, queries, ant_len, prefixes, items, reps):
    """Median CUDA-event milliseconds of each engine op."""
    op_ms = {
        "rule_search_batch": cuda_ms(
            lambda: engine.rule_search_batch(queries, ant_len), reps),
        "top_k_rules_batch_k10": cuda_ms(
            lambda: engine.top_k_rules_batch(prefixes, 10), reps),
        "top_k_rules_batch_k100": cuda_ms(
            lambda: engine.top_k_rules_batch(prefixes, 100), reps),
        "trie_reduce": cuda_ms(engine.trie_reduce, reps),
    }
    for role in ROLES:
        op_ms[f"rules_with_{role}"] = cuda_ms(
            lambda: engine.rules_with(items, role=role, k=10), reps)
    return op_ms


# the device kernels each wrapper launches, by name in a profiler trace
KERNEL_NAMES = {
    "topk_rank_batch": ("score_kernel", "chunk_topk_kernel",
                        "merge_pairs_kernel"),
    "rules_with_member": ("score_kernel", "chunk_topk_kernel",
                          "merge_pairs_kernel"),
    "rule_search_fused": ("rule_search_fused_kernel",),
    "rule_search_span": ("rule_search_span_kernel",),
    "trie_reduce_columns": ("partials", "fold"),
}


def score_bytes(metric, support, confidence):
    """Bytes per position a score of ``metric`` reads: the columns it
    needs (``metrics_inkernel.METRIC_COLUMNS``, which the score pass
    loads and no other) in their storage types, and the 4-byte depth of
    the min_depth mask."""
    from repro_torch.kernels.metrics_inkernel import METRIC_COLUMNS

    size = {"support": support.element_size(),
            "confidence": confidence.element_size(),
            "lift": confidence.element_size()}
    return 4 + sum(size[c] for c in METRIC_COLUMNS[metric])


def covered_positions(n, los, his):
    """Positions of ``[0, n)`` that one of the ranges ``[los, his)``
    covers: each is read once however many ranges hold it."""
    import torch

    los, his = los.long().clamp(0, n), his.long().clamp(0, n)
    ones = torch.ones_like(los, dtype=torch.int32)
    covered = torch.zeros((n + 1,), dtype=torch.int32, device=los.device)
    covered.index_add_(0, los, ones)
    covered.index_add_(0, his, -ones)
    return int((covered.cumsum(0)[:n] > 0).sum())


def member_work(n, post_lo, post_hi, plos, phis, n_items, k, score_b):
    """Bytes a membership top-k (role any) needs on this data: the
    postings of the queried items (8 bytes each), the score's columns at
    every position those postings cover, the item rows (12 bytes each)
    and the k results per item (8 bytes each)."""
    import numpy as np
    import torch

    idx = torch.as_tensor(np.concatenate(
        [np.arange(a, b) for a, b in zip(plos, phis)] + [np.zeros(0, int)]),
        dtype=torch.long, device=post_lo.device)
    union = covered_positions(n, post_lo[idx], post_hi[idx])
    return score_b * union + 8 * idx.numel() + 12 * n_items \
        + 8 * n_items * k


def kernel_row(name, kern, plain, work, where, launches, max_err, reps,
               flush, label=None):
    """One row of the ``kernels`` line: the kernel's device ms (its own
    kernels in a profiler trace, cold L2), and on the scope of the plain
    version's ``plain_ms`` (every device event of the call, the flush
    subtracted) ``whole_call_ms``, which adds the wrapper's own device
    work (casts, clamps, its range reduction); CUDA events per call
    around each (``call_ms``; the device ms fall back to these when a
    trace holds no device time), and the bound of ``work = (bytes,
    operations)`` at the card's peaks.  ``where`` is (route, source,
    file:line of the TPU kernel)."""
    call_ms = cuda_ms(kern, reps)
    plain_call_ms = cuda_ms(plain, reps, warmup=1)
    ms = device_ms(kern, reps, flush, kernel=KERNEL_NAMES[name])
    whole_call_ms = device_ms(kern, reps, flush)
    plain_ms = device_ms(plain, reps, flush)
    timer = "profiler"
    if ms is None or plain_ms is None:
        ms, plain_ms, timer = call_ms, plain_call_ms, "events"
    t_bytes = work[0] / HBM_BYTES_PER_S * 1e3
    t_ops = work[1] / FP32_OPS_PER_S * 1e3
    route, source, replaces = where
    row = {
        "name": label or name, "route": route, "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "timer": timer, "whole_call_ms": whole_call_ms,
        "call_ms": call_ms, "plain_call_ms": plain_call_ms,
    }
    log(f"[kernel] {row['name']}: {ms:.4f} ms device ({timer}), whole call "
        f"{whole_call_ms} ms device, "
        f"{call_ms:.4f} ms per call; plain {plain_ms:.4f} / "
        f"{plain_call_ms:.4f} ms; bound {row['bound_ms']:.5f} ms "
        f"({row['bound_by']})")
    return row


def support_work(mat, n_words):
    """(bytes, operations) a support-count launch needs on this data: the
    bitmap rows it touches read once, the candidate rows, lengths and
    counts; an AND and a popcount-add per word of each distinct valid
    item of each row."""
    import numpy as np

    c, k = mat.shape
    srt = np.sort(mat, axis=1)
    new = np.ones_like(srt, dtype=bool)
    new[:, 1:] = srt[:, 1:] != srt[:, :-1]
    distinct = int(((srt >= 0) & new).sum())
    rows = int(np.unique(mat[mat >= 0]).size)
    return rows * n_words * 4 + c * k * 4 + 8 * c, 2 * distinct * n_words


def construction_phase(args, dev, l2_flush):
    """Mine, build and annotate ``online_retail_db()`` at ``MINSUP`` on
    the card, check every step, serve the trie, and time the support-count
    launches; returns the kernel's row of the ``kernels`` line."""
    import numpy as np
    import torch
    from repro_torch.arm.apriori import apriori
    from repro_torch.arm.datasets import online_retail_db
    from repro_torch.arm.fpgrowth import fpgrowth
    from repro_torch.arm.rulegen import canonical_sequences
    from repro_torch.core.array_trie import item_tables
    from repro_torch.core.build_arrays import (
        build_frozen_trie, canonicalize_matrix, pack_sequences, trie_arrays,
    )
    from repro_torch.core.builder import build_trie_of_rules
    from repro_torch.kernels import (
        KERNELS, launch_counts, ops, ref, reset_launch_counts,
    )
    from repro_torch.kernels.support_count import support_count_bitmap
    from repro_torch.serve import TrieQueryEngine

    minsup, reps = MINSUP, args.reps
    name = "support_count_bitmap"

    # -- 6a. the DB and the itemsets -----------------------------------
    t0 = time.perf_counter()
    db = online_retail_db()
    n_tx, n_words = db.n_transactions, db.n_words
    log(f"[construct] online_retail_db: {n_tx} transactions x {db.n_items} "
        f"items, bitmaps {db.item_bitmaps.shape} "
        f"({db.item_bitmaps.nbytes} bytes), made in "
        f"{time.perf_counter() - t0:.1f} s")
    # the kernel path's own counting levels, recorded as apriori makes them
    launches_in = []
    host_batch = db.support_batch

    def recording(mat, lens=None, **kw):
        launches_in.append((np.asarray(mat, np.int32),
                            np.asarray(lens, np.int32)))
        return host_batch(mat, lens, **kw)

    db.support_batch = recording
    t0 = time.perf_counter()
    on_card = apriori(db, minsup, use_kernel=True, device=dev)
    t1 = time.perf_counter()
    del db.support_batch
    by_fpgrowth = fpgrowth(db, minsup)
    t2 = time.perf_counter()
    on_host = apriori(db, minsup)
    t3 = time.perf_counter()
    if not (on_card == by_fpgrowth == on_host):
        raise AssertionError("construct: apriori on the card, fpgrowth and "
                             "host apriori found different itemsets")
    log(f"[construct] minsup {minsup}: {len(on_card)} frequent itemsets, "
        f"max size {max(len(s) for s in on_card)}; apriori on the card "
        f"{t1 - t0:.2f} s, fpgrowth {t2 - t1:.2f} s, host apriori "
        f"{t3 - t2:.2f} s; all three equal")

    # -- 6b. every launch: kernel == plain version == host sweep -------
    bm = db.device_bitmaps(dev)

    def upload(mat, lens):
        return (torch.as_tensor(mat, device=dev),
                torch.as_tensor(lens, device=dev))

    seqs = canonical_sequences(on_card.keys(), db)
    mat, _ = pack_sequences(seqs)
    _, item_rank = item_tables(db.frequency_order())
    mat = canonicalize_matrix(mat, item_rank)
    arrs = trie_arrays(mat, (mat >= 0).sum(axis=1))
    cand, clens = arrs["cand"], arrs["node_depth"][1:].astype(np.int32)
    launches_in.append((cand, clens))
    tags = [f"level {i + 2}" for i in range(len(launches_in) - 1)] + \
        ["annotate"]
    for tag, (mat_l, lens_l) in zip(tags, launches_in):
        args_t = (bm, *upload(mat_l, lens_l), n_tx)
        got = support_count_bitmap(*args_t)
        want = ref.support_count_bitmap_ref(*args_t)
        if not torch.equal(got, want):
            raise AssertionError(f"construct {tag}: kernel != plain version")
        if not np.array_equal(got.cpu().numpy(),
                              db.support_batch(mat_l, lens_l)):
            raise AssertionError(f"construct {tag}: kernel != host sweep")
    torch.cuda.synchronize()
    log(f"[construct] {len(launches_in)} launches (C = "
        f"{[m.shape[0] for m, _ in launches_in]}): kernel == plain version "
        f"on the card == host bitmap sweep, exactly")

    # -- 6c. the main path: build_trie_of_rules on the default device --
    reset_launch_counts()
    t0 = time.perf_counter()
    built = build_trie_of_rules(db, minsup, miner="apriori", engine="arrays")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    log(f"[construct main path] {wall:.2f} s (mine {built.mine_seconds:.3f}"
        f", build {built.build_seconds:.3f}, annotate "
        f"{built.annotate_seconds:.3f}), launches {launches}")
    if launches[name] != len(launches_in):
        raise AssertionError(f"construct: {launches[name]} {name} launches, "
                             f"expected {len(launches_in)}")
    if any(launches[k] for k in KERNELS if k != name):
        raise AssertionError("construct: a query kernel ran while building")
    frozen = built.frozen
    if built.itemsets != on_host:
        raise AssertionError("construct: the build mined other itemsets")
    host, _, _ = build_frozen_trie(db, built.sequences, use_kernel=False)
    metrics = ("support", "confidence", "lift")
    for f in ("node_item", "node_parent", "node_depth", "edge_parent",
              "edge_item", "edge_child", "item_order", "item_rank",
              "child_offsets", "dfs_order", "subtree_size", "dfs_to_node",
              "item_offsets", "item_nodes", *metrics):
        g, w = getattr(frozen, f), getattr(host, f)
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"construct: {f} shape/dtype")
        if f in metrics:
            if not np.allclose(g, w, rtol=1e-6, atol=1e-7):
                raise AssertionError(f"construct: {f} off the host build")
        elif not np.array_equal(g, w):
            raise AssertionError(f"construct: {f} != host build")
    cpu_cols = ops.annotate_candidates(
        cand, clens, arrs["node_parent"][1:], arrs["node_item"][1:],
        db.item_counts(), n_tx, item_bitmaps=db.item_bitmaps, device="cpu")
    for f in metrics:
        if not np.array_equal(getattr(frozen, f)[1:].view(np.int32),
                              cpu_cols[f].numpy().view(np.int32)):
            raise AssertionError(f"construct: {f} on the card != on CPU "
                                 f"tensors")
    err = max(float(np.abs(getattr(frozen, f).astype(np.float64)
                           - getattr(host, f).astype(np.float64)).max())
              for f in metrics)
    log(f"[construct main path] {len(built.itemsets)} itemsets -> "
        f"{frozen.n_nodes} nodes, depth {frozen.max_depth}; structure == "
        f"host build, metrics within 1e-6 (max abs diff {err:.3g}), f32 "
        f"columns == annotate on CPU tensors, bitwise")

    # -- 6d. serve the mined trie --------------------------------------
    engine = TrieQueryEngine(frozen)
    n = frozen.n_nodes
    rng = np.random.RandomState(args.seed + 3)
    queries, ant_len = cand, clens - 1
    pairs = []
    for v in rng.randint(1, n, size=256):
        path = list(frozen.path_items(int(v)))
        cut = int(rng.randint(0, len(path)))
        pairs.append((path[:cut], path[cut:]))
    prefixes = prefixes_for({"node_item": frozen.node_item,
                             "node_parent": frozen.node_parent},
                            db.n_items, 256, rng)
    items = [int(x) for x in rng.randint(0, db.n_items, size=248)]
    items += [items[0], items[1], -1, db.n_items + 3, 0, 1, 2, 3]
    reset_launch_counts()
    t0 = time.perf_counter()
    res = drive_engine(engine, queries, ant_len, pairs, prefixes, items)
    torch.cuda.synchronize()
    served = launch_counts()
    log(f"[construct serve] {time.perf_counter() - t0:.2f} s, launches "
        f"{served}")
    require_launched("construct serve", served, PLAIN_QUERY_KERNELS)
    check_answers("construct serve", res, engine, queries, ant_len, pairs,
                  prefixes, items)
    found = res["search"]["found"].cpu().numpy()
    node = res["search"]["node"].cpu().numpy()
    if not found.all() or not np.array_equal(node, np.arange(1, n)):
        raise AssertionError("construct serve: a mined rule was not found")
    log(f"[construct serve] all {int(found.sum())} rules found at their "
        f"nodes; every answer equals the oracles")
    op_ms = time_ops(engine, queries, ant_len, prefixes, items, reps)
    log("[construct ops ms] " + json.dumps(op_ms))

    # -- 6e. timing ----------------------------------------------------
    splits = []
    for _ in range(3):
        r = build_trie_of_rules(db, minsup, miner="apriori", engine="arrays")
        splits.append((r.mine_seconds, r.build_seconds, r.annotate_seconds))
    mine_s, build_s, annotate_s = (statistics.median(x) for x in zip(*splits))
    log(f"[construct build s] mine {mine_s:.4f} build {build_s:.4f} annotate "
        f"{annotate_s:.4f} (median of 3; each run "
        f"{[tuple(round(x, 4) for x in sp) for sp in splits]})")
    plain_reps = max(2, reps // 4)
    per_launch = []
    for tag, (mat_l, lens_l) in zip(tags, launches_in):
        args_t = (bm, *upload(mat_l, lens_l), n_tx)
        kern = lambda: support_count_bitmap(*args_t)
        plain = lambda: ref.support_count_bitmap_ref(*args_t)
        call_ms = cuda_ms(kern, reps)
        plain_call_ms = cuda_ms(plain, plain_reps, warmup=1)
        # the kernel alone: the wrapper's item-range check (a max
        # reduction and a 4-byte copy to the host) is in call_ms
        ms = device_ms(kern, reps, l2_flush.zero_,
                       kernel="support_count_kernel")
        # on plain_ms's scope: the whole call, its range check included
        whole_call_ms = device_ms(kern, reps, l2_flush.zero_)
        plain_ms = device_ms(plain, plain_reps, l2_flush.zero_)
        timer = "events" if ms is None else "profiler"
        plain_timer = "events" if plain_ms is None else "profiler"
        ms = call_ms if ms is None else ms
        plain_ms = plain_call_ms if plain_ms is None else plain_ms
        nbytes, nops = support_work(mat_l, n_words)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / FP32_OPS_PER_S * 1e3
        dense_ms = 2.0 * n_tx * mat_l.shape[0] * db.n_items \
            / BF16_OPS_PER_S * 1e3
        per_launch.append({
            "launch": tag, "C": int(mat_l.shape[0]), "K": int(mat_l.shape[1]),
            "ms": ms, "whole_call_ms": whole_call_ms, "call_ms": call_ms,
            "plain_ms": plain_ms,
            "plain_call_ms": plain_call_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": nops, "dense_bf16_ms": dense_ms,
            "timer": timer, "plain_timer": plain_timer,
        })
        log(f"[kernel] {name} {tag} C={mat_l.shape[0]} K={mat_l.shape[1]}: "
            f"{ms:.4f} ms device ({timer}), whole call {whole_call_ms} ms "
            f"device, {call_ms:.4f} ms per call; plain "
            f"{plain_ms:.4f} ({plain_timer}) / {plain_call_ms:.4f} ms; bound "
            f"{per_launch[-1]['bound_ms']:.5f} ms "
            f"({per_launch[-1]['bound_by']}); a dense bf16 product would "
            f"take {dense_ms:.4f} ms at peak")
    total = {key: sum(p[key] for p in per_launch)
             for key in ("ms", "call_ms", "plain_ms", "plain_call_ms",
                         "dense_bf16_ms")}
    total["whole_call_ms"] = None if any(
        p["whole_call_ms"] is None for p in per_launch) else sum(
        p["whole_call_ms"] for p in per_launch)
    t_bytes = sum(p["bytes"] for p in per_launch) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(p["ops"] for p in per_launch) / FP32_OPS_PER_S * 1e3
    log(f"[construct] one build's {len(per_launch)} support counts: "
        f"{total['ms']:.4f} ms device, bound "
        f"{sum(p['bound_ms'] for p in per_launch):.5f} ms; the dense "
        f"formulation's bf16 bound {total['dense_bf16_ms']:.4f} ms")
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/support_count.cu",
        "replaces": "src/repro/kernels/support_count.py:52",
        "launches": launches[name], "max_abs_err": 0.0,
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": sum(p["bound_ms"] for p in per_launch),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "timer": "/".join(sorted({p["timer"] for p in per_launch})),
        "plain_timer": "/".join(sorted({p["plain_timer"] for p in per_launch})),
        "whole_call_ms": total["whole_call_ms"], "call_ms": total["call_ms"],
        "plain_call_ms": total["plain_call_ms"], "per_launch": per_launch,
    }, frozen, n_tx


def resident_bytes(*sources):
    """Bytes of the distinct device buffers a query configuration keeps:
    every tensor of a ``DeviceTrie`` and of its memoized column dicts,
    counted once per storage (a dict that holds the trie's own tensors
    adds nothing; a gathered copy adds its bytes)."""
    import torch

    seen = {}
    for src in sources:
        vals = src.values() if isinstance(src, dict) else vars(src).values()
        for v in vals:
            if isinstance(v, torch.Tensor) and v.is_cuda:
                st = v.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def layout_columns(dt):
    """The op-level column dicts a serving front door memoizes."""
    from repro_torch.kernels import ops

    dfs = ops.dfs_rank_arrays(dt)
    dfs["_device_trie"] = dt
    return {"edges": ops.edge_metric_arrays(dt), "dfs": dfs,
            "ia": ops.item_rank_arrays(dt)}


def drive_layout(dt, cols, queries, ant_len, prefixes, items):
    """One pass of every batched op over one device trie."""
    from repro_torch.kernels import ops

    res = {
        "search": ops.rule_search_batch(dt, queries, ant_len,
                                        edges=cols["edges"]),
        "topk10": ops.top_k_rules_batch(dt, prefixes, 10, arrays=cols["dfs"]),
        "topk100": ops.top_k_rules_batch(dt, prefixes, 100,
                                         arrays=cols["dfs"]),
        "reduce": ops.trie_reduce(dt),
    }
    for role in ROLES:
        res[role] = ops.rules_with(dt, items, role=role, k=10,
                                   arrays=cols["ia"])
    return res


def time_layout_ops(dt, cols, queries, ant_len, prefixes, items, reps):
    """Median CUDA-event milliseconds of each op over one device trie."""
    from repro_torch.kernels import ops

    op_ms = {
        "rule_search_batch": cuda_ms(
            lambda: ops.rule_search_batch(dt, queries, ant_len,
                                          edges=cols["edges"]), reps),
        "top_k_rules_batch_k10": cuda_ms(
            lambda: ops.top_k_rules_batch(dt, prefixes, 10,
                                          arrays=cols["dfs"]), reps),
        "top_k_rules_batch_k100": cuda_ms(
            lambda: ops.top_k_rules_batch(dt, prefixes, 100,
                                          arrays=cols["dfs"]), reps),
        "trie_reduce": cuda_ms(lambda: ops.trie_reduce(dt), reps),
    }
    for role in ROLES:
        op_ms[f"rules_with_{role}"] = cuda_ms(
            lambda: ops.rules_with(dt, items, role=role, k=10,
                                   arrays=cols["ia"]), reps)
    return op_ms


def span_args(dt):
    """The span search's arguments on a compressed trie, and its keywords
    (bucket width and dequantization scalars)."""
    from repro_torch.kernels import ops

    e = ops.edge_metric_arrays(dt)
    names = ("child_offsets", "edge_item", "edge_pos", "edge_span",
             "edge_tail", "node_item", "support", "confidence", "lift")
    return [e[k] for k in names], dict(max_fanout=e["max_fanout"],
                                       **ops._dequant_statics(e))


def span_walk_work(dt, queries, ant_len):
    """Bytes the two span walks of a search need on this data: per step a
    4-byte item-column gather inside a span, or at a CSR node the two
    bucket bounds and the found edge's four columns (24 bytes); a
    confidence gather per consequent step of the main walk; the support
    and lift of each found row and the support of each found consequent
    path."""
    import torch
    from repro_torch.core.array_trie import compressed_step

    q = queries.shape[0]
    z = torch.zeros((q,), dtype=torch.int32, device=queries.device)
    ones = torch.ones((q,), dtype=torch.bool, device=queries.device)
    es = {"sup": dt.support.element_size(),
          "col": dt.confidence.element_size()}
    total = 0
    for main in (True, False):
        pos, rem, ctail, ok = z, z, z, ones
        for s in range(queries.shape[1]):
            item = queries[:, s]
            active = (item >= 0) & ok
            if not main:
                active &= s >= ant_len
            p2, r2, t2, hit = compressed_step(dt, pos, rem, ctail, item)
            total += 4 * int((active & (rem > 0)).sum())
            total += 24 * int((active & (rem <= 0)).sum())
            adv = active & hit
            if main:
                total += es["col"] * int((adv & (s >= ant_len)).sum())
            ok = torch.where(active, hit, ok)
            pos = torch.where(adv, p2, pos)
            rem = torch.where(adv, r2, rem)
            ctail = torch.where(adv, t2, ctail)
        hits = int((ok & (pos > 0)).sum())
        total += hits * (es["sup"] + es["col"] if main else es["sup"])
    return total + queries.numel() * 4 + q * 4 + q * 24


F32_ULP = 2.0 ** -23
BF16_REL = 2.0 ** -8         # README: bf16 columns, relative


def column_bound(w, col):
    """The README's bound on one quantized column's error, at the plain f32
    values ``w`` (float64): int32 support counts 2 ulp relative plus the
    count's rounding, 1 / (2 n) absolute; bf16 2^-8 relative; int8
    scale / 2 absolute."""
    if col["kind"] == "count":
        return 2 * F32_ULP * w.abs() + 0.5 / col["n_transactions"]
    if col["kind"] == "bf16":
        return BF16_REL * w.abs()
    return col["scale"] / 2 + 0.0 * w


def product_bound(conf, m, col):
    """Bound on a compound confidence, the product of ``m`` quantized
    factors, each in [0, 1]: relative errors compound for bf16,
    absolute ones add for int8."""
    if col["kind"] == "bf16":
        return ((1 + BF16_REL) ** m - 1) * conf.abs()
    return m * col["scale"] / 2


def within(what, got, want, bound, mask, rtol):
    """Raise unless ``|got - want| <= bound`` (plus the f32 roundings of
    the widening and of the search's own products) on ``mask``; returns
    how many values lie outside ``rtol``, the tolerance of the reference's
    small-size test (2e-2 bf16, 6e-2 int8)."""
    import torch

    g, w = got.double()[mask], want.double()[mask]
    b = bound[mask] if isinstance(bound, torch.Tensor) and bound.dim() \
        else bound
    b = b + 32 * F32_ULP * w.abs()
    err = (g - w).abs()
    bad = err > b
    if bool(bad.any()):
        i = int(torch.nonzero(bad)[0])
        bi = float(b[i]) if isinstance(b, torch.Tensor) else float(b)
        raise AssertionError(f"{what}: {float(g[i])} vs plain {float(w[i])}"
                             f" beyond the README bound {bi}")
    return int((err > rtol * w.abs()).sum())


def compressed_phase(args, dev, l2_flush, retail, retail_n_tx):
    """The path-compressed, quantized layout at 2^20 rules and on the
    retail trie: drive, check and time it; returns the span kernel's and
    the quantized variants' rows of the ``kernels`` line."""
    import numpy as np
    import torch
    from repro_torch.core import synthetic
    from repro_torch.kernels import launch_counts, ops, ref, \
        reset_launch_counts
    from repro_torch.kernels.item_index import rules_with_member
    from repro_torch.kernels.rank import topk_rank_batch
    from repro_torch.kernels.rule_search import (
        rule_search_fused, rule_search_span,
    )
    from repro_torch.kernels.trie_reduce import trie_reduce_columns

    reps = args.reps
    t0 = time.perf_counter()
    arrs = synthetic.synthetic_chain_trie(1 << 20, chain_fraction=0.75,
                                          seed=3)
    fz = synthetic.frozen_from_arrays(arrs)
    t_gen = time.perf_counter() - t0
    tries = {"plain": fz.device_arrays(device=dev)}
    t0 = time.perf_counter()
    for tag, kw in QUANT.items():
        tries[tag] = fz.device_arrays(device=dev, **kw)
    t_comp = (time.perf_counter() - t0) / len(QUANT)
    if tries["compressed"].layout != "compressed":
        raise AssertionError("compress: layout='auto' kept the chain trie "
                             "plain")
    comp = tries["compressed"]
    n, n_items = fz.n_nodes, int(arrs["edge_item"].max()) + 1
    log(f"[compress] synthetic_chain_trie(2^20, 0.75, seed=3): {n} nodes, "
        f"span fraction {fz.span_fraction():.4f}, "
        f"{comp.edge_item.shape[0]} compressed edges, max fanout "
        f"{fz.max_fanout}, depth {fz.max_depth}; made in {t_gen:.1f} s, "
        f"compressed and uploaded in {t_comp:.2f} s each; layout='auto' "
        f"-> compressed")

    rng = np.random.RandomState(args.seed + 4)
    queries, ant_len = synthetic.mixed_queries(rng, arrs, 4096, 8)
    prefixes = prefixes_for(arrs, n_items, 256, rng)
    items = [int(x) for x in rng.randint(0, n_items, size=248)]
    items += [items[0], items[1], -1, n_items + 3, 0, 1, 2, 3]
    q_t = torch.as_tensor(queries, device=dev)
    al_t = torch.as_tensor(ant_len, device=dev)

    # -- 7a. the main path on each trie, counters at 0 around each ------
    cols, res, launched = {}, {}, {}
    for tag, dt in tries.items():
        cols[tag] = layout_columns(dt)
        reset_launch_counts()
        res[tag] = drive_layout(dt, cols[tag], queries, ant_len, prefixes,
                                items)
        torch.cuda.synchronize()
        launched[tag] = launch_counts()
        log(f"[compress main path] {tag}: launches {launched[tag]}")
        if tag == "plain":
            require_launched(f"compress {tag}", launched[tag],
                             PLAIN_QUERY_KERNELS)
        else:
            require_launched(f"compress {tag}", launched[tag],
                             SPAN_QUERY_KERNELS)
            if launched[tag]["rule_search_fused"]:
                raise AssertionError(f"compress {tag}: the plain search ran")

    # -- 7b. compressed f32 == plain, bitwise ---------------------------
    def same(what, got, want):
        if not bitwise_equal(got, want):
            raise AssertionError(f"compress: {what} differs")

    p, c = res["plain"], res["compressed"]
    for key in p["search"]:
        same(f"search {key}", c["search"][key], p["search"][key])
    for k in ("topk10", "topk100"):
        for key in p[k]:
            same(f"{k} {key}", c[k][key], p[k][key])
    for role in ROLES:
        keys = ("values", "node") if role == "consequent" else \
            ("values", "node", "pos")
        for key in keys:
            same(f"rules_with {role} {key}", c[role][key], p[role][key])
    for key in ("n_rules", "confidence_max"):
        same(f"trie_reduce {key}", c["reduce"][key], p["reduce"][key])
    for key in ("support_sum", "mean_conf"):
        g, w = float(c["reduce"][key]), float(p["reduce"][key])
        if abs(g - w) > 1e-6 * abs(w):
            raise AssertionError(f"compress: trie_reduce {key} {g} vs {w}")
    found = p["search"]["found"]
    log(f"[compress] compressed f32 == plain on every op, bitwise "
        f"({int(found.sum())} of {len(queries)} rows found)")

    # -- 7c. every kernel call == its plain version, on every trie ------
    errs = {}
    for tag in QUANT:
        dt, cl = tries[tag], cols[tag]
        dq = ops._dequant_statics(dt)
        sa, skw = span_args(dt)
        got = rule_search_span(*sa, q_t, al_t, **skw)
        want = ref.rule_search_span_ref(*sa, q_t, al_t, **skw)
        check_same(f"rule_search_span {tag}", [got[k] for k in want],
                   [want[k] for k in want], errs.setdefault(
                       ("rule_search_span", tag), []))
        for k in (10, 100):
            want = ops.top_k_rules_batch(dt, prefixes, k, arrays=cl["dfs"],
                                         use_kernel=False)
            check_same(f"topk_rank_batch {tag} k={k}",
                       [res[tag][f"topk{k}"][x] for x in want],
                       [want[x] for x in want],
                       errs.setdefault(("topk_rank_batch", tag), []))
        for role in ROLES:
            want = ops.rules_with(dt, items, role=role, k=10, arrays=cl["ia"],
                                  use_kernel=False)
            check_same(f"rules_with_member {tag} {role}",
                       [res[tag][role][x] for x in want],
                       [want[x] for x in want],
                       errs.setdefault(("rules_with_member", tag), []))
        rq = dict(n_transactions=dq["n_transactions"],
                  confidence_scale=dq["confidence_scale"])
        got = trie_reduce_columns(dt.support, dt.confidence, dt.node_depth,
                                  **rq)
        want = ref.trie_reduce_ref(dt.support, dt.confidence, dt.node_depth,
                                   **rq)
        e = errs.setdefault(("trie_reduce_columns", tag), [])
        check_same(f"trie_reduce {tag} count/max", (got[0], got[2]),
                   (want[0], want[2]), e)
        for g, w in ((got[1], want[1]), (got[3], want[3])):
            e.append(abs(float(g) - float(w)))
            if abs(float(g) - float(w)) > 1e-6 * abs(float(w)):
                raise AssertionError(f"trie_reduce {tag} sum off")
        # the op answers are the kernel answers mapped back to node ids
        red = res[tag]["reduce"]
        if not (bitwise_equal(red["n_rules"], got[0])
                and bitwise_equal(red["confidence_max"], got[2])):
            raise AssertionError(f"compress {tag}: trie_reduce op != kernel")
    torch.cuda.synchronize()
    log("[compress] every span, rank, membership and reduce call equals "
        "its plain version on the card, on the f32, i32+bf16 and i32+int8 "
        "tries (bitwise; reduce sums to 1e-6)")

    # -- 7d. the quantized answers within the README's bounds ----------
    p_search = p["search"]
    mask = p_search["found"]
    cons_steps = ((q_t >= 0) & (torch.arange(q_t.shape[1], device=dev)[None]
                                >= al_t[:, None])).sum(1)
    single = cons_steps == 1
    # the plain consequent-path support of each row, for compound lift
    cons_q = torch.where(torch.arange(q_t.shape[1], device=dev)[None]
                         >= al_t[:, None], q_t, -1)
    cons = ops.rule_search(tries["plain"], cons_q, torch.zeros_like(al_t))
    con_sup = torch.where(cons["found"], cons["support"], 0.0)
    outside = {}
    p_conf = p_search["confidence"].double()
    for tag in ("i32+bf16", "i32+int8"):
        dt = tries[tag]
        q_s = res[tag]["search"]
        for key in ("found", "node"):
            same(f"{tag} search {key}", q_s[key], p_search[key])
        kind = "bf16" if dt.confidence.dtype == torch.bfloat16 else "int8"
        rtol = 2e-2 if kind == "bf16" else 6e-2
        sup_col = {"kind": "count", "n_transactions": dt.n_transactions}
        conf_col = {"kind": kind, "scale": dt.confidence_scale}
        lift_col = {"kind": kind, "scale": dt.lift_scale}
        w_sup = p_search["support"].double()
        w_lift = p_search["lift"].double()
        conf_b = product_bound(p_conf, cons_steps.double(), conf_col)
        # compound lift = confidence / consequent support; that support
        # is a count (error d), so the quotient moves by at most
        # (conf_b + lift d) / (support - d)
        cs = con_sup.double()
        d = column_bound(cs, sup_col)
        compound_b = torch.where(
            cs > 0, (conf_b + w_lift.abs() * d) / (cs - d).clamp(min=1e-30),
            0.0)
        lift_b = torch.where(single, column_bound(w_lift, lift_col),
                             compound_b)
        out = {
            "support": within(f"{tag} search support", q_s["support"],
                              p_search["support"],
                              column_bound(w_sup, sup_col), mask, rtol),
            "confidence": within(f"{tag} search confidence",
                                 q_s["confidence"], p_search["confidence"],
                                 conf_b, mask, rtol),
            "lift": within(f"{tag} search lift", q_s["lift"],
                           p_search["lift"], lift_b, mask, rtol),
        }
        # rankings by confidence: when every value moves by at most the
        # column's bound, so does the k-th best of any set; the live slots
        # are the same
        for k in ("topk10", "topk100", *ROLES):
            g, w = res[tag][k]["values"], res["plain"][k]["values"]
            live = w > -torch.inf
            same(f"{tag} {k} live slots", g > -torch.inf, live)
            wd = torch.where(live, w, 0.0).double()
            out[k] = within(f"{tag} {k} values", g, w,
                            column_bound(wd, conf_col), live, rtol)
        outside[tag] = out
    log(f"[compress] quantized answers within the README bounds of plain "
        f"f32 (found and node exact); values outside the reference test's "
        f"rtol (2e-2 bf16, 6e-2 int8): {json.dumps(outside)}")

    # -- 7e. the retail trie: auto keeps it plain; served compressed ----
    if retail.device_arrays(device=dev, layout="auto").layout != "plain":
        raise AssertionError("compress: layout='auto' compressed the retail "
                             "trie")
    rt = retail.device_arrays(device=dev, layout="compressed", quantize=True,
                              n_transactions=retail_n_tx)
    rp = retail.device_arrays(device=dev)
    paths = np.full((retail.n_nodes - 1, max(retail.max_depth, 1)), -1,
                    np.int32)
    for v in range(1, retail.n_nodes):
        path = retail.path_items(v)
        paths[v - 1, :len(path)] = path
    r_al = np.maximum((paths >= 0).sum(1) - 1, 0).astype(np.int32)
    reset_launch_counts()
    r_res = ops.rule_search_batch(rt, paths, r_al)
    torch.cuda.synchronize()
    r_launch = launch_counts()
    require_launched("compress retail", r_launch, ("rule_search_span",))
    r_plain = ops.rule_search_batch(rp, paths, r_al)
    r_found = r_res["found"].cpu().numpy()
    if not r_found.all() or not np.array_equal(
            r_res["node"].cpu().numpy(), np.arange(1, retail.n_nodes)):
        raise AssertionError("compress retail: a rule was not found")
    r_mask = torch.ones_like(r_res["found"])
    r_out = {"support": within(
        "retail support", r_res["support"], r_plain["support"],
        column_bound(r_plain["support"].double(),
                     {"kind": "count", "n_transactions": retail_n_tx}),
        r_mask, 2e-2)}
    for key in ("confidence", "lift"):
        # every retail row has a one-item consequent: the node's own value
        r_out[key] = within(
            f"retail {key}", r_res[key], r_plain[key],
            column_bound(r_plain[key].double(), {"kind": "bf16"}),
            r_mask, 2e-2)
    log(f"[compress retail] span fraction {retail.span_fraction():.4f}: "
        f"layout='auto' -> plain; compressed + int32/bf16 at n_transactions "
        f"{retail_n_tx}: all {int(r_found.sum())} rules found at their "
        f"nodes, values within the README bounds (outside rtol 2e-2: "
        f"{r_out}); launches {r_launch}; resident {rp.nbytes()} bytes "
        f"plain, {rt.nbytes()} compressed + quantized")

    # -- 7f. resident bytes and op ms, compressed against plain ---------
    for tag, dt in tries.items():
        log(f"[compress resident] {tag}: DeviceTrie {dt.nbytes()} bytes; "
            f"with the three memoized column dicts "
            f"{resident_bytes(dt, *cols[tag].values())} bytes")
    op_ms = {tag: time_layout_ops(dt, cols[tag], queries, ant_len, prefixes,
                                  items, reps)
             for tag, dt in tries.items()}
    log("[compress ops ms] " + json.dumps(op_ms))

    # -- 7g. kernel times: the span search and the quantized variants ---
    los, his, _ = ops.prefix_ranges(comp, prefixes)
    union = covered_positions(n, los, his)
    span_len = float((his - los).clamp(min=0).sum())
    qitems = ops._posting_slices(cols["compressed"]["ia"]["item_offsets"],
                                 items)
    u_plos, u_phis, u_items = ops._pad_pow2_rows(
        *[a[np.unique(qitems[2], return_index=True)[1]] for a in qitems])
    dq_rows = []
    f32_ms = {}
    for tag in QUANT:
        dt, cl = tries[tag], cols[tag]
        dq = ops._dequant_statics(dt)
        es_s, es_c = dt.support.element_size(), dt.confidence.element_size()
        sa, skw = span_args(dt)
        r_args = (dt.support, dt.confidence, dt.lift, dt.node_depth, los, his)
        r_kw = dict(k=100, metric="confidence", min_depth=1, **dq)
        m_args = (dt.support, dt.confidence, dt.lift, dt.node_depth,
                  dt.node_item, dt.post_lo, dt.post_hi,
                  *[torch.as_tensor(a, device=dev)
                    for a in (u_plos, u_phis, u_items)])
        m_kw = dict(k=10, metric="confidence", min_depth=1, role="any", **dq)
        rq = dict(n_transactions=dq["n_transactions"],
                  confidence_scale=dq["confidence_scale"])
        range_len = torch.cat([
            torch.zeros((1,), dtype=torch.float64, device=dev),
            (dt.post_hi - dt.post_lo).double().cumsum(0)])
        members = float((range_len[torch.as_tensor(u_phis, device=dev)
                                   .long()]
                         - range_len[torch.as_tensor(u_plos, device=dev)
                                     .long()]).sum())
        calls = {
            "rule_search_span": (
                lambda: rule_search_span(*sa, q_t, al_t, **skw),
                lambda: ref.rule_search_span_ref(*sa, q_t, al_t, **skw),
                (span_walk_work(dt, q_t, al_t), q_t.shape[0] * 8),
                "cuda", "src/repro_torch/kernels/csrc/rule_search.cu",
                "src/repro/kernels/rule_search.py:565"),
            "topk_rank_batch": (
                lambda: topk_rank_batch(*r_args, **r_kw),
                lambda: ref.topk_rank_batch_ref(*r_args, **r_kw),
                (score_bytes(r_kw["metric"], dt.support, dt.confidence)
                 * union + 8 * los.numel() + 8 * los.numel() * r_kw["k"],
                 3 * span_len),
                "cuda", "src/repro_torch/kernels/csrc/rank.cu",
                "src/repro/kernels/rank.py:178"),
            "rules_with_member": (
                lambda: rules_with_member(*m_args, **m_kw),
                lambda: ref.rules_with_ref(*m_args, **m_kw),
                (member_work(n, dt.post_lo, dt.post_hi, u_plos, u_phis,
                             u_items.size, m_kw["k"],
                             score_bytes(m_kw["metric"], dt.support,
                                         dt.confidence)),
                 3 * members),
                "cuda", "src/repro_torch/kernels/csrc/item_index.cu",
                "src/repro/kernels/item_index.py:162"),
            "trie_reduce_columns": (
                lambda: trie_reduce_columns(dt.support, dt.confidence,
                                            dt.node_depth, **rq),
                lambda: ref.trie_reduce_ref(dt.support, dt.confidence,
                                            dt.node_depth, **rq),
                ((es_s + es_c + 4) * n + 16, 4 * n),
                "triton", "src/repro_torch/kernels/trie_reduce.py",
                "src/repro/kernels/trie_reduce.py:50"),
        }
        for name, (kern, plain, work, *where) in calls.items():
            if name != "rule_search_span" and tag == "compressed":
                # the f32 twin of a quantized row, timed in the same run
                f32_ms[name] = device_ms(kern, reps, l2_flush.zero_,
                                         kernel=KERNEL_NAMES[name])
                continue
            if name == "rule_search_span" and tag != "compressed":
                f32_ms[f"rule_search_span {tag}"] = device_ms(
                    kern, reps, l2_flush.zero_, kernel=KERNEL_NAMES[name])
                continue
            row = kernel_row(
                name, kern, plain, work, where, launched[tag][name],
                max(errs[(name, tag)]), reps, l2_flush.zero_,
                label=name if tag == "compressed" else f"{name} [{tag}]")
            if name != "rule_search_span":
                row["f32_ms"] = f32_ms[name]
                log(f"[kernel] {row['name']}: its f32 twin on the same trie "
                    f"{f32_ms[name]} ms device")
            else:
                # the plain layout's fused search on the same rows
                pe = cols["plain"]["edges"]
                fused = (pe["child_offsets"], pe["edge_item"],
                         pe["edge_child"], pe["edge_conf"], pe["edge_sup"],
                         pe["edge_lift"], q_t, al_t)
                row["plain_layout_fused_ms"] = device_ms(
                    lambda: rule_search_fused(
                        *fused, max_fanout=pe["max_fanout"]),
                    reps, l2_flush.zero_,
                    kernel=KERNEL_NAMES["rule_search_fused"])
                log(f"[kernel] rule_search_fused on the plain chain trie, "
                    f"same rows: {row['plain_layout_fused_ms']} ms device")
            dq_rows.append(row)
    span_row = next(r for r in dq_rows if r["name"] == "rule_search_span")
    span_row["quantized_ms"] = {k.split(" ", 1)[1]: v
                                for k, v in f32_ms.items()
                                if k.startswith("rule_search_span")}
    log(f"[kernel] rule_search_span on the quantized tries (device ms): "
        f"{span_row['quantized_ms']}")
    return dq_rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--edges", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from repro_torch.core import synthetic
    from repro_torch.kernels import (
        KERNELS, launch_counts, ops, reset_launch_counts,
    )
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.item_index import rules_with_member
    from repro_torch.kernels.rank import topk_rank_batch
    from repro_torch.kernels.rule_search import rule_search_fused
    from repro_torch.kernels.trie_reduce import trie_reduce_columns
    from repro_torch.serve import TrieQueryEngine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] nvcc {sorted(_build.SIGNATURES)} in "
        f"{time.perf_counter() - t0:.1f} s -> {_build.build_info['dir']}")
    for name, text in _build.build_info["ptxas"].items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    # -- 2. the trie ---------------------------------------------------
    t0 = time.perf_counter()
    arrs = synthetic.synthetic_csr_trie(args.edges, seed=args.seed)
    frozen = synthetic.frozen_from_arrays(arrs)
    engine = TrieQueryEngine(frozen, device=dev)
    dt = engine.dt
    n = frozen.n_nodes
    n_items = int(arrs["edge_item"].max()) + 1
    log(f"[trie] {n} nodes, {frozen.n_edges} edges, max_fanout "
        f"{frozen.max_fanout}, max_postings {frozen.max_postings}, "
        f"{dt.nbytes()} resident bytes, built in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.RandomState(args.seed + 1)
    prefixes = prefixes_for(arrs, n_items, 256, rng)
    items = [int(x) for x in rng.randint(0, n_items, size=248)]
    items += [items[0], items[1], -1, n_items + 3, 0, 1, 2, 3]
    queries, ant_len = synthetic.synthetic_search_queries(
        arrs, 4096, 8, seed=args.seed + 2)
    pairs = []
    for row in range(0, 512, 2):
        path = [int(x) for x in queries[row] if x >= 0]
        cut = int(rng.randint(0, len(path) + 1))
        pairs.append((path[:cut][::-1], path[cut:]))

    dfs = ops.dfs_rank_arrays(dt)
    dfs["_device_trie"] = dt
    ia = ops.item_rank_arrays(dt)
    edges = ops.edge_metric_arrays(dt)
    los, his, _ = ops.prefix_ranges(frozen, prefixes, dt=dt)
    q_t = torch.as_tensor(queries, device=dev)
    al_t = torch.as_tensor(ant_len, device=dev)
    plos, phis, qitems = ops._posting_slices(ia["item_offsets"], items)
    plos_t = torch.as_tensor(plos, device=dev)
    phis_t = torch.as_tensor(phis, device=dev)
    qitems_t = torch.as_tensor(qitems, device=dev)

    def tie_heavy(cols):
        return [torch.round(c * 10) / 10 for c in cols]

    # -- 3. kernel vs plain version at full size -----------------------
    t0 = time.perf_counter()
    errs = {name: [] for name in KERNELS}
    rank_cols = [dfs["support"], dfs["confidence"], dfs["lift"]]
    for cols, tag in ((rank_cols, "plain"), (tie_heavy(rank_cols), "ties")):
        for metric in METRICS:
            # k = 1500 passes the 1024-position tile: the chunk lists then
            # live in global scratch
            for k in ((10, 100, 1500) if metric == "confidence" else (10, 100)):
                kw = dict(k=k, metric=metric, min_depth=1)
                check_same(
                    f"topk_rank_batch {tag} {metric} k={k}",
                    topk_rank_batch(*cols, dfs["depth"], los, his, **kw),
                    ref.topk_rank_batch_ref(*cols, dfs["depth"], los, his,
                                            **kw),
                    errs["topk_rank_batch"])
    p_cols = [ia["p_support"], ia["p_confidence"], ia["p_lift"]]
    for metric in METRICS:
        kw = dict(k=10, metric=metric, min_depth=1)
        check_same(
            f"topk_rank_batch posting ranges {metric}",
            topk_rank_batch(*p_cols, ia["p_depth"], plos_t, phis_t, **kw),
            ref.topk_rank_batch_ref(*p_cols, ia["p_depth"], plos_t, phis_t,
                                    **kw),
            errs["topk_rank_batch"])
    m_cols = [ia["support"], ia["confidence"], ia["lift"]]
    sel = slice(0, 64)
    for cols, tag in ((m_cols, "plain"), (tie_heavy(m_cols), "ties")):
        for role in ROLES:
            for metric in METRICS:
                for k in ((10, 100, 1500) if metric == "confidence"
                          else (10,)):
                    args_m = (*cols, ia["depth"], ia["node_item"],
                              ia["post_lo"], ia["post_hi"], plos_t[sel],
                              phis_t[sel], qitems_t[sel])
                    kw = dict(k=k, metric=metric, min_depth=1, role=role)
                    check_same(
                        f"rules_with_member {tag} {role} {metric} k={k}",
                        rules_with_member(*args_m, **kw),
                        ref.rules_with_ref(*args_m, **kw),
                        errs["rules_with_member"])
    e_args = (edges["child_offsets"], edges["edge_item"], edges["edge_child"],
              edges["edge_conf"], edges["edge_sup"], edges["edge_lift"],
              q_t, al_t)
    got = rule_search_fused(*e_args, max_fanout=edges["max_fanout"])
    want = ref.rule_search_fused_ref(*e_args, max_fanout=edges["max_fanout"])
    check_same("rule_search_fused", [got[k] for k in want],
               [want[k] for k in want], errs["rule_search_fused"])
    for cols, tag in (((dt.support, dt.confidence), "plain"),
                      (tie_heavy((dt.support, dt.confidence)), "ties")):
        got = trie_reduce_columns(*cols, dt.node_depth)
        want = ref.trie_reduce_ref(*cols, dt.node_depth)
        check_same(f"trie_reduce {tag} count/max", (got[0], got[2]),
                   (want[0], want[2]), errs["trie_reduce_columns"])
        for g, w in ((got[1], want[1]), (got[3], want[3])):
            rel = abs(float(g) - float(w)) / max(abs(float(w)), 1e-30)
            errs["trie_reduce_columns"].append(abs(float(g) - float(w)))
            if rel > 1e-6:
                raise AssertionError(f"trie_reduce {tag} sum off by {rel}")
    torch.cuda.synchronize()
    log(f"[parity] every kernel equals its plain version "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- 4. the main path through TrieQueryEngine ----------------------
    reset_launch_counts()
    t0 = time.perf_counter()
    res = drive_engine(engine, queries, ant_len, pairs, prefixes, items)
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"[main path] {time.perf_counter() - t0:.2f} s, launches {launches}")
    require_launched("main path", launches, PLAIN_QUERY_KERNELS)
    check_answers("main path", res, engine, queries, ant_len, pairs,
                  prefixes, items)
    found = res["search"]["found"].cpu().numpy()
    if not found[0::2].all():
        raise AssertionError("a real root path was not found")
    log("[main path] answers equal the oracles")

    # -- 5. timing -----------------------------------------------------
    reps = args.reps
    op_ms = time_ops(engine, queries, ant_len, prefixes, items, reps)
    log("[ops ms] " + json.dumps(op_ms))

    u_plos, u_phis, u_items = ops._pad_pow2_rows(
        *[a[np.unique(qitems, return_index=True)[1]]
          for a in (plos, phis, qitems)])
    m_args = (*m_cols, ia["depth"], ia["node_item"], ia["post_lo"],
              ia["post_hi"], torch.as_tensor(u_plos, device=dev),
              torch.as_tensor(u_phis, device=dev),
              torch.as_tensor(u_items, device=dev))
    m_kw = dict(k=10, metric="confidence", min_depth=1, role="any")
    r_args = (*rank_cols, dfs["depth"], los, his)
    r_kw = dict(k=100, metric="confidence", min_depth=1)
    f_kw = dict(max_fanout=edges["max_fanout"])
    red_args = (dt.support, dt.confidence, dt.node_depth)
    calls = {
        "topk_rank_batch": (
            lambda: topk_rank_batch(*r_args, **r_kw),
            lambda: ref.topk_rank_batch_ref(*r_args, **r_kw)),
        "rule_search_fused": (
            lambda: rule_search_fused(*e_args, **f_kw),
            lambda: ref.rule_search_fused_ref(*e_args, **f_kw)),
        "rules_with_member": (
            lambda: rules_with_member(*m_args, **m_kw),
            lambda: ref.rules_with_ref(*m_args, **m_kw)),
        "trie_reduce_columns": (
            lambda: trie_reduce_columns(*red_args),
            lambda: ref.trie_reduce_ref(*red_args)),
    }

    # the least time the card needs for each call's work on this data:
    # the columns each score reads (score_bytes), once per covered position
    span = (his - los).clamp(min=0)
    main_steps, cons_steps = walk_steps(dt, q_t, al_t)
    # an item's members (role any) are the positions its posting ranges
    # cover: a score, a compare and a select each
    range_len = torch.cat([
        torch.zeros((1,), dtype=torch.float64, device=dev),
        (ia["post_hi"] - ia["post_lo"]).double().cumsum(0)])
    members = float((range_len[torch.as_tensor(u_phis, device=dev).long()]
                     - range_len[torch.as_tensor(u_plos, device=dev).long()]
                     ).sum())
    work = {
        "topk_rank_batch": (
            score_bytes(r_kw["metric"], *rank_cols[:2])
            * covered_positions(n, los, his)
            + 8 * los.numel() + 8 * los.numel() * r_kw["k"],
            3 * float(span.sum())),
        "rule_search_fused": (
            queries.size * 4 + ant_len.size * 4 + 24 * queries.shape[0]
            + 28 * main_steps + 20 * cons_steps,
            queries.shape[0] * 8),
        "rules_with_member": (
            member_work(n, ia["post_lo"], ia["post_hi"], u_plos, u_phis,
                        u_items.size, m_kw["k"],
                        score_bytes(m_kw["metric"], *m_cols[:2])),
            3 * members),
        "trie_reduce_columns": (12 * n + 16, 4 * n),
    }
    sources = {
        "topk_rank_batch": ("cuda", "src/repro_torch/kernels/csrc/rank.cu",
                            "src/repro/kernels/rank.py:178"),
        "rule_search_fused": (
            "cuda", "src/repro_torch/kernels/csrc/rule_search.cu",
            "src/repro/kernels/rule_search.py:333"),
        "rules_with_member": (
            "cuda", "src/repro_torch/kernels/csrc/item_index.cu",
            "src/repro/kernels/item_index.py:162"),
        "trie_reduce_columns": (
            "triton", "src/repro_torch/kernels/trie_reduce.py",
            "src/repro/kernels/trie_reduce.py:50"),
    }
    # "ms" and "plain_ms" are device time from a profiler trace, the 50 MB
    # L2 flushed before each call: the wrapper's own kernels
    # (KERNEL_NAMES), and every kernel the plain version ran;
    # "whole_call_ms" is the wrapper's call on plain_ms's scope (its own
    # casts, clamps and reductions too); "call_ms" and "plain_call_ms" are
    # CUDA events around one call, host launch work included, which is
    # all a call shorter than its launches shows
    l2_flush = torch.empty((L2_FLUSH_BYTES // 4,), dtype=torch.float32,
                           device=dev)
    rows = [kernel_row(name, kern, plain, work[name], sources[name],
                       launches[name], max(errs[name]), reps, l2_flush.zero_)
            for name, (kern, plain) in calls.items()]

    # -- 6. construction: mine -> trie -> annotate, then serve it -------
    row, retail, retail_n_tx = construction_phase(args, dev, l2_flush)
    rows.append(row)
    log(f"[construct] phase done at {time.perf_counter() - t_start:.1f} s")

    # -- 7. the compressed layout: the chain trie, then the retail trie --
    rows.extend(compressed_phase(args, dev, l2_flush, retail, retail_n_tx))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
