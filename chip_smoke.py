#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's batched query path on one NVIDIA GPU.

    python3 chip_smoke.py [--edges N] [--seed S] [--reps R]

1. Builds the four kernels from ``src/repro_torch/kernels/csrc`` (nvcc, in
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
5. Prints the GPU's name and power limit, one ``{"kernels": [...]}`` line,
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


def device_ms(fn, reps, flush):
    """Mean device milliseconds per call of ``fn`` with a cold L2: the
    durations of the kernels (and copies) it ran on the card, summed from
    a torch.profiler trace of ``reps`` calls each after ``flush()``, less
    a trace of ``flush()`` alone.  None when a trace holds no device
    event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def traced_us(call):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush()
                call()
            torch.cuda.synchronize()
        return sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA)

    fn()
    torch.cuda.synchronize()
    both, alone = traced_us(fn), traced_us(lambda: None)
    if both <= 0 or alone <= 0:
        return None
    return (both - alone) / reps / 1e3


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
    from repro_torch.core.array_trie import batched_rule_search, traverse_reduce
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
    res = {
        "search": engine.rule_search_batch(queries, ant_len),
        "search_pairs": engine.rule_search_batch(pairs),
        "topk10": engine.top_k_rules_batch(prefixes, 10),
        "topk100": engine.top_k_rules_batch(prefixes, 100),
        "reduce": engine.trie_reduce(),
    }
    for role in ROLES:
        res[role] = engine.rules_with(items, role=role, k=10)
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"[main path] {time.perf_counter() - t0:.2f} s, launches {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")

    # answers against the tensor oracles and the plain ops
    oracle = batched_rule_search(dt, q_t, al_t)
    for key in oracle:
        if not bitwise_equal(res["search"][key], oracle[key]):
            raise AssertionError(f"rule_search_batch {key} != oracle")
    found = res["search"]["found"].cpu().numpy()
    if not found[0::2].all():
        raise AssertionError("a real root path was not found")
    pq, pal = frozen.canonicalize_queries([p[0] for p in pairs],
                                          [p[1] for p in pairs])
    oracle = batched_rule_search(dt, torch.as_tensor(pq, device=dev),
                                 torch.as_tensor(pal, device=dev))
    for key in oracle:
        if not bitwise_equal(res["search_pairs"][key], oracle[key]):
            raise AssertionError(f"rule_search_batch pairs {key} != oracle")
    for k in (10, 100):
        want = ops.top_k_rules_batch(frozen, prefixes, k, arrays=dfs,
                                     use_kernel=False, device=dev)
        for key in want:
            if not bitwise_equal(res[f"topk{k}"][key], want[key]):
                raise AssertionError(f"top_k_rules_batch k={k} {key}")
        if res[f"topk{k}"]["values"].shape != (len(prefixes), k):
            raise AssertionError("top_k_rules_batch shape")
    for role in ROLES:
        want = ops.rules_with(frozen, items, role=role, k=10, arrays=ia,
                              use_kernel=False, device=dev)
        for key in want:
            if not bitwise_equal(res[role][key], want[key]):
                raise AssertionError(f"rules_with {role} {key}")
    want = traverse_reduce(dt)
    if float(res["reduce"]["n_rules"]) != float(want["n_rules"]) or \
            float(res["reduce"]["n_rules"]) != n - 1:
        raise AssertionError("trie_reduce n_rules")
    for key in ("support_sum", "confidence_max", "mean_conf"):
        got, w = float(res["reduce"][key]), float(want[key])
        if not math.isfinite(got) or abs(got - w) > 1e-6 * abs(w):
            raise AssertionError(f"trie_reduce {key}: {got} vs {w}")
    log("[main path] answers equal the oracles")

    # -- 5. timing -----------------------------------------------------
    reps = args.reps
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

    # the least time the card needs for each call's work on this data
    span = (his - los).clamp(min=0)
    covered = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    covered.index_add_(0, los.long(), torch.ones_like(los))
    covered.index_add_(0, his.long(), -torch.ones_like(his))
    union = int((covered.cumsum(0)[:n] > 0).sum())
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
            16 * union + 8 * los.numel() + 8 * los.numel() * r_kw["k"],
            3 * float(span.sum())),
        "rule_search_fused": (
            queries.size * 4 + ant_len.size * 4 + 24 * queries.shape[0]
            + 28 * main_steps + 20 * cons_steps,
            queries.shape[0] * 8),
        "rules_with_member": (
            20 * n + 8 * int((u_phis - u_plos).sum()) + 12 * u_items.size
            + 8 * u_items.size * m_kw["k"],
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
    # "ms" and "plain_ms" are device time (the kernels each call ran, from
    # a profiler trace, the 50 MB L2 flushed before each call);
    # "call_ms" and "plain_call_ms" are CUDA events around one call, host
    # launch work included, which is all a call shorter than its launches
    # shows
    l2_flush = torch.empty((L2_FLUSH_BYTES // 4,), dtype=torch.float32,
                           device=dev)
    rows = []
    for name, (kern, plain) in calls.items():
        call_ms = cuda_ms(kern, reps)
        plain_call_ms = cuda_ms(plain, reps, warmup=1)
        ms = device_ms(kern, reps, l2_flush.zero_)
        plain_ms = device_ms(plain, reps, l2_flush.zero_)
        timer = "profiler"
        if ms is None or plain_ms is None:
            ms, plain_ms, timer = call_ms, plain_call_ms, "events"
        nbytes, nops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / FP32_OPS_PER_S * 1e3
        route, source, replaces = sources[name]
        rows.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs[name]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "timer": timer, "call_ms": call_ms,
            "plain_call_ms": plain_call_ms,
        })
        log(f"[kernel] {name}: {ms:.4f} ms device ({timer}), "
            f"{call_ms:.4f} ms per call; plain {plain_ms:.4f} / "
            f"{plain_call_ms:.4f} ms; bound {rows[-1]['bound_ms']:.4f} ms "
            f"({rows[-1]['bound_by']})")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
