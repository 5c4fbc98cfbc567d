#!/usr/bin/env python3
"""Time the selection, support-count, full-sweep, descent-search and
reduction kernels of two or more checkouts of the port on one NVIDIA GPU,
in turns, at ``chip_smoke.py``'s main-path shapes: the port's A/B timer.

    python3 rank_ab.py TREE [TREE ...] [--edges N] [--reps R]
                       [--lanes rank,member,chain,support,sweep,search,
                                reduce]

Each TREE is the root of a checkout (a directory holding
``src/repro_torch``); list them in the order to run, e.g. ``parent
change change parent``, so that a drift of the card shows.  Each runs in
its own process, which builds that tree's kernels into the tree's own
``build/`` and times, as device ms of the wrapper's own kernels from a
``torch.profiler`` trace with the L2 flushed before each call (mean of
``--reps`` calls; ``chip_smoke.device_ms``):

- ``topk_rank_batch`` over the 256 prefixes of ``chip_smoke``'s query
  traffic on ``synthetic_csr_trie(--edges)`` at k = 10 and 100;
- ``rules_with_member`` per role at k = 10 over the traffic's items on
  the hub trie (``chip_smoke.member_kernel_rows``);
- on ``synthetic_chain_trie(2^20, 0.75, seed=3)`` compressed with int32
  + bf16 and with int32 + int8 columns, with ``chip_smoke.chain_traffic``:
  the rank kernel at k = 100 and the membership kernel per role at
  k = 10;
- ``support_count_bitmap`` at each of the 8 launches of one retail build
  (``online_retail_db()`` at ``chip_smoke.MINSUP``: apriori's counting
  levels on the kernel path, then the annotation;
  ``chip_smoke.support_launches``), by kernel name, and in total; beside
  each, CUDA events around one call (``_call_ms``), host work included;
- ``rule_search_sweep``, both launches of one seed-layout search
  (``chip_smoke.seed_phase``: the 2^20 trie served without CSR offsets,
  its rows from ``chip_smoke.seed_rows`` and ``sweep_launch_rows``), by
  kernel name, and in total, with CUDA events around one call beside each;
- ``rule_search_fused`` over the 4096 search rows of the query traffic on
  ``synthetic_csr_trie(--edges)`` (the call ``chip_smoke.py`` times), and
  ``rule_search_span`` over ``chip_smoke.chain_traffic``'s rows on the
  chain trie compressed with f32, int32 + bf16 and int32 + int8 columns,
  each with CUDA events around one call beside it, and around one
  ``ops.rule_search_batch`` over the same rows (``_op_ms``, host prep
  included); and the fused kernel over as many all-padding rows (no
  walk takes a step: its fixed cost);
- ``trie_reduce_columns`` on ``synthetic_csr_trie(2^20)`` and
  ``synthetic_csr_trie(2^23)`` (twice the L2: the streaming rate), on
  the first 4,096 nodes of the first (its fixed cost), and on the chain
  trie compressed with f32, int32 + bf16 and int32 + int8 columns, by the
  kernel names of either version (two Triton kernels, or one CUDA
  kernel), each with CUDA events around one call beside it, and around
  one ``ops.trie_reduce`` on each hub trie (``_op_ms``).

``--lanes`` picks a subset: ``rank`` and ``member`` on the 2^20 trie,
``chain`` on the chain trie, ``support``, ``sweep`` (always on a 2^20
trie), ``search``, ``reduce``.  Every tree's answers are
checked against its plain versions.  Prints one JSON line per run and,
last, the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# every selection kernel name either version of the port launches
RANK_KERNELS = ("score_kernel", "chunk_topk_kernel", "merge_pairs_kernel",
                "rank_seed_kernel", "rank_topk_kernel")
MEMBER_KERNELS = ("score_kernel", "member_count", "member_ranges",
                  "member_plan", "member_topk")
# every support-count kernel name either version launches: the
# warp-per-candidate kernel, or the pre-pass (a memset and the mark
# kernel) and the tile pass
SUPPORT_KERNELS = ("support_count_kernel", "Memset", "support_mark_kernel",
                   "support_tile_kernel")
# every full-sweep kernel name either version launches: one kernel a
# launch, or the fingerprint pass and per step the advance and the match
SWEEP_KERNELS = ("rule_search_sweep_kernel", "sweep_fingerprint_kernel",
                 "sweep_advance_kernel", "sweep_match_kernel")
# the two descent searches' kernels, by name in either version
SEARCH_KERNELS = ("rule_search_fused_kernel", "rule_search_span_kernel")
SEARCH_KEYS = ("found", "confidence", "support", "lift", "con_support")
# the traversal reduction's kernels in either version: two Triton kernels,
# or the one CUDA kernel
REDUCE_KERNELS = ("partials", "fold", "trie_reduce_kernel")
LANES = ("rank", "member", "chain", "support", "sweep", "search", "reduce")


def one(tree, edges, reps, lanes):
    import chip_smoke as cs  # stdlib only at import

    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch

    from repro_torch.kernels import _build

    assert os.path.abspath(tree) in os.path.abspath(_build.__file__)
    dev = torch.device("cuda", 0)
    _build.build_all()
    out = {"tree": tree}
    flush = torch.empty((cs.L2_FLUSH_BYTES // 4,), dtype=torch.float32,
                        device=dev).zero_

    def timed(name, call, plain, kernels, split=False):
        for g, w in zip(call(), plain()):
            if not cs.bitwise_equal(g, w):
                raise AssertionError(f"{tree}: {name} differs from plain")
        out[name] = cs.device_ms(call, reps, flush, kernel=kernels)
        if split:
            # each kernel of the call alone (None: not launched here)
            out[name + "_by_kernel"] = {
                kern: cs.device_ms(call, reps, flush, kernel=kern)
                for kern in kernels}

    if "support" in lanes:
        support_lane(cs, dev, timed, out, reps)
    if lanes & {"rank", "member"}:
        query_lanes(cs, dev, timed, edges, lanes)
    if "chain" in lanes:
        chain_lane(cs, dev, timed)
    if "sweep" in lanes:
        sweep_lane(cs, dev, timed, out, reps)
    if "search" in lanes:
        search_lane(cs, dev, timed, out, edges, reps)
    if "reduce" in lanes:
        reduce_lane(cs, dev, flush, out, reps)
    print(json.dumps(out), flush=True)


def support_lane(cs, dev, timed, out, reps):
    import torch

    from repro_torch.arm.datasets import online_retail_db
    from repro_torch.kernels import ref
    from repro_torch.kernels.support_count import support_count_bitmap

    db = online_retail_db()
    tags, launches, _ = cs.support_launches(db, cs.MINSUP, dev)
    bm = db.device_bitmaps(dev)
    total = call_total = 0.0
    for tag, (mat, lens) in zip(tags, launches):
        a = (bm, torch.as_tensor(mat, device=dev),
             torch.as_tensor(lens, device=dev), db.n_transactions)
        name = "support_" + tag.replace(" ", "")
        timed(name, lambda: (support_count_bitmap(*a),),
              lambda: (ref.support_count_bitmap_ref(*a),), SUPPORT_KERNELS,
              split=True)
        out[name + "_call_ms"] = cs.cuda_ms(
            lambda: support_count_bitmap(*a), reps)
        total += out[name]
        call_total += out[name + "_call_ms"]
    out["support_total"], out["support_total_call_ms"] = total, call_total


def sweep_lane(cs, dev, timed, out, reps):
    import dataclasses

    from repro_torch.core import synthetic
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rule_search import rule_search_sweep

    arrs = synthetic.synthetic_csr_trie(cs.SEED_EDGES, seed=0)
    frozen = synthetic.frozen_from_arrays(arrs)
    queries, ant_len, pairs, _, _ = cs.query_traffic(arrs, 0)
    rows, rows_al = cs.seed_rows(queries, ant_len, frozen, pairs)
    seed = dataclasses.replace(frozen.device_arrays(device=dev),
                               child_offsets=None, max_fanout=0)
    sw = ops.edge_metric_arrays(seed)
    cols = [sw[k] for k in ("edge_parent", "edge_item", "edge_child",
                            "edge_conf", "edge_sup", "edge_lift")]
    total = call_total = 0.0
    for tag, (q_t, al_t) in cs.sweep_launch_rows(rows, rows_al, dev).items():
        name = "sweep_" + tag.replace(" ", "_")
        timed(name,
              lambda: tuple(rule_search_sweep(*cols, q_t, al_t).values()),
              lambda: tuple(ref.rule_search_sweep_ref(
                  *cols, q_t, al_t).values()),
              SWEEP_KERNELS, split=True)
        out[name + "_call_ms"] = cs.cuda_ms(
            lambda: rule_search_sweep(*cols, q_t, al_t), reps)
        total += out[name]
        call_total += out[name + "_call_ms"]
    out["sweep_total"], out["sweep_total_call_ms"] = total, call_total


def search_lane(cs, dev, timed, out, edges, reps):
    import torch

    from repro_torch.core import synthetic
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rule_search import (
        rule_search_fused, rule_search_span,
    )

    def answers(res, where):
        return tuple(res[k] for k in (where, *SEARCH_KEYS))

    arrs = synthetic.synthetic_csr_trie(edges, seed=0)
    dt = synthetic.frozen_from_arrays(arrs).device_arrays(device=dev)
    queries, ant_len, _, _, _ = cs.query_traffic(arrs, 0)
    e = ops.edge_metric_arrays(dt)
    f_args = [e[k] for k in ("child_offsets", "edge_item", "edge_child",
                             "edge_conf", "edge_sup", "edge_lift")]
    f_args += [torch.as_tensor(queries, device=dev),
               torch.as_tensor(ant_len, device=dev)]
    f_kw = dict(max_fanout=e["max_fanout"])
    timed("search_fused",
          lambda: answers(rule_search_fused(*f_args, **f_kw), "node"),
          lambda: answers(ref.rule_search_fused_ref(*f_args, **f_kw),
                          "node"), SEARCH_KERNELS)
    out["search_fused_call_ms"] = cs.cuda_ms(
        lambda: rule_search_fused(*f_args, **f_kw), reps)
    # the search op around it, host prep included
    out["search_op_ms"] = cs.cuda_ms(
        lambda: ops.rule_search_batch(dt, queries, ant_len, edges=e), reps)
    # the same launch over all-padding rows: no walk takes a step, what is
    # left is the launch, the row's round and the writes
    blank = [*f_args[:6], torch.full_like(f_args[6], -1), f_args[7]]
    timed("search_fused_blank_rows",
          lambda: answers(rule_search_fused(*blank, **f_kw), "node"),
          lambda: answers(ref.rule_search_fused_ref(*blank, **f_kw),
                          "node"), SEARCH_KERNELS)
    carrs = synthetic.synthetic_chain_trie(1 << 20, chain_fraction=0.75,
                                           seed=3)
    cfz = synthetic.frozen_from_arrays(carrs)
    cq, cal, _, _ = cs.chain_traffic(carrs, 0)
    cq_t = torch.as_tensor(cq, device=dev)
    cal_t = torch.as_tensor(cal, device=dev)
    for tag in cs.QUANT:
        cdt = cfz.device_arrays(device=dev, **cs.QUANT[tag])
        sa, skw = cs.span_args(cdt)
        name = "search_span_" + tag.replace("+", "_")
        timed(name,
              lambda: answers(rule_search_span(*sa, cq_t, cal_t, **skw),
                              "pos"),
              lambda: answers(ref.rule_search_span_ref(*sa, cq_t, cal_t,
                                                       **skw), "pos"),
              SEARCH_KERNELS)
        out[name + "_call_ms"] = cs.cuda_ms(
            lambda: rule_search_span(*sa, cq_t, cal_t, **skw), reps)
        ce = ops.edge_metric_arrays(cdt)
        out[name + "_op_ms"] = cs.cuda_ms(
            lambda: ops.rule_search_batch(cdt, cq, cal, edges=ce), reps)


def reduce_lane(cs, dev, flush, out, reps):
    import torch

    from repro_torch.core import synthetic
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.trie_reduce import trie_reduce_columns

    def timed_reduce(name, cols, **kw):
        # count and max bitwise, the sums to 1e-6 relative: the plain
        # version adds in another order
        got = trie_reduce_columns(*cols, **kw)
        want = ref.trie_reduce_ref(*cols, **kw)
        for i in range(4):
            g, w = float(got[i]), float(want[i])
            if not (cs.bitwise_equal(got[i], want[i]) if i in (0, 2)
                    else abs(g - w) <= 1e-6 * abs(w)):
                raise AssertionError(f"{name}: output {i} {g} vs {w}")
        out[name] = cs.device_ms(lambda: trie_reduce_columns(*cols, **kw),
                                 reps, flush, kernel=REDUCE_KERNELS)
        out[name + "_call_ms"] = cs.cuda_ms(
            lambda: trie_reduce_columns(*cols, **kw), reps)

    for edges, tag in ((1 << 20, "hub20"), (1 << 23, "hub23")):
        dt = synthetic.frozen_from_arrays(synthetic.synthetic_csr_trie(
            edges, seed=0)).device_arrays(device=dev)
        cols = (dt.support, dt.confidence, dt.node_depth)
        timed_reduce(f"reduce_{tag}", cols)
        # the op around it: the wrapper's host work and every launch
        out[f"reduce_{tag}_op_ms"] = cs.cuda_ms(lambda: ops.trie_reduce(dt),
                                                reps)
        if tag == "hub20":
            # 4,096 nodes: what a launch costs whatever its work
            timed_reduce("reduce_floor4096", tuple(c[:4096] for c in cols))
        del dt, cols
        torch.cuda.empty_cache()
    cfz = synthetic.frozen_from_arrays(synthetic.synthetic_chain_trie(
        1 << 20, chain_fraction=0.75, seed=3))
    for tag in cs.QUANT:
        cdt = cfz.device_arrays(device=dev, **cs.QUANT[tag])
        dq = ops._dequant_statics(cdt)
        timed_reduce(f"reduce_chain_{tag.replace('+', '_')}",
                     (cdt.support, cdt.confidence, cdt.node_depth),
                     n_transactions=dq["n_transactions"],
                     confidence_scale=dq["confidence_scale"])


def query_lanes(cs, dev, timed, edges, lanes):
    from repro_torch.core import synthetic
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.item_index import rules_with_member
    from repro_torch.kernels.rank import topk_rank_batch

    arrs = synthetic.synthetic_csr_trie(edges, seed=0)
    frozen = synthetic.frozen_from_arrays(arrs)
    dt = frozen.device_arrays(device=dev)
    _, _, _, prefixes, items = cs.query_traffic(arrs, 0)
    dfs = ops.dfs_rank_arrays(dt)
    los, his, _ = ops.prefix_ranges(frozen, prefixes, dt=dt)
    r_args = (dfs["support"], dfs["confidence"], dfs["lift"], dfs["depth"],
              los, his)
    for k in ((10, 100) if "rank" in lanes else ()):
        kw = dict(k=k, metric="confidence", min_depth=1)
        timed(f"rank_k{k}", lambda: topk_rank_batch(*r_args, **kw),
              lambda: ref.topk_rank_batch_ref(*r_args, **kw), RANK_KERNELS,
              split=True)
    if "member" not in lanes:
        return
    ia = ops.item_rank_arrays(dt)
    m_args = (ia["support"], ia["confidence"], ia["lift"], ia["depth"],
              ia["node_item"], ia["post_lo"], ia["post_hi"],
              *cs.member_kernel_rows(ia, items, dev))
    for role in cs.ROLES:
        kw = dict(k=10, metric="confidence", min_depth=1, role=role)
        timed(f"member_{role}", lambda: rules_with_member(*m_args, **kw),
              lambda: ref.rules_with_ref(*m_args, **kw), MEMBER_KERNELS,
              split=role == "consequent")


def chain_lane(cs, dev, timed):
    from repro_torch.core import synthetic
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.item_index import rules_with_member
    from repro_torch.kernels.rank import topk_rank_batch

    # the compressed phase's traffic (chip_smoke.compressed_phase)
    carrs = synthetic.synthetic_chain_trie(1 << 20, chain_fraction=0.75,
                                           seed=3)
    cfz = synthetic.frozen_from_arrays(carrs)
    _, _, cprefixes, citems = cs.chain_traffic(carrs, 0)
    for tag in ("i32+bf16", "i32+int8"):
        cdt = cfz.device_arrays(device=dev, **cs.QUANT[tag])
        dq = ops._dequant_statics(cdt)
        clos, chis, _ = ops.prefix_ranges(cdt, cprefixes)
        c_args = (cdt.support, cdt.confidence, cdt.lift, cdt.node_depth,
                  clos, chis)
        kw = dict(k=100, metric="confidence", min_depth=1, **dq)
        name = tag.replace("+", "_")
        timed(f"rank_chain_{name}_k100",
              lambda: topk_rank_batch(*c_args, **kw),
              lambda: ref.topk_rank_batch_ref(*c_args, **kw), RANK_KERNELS)
        cia = ops.item_rank_arrays(cdt)
        cm_args = (cia["support"], cia["confidence"], cia["lift"],
                   cia["depth"], cia["node_item"], cia["post_lo"],
                   cia["post_hi"], *cs.member_kernel_rows(cia, citems, dev))
        for role in cs.ROLES:
            kw = dict(k=10, metric="confidence", min_depth=1, role=role,
                      **dq)
            timed(f"member_chain_{name}_{role}",
                  lambda: rules_with_member(*cm_args, **kw),
                  lambda: ref.rules_with_ref(*cm_args, **kw), MEMBER_KERNELS)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--edges", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--lanes", default=",".join(LANES),
                    help="comma-separated subset of " + ",".join(LANES))
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    lanes = set(args.lanes.split(","))
    if not lanes <= set(LANES):
        ap.error(f"--lanes: unknown {sorted(lanes - set(LANES))}")
    if args.one:
        one(args.trees[0], args.edges, args.reps, lanes)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("rank_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    for tree in args.trees:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        tree, "--edges", str(args.edges), "--reps",
                        str(args.reps), "--lanes", args.lanes],
                       check=True, cwd=HERE)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
