"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 trie_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up makes the configuration's database from ``--seed``
(``data.make_transactions``), builds the Trie of Rules on the card with
the port's ``build_trie_of_rules(db, minsup, miner=<the configuration's
miner>, engine="arrays")``, serves it in the configuration's layout from a
``TrieQueryEngine`` through a ``TrieScheduler`` with the scheduler's own
defaults, warms every launch shape and then the loop itself.  The window drives the scheduler with the
mix's closed-loop clients for ``--seconds`` on the host's monotonic clock
(``serve_loop``).  Then the program's state is freed, the reference mines
the same database on the card and the comparison (``check``) judges the
program's trie and every answer it returned.

With ``--trace 0`` the result line carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a device trace of the
window by ``metrics/<name>.py``.  The last line of standard output is the
result; the last lines of standard error are the compared numbers beside
their limits.  A run without a CUDA device, or in a checkout without the
port, prints no result and exits non-zero.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import inspect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# caches the program or torch may write live inside the checkout, at fixed
# paths; the port's own kernel builds go to <checkout>/build (fixed in code)
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ.setdefault(_var, str(ROOT / "build" / "trie_bench" / _sub))
os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("USE_FLAX", "0")
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the miners whose output is every frequent itemset, which the reference
# mines too, and the layouts the engine serves (its replicated upload is
# the plain CSR); a configuration that names another is refused
MINERS = ("apriori", "fpgrowth")
LAYOUTS = ("plain",)


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def setup(cell, seed, device, hooks):
    """Database, trie, engine and scheduler; every launch shape warmed."""
    import numpy as np
    import torch
    from repro_torch.arm.transactions import TransactionDB
    from repro_torch.core.builder import build_trie_of_rules
    from repro_torch.serve import TrieScheduler
    from repro_torch.serve.trie_engine import TrieQueryEngine

    from trie_bench.data import make_transactions
    from trie_bench.loadgen import Traffic, item_paths
    from trie_bench.serve_loop import TimedEngine

    cfg, mix = cell["config"], cell["traffic"]
    if cfg["miner"] not in MINERS:
        raise ValueError(f"miner {cfg['miner']!r} not in {MINERS}")
    if cfg["layout"] not in LAYOUTS:
        raise ValueError(f"layout {cfg['layout']!r} not in {LAYOUTS}")
    times = {"start_s": time.perf_counter() - T_PROCESS}
    t = time.perf_counter()
    tx = make_transactions(cfg, seed)
    db = TransactionDB(tx, n_items=int(cfg["n_items"]))
    times["db_s"] = time.perf_counter() - t
    t = time.perf_counter()
    built = build_trie_of_rules(db, float(cfg["minsup"]), miner=cfg["miner"],
                                max_len=int(cfg["max_len"]), engine="arrays",
                                device=device)
    frozen = built.frozen
    times.update(construct_s=time.perf_counter() - t,
                 mine_s=built.mine_seconds, build_s=built.build_seconds,
                 annotate_s=built.annotate_seconds)
    del built
    t = time.perf_counter()
    if hooks.get("frozen"):
        frozen = hooks["frozen"](frozen)
    engine = TrieQueryEngine(frozen, device=device, mode="replicated")
    traffic = Traffic(mix, item_paths(frozen.node_parent, frozen.node_item,
                                      frozen.node_depth), seed)

    # every launch shape: each op at each power-of-two batch the
    # scheduler pads to (1 .. its default max_batch), on real queries as
    # wide as its query rows (the trie's depth to a power of two)
    max_batch = inspect.signature(TrieScheduler).parameters[
        "max_batch"].default
    qwidth = 1 << max(int(frozen.node_depth.max()) - 1, 0).bit_length()
    kw = traffic.kwargs
    n = 1
    while n <= max_batch:
        paths = [traffic.paths[i % len(traffic.paths)] for i in range(n)]
        q = np.full((n, qwidth), -1, np.int32)
        for i, p in enumerate(paths):
            q[i, : len(p)] = p
        al = np.array([max(len(p) - 1, 1) for p in paths], np.int32)
        engine.rule_search_batch(q, al)
        engine.top_k_rules_batch(q, kw["top_k"]["k"],
                                 metric=kw["top_k"]["metric"])
        engine.rules_with([p[-1] for p in paths],
                          role=kw["rules_with"]["role"],
                          k=kw["rules_with"]["k"],
                          metric=kw["rules_with"]["metric"])
        n *= 2
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times["serve_prep_s"] = time.perf_counter() - t

    timed = None
    served = engine
    if hooks.get("engine"):
        served = hooks["engine"](served)
    if cell.get("trace"):
        timed = TimedEngine(served, lambda: torch.cuda.synchronize(device))
        served = timed
    sched = TrieScheduler(served)
    # the start-up heap (torch, the port, the database) is frozen, as
    # long-running Python servers freeze theirs: the collector's full
    # passes in the window then scan only what serving made
    gc.collect()
    gc.freeze()
    return SimpleNamespace(tx=tx, frozen=frozen, engine=engine, sched=sched,
                           traffic=traffic, timed=timed, times=times)


def main(argv=None, device=None, hooks=None, root=None) -> int:
    """One run; returns the exit code.  ``device``, ``hooks`` and ``root``
    are for the benchmark's own tests: a CPU device skips the look for a
    card, ``hooks`` may alter the built trie (``frozen``) or wrap the
    served engine (``engine``) to plant a fault under the timed path, and
    ``root`` holds another ``BENCHMARK.json``; ``hooks["judged"]`` is
    handed the run's loop, traffic, reference and compared numbers once
    the comparison is made (``readings.py`` reads the control there)."""
    args = parse(argv)
    seed = args.seed % (1 << 64)
    hooks = hooks or {}
    import numpy as np
    import torch

    from trie_bench import check, spec
    from trie_bench.reference.mine import mine
    from trie_bench.serve_loop import run_loop

    torch.set_num_threads(1)
    cell = spec.cell(args.workload, root or spec.ROOT)
    chips = int(cell["workload"]["chips"])
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            log(f"trie_bench: the cell needs {chips} CUDA device(s); "
                f"{n} visible")
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    on_card = device.type == "cuda"
    cell["trace"] = bool(args.trace)
    if args.trace and not on_card:
        log("trie_bench: a traced run needs a CUDA device")
        return 2
    cfg = cell["config"]

    st = setup(cell, seed, device, hooks)
    t_ready = time.perf_counter()
    mem = {}
    opened = {}

    def on_open():
        if on_card:
            torch.cuda.synchronize(device)
            mem["setup"] = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        opened["t"] = time.perf_counter()

    def on_close():
        if on_card:
            torch.cuda.synchronize(device)
            mem["window"] = torch.cuda.max_memory_allocated(device)

    trace = None
    if args.trace:
        from trie_bench.trace import DeviceTrace
        trace = DeviceTrace(device)
    loop = run_loop(st.sched, st.traffic, args.seconds, on_open, on_close,
                    trace=trace)
    setup_s = opened["t"] - T_PROCESS
    st.times["warm_loop_s"] = opened["t"] - t_ready

    # the program's state is freed before the reference runs on the card
    port = {k: np.asarray(getattr(st.frozen, k)) for k in (
        "node_item", "node_parent", "node_depth", "support", "confidence",
        "lift")}
    calls = st.timed.calls if st.timed is not None else []
    n_nodes = st.frozen.n_nodes
    del st.sched, st.engine, st.timed, st.frozen
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    events = trace.events() if trace is not None else None
    if trace is not None:
        del trace.prof

    t_ref = time.perf_counter()
    ref = mine(st.tx, int(cfg["n_items"]), float(cfg["minsup"]),
               int(cfg["max_len"]), device=device)
    numbers, node_map = check.trie_numbers(port, ref)
    numbers.update(check.answer_numbers(loop, st.traffic, ref, node_map))
    correct, lines = check.judge(numbers)
    t_ref = time.perf_counter() - t_ref
    if hooks.get("judged"):
        hooks["judged"](SimpleNamespace(loop=loop, traffic=st.traffic,
                                        ref=ref, numbers=numbers))

    ctx = SimpleNamespace(loop=loop, calls=calls, events=events, ref=ref,
                          traffic=st.traffic)
    metrics = {}
    if args.trace:
        for m in cell["per_layer"]:
            v = spec.metric_reader(m["name"], cell["root"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {
            "queries_per_s": loop.window_done / loop.window_s,
            "setup_s": setup_s,
        }
        for m in cell["end_to_end"]:
            if m["name"] not in values:
                raise KeyError(f"end-to-end metric {m['name']!r} unknown")
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1,
           "memory_peak_bytes": int(max(mem.values(), default=0))}
    out = {"correct": bool(correct),
           "attempted": len(loop.ops),
           "failed": int(numbers["unanswered"] + numbers["answer_wrong"]),
           "metrics": metrics, "device": dev}
    if events is not None:
        from trie_bench.trace import breakdown

        dev["busy_s"] = events.busy_s()
        dev["window_s"] = events.window_s()
        spans = [("scheduler.step", int(a * 1e9), int(b * 1e9))
                 for a, b in loop.steps]
        spans += [("engine." + c[0], c[1], c[2]) for c in calls]
        out["breakdown"] = breakdown(events, spans)
    out["checks"] = check.checks_json(numbers)

    log(f"[run] {args.workload} seed {args.seed}: {n_nodes} nodes, "
        f"set-up {setup_s:.3f} s ({', '.join(f'{k} {v:.3f}' for k, v in st.times.items())}), "
        f"window {loop.window_s:.3f} s ({loop.cpu_s:.3f} s on the CPU), "
        f"{loop.window_done} answered, "
        f"longest steps {[round(x, 2) for x in loop.longest_steps_ms]} ms, "
        f"gc {loop.gc_n} in {loop.gc_s * 1e3:.1f} ms, "
        f"answered a second {loop.per_second}, "
        f"counters {loop.counters}, pools {st.traffic.describe()}, "
        f"not ok {len(loop.not_ok)}, still pending {loop.outstanding}, "
        f"reference and check {t_ref:.3f} s"
        + (f", trace drift {events.drift_ns:.0f} ns, "
           f"{len(events.names)} device events" if events is not None
           else ""))
    bad = forbidden_modules()
    if bad:
        log(f"trie_bench: modules of JAX or the JAX package loaded: {bad}")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
