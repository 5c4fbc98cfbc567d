"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (its file from ``configs``) and a traffic
mix (``trie_bench/traffic/<mix>.json``); a per-layer metric is read by
``trie_bench/metrics/<metric>.py``, which defines ``read(ctx)`` returning
a number, or None where the run gave it nothing to read.  So a later
configuration, mix, cell or metric is a file and an entry, with no file
here edited.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _for_cell(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics
            if "workloads" not in m or cell in m["workloads"]]


def cell(name: str, root: Path = ROOT) -> Dict:
    """The workload ``name``: its entry, configuration, traffic mix and the
    metrics it reports."""
    root = Path(root)
    bench = load(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(work)}")
    w = work[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    with open(root / cfgs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "trie_bench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return {
        "workload": w,
        "config": config,
        "traffic": traffic,
        "end_to_end": _for_cell(bench["end_to_end"], name),
        "per_layer": _for_cell(bench["per_layer"], name),
        "run_seconds": bench["run_seconds"],
        "root": root,
    }


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``trie_bench/metrics/<name>.py``."""
    path = Path(root) / "trie_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"trie_bench.metrics.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
